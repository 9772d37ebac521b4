"""Which operations of a fleet solve round by their batch's size.

    python -m tenscalc_tpu_torch.parallel.batch_rounding [--device cuda|cpu]
        [--T 30] [--batch 1024] [--max-iter 100] [--out FILE]

A fleet split over a mesh solves each entry's instances as a smaller
fleet, and on the card a fleet of 512 does not give a fleet of 1024's
bits.  This finds where the bits part.  It builds the flagship fleet
(``mpc_dcmotor``, float32, the inputs of :func:`fleet_inputs` from seed
0), solves all B instances as one fleet and the first B/2 as a fleet of
their own, and reports:

1. how far the two answers for the first B/2 instances are apart, and
   the first lockstep iteration at which their history rows part
   (``profiling=True``, which leaves the answers bitwise as without it);
2. every operation of the fleet-of-B solve whose first B/2 rows are not
   bitwise what the same operation gives on the first B/2 rows of its
   batched operands: the ATen operators by a ``TorchDispatchMode``, the
   hand-written K1/K2 by replaying their wrappers on the half;
3. the fleet of B solved with every ``aten.bmm`` of batch B split into
   calls of B/2 rows, against the two halves solved as fleets of their
   own: how many instances are then bitwise equal;
4. the CUDA kernels that the profiler sees in a solve of one size and
   not in the other, each with the host operators (and their operand
   shapes) that launched it.

An operand is batched when its first dimension is B.  Operators with an
integer operand (indexing: a half could index past its rows), operators
that write into an operand, and ``empty``-like factories are left out
and counted; so are operators whose result's first dimension is not B or
that do not accept the half.  It runs on the card unless ``--device
cpu`` asks for the CPU (there K1/K2 are their plain versions and are not
replayed).  It prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter, defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.is_floating_point():
        return float("nan")
    d = (a.double() - b.double()).abs().nan_to_num(0.0)
    return float(d.max()) if d.numel() else 0.0


class RowCheck(TorchDispatchMode):
    """Recompute every batched operator on the first ``half`` rows of its
    batched operands and hold the result against the first ``half`` rows
    of its own: ``checked`` and ``parted`` count calls by operator and
    operand shapes, ``left_out`` the calls not checked, by reason."""

    def __init__(self, batch: int):
        super().__init__()
        self.batch, self.half = batch, batch // 2
        self.checked: Counter = Counter()
        self.parted: Counter = Counter()
        self.parted_diff = defaultdict(float)
        self.left_out: Counter = Counter()

    def _cut(self, t):
        if isinstance(t, torch.Tensor) and t.dim() > 0 and t.shape[0] == self.batch:
            return t[: self.half]
        return t

    def note(self, key: str, same: bool, diff: float) -> None:
        self.checked[key] += 1
        if not same:
            self.parted[key] += 1
            self.parted_diff[key] = max(self.parted_diff[key], diff)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (isinstance(out, torch.Tensor) and out.dim() > 0 and out.shape[0] == self.batch):
            return out
        leaves = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        batched = [t for t in leaves if t.dim() > 0 and t.shape[0] == self.batch]
        name = str(func.overloadpacket.__name__)
        if not batched:
            return out
        if any(type(t) is not torch.Tensor or t.is_meta for t in leaves + [out]):
            self.left_out["traced, not run"] += 1
            return out
        if func._schema.is_mutable or "empty" in name:
            self.left_out["writes or allocates"] += 1
            return out
        if any(not (t.is_floating_point() or t.dtype == torch.bool) for t in leaves):
            self.left_out["integer operand"] += 1
            return out
        try:
            again = func(*tree_map(self._cut, args), **tree_map(self._cut, kwargs))
        except Exception:  # an operator that mixes the batch with other rows
            self.left_out["refuses the half"] += 1
            return out
        ref = out[: self.half]
        if not isinstance(again, torch.Tensor) or again.shape != ref.shape:
            self.left_out["other shape on the half"] += 1
            return out
        key = f"{func} {[tuple(t.shape) for t in leaves]}"
        self.note(key, _same(again, ref), _max_diff(again, ref))
        return out


class ChunkedBmm(TorchDispatchMode):
    """Run every ``aten.bmm`` whose batch is ``batch`` as calls of
    ``chunk`` rows each: the counterfactual in which that operator rounds
    as in a fleet of ``chunk``.  ``calls`` counts the split calls."""

    def __init__(self, batch: int, chunk: int):
        super().__init__()
        self.batch, self.chunk, self.calls = batch, chunk, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten.bmm.default and not kwargs
                and args[0].shape[0] == self.batch > self.chunk):
            self.calls += 1
            a, b = args
            return torch.cat([func(a[i:i + self.chunk], b[i:i + self.chunk])
                              for i in range(0, self.batch, self.chunk)])
        return func(*args, **kwargs)


def _replay_kernels(mode: RowCheck):
    """Wrap K1/K2's launch wrappers to replay each launch on the first
    half of the fleet into fresh outputs; returns the undo."""
    from ..kkt import fleet_banded as fb

    k1, k2 = fb.launch_factor_solve, fb.launch_solve
    h = mode.half

    def factor_solve(band, rhs, fband, x, w, clamp, group=None):
        k1(band, rhs, fband, x, w, clamp, group)
        if band.shape[0] == mode.batch:
            f2, x2 = torch.empty_like(fband[:h]), torch.empty_like(x[:h])
            k1(band[:h], rhs[:h], f2, x2, w, clamp, group)
            mode.note(f"K1 fleet_banded factor_solve {tuple(band.shape)}",
                      _same(f2, fband[:h]) and _same(x2, x[:h]),
                      max(_max_diff(f2, fband[:h]), _max_diff(x2, x[:h])))

    def solve(fband, rhs, x, w, group=None):
        k2(fband, rhs, x, w, group)
        if fband.shape[0] == mode.batch:
            x2 = torch.empty_like(x[:h])
            k2(fband[:h], rhs[:h], x2, w, group)
            mode.note(f"K2 fleet_banded solve {tuple(fband.shape)}", _same(x2, x[:h]),
                      _max_diff(x2, x[:h]))

    fb.launch_factor_solve, fb.launch_solve = factor_solve, solve

    def undo():
        fb.launch_factor_solve, fb.launch_solve = k1, k2
    return undo


def _launched_by(fn) -> dict:
    """One call of ``fn`` (after a warm-up) under the profiler: {CUDA
    kernel name: {"operator [operand shapes]": launches}}, each kernel
    by the host operator that launched it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    by: dict = defaultdict(Counter)
    for e in prof.events():
        for k in e.kernels:
            by[k.name][f"{e.name} {e.input_shapes}"] += 1
    return by


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(device: str = "cuda", T: int = 30, batch: int = 1024, max_iter: int = 100) -> dict:
    """The readings above, as a dict."""
    from ..examples import mpc_dcmotor as mpc

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; no solve on the CPU in its place")
    ns = "brd_"
    solver = mpc.build_solver(T=T, namespace=ns, dtype="float32", device=device,
                              profiling=True)
    params, inits = mpc.fleet_inputs(T, batch, ns, seed=0)
    h = batch // 2
    hparams = {k: (v[:h] if k in (ns + "ref", ns + "xinit") else v) for k, v in params.items()}
    hinits = {k: v[:h] for k, v in inits.items()}

    def whole():
        return solver.solve_many(params, inits=inits, mu0=1e-3, max_iter=max_iter)

    def half():
        return solver.solve_many(hparams, inits=hinits, mu0=1e-3, max_iter=max_iter)

    rw, rh = whole(), half()
    a = {k: getattr(rw, k)[:h].cpu() for k in ("u", "status", "iters", "f", "history")}
    b = {k: getattr(rh, k).cpu() for k in ("u", "status", "iters", "f", "history")}
    du = (a["u"].double() - b["u"].double()).abs().amax(dim=1)
    rows = a["history"].shape[1]
    parts = [i for i in range(rows)
             if not _same(a["history"][:, i], b["history"][:, i])]
    out = dict(
        device=device, card=_card_line() if device == "cuda" else None, T=T, batch=batch,
        backend=solver.kkt_backend_resolved,
        answers=dict(
            bitwise=int(sum(_same(a["u"][i], b["u"][i]) and _same(a["f"][i], b["f"][i])
                            for i in range(h))),
            of=h, max_abs_du=float(du.max()), above_2e_3=int((du > 2e-3).sum()),
            iterations_differ=int((a["iters"] != b["iters"]).sum()),
            status_whole=np.bincount(a["status"].numpy()).tolist(),
            status_half=np.bincount(b["status"].numpy()).tolist(),
            objective_rel_max=float(((a["f"].double() - b["f"].double()).abs()
                                     / b["f"].double().abs()).max()),
            history_first_parted_row=parts[0] if parts else None),
    )

    # the counterfactual: the fleet of B with its bmm split into halves,
    # against the two halves solved as fleets of their own
    rest = {k: (v[h:] if k in (ns + "ref", ns + "xinit") else v) for k, v in params.items()}
    rh2 = solver.solve_many(rest, inits={k: v[h:] for k, v in inits.items()}, mu0=1e-3,
                            max_iter=max_iter)
    cut = ChunkedBmm(batch, h)
    with cut:
        rcut = whole()
    pair = {k: torch.cat([getattr(rh, k).cpu(), getattr(rh2, k).cpu()])
            for k in ("u", "status", "iters", "f")}
    out["bmm_split"] = dict(
        split_calls=cut.calls,
        bitwise=int(sum(all(_same(getattr(rcut, k)[i].cpu(), pair[k][i])
                            for k in ("u", "status", "iters", "f")) for i in range(batch))),
        of=batch)

    mode = RowCheck(batch)
    undo = _replay_kernels(mode) if device == "cuda" else (lambda: None)
    try:
        with mode:
            rc = whole()
    finally:
        undo()
    check_same = _same(rc.u.cpu(), rw.u.cpu())
    out["rows"] = dict(
        solve_bitwise_unchecked=check_same,
        checked_calls=sum(mode.checked.values()), checked_kinds=len(mode.checked),
        parted={k: dict(calls=mode.parted[k], of=mode.checked[k],
                        max_abs_diff=mode.parted_diff[k])
                for k in sorted(mode.parted, key=lambda k: -mode.parted[k])},
        left_out=dict(mode.left_out))

    if device == "cuda":
        w_, h_ = _launched_by(whole), _launched_by(half)
        out["kernels"] = dict(
            whole_only={k: dict(w_[k]) for k in sorted(set(w_) - set(h_))},
            half_only={k: dict(h_[k]) for k in sorted(set(h_) - set(w_))},
            both=len(set(w_) & set(h_)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        os.environ.setdefault("TENSCALC_AUTO_FLEET", "1")
    res = run(args.device, args.T, args.batch, args.max_iter)
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0 if res["rows"]["solve_bitwise_unchecked"] else 1


if __name__ == "__main__":
    sys.exit(main())
