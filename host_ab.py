"""Wall times of the port's host-bound paths, for one checkout.

    python3 host_ab.py [--root DIR]

imports ``tenscalc_tpu_torch`` from ``DIR`` (default: this script's
directory) and times, at chip_smoke.py's shapes in float32 on the card,
the paths whose time the host sets: the MPC-MHE fleet (B = 1024), the
sls fleet (B = 1024, n = 32), the min-max saddle fleet (B = 1024,
n = 80), the sls single warm solve and the flops N = 300 and N = 1000
warm solves.  Each path is built and solved once untimed, then solved
REPS times; the sls single and flops N = 300 solves once more under the
profiler, which counts the ATen operator calls and CUDA launches of a
solve.  Every time and count is printed, with the card's name and power
limit, as one JSON line.  To compare two commits, unpack the other one
with ``git archive`` into a git-ignored directory and run both on the
same card in one call, e.g. parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs


def timed(fn):
    """(wall seconds, result) of ``fn()`` between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


REPS = 5  # timed solves a path
# the paths whose operators are counted (a fleet's solve dispatches over
# a million, which the profiler takes minutes to gather)
COUNTED = ("sls_single_warm", "flops_300")


def host_ops(fn) -> dict:
    """What one more call of ``fn`` asks of the host, from the profiler:
    ATen operator calls (nested ones included), among them scalar-tensor
    factories and fills, and CUDA kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    return {"aten_ops": sum(c for k, c in counts.items() if k.startswith("aten::")),
            "scalar_tensor_and_fill": sum(counts.get(k, 0) for k in (
                "aten::scalar_tensor", "aten::fill_")),
            "cuda_launches": sum(c for k, c in counts.items()
                                 if k in ("cudaLaunchKernel", "cuLaunchKernel",
                                          "cudaLaunchKernelExC", "cuLaunchKernelEx"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("host_ab.py needs a CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import tenscalc_tpu_torch as ttc
    from tenscalc_tpu_torch import native
    from tenscalc_tpu_torch.examples import flops, mpcmhe_dcmotor, sls
    from tenscalc_tpu_torch.kkt import banded_lu, dense_ldl, fleet_banded

    if not Path(ttc.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"tenscalc_tpu_torch came from {ttc.__file__}, not {root}")
    with ThreadPoolExecutor(max_workers=4) as pool:  # the kernels' builds
        for f in [pool.submit(m._load) for m in (fleet_banded, banded_lu, dense_ldl, native)]:
            f.result()

    paths = {}

    mm = mpcmhe_dcmotor.build_solver(T=cs.MMHE_T, L=cs.MMHE_L, ns="mmhe_", dtype="float32")
    mparams = mpcmhe_dcmotor.fleet_inputs(cs.MMHE_T, cs.MMHE_L, cs.MMHE_B, "mmhe_", seed=0)
    paths["mpcmhe_fleet"] = (cs.MMHE_B, lambda: mm.solve_many(mparams, mu0=1e-3, max_iter=100))

    sf = sls.build_constrained(n=cs.SLS_N, ns="slsf_", dtype="float32")
    sdata = sls.fleet_inputs(cs.SLS_B, n=cs.SLS_N, seed=0)
    paths["sls_fleet"] = (cs.SLS_B, lambda: cs.solve_sls_fleet(sf, "slsf_", sdata))

    mmx = cs.build_minmax(ttc, "bmm_")
    xparams, xinits = cs.minmax_inputs("bmm_", cs.MM_B)
    paths["minmax_fleet"] = (cs.MM_B, lambda: mmx.solve_many(xparams, inits=xinits, mu0=1.0,
                                                             max_iter=60))

    s1 = sls.build_constrained(ns="sls1_", dtype="float32")
    d1 = sls.default_data()
    p1 = cs.sls_params("sls1_", d1)
    x1 = s1.solve(p1, init={"sls1_x": d1["x0"]}, mu0=1.0, max_iter=30).variables["sls1_x"]
    paths["sls_single_warm"] = (1, lambda: s1.solve(p1, init={"sls1_x": x1}, mu0=1.0,
                                                    max_iter=30))

    for N in (300, 1000):
        fl, fns = flops.build_solver(N, ns=f"bfl{N}_", dtype="float32")
        fparams, finit = flops.default_data(N, fns)
        paths[f"flops_{N}"] = (1, lambda fl=fl, p=fparams, i=finit:
                               fl.solve(p, init=i, mu0=1.0, max_iter=60))

    out = {}
    for name, (count, fn) in paths.items():
        _, res = timed(fn)  # warm-up (first-call allocations)
        status = res.status.cpu().numpy() if torch.is_tensor(res.status) else [res.status]
        if any(int(s) != 0 for s in status):
            raise RuntimeError(f"{name}: an instance not at status 0")
        walls = [timed(fn)[0] for _ in range(REPS)]
        out[name] = {"count": count, "wall_s": walls, "median_s": statistics.median(walls),
                     "per_s_at_median": count / statistics.median(walls),
                     **(host_ops(fn) if name in COUNTED else {})}
    print(json.dumps({"root": str(root), "card": cs.card_line(), "paths": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
