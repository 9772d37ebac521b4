"""Profiling: per-phase timers and flop-class counters (port of
``tenscalc_tpu/profiling.py``).

The reference bakes 17 flop-class counters and per-dependency-group ns
timers into its generated C (lib/csparse/instructionsTableTypes.h:
107-125, lib/@csparse/writeCfunctionpergroup.m:148-178) and prints them
with profilingView (lib/@csparse/writeCprofiling.c:8-60).  Here:

* :func:`flop_counts` — analytic per-iteration flop counts by phase,
  from the problem's static dimensions and the resolved KKT backend and
  plan (the JAX package's arithmetic, so the same dict);
* :func:`kernel_times` and :func:`measure_device_time` — device times
  from ``torch.profiler``'s CUDA kernel events (:func:`kernel_events`;
  the JAX versions read the TPU's xplane trace); None off the card;
* :func:`xla_cost` — the name kept so a reader finds it: the flops
  ``torch.utils.flop_counter.FlopCounterMode`` counts over one solve;
* :func:`phase_times` — measured seconds per phase, CUDA events on the
  card and ``perf_counter`` on the CPU;
* :func:`print_profile` — the profilingView-style report.
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch.func import grad, vmap

from .ipm.solver import dense_kkt
from .kkt.dense import lu_solve_mixed

_CSRC = Path(__file__).resolve().parent / "csrc"


# ---------------------------------------------------------------------------
# profiler-measured device time
# ---------------------------------------------------------------------------

def _sync_default(_result=None) -> None:
    torch.cuda.synchronize()


def kernel_events(call: Callable, sync: Optional[Callable] = None, n: int = 1,
                  warmup: bool = True, host_ops: bool = False):
    """``call`` once to warm up (unless not ``warmup``), then n times
    under ``torch.profiler`` (CUDA activity, and the host's operators if
    ``host_ops``): (wall seconds of the n calls, {kernel name: (total
    device us, launches)}), or None without CUDA or when the profiler saw
    no kernel.  ``sync`` waits for a call's result (default
    ``torch.cuda.synchronize``)."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    sync = sync or _sync_default
    if warmup:
        sync(call())
    acts = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = None
        for _ in range(n):
            r = call()
        sync(r)
        wall = time.perf_counter() - t0
    # kernel events only: operator events also carry their kernels' time
    out = {
        e.key: (e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    }
    return (wall, out) if out else None


def csrc_kernel_names() -> list:
    """The ``__global__`` functions of the port's hand-written sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    names = set()
    for src in sorted(_CSRC.glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return sorted(names)


def kernel_times(call: Callable, sync: Optional[Callable] = None, n: int = 3,
                 match: Optional[str] = None):
    """Per-kernel device times of ``call()``: {kernel: {"us_per_occ",
    "occ_per_call"}} over the CUDA kernels whose names ``match`` (a
    regular expression) finds; by default the hand-written kernels, by
    their names in ``csrc/`` (a template's instances apart).  ``sync``
    waits for a call's result (default ``torch.cuda.synchronize``).
    None off the card or when no kernel matched (the JAX version returns
    None without a trace)."""
    got = kernel_events(call, sync, n)
    if got is None:
        return None
    ev = got[1]
    if match is None:
        match = r"\b(?:" + "|".join(csrc_kernel_names()) + r")\b\s*[<(]"
    out = {}
    for name, (us, cnt) in ev.items():
        if cnt > 0 and re.search(match, name):
            key = name.replace("(anonymous namespace)::", "").removeprefix("void ")
            key = key.split("(")[0].strip()
            out[key] = {"us_per_occ": round(us / cnt, 2), "occ_per_call": round(cnt / n, 2)}
    return out or None


def measure_device_time(call: Callable, sync: Optional[Callable] = None, n: int = 10):
    """Mean device seconds per ``call()``: the sum of its CUDA kernels'
    device time under ``torch.profiler`` over n calls, divided by n.
    None off the card (callers fall back to the host clock, as the JAX
    version's do without a TPU trace)."""
    got = kernel_events(call, sync, n)
    if got is None:
        return None
    return sum(us for us, _ in got[1].values()) / n / 1e6


# ---------------------------------------------------------------------------
# analytic flop counters
# ---------------------------------------------------------------------------

def flop_counts(solver) -> Dict[str, float]:
    """Per-IPM-iteration flop estimates by phase for an OptimizeSolver.

    Counts assume the hoisted (QP-like) path recomputes only what the
    build-time invariance analysis left in the loop; AD factors of ~3
    (forward) / ~4 (reverse over forward) follow the standard
    autodiff cost model.
    """
    nU, nF, nG = solver.nU, solver.nF, solver.nG
    opts = solver.opts
    small = opts.smallerNewtonMatrix
    nK = nU + nG + (0 if small else nF)
    hoist_H, hoist_Fu, hoist_Gu = solver._hoist

    c: Dict[str, float] = {}
    # derivative (re)assembly inside the loop
    c["grad_lagrangian"] = 4.0 * (nU + nF * nU + nG * nU)
    c["hessian"] = 0.0 if hoist_H else 12.0 * nU * nU
    c["ineq_jacobian"] = 0.0 if (hoist_Fu or nF == 0) else 3.0 * nF * nU
    c["eq_jacobian"] = 0.0 if (hoist_Gu or nG == 0) else 3.0 * nG * nU
    # KKT assembly
    if small and nF:
        c["kkt_assembly"] = 2.0 * nF * nU * nU + 2.0 * nF * nU  # Fu' LPG
    else:
        c["kkt_assembly"] = float(nK * nK)  # concats/scaling
    # factorization + substitutions, by (resolved) backend
    plan = getattr(solver, "kkt_plan", None)
    backend = getattr(solver, "kkt_backend_resolved", opts.kkt_backend)
    n_refine = opts.refine_for(backend)
    n_rhs = 1 + (0 if opts.skipAffine else 1)
    n_solve32 = n_rhs * (1 + n_refine)
    if plan is not None and getattr(plan, "bandwidth", None) and backend in (
        "fleet_banded", "tridiag", "cyclic", "spike",
    ):
        w = plan.bandwidth
        c["factorization"] = 2.0 * nK * w * (w + 1)
        c["substitutions"] = n_solve32 * 4.0 * nK * w
    else:
        c["factorization"] = 2.0 * nK**3 / 3.0
        c["substitutions"] = n_solve32 * 2.0 * nK * nK
    c["refinement_matvecs"] = n_rhs * n_refine * 2.0 * nK * nK
    c["direction_error"] = 2.0 * nK * nK
    # batched line search: 2*(K+2) evaluations of F(u + a dU)
    if nF:
        c["line_search"] = 2.0 * (opts.linesearch_points + 2) * (
            3.0 * nF + nU
        )
    else:
        c["line_search"] = 0.0
    c["exit_tests"] = 2.0 * (nU + nF + nG)
    c["total_per_iteration"] = float(sum(c.values()))
    c["kkt_size"] = float(nK)
    return c


def xla_cost(solver, parameters: Mapping[str, Any],
             init: Optional[Mapping[str, Any]] = None,
             mu0: float = 1.0) -> Dict[str, float]:
    """The flops of one whole solve (every iteration, the prologue and
    the exit tests), as ``torch.utils.flop_counter.FlopCounterMode``
    counts them: the matrix products, convolutions and attention it
    knows, and no elementwise operation.  The name is the JAX package's,
    whose version reads XLA's cost model.  A hand-written kernel bound
    through ctypes is invisible to the counter: on the card the KKT
    factor and solves do not count, on the CPU their plain versions'
    products do."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        solver.solve_result(parameters, init, mu0=mu0)
    return {"flops": float(counter.get_total_flops())}


# ---------------------------------------------------------------------------
# measured per-phase timers
# ---------------------------------------------------------------------------

def _loop_time(fn: Callable, device: torch.device, iters: int = 20) -> float:
    """Seconds per call of ``fn`` over ``iters`` calls after one warm-up:
    CUDA events around the calls on the card, ``perf_counter`` on the
    CPU."""
    fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def phase_times(solver, parameters: Mapping[str, Any],
                init: Optional[Mapping[str, Any]] = None,
                mu: float = 1e-1, iters: int = 20) -> Dict[str, float]:
    """Measured seconds per phase of one instance on the solver's device:
    the options' dense KKT assembly (:func:`.ipm.solver.dense_kkt`), a
    factor and solve (:func:`.kkt.dense.lu_solve_mixed`), the line
    search's constraint sweep and the exit tests' gradient, at the init
    with unit duals (``mu`` is kept for the JAX package's signature)."""
    dt = solver.opts.torch_dtype
    penv = solver._param_env(parameters)
    u0 = solver._pack_init(init)
    nF, nG = solver.nF, solver.nG
    lam, nu = u0.new_ones(nF), u0.new_zeros(nG)
    fns = solver._fns
    assemble = dense_kkt(fns, solver.nU, nF, nG, solver.opts)
    one = torch.ones((), dtype=dt, device=u0.device)

    def asm():
        return assemble(u0, nu, lam, 1e-9, 1e-9, penv, u0.new_ones(nF), one)

    times: Dict[str, float] = {"assemble_ww": _loop_time(asm, u0.device, iters)}
    WW = asm()[None]
    times["factor_plus_solve"] = _loop_time(
        lambda: lu_solve_mixed(WW, WW[:, :, 0]), u0.device, iters)
    if nF:
        cands = torch.linspace(0.01, 1.0, 2 * (solver.opts.linesearch_points + 2),
                               dtype=dt, device=u0.device)
        du = 0.01 * torch.ones_like(u0)
        sweep = vmap(lambda a: fns.F(u0 + a * du, penv).amin())
        times["line_search_sweep"] = _loop_time(lambda: sweep(cands), u0.device, iters)

    def lagr(uu):
        val = fns.f(uu, penv)
        if nF:
            val = val - lam @ fns.F(uu, penv)
        if nG:
            val = val + nu @ fns.G(uu, penv)
        return val

    times["exit_tests_grad"] = _loop_time(lambda: grad(lagr)(u0), u0.device, iters)
    times["iteration_estimate"] = sum(times.values())
    return times


def print_profile(solver, parameters=None, init=None, file=None,
                  measure: bool = False) -> Dict[str, Any]:
    """profilingView-style report (lib/@csparse/writeCprofiling.c):
    analytic flop counters per phase, plus measured per-phase times when
    ``measure=True`` (requires parameter values)."""
    import sys

    file = file or sys.stdout
    counts = flop_counts(solver)
    print("=== tenscalc_tpu_torch profile (per IPM iteration) ===", file=file)
    print(f"KKT size: {int(counts['kkt_size'])}   backend: "
          f"{solver.opts.kkt_backend}", file=file)
    print(f"{'phase':24s}{'flops':>14s}", file=file)
    for k, v in counts.items():
        if k in ("total_per_iteration", "kkt_size"):
            continue
        print(f"{k:24s}{v:14.3e}", file=file)
    print(f"{'TOTAL':24s}{counts['total_per_iteration']:14.3e}", file=file)
    report: Dict[str, Any] = {"flops": counts}
    if measure:
        if parameters is None:
            raise ValueError("measure=True needs parameter values")
        times = phase_times(solver, parameters, init)
        print(f"\n{'phase':24s}{'us/call':>12s}", file=file)
        for k, v in times.items():
            print(f"{k:24s}{v * 1e6:12.1f}", file=file)
        report["times_s"] = times
    return report
