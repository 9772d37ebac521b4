"""Solver diagnostics (port of ``tenscalc_tpu/diagnostics.py``): the
analogs of lib/analyzeHess.m (structural KKT analysis mapping Hessian
blocks back to named variables/constraints) and
lib/debugConvergenceAnalysis.m (post-mortem scaling/dispersion advice
from solver iterates).  numpy and text on the host, on the IPM's
profiling history (:data:`.ipm.solver.HISTORY_COLUMNS`) and on the KKT
that :func:`.ipm.solver.dense_kkt` assembles."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .ipm.solver import HISTORY_COLUMNS, dense_kkt


def analyze_hessian(solver, parameters, init=None, mu: float = 1e-1) -> dict:
    """Structural analysis of the KKT matrix at a given point.

    Returns per-variable gradient/Hessian block norms, per-constraint
    Jacobian row norms, overall conditioning estimates, and the banded
    plan if one was found — the analog of analyzeHess.m:1-30 ("maps
    Hessian blocks back to named variables/constraints").  The KKT is
    the options' dense Newton matrix at the init, with unit duals, zero
    equality multipliers, regularizations 1e-9 and unit scales (``mu``
    is kept for the JAX package's signature: the matrix does not read it).
    """
    dt = solver.opts.torch_dtype
    penv = solver._param_env(parameters)
    u = solver._pack_init(init)
    nF, nG = solver.nF, solver.nG
    assemble = dense_kkt(solver._fns, solver.nU, nF, nG, solver.opts, parts=True)
    a = assemble(
        u, u.new_zeros(nG), u.new_ones(nF), 1e-9, 1e-9, penv,
        u.new_ones(nF), torch.ones((), dtype=dt, device=u.device),
    )
    return analyze_assembled(solver, a)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def analyze_assembled(solver, a: Mapping[str, Any]) -> dict:
    """Structural report from an assembled KKT dict (as produced by the
    port's :func:`.ipm.solver.dense_kkt` with ``parts=True`` or by
    :meth:`OptimizeSolver.capture_ww` —
    the saveWW__ post-mortem path, lib/ipmPD_CS.m:511-515)."""
    nU, nF, nG = solver.nU, solver.nF, solver.nG
    WW = _host(a["WW"])
    H = _host(a["WW11"])
    Fu = _host(a["Fu"])
    Gu = _host(a["Gu"])
    grad = _host(a["f_u"])

    report: dict = {
        "nU": nU, "nF": nF, "nG": nG, "kkt_size": WW.shape[0],
        "kkt_plan": solver.kkt_plan,
    }
    # per-variable blocks
    per_var = {}
    for name in solver.packing.names:
        sl = solver.packing.slice_of(name)
        per_var[name] = {
            "size": sl.stop - sl.start,
            "grad_norminf": float(np.abs(grad[sl]).max(initial=0.0)),
            "hess_diag_range": (
                float(np.abs(np.diag(H)[sl]).min(initial=0.0)),
                float(np.abs(np.diag(H)[sl]).max(initial=0.0)),
            ),
            "ineq_jac_norminf": float(np.abs(Fu[:, sl]).max(initial=0.0)),
            "eq_jac_norminf": float(np.abs(Gu[:, sl]).max(initial=0.0)),
        }
    report["variables"] = per_var
    # conditioning
    try:
        svals = np.linalg.svd(WW, compute_uv=False)
        report["kkt_cond"] = float(svals[0] / max(svals[-1], 1e-300))
        report["kkt_extreme_singular_values"] = (
            float(svals[-1]), float(svals[0])
        )
    except np.linalg.LinAlgError:
        report["kkt_cond"] = float("inf")
    # advice (debugConvergenceAnalysis-style)
    advice = []
    hd = np.abs(np.diag(H))
    if hd.size and hd.max() > 0 and hd.max() / max(hd.min(), 1e-300) > 1e8:
        advice.append(
            "Hessian diagonal spans >1e8 — consider rescaling variables "
            "(reference: debugConvergenceAnalysis scaling advice)"
        )
    if nF and np.abs(Fu).max(initial=0) > 1e4:
        advice.append(
            "inequality Jacobian entries >1e4 — scaleInequalities should "
            "help (enabled by default)"
        )
    if report.get("kkt_cond", 0) > 1e12:
        advice.append(
            "KKT condition number >1e12 at this point — expect the "
            "addEye2Hessian adaptation to engage"
        )
    report["advice"] = advice
    return report


def debug_convergence_analysis(solution) -> dict:
    """Post-mortem on a Solution with profiling history: detects stalls,
    mu plateaus, persistent regularization, and direction-error trouble
    (analog of lib/debugConvergenceAnalysis.m:1-45)."""
    if solution.history is None:
        raise ValueError(
            "solve with SolverOptions(profiling=True) to record history"
        )
    h = np.asarray(solution.history)
    cols = {name: h[:, i] for i, name in enumerate(HISTORY_COLUMNS)}
    findings = []
    alphas = cols["alphaPrimal"]
    if (alphas < 0.1).mean() > 0.5:
        findings.append(
            "alphaPrimal < 0.1 in most iterations — poor scaling or "
            "nearly-infeasible iterates; check variable scaling"
        )
    if (cols["directionError"] > 1e-6).mean() > 0.3:
        findings.append(
            "direction error above 1e-6 in many iterations — the KKT "
            "system is ill-conditioned; addEye2Hessian adaptation active"
        )
    mu = cols["mu"]
    if len(mu) > 10 and mu[-1] > mu[0] * 0.9:
        findings.append("mu barely decreased — solver made little progress")
    addU = cols["addU"]
    if len(addU) and addU[-1] > 1e-4:
        findings.append(
            f"final addEye2HessianU = {addU[-1]:.1e} is large — the "
            "problem may be nonconvex or degenerate at the solution"
        )
    return {
        "iters": len(h),
        "columns": dict(cols),
        "findings": findings,
    }


def plot_convergence(solution, width: int = 64, height: int = 10,
                     file=None) -> None:
    """Render the iterate history as terminal charts — the runtime
    analog of the reference's debugConvergence figures
    (lib/ipmPD_CSsolver.m debugConvergence plots of cost, |grad|, gap,
    mu, and step sizes vs iteration).

    One panel per quantity: log10 scale for the positive convergence
    measures (|grad|, |eq|, gap, mu, addU, direction error), linear for
    cost and alphaPrimal.  Requires ``SolverOptions(profiling=True)``.
    """
    import sys

    file = file or sys.stdout
    if solution.history is None:
        print("(no history: solve with profiling=True)", file=file)
        return
    h = np.asarray(solution.history)
    cols = {name: h[:, i] for i, name in enumerate(HISTORY_COLUMNS)}
    panels = [
        ("cost", cols["J"], "lin"),
        ("|grad|", cols["norminf_grad"], "log"),
        ("|eq|", cols["norminf_eq"], "log"),
        ("gap", cols["gap"], "log"),
        ("mu", cols["mu"], "log"),
        ("alphaPrimal", cols["alphaPrimal"], "lin"),
        ("addEye2HessianU", cols["addU"], "log"),
        ("direction error", cols["directionError"], "log"),
    ]
    n = len(h)
    for title, y, scale in panels:
        y = np.asarray(y, float)
        if scale == "log":
            if not (y > 0).any():
                continue
            y = np.log10(np.maximum(y, 1e-300))
            fmt = lambda v: f"1e{v:+.1f}"
        else:
            fmt = lambda v: f"{v:.3g}"
        lo, hi = float(y.min()), float(y.max())
        if hi - lo < 1e-12:
            hi = lo + 1.0
        # resample iterations onto the plot width
        xi = np.linspace(0, n - 1, min(n, width)).round().astype(int)
        ys = y[xi]
        rows = np.clip(
            ((ys - lo) / (hi - lo) * (height - 1)).round().astype(int),
            0, height - 1,
        )
        grid = [[" "] * len(xi) for _ in range(height)]
        for c, r in enumerate(rows):
            grid[height - 1 - r][c] = "*"
        print(f"\n{title}  [{fmt(lo)} .. {fmt(hi)}]  ({n} iters)",
              file=file)
        for r, line in enumerate(grid):
            edge = fmt(hi) if r == 0 else (fmt(lo) if r == height - 1 else "")
            print(f"{edge:>9s} |{''.join(line)}", file=file)
        print(" " * 10 + "+" + "-" * len(xi), file=file)


def print_iteration_table(solution, file=None) -> None:
    """Render the profiling history like the reference's verboseLevel>=3
    per-iteration table (lib/ipmPD_CSsolver.c:247-276)."""
    import sys

    file = file or sys.stdout
    if solution.history is None:
        print("(no history: solve with profiling=True)", file=file)
        return
    h = np.asarray(solution.history)
    print(
        "Iter      cost    |grad|    |eq|      gap     l(mu)  alphaP  "
        "l(addU)  d.err.",
        file=file,
    )
    for i, row in enumerate(h):
        J, g, eq, gap, mu, aP, addU, derr = row
        print(
            f"{i + 1:4d}:{J:11.3e}{g:9.1e}{eq:9.1e}{gap:9.1e}"
            f"{np.log10(max(mu, 1e-300)):7.1f}{aP:8.1e}"
            f"{np.log10(max(addU, 1e-300)):8.1f}{derr:9.1e}",
            file=file,
        )
