"""Solver status bitmask (copy of ``tenscalc_tpu/ipm/status.py``) —
identical semantics to the reference (lib/ipmPD_CSsolver.c:315-381,
885-920)."""

from __future__ import annotations

import enum


class SolverStatus(enum.IntFlag):
    OK = 0
    PRIMAL_INFEASIBLE = 1      # primal variables violate inequality constraints
    DUAL_NEGATIVE = 2          # negative dual variables
    FACTORIZATION_NAN = 4      # failed to invert hessian (NaN direction)
    MAX_ITER = 8               # maximum iterations reached
    LARGE_GRADIENT = 16        # |grad| > gradTolerance at exit
    BAD_EQUALITY = 32          # |G| > equalTolerance at exit
    LARGE_GAP = 64             # duality gap > desiredDualityGap at exit
    LARGE_MU = 128             # mu > muMin at exit
    ALPHA_NEGLIGIBLE = 256     # alpha <= alphaMin
    ALPHA_SMALL = 512          # alpha <= .1
    ALPHA_MEDIUM = 1024        # alpha <= .5
    LARGE_ADDEYE2HESSIAN = 2048  # addEye2HessianU > tolerance at exit


_DESCRIPTIONS = {
    SolverStatus.PRIMAL_INFEASIBLE: "(primal) variables violate constraints",
    SolverStatus.DUAL_NEGATIVE: "negative value for dual variables",
    SolverStatus.FACTORIZATION_NAN: "failed to invert hessian",
    SolverStatus.MAX_ITER: "maximum # iterations reached",
    SolverStatus.LARGE_GRADIENT: "large gradient",
    SolverStatus.BAD_EQUALITY: "bad equality const.",
    SolverStatus.LARGE_GAP: "large duality gap",
    SolverStatus.LARGE_MU: "large mu",
    SolverStatus.ALPHA_NEGLIGIBLE: "alpha negligible",
    SolverStatus.ALPHA_SMALL: "alpha<.1",
    SolverStatus.ALPHA_MEDIUM: "alpha<.5",
    SolverStatus.LARGE_ADDEYE2HESSIAN: "large addEye2Hessian",
}


def describe_status(status: int) -> str:
    """Human-readable status report (analog of the exit summary printed at
    lib/ipmPD_CSsolver.c:939-981)."""
    status = int(status)
    if status == 0:
        return "clean exit (converged)"
    parts = [
        desc for flag, desc in _DESCRIPTIONS.items() if status & int(flag)
    ]
    return f"status=0x{status:X} (" + ", ".join(parts) + ")"
