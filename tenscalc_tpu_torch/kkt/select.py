"""Structured-KKT backend selection for the game solvers (port of
``tenscalc_tpu/kkt/select.py``).

The KKT pattern is probed at build time, an RCM banded plan computed,
and a factorization chosen.  The equilibrium KKT stacks two Lagrangians'
rows, so it is unsymmetric and routes to the banded LU
(:mod:`tenscalc_tpu_torch.kkt.banded_lu`).  ``kkt_backend='auto'``
resolves the same way on the CPU and on the card (the plain versions of
the kernels run on the CPU); the JAX package picks its pure-XLA
block-tridiagonal LU on the CPU instead, which is ROADMAP item M13.
"""

from __future__ import annotations

import warnings

from .structure import plan_banded, probe_pattern


def compute_banded_plan(assemble_trial, nK):
    """Probe |WW| over random trials -> BandedPlan, or None when probing
    fails (with a warning: a broken assembly must not pass unnoticed)."""
    try:
        pattern = probe_pattern(assemble_trial, nK)
    except Exception as exc:
        warnings.warn(
            "game-solver KKT structure probe failed "
            f"({type(exc).__name__}: {exc})",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
    return plan_banded(pattern)


def _deferred(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


def select_game_backend(opts, nK, plan_fn, symmetric: bool):
    """Return ``(kkt_solver, resolved_name, plan)`` for a game solver.

    ``plan_fn``: lazy () -> BandedPlan | None.  ``kkt_solver`` maps the
    band-mode :class:`~tenscalc_tpu_torch.kkt.band_assemble.BandedOperator`
    to a factorization with ``solve`` and ``inertia``."""
    kb = opts.kkt_backend
    if kb in ("dense", "ldl"):
        raise _deferred(f"kkt_backend={kb!r} for the game solvers", "M13")
    allowed = ("auto", "tridiag", "fleet", "fleet_banded")
    if kb not in allowed:
        raise ValueError(
            f"kkt_backend={kb!r} is not supported for the game solvers; "
            f"use one of {('dense',) + allowed}"
        )
    if symmetric:
        raise _deferred("the symmetric (min-max) game backends", "M12")
    if kb == "fleet":
        raise ValueError(
            "kkt_backend='fleet' (dense LDL fleet kernel) needs a "
            "symmetric KKT; the equilibrium system is unsymmetric — "
            "use 'fleet_banded' (banded LU) or 'dense'"
        )
    if kb == "tridiag":
        raise _deferred("the block-tridiagonal LU (tridiag_lu)", "M13")
    if nK < 64:
        raise _deferred(f"a game KKT with nK={nK} < 64 (dense backend)", "M4/M13")
    plan = plan_fn()
    if plan is None or not plan.worthwhile:
        raise _deferred(
            "a game KKT without a worthwhile band (dense backend)", "M4/M13"
        )
    from .banded_lu import FleetBandedLUFromBand

    n_ref = opts.refine_for("fleet_banded_lu")
    return (lambda op: FleetBandedLUFromBand(op, plan, n_refine=n_ref),
            "fleet_banded_lu", plan)
