"""Structured-KKT backend selection for the game solvers (port of
``tenscalc_tpu/kkt/select.py``).

The KKT pattern is probed at build time, an RCM banded plan computed,
and a factorization chosen.  The min-max saddle KKT is symmetric: a
worthwhile band goes to the fleet banded LDL^T
(:mod:`tenscalc_tpu_torch.kkt.fleet_banded`), a small or unbanded one to
the fleet dense LDL^T (:mod:`tenscalc_tpu_torch.kkt.fleet`),
``'tridiag'`` to the block-tridiagonal LDL^T
(:mod:`tenscalc_tpu_torch.kkt.tridiag`), and ``'dense'``/``'ldl'`` to the
solver's own unpivoted LDL^T.  The equilibrium KKT stacks two
Lagrangians' rows, so it is unsymmetric and routes to the banded LU
(:mod:`tenscalc_tpu_torch.kkt.banded_lu`): the fleet banded LU of a
worthwhile band, the block-tridiagonal LU for ``'tridiag'``, and the
solver's dense pivoted LU below nK = 64, without a worthwhile band or
for ``'dense'``/``'ldl'``.  ``kkt_backend='auto'`` takes the fleet
backends on the CPU and on the card alike (the plain versions of the
kernels run on the CPU) unless ``TENSCALC_AUTO_FLEET=0``, which takes
the JAX package's other branch: ``'tridiag'`` (symmetric) or
``'tridiag_lu'`` (unsymmetric) of a worthwhile band, else ``'dense'``.
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


def select_game_backend(opts, nK, plan_fn, symmetric: bool):
    """Return ``(kkt_solver, resolved_name, plan)`` for a game solver.

    ``plan_fn``: lazy () -> BandedPlan | None.  ``kkt_solver`` is None for
    the solver's own dense factorization (the min-max solver's LDL^T, the
    equilibrium solver's pivoted LU); else it maps the KKT of a direction
    to a factorization with ``solve`` and ``inertia``: the band-mode
    :class:`~tenscalc_tpu_torch.kkt.band_assemble.BandedOperator` or the
    dense (B, nK, nK) matrix."""
    from ..api import _prefer_fleet

    kb = opts.kkt_backend
    if kb in ("dense", "ldl"):
        return None, "dense", None
    allowed = ("auto", "tridiag", "fleet", "fleet_banded")
    if kb not in allowed:
        raise ValueError(
            f"kkt_backend={kb!r} is not supported for the game solvers; "
            f"use one of {('dense',) + allowed}"
        )
    fleet = kb in ("fleet", "fleet_banded") or (kb == "auto" and _prefer_fleet())
    if kb == "fleet" and not symmetric:
        raise ValueError(
            "kkt_backend='fleet' (dense LDL fleet kernel) needs a "
            "symmetric KKT; the equilibrium system is unsymmetric — "
            "use 'fleet_banded' (banded LU) or 'dense'"
        )
    if kb == "fleet" or nK < 64:  # too small for a structured path to matter
        if fleet and symmetric:
            return _fleet_dense(opts), "fleet", None
        return None, "dense", None
    plan = plan_fn()
    if plan is None or not plan.worthwhile:
        if kb == "tridiag":
            raise ValueError(
                "kkt_backend='tridiag' requested but the probed KKT "
                "pattern has no worthwhile band structure"
            )
        if fleet and symmetric:
            return _fleet_dense(opts), "fleet", None
        return None, "dense", None
    if not fleet:
        # the block-tridiagonal factorizations (explicit 'tridiag', or
        # 'auto' under TENSCALC_AUTO_FLEET=0)
        if symmetric:
            from .tridiag import tridiag_factorize

            return (lambda WW: tridiag_factorize(WW, plan), "tridiag", plan)
        from .banded_lu import tridiag_lu_factorize

        return (lambda WW: tridiag_lu_factorize(WW, plan), "tridiag_lu", plan)
    if symmetric:
        return _fleet_banded_sym(opts, plan), "fleet_banded", plan
    from .banded_lu import FleetBandedLUFactorization, FleetBandedLUFromBand
    from .band_assemble import BandedOperator

    n_ref = opts.refine_for("fleet_banded_lu")

    def kkt_lu(op):
        # band mode hands over its band, the dense branch its KKT
        if isinstance(op, BandedOperator):
            return FleetBandedLUFromBand(op, plan, n_refine=n_ref)
        return FleetBandedLUFactorization(op, plan, n_refine=n_ref)

    return kkt_lu, "fleet_banded_lu", plan


def _fleet_banded_sym(opts, plan):
    """The fleet banded LDL^T of the saddle KKT: on the directly
    assembled band in band mode, on the dense saddle KKT outside it."""
    from .band_assemble import BandedOperator
    from .fleet_banded import FleetBandedFromBand, fleet_banded_kkt_factorize

    n_ref = opts.refine_for("fleet_banded")

    def kkt_sym(op):
        if isinstance(op, BandedOperator):
            return FleetBandedFromBand(op, plan, n_refine=n_ref)
        return fleet_banded_kkt_factorize(op, plan, n_refine=n_ref)

    return kkt_sym


def _fleet_dense(opts):
    """The fleet dense LDL^T (K4/K5, or K8/K7 at B = 1) on a dense KKT."""
    from .fleet import fleet_kkt_factorize

    n_ref = opts.refine_for("fleet")
    return lambda WW: fleet_kkt_factorize(WW, n_refine=n_ref)
