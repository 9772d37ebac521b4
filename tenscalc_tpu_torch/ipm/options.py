"""Solver option catalog (copy of ``tenscalc_tpu/ipm/options.py``; the
port keeps its own so that it never imports the JAX package).

The static/dynamic split mirrors the reference's compile-time ``#define``
vs runtime-argument distinction: everything in :class:`SolverOptions` is
static (jit-specialized, like the defines emitted at
lib/cmex2optimizeCS.m:303-331 from lib/private/parameters4all.m /
parameters4optimize.m), while ``mu0``, ``maxIter`` and the initial
``addEye2Hessian`` values stay runtime inputs of ``solve()`` exactly as in
lib/ipmPD_CSsolver.c:132-141.

Defaults replicate the reference's defaults (lib/private/parameters4all.m:
gradTolerance=1e-4, equalTolerance=1e-4, desiredDualityGap=1e-5,
maxIter=200, muFactorAggressive=.2, muFactorConservative=.95,
skipAffine=true, delta=3, alphaMin=1e-7, alphaMax=1, coupledAlphas=true;
parameters4optimize.m: addEye2Hessian=true, adjustAddEye2Hessian=true,
useInertia=false, addEye2HessianUtolerance=1e-6, smallerNewtonMatrix=false).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    # -- exit tolerances (parameters4all.m:45-62) ----------------------
    gradTolerance: float = 1e-4
    equalTolerance: float = 1e-4
    desiredDualityGap: float = 1e-5
    maxIter: int = 200

    # -- scaling (parameters4all.m:96-106) -----------------------------
    scaleInequalities: bool = True
    scaleCost: float = 0.0
    scaleEqualities: bool = False  # accepted but unused, as in reference

    # -- mu schedule (parameters4all.m:131-199) ------------------------
    muFactorAggressive: float = 0.2
    muFactorConservative: float = 0.95
    # skipAffine=None resolves per problem class (resolved()): False —
    # Mehrotra affine/centering steps ON — for single minimization with
    # the standard variant (the affine direction is one extra rhs
    # through an already-computed factorization, measured ~free on TPU,
    # and cuts IPM iterations ~30% on the reference benchmarks: sls
    # 18 -> 12); True (the reference's parameters4all.m default, and a
    # hard requirement of timesLambda / minmax) everywhere else.
    skipAffine: Optional[bool] = None
    delta: int = 3  # sigma = rho^delta, delta in {2,3}
    alphaMin: float = 1e-7
    alphaMax: float = 1.0
    coupledAlphas: bool = True

    # -- Newton matrix / factorization (parameters4optimize.m) ---------
    # smallerNewtonMatrix=None resolves per variant: the condensed
    # (smaller) system for 'standard'/'auto', the large matrix for
    # 'timesLambda' (which requires it, ipmPD_CStimesLambda.m:34-48)
    smallerNewtonMatrix: Optional[bool] = None
    useLDL: bool = True
    addEye2Hessian: bool = True
    adjustAddEye2Hessian: bool = True
    useInertia: bool = False
    addEye2HessianUtolerance: float = 1e-6
    # variant: 'auto' (default — resolves to the condensed 'standard'
    # formulation, the fastest path on TPU: smaller KKT system that the
    # structure planner can map onto the banded fleet kernels),
    # 'timesLambda' (the reference generators' own pick, switch 3 at
    # lib/cmex2optimizeCS.m:83-93 — multiplicative lambda updates), or
    # 'standard' (ipmPD_CS.m large/small Newton matrix).  The reference
    # also picks the variant for the user; this framework picks the one
    # that dominates on the target hardware.
    variant: str = "auto"

    # -- regularization adaptation constants (ipmPD_CSsolver.c:145-148) -
    addEye2HessianMIN: float = 1e-20
    addEye2HessianMAX: float = 1e2
    maxDirectionError: float = 1e-6

    # -- numerics ------------------------------------------------------
    dtype: str = "float64"  # IPM conditioning ~1/mu needs f64 on TPU
    ldl_block: int = 64
    # iterative-refinement sweeps after the f32 factorization solve
    # (mixed-precision contract, kkt/dense.py); more sweeps cost one
    # matvec + one substitution pair each but cut direction error —
    # worth it when stragglers trip the addEye2Hessian adaptation.
    # None resolves per backend (see refine_for): 1 on the Jacobi-
    # equilibrated banded fleet kernel (ablation: identical convergence,
    # -3.2 ms/iter at B=1024), 2 elsewhere.
    kkt_refine: Optional[int] = None
    # KKT backend: 'auto' (default — probe the KKT sparsity at build
    # time and pick the best structured kernel for the hardware: the
    # batch-in-lanes banded/dense Pallas fleet kernels on TPU, the pure-
    # XLA block-tridiagonal elimination on CPU, arrow when band fails,
    # dense otherwise), 'dense', 'ldl', 'tridiag', 'cyclic', 'pallas',
    # 'fleet', 'fleet_banded', or 'spike' (tridiag partitioned across a
    # device mesh — pass kkt_mesh to optimize())
    kkt_backend: str = "auto"
    # number of line-search trial alphas evaluated in one batched sweep
    # (replaces the reference's sequential backtracking get/set loop,
    # lib/ipmPD_CSsolver.c:690-756)
    linesearch_points: int = 32
    # when True AND dF/du is iteration-invariant (affine F, certified by
    # the build-time hoist analysis), the line search evaluates
    # min F(u + a dU) = min(F + a Fu dU) as one broadcast instead of
    # linesearch_points constraint evaluations.  Mathematically exact
    # whenever the certificate holds (the only difference is rounding
    # order), so it is ON by default; set False to force the reference's
    # exact-F re-evaluation (lib/ipmPD_CSsolver.c:690-756).
    linesearch_affine_F: bool = True

    # -- diagnostics ---------------------------------------------------
    verboseLevel: int = 0
    profiling: bool = False
    # allowSave (reference: lib/private/parameters4all.m allowSave +
    # saveIter runtime arg, lib/ipmPD_CS.m:511-515 saveWW__): when True
    # the solve carries a snapshot of (u, nu, lam, mu, addU, addEq)
    # captured at the runtime-selected iteration, from which the KKT
    # matrix at that iterate can be rebuilt post-mortem
    # (OptimizeSolver.capture_ww)
    allowSave: bool = False

    def __post_init__(self):
        if self.delta not in (2, 3):
            raise ValueError("delta must be 2 or 3 (parameters4all.m:171)")
        if self.variant not in ("auto", "timesLambda", "standard"):
            raise ValueError(
                "variant must be 'auto', 'timesLambda' or 'standard'"
            )
        # resolve 'auto' variant (the reference generators likewise pick
        # the variant for the user, lib/cmex2optimizeCS.m:83-93);
        # smallerNewtonMatrix=None stays unresolved here — it is decided
        # per problem class by resolved(): condensed for optimize (the
        # TPU fast path), large matrix for the game solvers (the
        # reference's own equilibrium default, and the more robust
        # branch on rank-deficient latent games)
        if self.variant == "auto":
            object.__setattr__(self, "variant", "standard")
        if self.variant == "timesLambda" and self.smallerNewtonMatrix is None:
            object.__setattr__(self, "smallerNewtonMatrix", False)
        if self.variant == "timesLambda" and self.skipAffine is None:
            object.__setattr__(self, "skipAffine", True)
        if self.variant == "timesLambda":
            # same restrictions the reference enforces
            # (ipmPD_CStimesLambda.m:34-48)
            if self.smallerNewtonMatrix:
                raise ValueError(
                    "variant='timesLambda' requires smallerNewtonMatrix=False"
                )
            if not self.skipAffine:
                raise ValueError("variant='timesLambda' requires skipAffine=True")
            if not self.useLDL:
                raise ValueError("variant='timesLambda' requires useLDL=True")
        if self.kkt_backend not in (
            "dense", "ldl", "tridiag", "cyclic", "auto", "spike", "pallas",
            "fleet", "fleet_banded",
        ):
            raise ValueError(
                "kkt_backend must be dense|ldl|tridiag|cyclic|auto|spike|"
                "pallas|fleet|fleet_banded"
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    def resolved(self, problem_class: str = "optimize") -> "SolverOptions":
        """Resolve per-problem-class defaults: smallerNewtonMatrix=None
        becomes the condensed system for single minimization with the
        standard variant (the large matrix for minmax/equilibrium games);
        skipAffine=None becomes False (Mehrotra on) for the same
        optimize/standard combination and True (the reference default,
        required by minmax) elsewhere."""
        kw = {}
        std_opt = self.variant == "standard" and problem_class == "optimize"
        if self.smallerNewtonMatrix is None:
            kw["smallerNewtonMatrix"] = std_opt
        if self.skipAffine is None:
            kw["skipAffine"] = not std_opt
        return self.replace(**kw) if kw else self

    def refine_for(self, backend: str) -> int:
        """Iterative-refinement sweep count for a (resolved) backend.

        kkt_refine=None resolves to 1 on the Jacobi-equilibrated banded
        fleet kernel and 2 elsewhere (mixed-precision contract of
        kkt/dense.py)."""
        if self.kkt_refine is not None:
            return self.kkt_refine
        # the symmetric Jacobi-equilibrated LDL paths (banded fleet,
        # dense fleet — both clamp pivots and scale S W S first) need
        # only one sweep (round-2 ablation: identical convergence, one
        # kernel pass saved per solve); the unsymmetric banded LU and
        # the unequilibrated dense paths keep two
        return 1 if backend in ("fleet_banded", "fleet") else 2

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)
