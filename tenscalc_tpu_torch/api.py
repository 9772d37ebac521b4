"""Problem-definition API (port of ``tenscalc_tpu/api.py``).

:func:`optimize` takes a symbolic objective, optimization variables,
constraints, parameters and output expressions, and returns an
:class:`OptimizeSolver` whose ``solve`` runs the primal-dual IPM on one
instance and whose ``solve_many`` runs a fleet (split over a device mesh
with ``mesh=``).  The solver runs on the card (``device=None`` means
``"cuda"``) unless the caller asks for the CPU; without CUDA it raises
rather than quietly running on the CPU.

For minimization, ``kkt_backend='auto'`` resolves as the JAX package's
``TENSCALC_AUTO_FLEET=1`` branch on every device when that variable is
'1' or unset: the fleet banded LDL^T (``'fleet_banded'``) when the KKT
has at least 64 rows and a worthwhile band, else the fleet dense LDL^T
(``'fleet'``); the condensed KKT's rows count nU + nG, the large Newton
matrix's nU + nG + nF.  With ``TENSCALC_AUTO_FLEET=0`` it takes the JAX
package's other branch: the block-tridiagonal LDL^T (``'tridiag'``,
:mod:`.kkt.tridiag`) of a worthwhile band, else arrow-plus-band
(``'arrow'``, :mod:`.kkt.arrow`) where a few dense rows hide a band,
else ``'dense'``.  The other values: ``'tridiag'``, ``'cyclic'`` (block
cyclic reduction, :mod:`.kkt.cyclic`) and ``'spike'`` (the banded solve
split over ``kkt_mesh``, :mod:`.kkt.spike`), each ``'dense'`` below 64
KKT rows; ``'pallas'`` the single-instance dense LDL^T, ``'dense'`` the
JAX package's dense backend (:func:`.kkt.dense.kkt_factorize`: a
pivoted LU, or an LDL^T for inertia) and ``'ldl'`` its blocked LDL^T
(``kkt_factorize(force_ldl=True)``).  :func:`minmax` builds a min-max
solver (:mod:`tenscalc_tpu_torch.ipm.minmax`) whose symmetric saddle KKT
goes to the same fleet LDL^T backends, to ``'tridiag'``, or with
``kkt_backend='dense'`` to an unpivoted dense LDL^T; :func:`equilibrium`
builds a two-player Nash solver
(:mod:`tenscalc_tpu_torch.ipm.equilibrium`) whose unsymmetric KKT goes to
the fleet banded LU (``'fleet_banded_lu'``) or the block-tridiagonal LU
(``'tridiag_lu'``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .expr import Constraint, Expr, Variable
from .ipm.options import SolverOptions
from .ipm.solver import IPMFunctions, IPMResult, build_ipm, dense_kkt
from .ipm.status import describe_status
from .pack import Packing


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to solve on the CPU"
        )
    return device


def _prefer_fleet() -> bool:
    """Whether ``kkt_backend='auto'`` takes the fleet kernels: the JAX
    package's switch ``TENSCALC_AUTO_FLEET``, read as it reads it ('1'
    or '0').  Unset, the port takes the fleet kernels on every device
    (the JAX package's TPU branch; on its CPU it would take '0')."""
    import os

    return os.environ.get("TENSCALC_AUTO_FLEET") != "0"


def full_precision_matmul() -> None:
    """float32 products in full precision (no TF32), as the reference
    computes them at Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _split_constraints(constraints):
    """Split into (F >= 0 list, G == 0 list)."""
    Fs, Gs = [], []
    for c in constraints or []:
        if not isinstance(c, Constraint):
            raise TypeError(
                f"constraints must be built with >=, <= or == on Expr; got {c!r}"
            )
        (Fs if c.kind == "ineq" else Gs).append(c.expr)
    return Fs, Gs


def problem_functions(objective: Expr, variables: Sequence[Variable],
                      constraints, parameters: Sequence[Variable],
                      dt: torch.dtype):
    """(IPMFunctions, Packing, nF, nG) of a problem; validates that every
    expression reads only declared parameters and variables."""
    packing = Packing(variables)
    F_exprs, G_exprs = _split_constraints(constraints)
    known = {p.name for p in parameters} | set(packing.names)
    for e in [objective] + F_exprs + G_exprs:
        extra = e.deps - known
        if extra:
            raise ValueError(
                f"expression depends on undeclared symbols {sorted(extra)}; "
                "declare them as parameters or optimization variables"
            )

    def stack(exprs, u, penv):
        env = {**penv, **packing.unpack(u)}
        if not exprs:
            return u.new_zeros(0)
        # a copy: forward-mode AD of a 0-dim expression and a Python
        # number gives a float64 tangent, which a cast in place would keep
        return torch.cat([torch.ravel(e(env)) for e in exprs]).to(dt, copy=True)

    def f_fn(u, penv):
        env = {**penv, **packing.unpack(u)}
        return objective(env).to(dt).reshape(())

    def F_fn(u, penv):
        return stack(F_exprs, u, penv)

    def G_fn(u, penv):
        return stack(G_exprs, u, penv)

    nF = int(sum(e.size for e in F_exprs))
    nG = int(sum(e.size for e in G_exprs))
    return IPMFunctions(f=f_fn, F=F_fn, G=G_fn), packing, nF, nG


@dataclasses.dataclass
class Solution:
    """Result of one solve."""

    status: int
    iters: int
    outputs: Dict[str, Any]
    variables: Dict[str, Any]
    mu: float
    norminf_grad: float
    norminf_eq: float
    gap: float
    objective: float
    lam: Any
    nu: Any
    time: float = 0.0
    # the per-iteration profiling history (iters - 1 rows of
    # ipm.solver.HISTORY_COLUMNS; None without profiling) and the
    # internal scales sensitivity() unscales the duals by
    history: Any = None
    scale_ineq: Any = None
    scale_cost: Any = None

    @property
    def ok(self) -> bool:
        return int(self.status) == 0

    def describe(self) -> str:
        return describe_status(int(self.status))


def _first_or_none(res, field: str):
    """Instance 0 of a result field as numpy, None where the result type
    has no such field."""
    v = getattr(res, field, None)
    return None if v is None else v[0].cpu().numpy()


class SolverBase:
    """Parameter, init and result handling shared by the solvers.  A
    subclass sets ``opts``, ``device``, ``parameters``, ``variables``,
    ``packing`` (over the packed primal vector) and
    ``outputExpressions``."""

    def _param_env(self, parameters: Optional[Mapping[str, Any]]):
        parameters = dict(parameters or {})
        dt = self.opts.torch_dtype
        env = {}
        for p in self.parameters:
            if p.name not in parameters:
                raise ValueError(f"missing parameter {p.name!r}")
            v = torch.as_tensor(np.asarray(parameters[p.name]), dtype=dt,
                                device=self.device)
            if tuple(v.shape) != p.shape:
                raise ValueError(
                    f"parameter {p.name!r}: expected shape {p.shape}, got {tuple(v.shape)}"
                )
            env[p.name] = v
        extra = set(parameters) - set(env)
        if extra:
            raise ValueError(f"unknown parameters {sorted(extra)}")
        return env

    def _pack_init(self, init: Optional[Mapping[str, Any]]) -> torch.Tensor:
        init = dict(init or {})
        dt = self.opts.torch_dtype
        env = {
            v.name: torch.as_tensor(
                np.asarray(init[v.name]) if v.name in init else np.zeros(v.shape),
                dtype=dt, device=self.device,
            )
            for v in self.variables
        }
        return self.packing.pack(env)

    def _make_solution(self, res: IPMResult, penv, elapsed: float) -> Solution:
        iters = int(res.iters[0])
        var_env = self.packing.unpack(res.u[0])
        out_env = {**penv, **var_env, **self._internal_env(res)}
        outputs = {
            name: e(out_env).cpu().numpy() if isinstance(e, Expr) else e
            for name, e in self.outputExpressions.items()
        }
        return Solution(
            status=int(res.status[0]), iters=iters, outputs=outputs,
            variables={k: v.cpu().numpy() for k, v in var_env.items()},
            mu=float(res.mu[0]), norminf_grad=float(res.norminf_grad[0]),
            norminf_eq=float(res.norminf_eq[0]), gap=float(res.gap[0]),
            objective=float(res.f[0]), lam=res.lam[0].cpu().numpy(),
            nu=res.nu[0].cpu().numpy(), time=elapsed,
            scale_ineq=_first_or_none(res, "scale_ineq"),
            scale_cost=_first_or_none(res, "scale_cost"),
            # the last iteration only runs the exit tests: no row
            history=(res.history[0, : max(iters - 1, 0)].cpu().numpy()
                     if getattr(res, "history", None) is not None else None),
        )

    @staticmethod
    def _internal_env(res: IPMResult):
        """Solver internals that outputExpressions may read."""
        return {
            "lambda_": res.lam[0], "nu_": res.nu[0], "mu_": res.mu[0],
            "status_": res.status[0], "iter_": res.iters[0],
        }


class OptimizeSolver(SolverBase):
    """A constrained-minimization solver instance."""

    def __init__(self, objective: Expr,
                 optimizationVariables: Sequence[Variable],
                 constraints: Sequence[Constraint] = (),
                 parameters: Sequence[Variable] = (),
                 outputExpressions: Optional[Mapping[str, Expr]] = None,
                 options: Optional[SolverOptions] = None,
                 device=None, kkt_mesh=None, **option_kwargs):
        self.opts = (
            (options or SolverOptions()).replace(**option_kwargs).resolved("optimize")
        )
        self.kkt_mesh = kkt_mesh
        self.device = resolve_device(device)
        full_precision_matmul()
        dt = self.opts.torch_dtype
        self.variables = list(optimizationVariables)
        self.parameters = list(parameters)
        self.objective = objective
        self.outputExpressions = dict(outputExpressions or {})
        self._fns, self.packing, self.nF, self.nG = problem_functions(
            objective, self.variables, constraints, self.parameters, dt
        )
        self.nU = self.packing.total

        from .ipm.hoist import analyze_hoistable, analyze_scale_free

        shapes = {p.name: p.shape for p in self.parameters}
        self._hoist = analyze_hoistable(
            self._fns, self.nU, self.nF, self.nG, dt, shapes
        )
        self._hoist_scale_free = bool(self._hoist[0]) and analyze_scale_free(
            self._fns, self.nU, self.nF, self.nG, dt, shapes,
            taint_ineq=bool(self.opts.scaleInequalities) and self.nF > 0,
            taint_cost=self.opts.scaleCost > 0,
        )
        self._hoist_param_deps = None
        if self._hoist_scale_free and self._hoist[1]:
            self._hoist_param_deps = self._param_deps(dt)
        self.kkt_backend_resolved = None
        self.kkt_plan = None
        self._plan_structure()
        if self.opts.verboseLevel >= 2:
            self._report_kkt_plan()

    def _report_kkt_plan(self) -> None:
        """The planner's line (JAX ``api.py:292-312``): the sizes, the
        Newton matrix's variant, the backend and the plan's statistics."""
        small = self.opts.smallerNewtonMatrix
        nK = self.nU + self.nG + (0 if small else self.nF)
        msg = (
            f"[kkt plan] nU={self.nU} nG={self.nG} nF={self.nF} nK={nK} "
            f"variant={'condensed' if small else 'large'} "
            f"backend={self.kkt_backend_resolved}"
        )
        plan = self.kkt_plan
        if plan is not None:
            for attr in ("bandwidth", "block", "n_blocks", "n_arrow"):
                v = getattr(plan, attr, None)
                if v is not None:
                    msg += f" {attr}={v}"
        print(msg)

    def _param_deps(self, dt):
        """Parameter-value dependencies of the hoisted H, Fu and Gu."""
        from torch.func import grad, jacfwd

        from .ipm.hoist import param_value_deps

        fns, nF, nG = self._fns, self.nF, self.nG
        penv_d = {p.name: torch.zeros(p.shape, dtype=dt) for p in self.parameters}
        u_d = torch.zeros(self.nU, dtype=dt)

        def Hfun(penv, u, nu, lam):
            def lagr(uu):
                val = fns.f(uu, penv)
                if nF > 0:
                    val = val - lam @ fns.F(uu, penv)
                if nG > 0:
                    val = val + nu @ fns.G(uu, penv)
                return val

            return jacfwd(grad(lagr))(u)

        h_deps = param_value_deps(
            Hfun, penv_d, u_d, torch.zeros(nG, dtype=dt), torch.ones(nF, dtype=dt)
        )
        fu_deps = param_value_deps(
            lambda penv, u: jacfwd(lambda uu: fns.F(uu, penv))(u), penv_d, u_d
        ) if nF > 0 else set()
        gu_deps = param_value_deps(
            lambda penv, u: jacfwd(lambda uu: fns.G(uu, penv))(u), penv_d, u_d
        ) if nG > 0 else set()
        return h_deps, fu_deps, gu_deps

    def _plan_structure(self) -> None:
        """Pick the KKT backend (JAX ``api.py:243-471``): ``'dense'``,
        ``'ldl'``, ``'pallas'`` and ``'fleet'`` as named; else, from 64 KKT
        rows, probe the KKT sparsity pattern on the CPU and plan the RCM
        band.  ``'fleet_banded'`` and the fleet branch of ``'auto'`` take
        the fleet banded LDL^T of a worthwhile band, else the fleet dense
        LDL^T; ``'tridiag'``, ``'cyclic'`` and ``'spike'`` are installed
        on the plan worthwhile or not; the other branch of ``'auto'``
        takes ``'tridiag'`` of a worthwhile band, else ``'arrow'`` of a
        worthwhile arrow plan, else ``'dense'``."""
        from .kkt.structure import plan_banded, probe_pattern

        backend = self.opts.kkt_backend
        if backend == "dense":
            self._install_backend(None, "dense")
            return
        if backend == "ldl":
            from .kkt.dense import kkt_factorize

            opts = self.opts
            self._install_backend(
                lambda WW: kkt_factorize(WW, need_inertia=opts.useInertia,
                                         block=opts.ldl_block, force_ldl=True),
                "ldl",
            )
            return
        if backend == "pallas":
            self._use_pallas()
            return
        if backend == "fleet":
            self._use_fleet_dense()
            return
        fleet = backend == "fleet_banded" or (backend == "auto" and _prefer_fleet())
        nK = self.nU + self.nG + (0 if self.opts.smallerNewtonMatrix else self.nF)
        if nK < 64:  # too small for a structured path to matter
            if fleet:
                self._use_fleet_dense()
            else:
                self._install_backend(None, "dense")
            return
        dt = self.opts.torch_dtype
        assemble_dense = dense_kkt(self._fns, self.nU, self.nF, self.nG, self.opts)

        def assemble(trial: int):
            rng = np.random.default_rng(trial)
            penv = {
                p.name: torch.as_tensor(rng.standard_normal(p.shape), dtype=dt)
                for p in self.parameters
            }
            u = torch.as_tensor(rng.standard_normal(self.nU), dtype=dt)
            lam = torch.as_tensor(rng.uniform(0.5, 1.5, self.nF), dtype=dt)
            nu = torch.as_tensor(rng.standard_normal(self.nG), dtype=dt)
            WW = assemble_dense(
                u, nu, lam, 1e-3, 1e-3, penv,
                torch.ones(self.nF, dtype=dt), torch.ones((), dtype=dt),
            )
            return WW.numpy()

        # a probe failure raises, under every backend
        pattern = probe_pattern(assemble, nK)
        plan = plan_banded(pattern)
        if fleet:
            self._use_fleet_banded(plan)
            return
        if not plan.worthwhile and backend == "auto":
            # no band: look for a band under a few dense rows (global
            # variables coupling every stage)
            from .kkt.arrow import ArrowFactorization, plan_arrow

            aplan = plan_arrow(pattern)
            if aplan is not None and aplan.worthwhile:
                self.kkt_plan = aplan
                self._install_backend(lambda WW: ArrowFactorization(WW, aplan), "arrow")
                return
        if backend == "spike":
            from .kkt.spike import SpikeFactorization

            mesh = self.kkt_mesh
            if mesh is None:
                raise ValueError("kkt_backend='spike' requires kkt_mesh=Mesh(...)")
            axis = "stages" if "stages" in mesh.axis_names else mesh.axis_names[0]
            self.kkt_plan = plan
            self._install_backend(
                lambda WW: SpikeFactorization(WW, plan, mesh, axis=axis), "spike")
            return
        if not plan.worthwhile and backend not in ("tridiag", "cyclic"):
            self._install_backend(None, "dense")
            return
        self.kkt_plan = plan
        if backend == "cyclic":
            from .kkt.cyclic import CyclicFactorization

            self._install_backend(lambda WW: CyclicFactorization(WW, plan), "cyclic")
        else:
            from .kkt.tridiag import tridiag_factorize

            self._install_backend(lambda WW: tridiag_factorize(WW, plan), "tridiag")

    def _use_fleet_banded(self, plan) -> None:
        """The fleet banded LDL^T of a worthwhile band (band modes hand
        over the band they assembled; the problems without inequalities
        and the large Newton matrix their dense KKT, JAX
        ``api.py:419-424``), else the fleet dense LDL^T."""
        from .ipm.solver import BandKKT
        from .kkt.fleet_banded import FleetBandedFromBand, fleet_banded_kkt_factorize

        if not plan.worthwhile:
            self._use_fleet_dense()
            return
        self.kkt_plan = plan
        n_ref = self.opts.refine_for("fleet_banded")

        def kkt(WW):
            if isinstance(WW, BandKKT):
                return FleetBandedFromBand(WW, plan, n_refine=n_ref)
            return fleet_banded_kkt_factorize(WW, plan, n_refine=n_ref)

        self._install_backend(kkt, "fleet_banded", band_plan=plan)

    def _install_backend(self, kkt_solver, name: str, band_plan=None) -> None:
        """Build the solve function around a KKT backend (``None``: the
        dense ``kkt_factorize``); the fleet backends take the CG
        nu-initializer (JAX ``api.py:314-332``)."""
        self._kkt_solver = kkt_solver
        self.kkt_backend_resolved = name
        self._solve_raw = build_ipm(
            self._fns, self.nU, self.nF, self.nG, self.opts,
            kkt_solver=kkt_solver, hoist=self._hoist, band_plan=band_plan,
            hoist_scale_free=self._hoist_scale_free,
            hoist_param_deps=self._hoist_param_deps,
            fleet_init=name in ("fleet", "fleet_banded"),
        )

    def _use_fleet_dense(self) -> None:
        """The fleet dense LDL^T (``kkt/fleet.py``): K4/K5 for a fleet,
        the single-instance K6-K8 for one solve."""
        from .kkt.fleet import fleet_kkt_factorize

        n_ref = self.opts.refine_for("fleet")
        self._install_backend(
            lambda WW: fleet_kkt_factorize(WW, n_refine=n_ref), "fleet"
        )

    def _use_pallas(self) -> None:
        """The single-instance dense LDL^T (``kkt/pallas_ldl.py``) with the
        pivot clamp of JAX ``api.py:257-269``: K6 per factorization, K7
        per solve, one instance per CTA in a fleet."""
        from .kkt.dense_ldl import CLAMP
        from .kkt.pallas_ldl import pallas_kkt_factorize

        self._install_backend(
            lambda WW: pallas_kkt_factorize(WW, clamp=CLAMP), "pallas"
        )

    # -- solving -------------------------------------------------------
    def solve(self, parameters: Optional[Mapping[str, Any]] = None,
              init: Optional[Mapping[str, Any]] = None, mu0: float = 1.0,
              max_iter: Optional[int] = None,
              addEye2Hessian=(1e-9, 1e-9)) -> Solution:
        """One instance: the fleet path at B = 1, every parameter shared."""
        penv = self._param_env(parameters)
        u0 = self._pack_init(init)[None]
        t0 = time.perf_counter()
        res = self._solve_raw(
            u0, penv, frozenset(penv), mu0, max_iter,
            addEye2Hessian[0], addEye2Hessian[1],
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return self._make_solution(res, penv, elapsed)

    def solve_many(self, parameters: Mapping[str, Any],
                   inits: Optional[Mapping[str, Any]] = None,
                   mu0: float = 1.0, max_iter: Optional[int] = None,
                   addEye2Hessian=(1e-9, 1e-9), mesh=None) -> IPMResult:
        """A fleet: every batched parameter/init leaf has a leading batch
        dimension; a parameter in its declared shape is shared.  With
        ``mesh`` (:func:`tenscalc_tpu_torch.parallel.make_mesh`) the fleet
        is split over its devices."""
        from .parallel.batch import solve_batched

        return solve_batched(
            self, parameters, inits=inits, mu0=mu0, max_iter=max_iter,
            addEye2Hessian=addEye2Hessian, mesh=mesh,
        )

    def solve_result(self, parameters: Optional[Mapping[str, Any]] = None,
                     init: Optional[Mapping[str, Any]] = None, mu0: float = 1.0,
                     max_iter: Optional[int] = None, addEye2Hessian=(1e-9, 1e-9),
                     save_iter: int = -1) -> IPMResult:
        """One instance's raw :class:`IPMResult` (JAX ``api.py:553-563``):
        the tensors on the solver's device, one instance's fields without
        the batch dimension, with no synchronization and no copy to the
        host after the solve.  Under ``allowSave`` its ``saved`` holds
        (u, nu, lam, mu, addU, addEq) at iteration ``save_iter``."""
        from .interop import map_fields

        penv = self._param_env(parameters)
        u0 = self._pack_init(init)[None]
        res = self._solve_raw(
            u0, penv, frozenset(penv), mu0, max_iter,
            addEye2Hessian[0], addEye2Hessian[1], save_iter,
        )
        return map_fields(lambda v: v[0], res)

    def capture_ww(self, parameters, init=None, it: Optional[int] = None,
                   mu0: float = 1.0, max_iter: Optional[int] = None,
                   addEye2Hessian=(1e-9, 1e-9)) -> Dict[str, Any]:
        """The KKT matrix at a chosen iterate of an actual solve (JAX
        ``api.py:565-620``; the reference's saveWW__, lib/ipmPD_CS.m:511-515).

        Needs ``allowSave=True``.  With ``it=None`` (and ``profiling=True``)
        the iterate with the largest direction error in the solve's own
        history is taken.  The solve is run again with ``save_iter=it``,
        and the dense Newton matrix of the options' variant is assembled
        at the saved state (:func:`.ipm.solver.dense_kkt`, whatever the
        backend).  Returns ``it``, ``WW`` and the ``state`` as numpy, and
        the report of :func:`tenscalc_tpu_torch.diagnostics.analyze_assembled`."""
        from .diagnostics import analyze_assembled

        if not self.opts.allowSave:
            raise ValueError("capture_ww requires SolverOptions(allowSave=True)")
        if it is None:
            if not self.opts.profiling:
                raise ValueError(
                    "capture_ww(it=None) selects the worst-direction-error "
                    "iterate from the profiling history; set profiling=True "
                    "or pass an explicit iteration"
                )
            res0 = self.solve_result(parameters, init, mu0, max_iter, addEye2Hessian)
            hist = res0.history[: max(int(res0.iters) - 1, 0)].cpu().numpy()
            if hist.size == 0:
                raise ValueError("solve recorded no iterations")
            it = int(np.nanargmax(np.nan_to_num(hist[:, 7], nan=-1.0))) + 1
        res = self.solve_result(parameters, init, mu0, max_iter, addEye2Hessian,
                                save_iter=int(it))
        u, nu, lam, mu, addU, addEq = res.saved
        assemble = dense_kkt(self._fns, self.nU, self.nF, self.nG, self.opts, parts=True)
        a = assemble(u, nu, lam, addU, addEq, self._param_env(parameters),
                     res.scale_ineq, res.scale_cost)
        a = {k: v.detach().cpu().numpy() for k, v in a.items()}
        return {
            "it": int(it),
            "WW": a["WW"],
            "state": {
                "u": u.cpu().numpy(), "nu": nu.cpu().numpy(),
                "lam": lam.cpu().numpy(), "mu": float(mu),
                "addU": float(addU), "addEq": float(addEq),
            },
            "report": analyze_assembled(self, a),
        }

    def sensitivity(self, solution: Solution, parameters: Mapping[str, Any],
                    wrt: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, np.ndarray]]:
        """d(u*)/d(parameter) at a converged solution (JAX
        ``api.py:657-737``): implicit differentiation of the unscaled
        stationarity system r(u, nu, lam; p) = [grad_u L; G; lam F - mu]
        = 0, the duals recovered from the solver's internal scales.  K =
        dr/dz and dr/dp by ``torch.func.jacfwd`` on the solver's device,
        dz/dp = -K^-1 dr/dp by :func:`.kkt.dense.lu_solve_mixed` (a
        pivoted LU, as the JAX package solves it outside any Pallas
        kernel).  Returns {variable: {parameter: array of shape
        variable.shape + parameter.shape}}."""
        from torch.func import grad, jacfwd

        from .kkt.dense import lu_solve_mixed

        dt, dev = self.opts.torch_dtype, self.device
        penv = self._param_env(parameters)
        packing, fns = self.packing, self._fns
        nU, nF, nG = self.nU, self.nF, self.nG

        def as_t(v):
            return torch.as_tensor(np.asarray(v), dtype=dt, device=dev)

        u_star = packing.pack({k: as_t(v) for k, v in solution.variables.items()})
        sc = as_t(solution.scale_cost if solution.scale_cost is not None else 1.0)
        si = as_t(solution.scale_ineq if solution.scale_ineq is not None else np.ones(nF))
        # unscale the duals: lam_u = si lam_s / sc, nu_u = nu_s / sc; the
        # complementarity target becomes mu_s / sc
        lam_u = si * as_t(solution.lam) / sc
        nu_u = as_t(solution.nu) / sc
        mu_u = as_t(solution.mu) / sc
        z_star = torch.cat([u_star, nu_u, lam_u])

        def residual(z, pv):
            u, nu, lam = z[:nU], z[nU: nU + nG], z[nU + nG:]

            def lagr(uu):
                val = fns.f(uu, pv)
                if nG:
                    val = val + nu @ fns.G(uu, pv)
                if nF:
                    val = val - lam @ fns.F(uu, pv)
                return val

            r1 = grad(lagr)(u)
            r2 = fns.G(u, pv) if nG else z.new_zeros(0)
            r3 = lam * fns.F(u, pv) - mu_u if nF else z.new_zeros(0)
            return torch.cat([r1, r2, r3])

        K = jacfwd(residual, argnums=0)(z_star, penv)
        dR = jacfwd(residual, argnums=1)(z_star, penv)
        names = list(wrt) if wrt is not None else [p.name for p in self.parameters]
        out: Dict[str, Dict[str, np.ndarray]] = {v: {} for v in packing.names}
        for pname in names:
            Rp = dR[pname].reshape(z_star.shape[0], -1)
            # one factor of K, the columns of dr/dp as a batch of rhs
            dz = -lu_solve_mixed(K[None], Rp.T.contiguous()).T
            for vname in packing.names:
                vshape = self.variables[packing.names.index(vname)].shape
                out[vname][pname] = (
                    dz[packing.slice_of(vname)].reshape(vshape + penv[pname].shape)
                    .cpu().numpy())
        return out

def minmax(*args, **kwargs):
    """Create a min-max solver on ``device`` (the card when None); see
    :class:`tenscalc_tpu_torch.ipm.minmax.MinMaxSolver`."""
    from .ipm.minmax import MinMaxSolver

    return MinMaxSolver(*args, **kwargs)


def equilibrium(*args, **kwargs):
    """Create a two-player equilibrium solver on ``device`` (the card when
    None); see :class:`tenscalc_tpu_torch.ipm.equilibrium.EquilibriumSolver`."""
    from .ipm.equilibrium import EquilibriumSolver

    return EquilibriumSolver(*args, **kwargs)


def optimize(objective: Expr, optimizationVariables: Sequence[Variable],
             constraints: Sequence[Constraint] = (),
             parameters: Sequence[Variable] = (),
             outputExpressions: Optional[Mapping[str, Expr]] = None,
             options: Optional[SolverOptions] = None, device=None,
             kkt_mesh=None, **option_kwargs) -> OptimizeSolver:
    """Create a constrained-minimization solver on ``device`` (the card
    when None); ``kkt_mesh`` is the mesh of ``kkt_backend='spike'``."""
    return OptimizeSolver(
        objective, optimizationVariables, constraints, parameters,
        outputExpressions, options, device=device, kkt_mesh=kkt_mesh,
        **option_kwargs,
    )


def _as_input(v, device: torch.device) -> torch.Tensor:
    """An input value as a tensor on ``device``, in its own dtype (a numpy
    or Python float is float64, as the JAX package's inputs are with
    x64)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


class ComputeFunction:
    """Evaluation of a set of expressions (JAX ``api.py:786-810``; the
    reference's cmex2compute): declared inputs, named outputs, evaluated
    as plain functions on tensors on ``device`` (the card when None);
    the outputs are tensors on that device."""

    def __init__(self, inputs: Sequence[Variable], outputs: Mapping[str, Expr],
                 device=None):
        self.inputs = list(inputs)
        self.outputs = dict(outputs)
        self.device = resolve_device(device)
        full_precision_matmul()
        self._names = [v.name for v in self.inputs]

    def __call__(self, **values):
        missing = set(self._names) - set(values)
        if missing:
            raise ValueError(f"missing inputs {sorted(missing)}")
        env = {k: _as_input(v, self.device) for k, v in values.items()}
        # .to: an output that reads no input (a constant) is made on the CPU
        return {k: e(env).to(self.device) for k, e in self.outputs.items()}


def compute(inputs: Sequence[Variable], outputs: Mapping[str, Expr],
            device=None) -> ComputeFunction:
    return ComputeFunction(inputs, outputs, device=device)


def _eval_group(group, env, device: torch.device):
    """A get group's value on ``device``: an Expr, or a mapping or
    sequence of groups (an Expr that reads no variable, a constant, is
    made on the CPU and moved)."""
    if isinstance(group, Expr):
        return group(env).to(device)
    if isinstance(group, Mapping):
        return {k: _eval_group(g, env, device) for k, g in group.items()}
    return [_eval_group(g, env, device) for g in group]


def _group_deps(group) -> frozenset:
    if isinstance(group, Expr):
        return frozenset(group.deps)
    groups = group.values() if isinstance(group, Mapping) else group
    return frozenset().union(*(_group_deps(g) for g in groups))


class ComputeObject:
    """A stateful compute object (JAX ``api.py:813-944``; the reference's
    csparse declareSet / declareGet / declareCopy): inputs and state
    variables live as tensors on ``device`` (the card when None); ``get``
    evaluates a named output group (an Expr, or a dict or list of them)
    and ``copy`` runs a named update, atomically: every right-hand side
    is evaluated before any state variable is assigned.  Each get or
    copy reads only the variables its expressions depend on, so it needs
    only those set.  ``state`` maps a Variable to its initial value;
    ``updates`` maps a copy's name to {state Variable: Expr}, and a
    target that is not a state variable is refused."""

    def __init__(self, inputs: Sequence[Variable], outputs: Mapping[str, Any],
                 state: Optional[Mapping[Variable, Any]] = None,
                 updates: Optional[Mapping[str, Mapping[Variable, Expr]]] = None,
                 device=None):
        self.device = resolve_device(device)
        full_precision_matmul()
        self.inputs = list(inputs)
        self.state_vars = list((state or {}).keys())
        self._names = [v.name for v in self.inputs]
        state_names = {v.name for v in self.state_vars}
        self.outputs = dict(outputs)
        self.updates = {name: {v.name: e for v, e in upd.items()}
                        for name, upd in (updates or {}).items()}
        for name, upd in self.updates.items():
            bad = set(upd) - state_names
            if bad:
                raise ValueError(f"copy {name!r} targets non-state variables {sorted(bad)}")
        self._values: Dict[str, torch.Tensor] = {}
        for v, init in (state or {}).items():
            t = _as_input(init, self.device)
            if tuple(t.shape) != v.shape:
                t = torch.broadcast_to(t, v.shape)
            self._values[v.name] = t
        self._get_deps = {name: _group_deps(g) for name, g in self.outputs.items()}
        self._copy_deps = {
            name: frozenset().union(*(e.deps for e in upd.values())) if upd else frozenset()
            for name, upd in self.updates.items()
        }

    def set(self, name: str, value) -> None:
        """Load an input or state variable (declareSet)."""
        if name not in self._names and name not in {v.name for v in self.state_vars}:
            raise ValueError(f"unknown variable {name!r}")
        self._values[name] = _as_input(value, self.device)

    def _env(self, needed: frozenset):
        missing = needed - set(self._values)
        if missing:
            raise ValueError(f"inputs not set: {sorted(missing)}")
        return {k: self._values[k] for k in needed}

    def get(self, name: str):
        """Evaluate a named output group at the current values."""
        return _eval_group(self.outputs[name], self._env(self._get_deps[name]), self.device)

    def copy(self, name: str) -> None:
        """Run a named atomic state update (declareCopy)."""
        env = self._env(self._copy_deps[name])
        new = {k: e(env).to(self.device) for k, e in self.updates[name].items()}
        self._values.update(new)

    def value(self, var) -> torch.Tensor:
        """The current value of an input or state variable."""
        return self._values[var.name if isinstance(var, Variable) else var]


def compute_object(inputs: Sequence[Variable], outputs: Mapping[str, Any],
                   state: Optional[Mapping[Variable, Any]] = None,
                   updates: Optional[Mapping[str, Mapping[Variable, Expr]]] = None,
                   device=None) -> ComputeObject:
    """Create a stateful compute object (csparse declareSet/Get/Copy)."""
    return ComputeObject(inputs, outputs, state=state, updates=updates, device=device)
