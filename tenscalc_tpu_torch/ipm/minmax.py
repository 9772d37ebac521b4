"""Primal-dual IPM for min-max (Stackelberg / robust) problems, over an
explicit batch dimension (port of ``tenscalc_tpu/ipm/minmax.py``):

    min_u max_d f(u, d)
    s.t.  Fu(u) >= 0, Gu(u) == 0          (minimizer constraints)
          Fd(u,d) >= 0, Gd(u,d) == 0      (maximizer constraints)

The saddle Lagrangian is Lf = f + nuU'Gu + nuD'Gd - lambdaU'Fu +
lambdaD'Fd (lib/ipmPDminmax_CS.m:148-160).  Each direction solves the
symmetric saddle KKT [[H + addU on u, -addD on d, Gz', Fz_s'], [Gz,
-addEq I, 0], [Fz_s, 0, diag(d3)]]; three regularizations adapt, addU
while the saddle KKT lacks positive eigenvalues, addD while the
maximizer's sub-system HessD lacks negative ones, addEq while the
direction error exceeds its gate (lib/ipmPDminmax_CSsolver.m:254-305).

As in ``ipm/equilibrium.py``, the JAX package's ``vmap`` of a
``lax.while_loop`` becomes Python loops over a leading batch dimension
B with per-instance masks: every instance computes each adaptation trip
and keeps its result only while its own loop condition holds, so an
instance carries exactly the values it would carry alone.  A single
solve is B = 1 through the same code.

Two assemblies share the iteration loop:

* band mode ('hoisted'): every block certified iteration-invariant, the
  permuted band assembled as ``const_band * g[row] * g[col]`` plus the
  global diagonal, factored by the fleet banded LDL^T (K1, K2), with
  the HessD inertia from its own banded plan (K3);
* the dense branch: the (B, nK, nK) saddle matrix for the solver's
  unpivoted LDL^T (``kkt_backend='dense'``), the fleet dense LDL^T
  (``'fleet'``, or nK < 64), the block-tridiagonal LDL^T
  (``'tridiag'``) or, on a worthwhile band outside band mode, the fleet
  banded LDL^T of the dense matrix (K1, K2); the HessD inertia from the
  dense LDL^T.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ..api import SolverBase, full_precision_matmul, resolve_device
from ..expr import Expr, Variable
from ..kkt.band_assemble import BandedOperator, extract_band_lower, shifted_cols
from ..kkt.dense import KKTFactorization, hdot, hdotT, ldl_factor, ldl_inertia
from ..pack import Packing
from .options import SolverOptions
from .solver import STEPBACK, IPMResult, _clp, _dot, _norminf, _select, line_search_combined

# reference constants (ipmPDminmax_CSsolver.m:37-42); the direction-error
# gate is 1e-7 in float64 and, relative to the backward-error scale,
# 1e-6 in float32
ADD_MAX = 1e2
ADD_MIN = 1e-20
MAX_DIRECTION_ERROR = 1e-7
MAX_DIRECTION_ERROR_F32 = 1e-6
MAX_ADAPT_STEPS = 30


class MinMaxState(NamedTuple):
    """Solver state; every field has the batch as its leading dimension."""

    z: torch.Tensor       # packed [u; d]
    nu: torch.Tensor      # [nuU; nuD]
    lam: torch.Tensor     # [lambdaU; lambdaD]
    mu: torch.Tensor
    addU: torch.Tensor    # addEye2HessianU (+ on the u block)
    addU_next: torch.Tensor
    addD: torch.Tensor    # addEye2HessianD (- on the d block)
    addD_next: torch.Tensor
    addEq: torch.Tensor   # addEye2HessianEq (- on the equality block)
    addEq_next: torch.Tensor
    alphaPrimal: torch.Tensor
    alphaDualIneq: torch.Tensor
    alphaDualEq: torch.Tensor
    status: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor


class MMDirection(NamedTuple):
    dx: torch.Tensor      # [dZ; dNu; dLambda]
    derr: torch.Tensor    # ||WW dx - b||_inf
    mpU: torch.Tensor     # positive pivots of the saddle KKT
    mnD: torch.Tensor     # negative pivots of HessD
    FzdZ: torch.Tensor    # [Fuz_s; Fdz_s] dZ
    bscale: torch.Tensor  # scale the f32 direction-error gate is relative to


class _MinMaxFns(NamedTuple):
    """Problem callables of one instance: (z, penv) -> tensor."""

    f: Callable
    Fu: Callable
    Fd: Callable
    Gu: Callable
    Gd: Callable


def _sizes(dims):
    nUu, nD, nFu, nFd, nGu, nGd = dims
    nZ, nF, nG = nUu + nD, nFu + nFd, nGu + nGd
    return nZ, nF, nG, nZ + nG + nF


def _unit_scales(dims, dt, device=None):
    return (torch.ones(dims[2], dtype=dt, device=device),
            torch.ones(dims[3], dtype=dt, device=device),
            torch.ones((), dtype=dt, device=device))


def scaled_fns(fns: _MinMaxFns, dims, penv, sFu, sFd, sc):
    """Single-instance (f, Fu, Fd, Fall, Gall, lagrangian) at scales
    ``sFu``, ``sFd`` (inequalities) and ``sc`` (cost)."""
    nUu, nD, nFu, nFd, nGu, nGd = dims
    nG = nGu + nGd

    def f(z):
        return sc * fns.f(z, penv)

    def Fu(z):
        return sFu * fns.Fu(z, penv) if nFu else z.new_zeros(0)

    def Fd(z):
        return sFd * fns.Fd(z, penv) if nFd else z.new_zeros(0)

    def Gall(z):
        return torch.cat([fns.Gu(z, penv) if nGu else z.new_zeros(0),
                          fns.Gd(z, penv) if nGd else z.new_zeros(0)])

    def Fall(z):
        return torch.cat([Fu(z), Fd(z)])

    def lagrangian(z, nu, lam):
        val = f(z)
        if nG:
            val = val + nu @ Gall(z)
        if nFu:
            val = val - lam[:nFu] @ Fu(z)
        if nFd:
            val = val + lam[nFu:] @ Fd(z)
        return val

    return f, Fu, Fd, Fall, Gall, lagrangian


def _sym(H: torch.Tensor) -> torch.Tensor:
    return 0.5 * (H + H.transpose(-1, -2))


def minmax_certificates(fns: _MinMaxFns, dims, opts: SolverOptions, param_shapes,
                        want_band: bool) -> dict:
    """Build-time certificates of iteration-invariant derivatives
    (minmax.py:154-318 of the JAX package), through the structural taint
    analysis of :mod:`tenscalc_tpu_torch.ipm.hoist`.

    ``hoist_H``: the saddle Hessian is independent of (z, nu, lam);
    ``hoist_H_sf``: also of the scales that vary at run time;
    ``hoist_Gz``/``hoist_Fz``: the constraint Jacobians are independent
    of z; ``deps_*``: the parameters whose values each hoisted block
    depends on (None when not certified; ``deps_Fz`` only in band mode).
    ``band_ok``: every block allows direct banded assembly.  Each block is
    traced once with the iterate and every parameter as arguments."""
    from .hoist import TaintGraph, output_independent_of

    nZ, nF, nG, _ = _sizes(dims)
    dt = opts.torch_dtype
    keys = sorted(param_shapes)
    pvals = [torch.zeros(param_shapes[k], dtype=dt) for k in keys]
    units = _unit_scales(dims, dt)
    z = torch.zeros(nZ, dtype=dt)
    nu = torch.zeros(nG, dtype=dt)
    lam = torch.ones(nF, dtype=dt)
    cert = dict(hoist_H=False, hoist_H_sf=False, hoist_Gz=False, hoist_Fz=False,
                deps_H=None, deps_Gz=None, deps_Fz=None, band_ok=False)

    def unit_fns(pv):
        return scaled_fns(fns, dims, dict(zip(keys, pv)), *units)

    def deps(graph, n_iter):
        return {k for i, k in enumerate(keys) if any(graph.tainted_outputs([n_iter + i]))}

    try:
        gH = TaintGraph(
            lambda z_, nu_, lam_, *pv: jacfwd(grad(unit_fns(pv)[5], argnums=0),
                                              argnums=0)(z_, nu_, lam_),
            z, nu, lam, *pvals,
        )
        cert["hoist_H"] = not any(gH.tainted_outputs([0, 1, 2]))
    except Exception:  # pragma: no cover - non-differentiable corner
        cert["hoist_H"] = False
    if cert["hoist_H"]:
        # taint only the scales that vary at run time: with scaleCost 0
        # the cost scale is statically one
        t_ineq = bool(opts.scaleInequalities) and nF > 0
        t_cost = opts.scaleCost > 0
        if not (t_ineq or t_cost):
            cert["hoist_H_sf"] = True
        else:
            penv_d = dict(zip(keys, pvals))

            def H_of(z_, nu_, lam_, *scales):
                sfu, sfd, sc = units
                if t_ineq:
                    sfu, sfd = scales[0], scales[1]
                if t_cost:
                    sc = scales[-1]
                lg = scaled_fns(fns, dims, penv_d, sfu, sfd, sc)[5]
                return jacfwd(grad(lg, argnums=0), argnums=0)(z_, nu_, lam_)

            scales = (list(units[:2]) if t_ineq else []) + ([units[2]] if t_cost else [])
            try:
                cert["hoist_H_sf"] = output_independent_of(
                    H_of, 3 + len(scales), z, nu, lam, *scales
                )
            except Exception:  # pragma: no cover
                cert["hoist_H_sf"] = False
        if cert["hoist_H_sf"]:
            cert["deps_H"] = deps(gH, 3)
    if nG:
        try:
            gG = TaintGraph(lambda z_, *pv: jacfwd(unit_fns(pv)[4])(z_), z, *pvals)
            cert["hoist_Gz"] = not any(gG.tainted_outputs([0]))
        except Exception:  # pragma: no cover
            cert["hoist_Gz"] = False
        if cert["hoist_Gz"]:
            cert["deps_Gz"] = deps(gG, 1)
    if nF:
        try:
            gF = TaintGraph(lambda z_, *pv: jacfwd(unit_fns(pv)[3])(z_), z, *pvals)
            cert["hoist_Fz"] = not any(gF.tainted_outputs([0]))
        except Exception:  # pragma: no cover
            cert["hoist_Fz"] = False
    # direct banded assembly: every block hoisted, the Hessian also
    # scale-free (it enters the constant band verbatim); the scales of
    # Fz are exact row/column scalings
    cert["band_ok"] = bool(
        nF > 0 and cert["hoist_H"] and cert["hoist_H_sf"] and cert["hoist_Fz"]
        and (nG == 0 or cert["hoist_Gz"])
    )
    if want_band and cert["band_ok"]:
        cert["deps_Fz"] = deps(gF, 1)
    return cert


def _hessd(dims, H, Gz, Fdz, Fdv, lamD, addD, addEq):
    """Single-instance maximizer sub-system (ipmPDminmax_CS.m:246-259):
    [[Hdd - addD I, Gd_d', Fd_d'], [Gd_d, -addEq I, 0], [Fd_d, 0,
    diag(Fd/lamD)]]."""
    nUu, nD, nFu, nFd, nGu, nGd = dims
    Hdd = H[nUu:, nUu:] - addD * torch.eye(nD, dtype=H.dtype, device=H.device)
    Gdz_d = Gz[nGu:, nUu:]
    Fdz_d = Fdz[:, nUu:]
    z_gf = H.new_zeros(nGd, nFd)
    return torch.cat([
        torch.cat([Hdd, Gdz_d.T, Fdz_d.T], dim=1),
        torch.cat([Gdz_d, -addEq * torch.eye(nGd, dtype=H.dtype, device=H.device), z_gf],
                  dim=1),
        torch.cat([Fdz_d, z_gf.T, torch.diag(Fdv / lamD)], dim=1),
    ], dim=0)


def dense_minmax_kkt(fns: _MinMaxFns, dims):
    """Single-instance dense assembly of the saddle KKT and of HessD (the
    branch the build-time structure probes read, and each instance of the
    dense branch): ``assemble_ww(z, nu, lam, addU, addD, addEq, penv, sFu,
    sFd, sc, pre)`` -> (WW, Fuz, Fdz) and ``assemble_hessd(z, nu,
    lam, addD, addEq, penv, sFu, sFd, sc, pre)`` -> HessD.  ``pre`` holds
    hoisted blocks ('H', 'Gz', 'Fuz', 'Fdz', 'Fz_all_u'); the others are
    evaluated at z."""
    nUu, nD, nFu, nFd, nGu, nGd = dims
    nZ, nF, nG, _ = _sizes(dims)

    def derivs(z, nu, lam, penv, sFu, sFd, sc, pre):
        _, Fu, Fd, _, Gall, lagr = scaled_fns(fns, dims, penv, sFu, sFd, sc)
        H = pre.get("H")
        if H is None:
            H = _sym(jacfwd(grad(lagr, argnums=0), argnums=0)(z, nu, lam))
        Gz = pre.get("Gz")
        if Gz is None:
            Gz = jacfwd(Gall)(z) if nG else z.new_zeros(0, nZ)
        return H, Gz, Fu, Fd

    def assemble_ww(z, nu, lam, addU, addD, addEq, penv, sFu, sFd, sc, pre):
        H, Gz, Fu, Fd = derivs(z, nu, lam, penv, sFu, sFd, sc, pre)
        dt = z.dtype
        diagU = torch.cat([torch.ones(nUu, dtype=dt, device=z.device),
                           torch.zeros(nD, dtype=dt, device=z.device)])
        # saddle regularization: +addU on u, -addD on d (ipmPDminmax_CS.m:214-216)
        WWUD = H + torch.diag(addU * diagU - addD * (1.0 - diagU))
        Fuz, Fdz = pre.get("Fuz"), pre.get("Fdz")
        if Fuz is None or Fdz is None:
            Fuz = jacfwd(Fu)(z) if nFu else z.new_zeros(0, nZ)
            Fdz = jacfwd(Fd)(z) if nFd else z.new_zeros(0, nZ)
        Fz_signed = torch.cat([-Fuz, Fdz], dim=0)
        d3 = torch.cat([-Fu(z) / lam[:nFu], Fd(z) / lam[nFu:]])
        WW = torch.cat([
            torch.cat([WWUD, Gz.T, Fz_signed.T], dim=1),
            torch.cat([Gz, -addEq * torch.eye(nG, dtype=dt, device=z.device),
                       z.new_zeros(nG, nF)], dim=1),
            torch.cat([Fz_signed, z.new_zeros(nF, nG), torch.diag(d3)], dim=1),
        ], dim=0)
        return WW, Fuz, Fdz

    def assemble_hessd(z, nu, lam, addD, addEq, penv, sFu, sFd, sc, pre):
        H, Gz, _, Fd = derivs(z, nu, lam, penv, sFu, sFd, sc, pre)
        Fdz = pre.get("Fdz")
        if Fdz is None:
            if "Fz_all_u" in pre:
                Fdz = sFd[:, None] * pre["Fz_all_u"][nFu:]
            else:
                Fdz = jacfwd(Fd)(z) if nFd else z.new_zeros(0, nZ)
        return _hessd(dims, H, Gz, Fdz, Fd(z), lam[nFu:], addD, addEq)

    return assemble_ww, assemble_hessd


def build_minmax_ipm(fns: _MinMaxFns, dims, opts: SolverOptions, kkt_solver=None,
                     param_shapes=None, band_plan=None, hessd_plan=None):
    """Build the batched ``solve`` function of a min-max problem.

    ``solve(z0, penv, shared, mu0, max_iter, addU0, addD0, addEq0)``: ``z0``
    is (B, nZ); each ``penv`` entry has a leading batch dimension except
    the parameters named in ``shared``.  ``kkt_solver`` maps the KKT of a
    direction to a factorization (None: the unpivoted LDL^T of
    :mod:`tenscalc_tpu_torch.kkt.dense`).  ``band_plan`` (with a banded
    ``kkt_solver``) enables band mode where the certificates allow it;
    ``hessd_plan``, when worthwhile, the banded HessD inertia (K3).  The
    certificates are kept as ``solve.certificates``."""
    nUu, nD, nFu, nFd, nGu, nGd = dims
    nZ, nF, nG, nK = _sizes(dims)
    dt = opts.torch_dtype
    f64 = dt == torch.float64
    tol = MAX_DIRECTION_ERROR if f64 else MAX_DIRECTION_ERROR_F32
    adapt = opts.addEye2Hessian and opts.adjustAddEye2Hessian
    want_band = band_plan is not None and kkt_solver is not None
    cert = minmax_certificates(fns, dims, opts, param_shapes or {}, want_band)
    # outside band mode a banded backend takes the dense saddle KKT
    band_mode = want_band and cert["band_ok"]
    hessd_banded = bool(band_mode and hessd_plan is not None and hessd_plan.worthwhile)
    F_affine = nF > 0 and cert["hoist_Fz"] and opts.linesearch_affine_F
    # desired inertias (ipmPDminmax_CSsolver.m:68-69): the saddle KKT has
    # nU + nGd + nFd positive eigenvalues, HessD nD negative ones
    mp_desired = float(nUu + nGd + nFd)
    mn_desired = float(nD)
    assemble_ww, assemble_hessd = dense_minmax_kkt(fns, dims)

    def solve(z0: torch.Tensor, penv, shared=frozenset(), mu0: float = 1.0,
              max_iter: Optional[int] = None, addU0: float = 1e-9,
              addD0: float = 1e-9, addEq0: float = 1e-9) -> IPMResult:
        max_iter_v = opts.maxIter if max_iter is None else int(max_iter)
        dev = z0.device
        z0 = z0.to(dt)
        B = z0.shape[0]
        pdims = {k: (None if k in shared else 0) for k in penv}
        shapes = {k: tuple(v.shape[0 if k in shared else 1:]) for k, v in penv.items()}
        reg = opts.addEye2Hessian

        def full(v, dtype=dt):
            return torch.full((B,), v, dtype=dtype, device=dev)

        def raw(fn):
            return vmap(fn, in_dims=(0, pdims))

        # scaling at the initial point (ipmPDminmax_CS.m:58-82)
        if nFu and opts.scaleInequalities:
            sFu = torch.abs(1.0 / raw(fns.Fu)(z0, penv)).to(dt)
        else:
            sFu = torch.ones(B, nFu, dtype=dt, device=dev)
        if nFd and opts.scaleInequalities:
            sFd = torch.abs(1.0 / raw(fns.Fd)(z0, penv)).to(dt)
        else:
            sFd = torch.ones(B, nFd, dtype=dt, device=dev)
        if opts.scaleCost > 0:
            sc = torch.abs(opts.scaleCost / raw(fns.f)(z0, penv)).to(dt)
            desired_gap = opts.desiredDualityGap * sc
        else:
            sc = full(1.0)
            desired_gap = full(opts.desiredDualityGap)
        mu_min = desired_gap / max(nF, 1) / 2.0
        s_all = torch.cat([sFu, sFd], dim=1)
        mu0_t = torch.as_tensor(mu0, dtype=dt, device=dev)
        in_b = (0, 0, 0, pdims, 0, 0, 0)  # (z, nu, lam, penv, sFu, sFd, sc)

        def _terms(z, nu, lam, pe, sfu, sfd, sc_):
            _, _, _, Fall, Gall, lagr = scaled_fns(fns, dims, pe, sfu, sfd, sc_)
            return grad(lagr, argnums=0)(z, nu, lam), Fall(z), Gall(z)

        terms_b = vmap(_terms, in_dims=in_b)
        Fall_b = vmap(lambda z, pe, sfu, sfd, sc_: scaled_fns(fns, dims, pe, sfu, sfd, sc_)[3](z),
                      in_dims=(0, pdims, 0, 0, 0))

        def Fall_at(z):
            return Fall_b(z, penv, sFu, sFd, sc)

        # hoisted blocks at the dummy iterate (value-equal by certificate):
        # certified scale-free ones at unit scales with the parameters a
        # block does not depend on replaced by zeros, so that with every
        # remaining dependency shared they carry no batch dimension
        z_d = torch.zeros(nZ, dtype=dt, device=dev)
        nu_d = torch.zeros(nG, dtype=dt, device=dev)
        lam_d = torch.ones(nF, dtype=dt, device=dev)
        units = _unit_scales(dims, dt, dev)

        def hoisted_unit(fn, deps):
            keep = [k for k in penv if deps is None or k in deps]
            env = {k: (penv[k] if k in keep else torch.zeros(shapes[k], dtype=dt, device=dev))
                   for k in penv}
            if all(k in shared for k in keep):
                return fn(env)
            return vmap(fn, in_dims=({k: (0 if (k in keep and k not in shared) else None)
                                      for k in env},))(env)

        def hoisted_scaled(fn):
            """fn(fns at the instance's scales) with the full parameters."""
            return vmap(lambda pe, sfu, sfd, sc_: fn(scaled_fns(fns, dims, pe, sfu, sfd, sc_)),
                        in_dims=(pdims, 0, 0, 0))(penv, sFu, sFd, sc)

        def unit(env):
            return scaled_fns(fns, dims, env, *units)

        pre = {}
        if cert["hoist_H"]:
            if cert["hoist_H_sf"]:
                H0 = hoisted_unit(
                    lambda env: jacfwd(grad(unit(env)[5], argnums=0), argnums=0)(
                        z_d, nu_d, lam_d), cert["deps_H"])
            else:
                H0 = hoisted_scaled(
                    lambda fs: jacfwd(grad(fs[5], argnums=0), argnums=0)(z_d, nu_d, lam_d))
            pre["H"] = _sym(H0)
        if cert["hoist_Gz"] and nG:
            pre["Gz"] = hoisted_unit(lambda env: jacfwd(unit(env)[4])(z_d), cert["deps_Gz"])
        if cert["hoist_Fz"] and nF and not band_mode:
            pre["Fuz"] = hoisted_scaled(
                lambda fs: jacfwd(fs[1])(z_d) if nFu else z_d.new_zeros(0, nZ))
            pre["Fdz"] = hoisted_scaled(
                lambda fs: jacfwd(fs[2])(z_d) if nFd else z_d.new_zeros(0, nZ))

        if band_mode:
            band_dir = _BandDirection(
                dims, opts, band_plan, hessd_plan if hessd_banded else None, pre,
                hoisted_unit(lambda env: jacfwd(unit(env)[3])(z_d), cert["deps_Fz"]),
                s_all, sFd,
            )
            pre["Fz_all_u"] = band_dir.Fz_all_u

        # the dense branch: each instance assembled by the single-instance
        # functions, hoisted blocks shared or per instance
        pre_dims = {k: (0 if v.dim() == 3 else None) for k, v in pre.items()}
        ww_b = vmap(assemble_ww, in_dims=(0, 0, 0, 0, 0, 0, pdims, 0, 0, 0, pre_dims))
        hessd_b = vmap(assemble_hessd, in_dims=(0, 0, 0, 0, 0, pdims, 0, 0, 0, pre_dims))

        def factor_dense(WW):
            if kkt_solver is not None:
                return kkt_solver(WW)
            L, dfac = ldl_factor(WW, block=opts.ldl_block)
            return KKTFactorization("ldl", L, dfac)

        def hessd_inertia_dense(HessD):
            _, dD = ldl_factor(HessD, block=opts.ldl_block)
            return ldl_inertia(dD)[1]

        def compute_direction(z, nu, lam, mu, addU, addD, addEq, cached,
                              need_inertia: bool) -> MMDirection:
            grad_z, Fv, Gv = cached
            Fuv, Fdv = Fv[:, :nFu], Fv[:, nFu:]
            lamU, lamD = lam[:, :nFu], lam[:, nFu:]
            b = torch.cat([-grad_z, -Gv, Fuv - mu[:, None] / lamU,
                           -Fdv + mu[:, None] / lamD], dim=1)
            if band_mode:
                d3 = torch.cat([-Fuv / lamU, Fdv / lamD], dim=1)
                op, rowsum_ub = band_dir.assemble(d3, addU, addD, addEq)
                fac = kkt_solver(op)
                dx = fac.solve(b)
                derr = _norminf(op.matvec(dx) - b)
                FzdZ = s_all * hdot(band_dir.Fz_all_u, dx[:, :nZ])
            else:
                WW, Fuz, Fdz = ww_b(z, nu, lam, addU, addD, addEq, penv, sFu, sFd, sc, pre)
                fac = factor_dense(WW)
                dx = fac.solve(b)
                derr = _norminf(hdot(WW, dx) - b)
                rowsum_ub = WW.abs().sum(dim=-1).amax(dim=-1)
                FzdZ = hdot(torch.cat([Fuz, Fdz], dim=1), dx[:, :nZ])
            # f32 backward-error scale (an absolute f32 gate would re-solve
            # healthy systems)
            if f64:
                bscale = torch.ones_like(mu)
            else:
                bscale = torch.clamp(rowsum_ub * _norminf(dx) + _norminf(b), min=1.0)
            if need_inertia:
                # the saddle KKT's inertia from its own factor
                # (getHessUinertia__), HessD's from a factor of its own
                # (getHessDinertia__, ipmPDminmax_CS.m:246-259)
                mpU, _ = fac.inertia()
                if hessd_banded:
                    mnD = band_dir.hessd_inertia(Fdv / lamD, addD, addEq)
                else:
                    mnD = hessd_inertia_dense(
                        hessd_b(z, nu, lam, addD, addEq, penv, sFu, sFd, sc, pre))
            else:
                mpU = torch.full_like(mu, mp_desired)
                mnD = torch.full_like(mu, mn_desired)
            return MMDirection(dx, derr, mpU, mnD, FzdZ, bscale)

        def exit_metrics(st: MinMaxState):
            grad_z, Fv, Gv = terms_b(st.z, st.nu, st.lam, penv, sFu, sFd, sc)
            g = _norminf(grad_z)
            eq = _norminf(Gv)
            if nF:
                gap, ineq, dual = _dot(st.lam, Fv), Fv.amin(dim=1), st.lam.amin(dim=1)
            else:
                gap, ineq, dual = full(0.0), full(math.inf), full(math.inf)
            return g, eq, gap, ineq, dual, (grad_z, Fv, Gv)

        def flags(res: MMDirection, aU, aD, aE):
            # f32 gate relative to the backward-error scale (1.0 in f64)
            ok = res.derr <= tol * res.bscale  # NaN counts as too large
            good = (res.mpU == mp_desired) & (res.mnD == mn_desired) & ok
            incU = (res.mpU < mp_desired) & (aU < ADD_MAX)
            incD = (res.mnD < mn_desired) & (aD < ADD_MAX)
            incE = ~ok & (aE < ADD_MAX)
            return good, incU, incD, incE

        def bump(a):
            return torch.clamp(10.0 * torch.clamp(a, min=ADD_MIN), max=ADD_MAX)

        def adapt_directions(st: MinMaxState, cached, run):
            """The reference's adaptation loop (ipmPDminmax_CSsolver.m:
            254-305), solve at least once: while an instance's saddle KKT
            lacks positive pivots raise addU x10, while HessD lacks
            negative ones addD x10, while its direction error exceeds the
            gate addEq x10 (in f32 only while the re-solves keep halving
            the error), at most MAX_ADAPT_STEPS times."""
            aU, aD, aE = st.addU, st.addD, st.addEq

            def direction(aU_, aD_, aE_):
                return compute_direction(st.z, st.nu, st.lam, st.mu, aU_, aD_, aE_,
                                         cached, need_inertia=True)

            def retry(res, k, derr_prev):
                good, incU, incD, incE = flags(res, aU, aD, aE)
                if f64:
                    derr_ok = torch.ones_like(good)
                else:
                    derr_ok = (k <= 1) | (res.derr < 0.5 * derr_prev)
                return ~good & (incU | incD | (incE & derr_ok)) & (k <= MAX_ADAPT_STEPS)

            res = direction(aU, aD, aE)
            k = torch.ones(B, dtype=torch.int32, device=dev)
            derr_prev = full(math.inf)
            need = run & retry(res, k, derr_prev)
            while bool(need.any()):
                _, incU, incD, incE = flags(res, aU, aD, aE)
                aU, aD, aE = (torch.where(need & inc, bump(a), a)
                              for inc, a in ((incU, aU), (incD, aD), (incE, aE)))
                derr_prev = torch.where(need, res.derr, derr_prev)
                res = _select(need, direction(aU, aD, aE), res)
                k = torch.where(need, k + 1, k)
                need = need & retry(res, k, derr_prev)
            return res, aU, aD, aE

        def iterate(st: MinMaxState, g, eq, cached, run) -> MinMaxState:
            z, nu, lam, mu = st.z, st.nu, st.lam, st.mu
            _, Fv, _ = cached
            if not adapt:
                dirn = compute_direction(z, nu, lam, mu, st.addU, st.addD, st.addEq,
                                         cached, need_inertia=False)
                addU, addD, addEq = st.addU, st.addD, st.addEq
                nxt = (addU, addD, addEq)
            else:
                dirn, addU, addD, addEq = adapt_directions(st, cached, run)
                # delayed decrease once every check passes (next iteration)
                good = flags(dirn, addU, addD, addEq)[0]
                nxt = tuple(
                    torch.where(good & (a > ADD_MIN), torch.clamp(0.75 * a, min=ADD_MIN), a)
                    for a in (addU, addD, addEq)
                )
            dx, FzdZ = dirn.dx, dirn.FzdZ
            dZ, dNu, dLam = dx[:, :nZ], dx[:, nZ: nZ + nG], dx[:, nZ + nG:]
            if nF == 0:
                alphaPrimal = full(opts.alphaMax)
                alphaDualEq = full(opts.alphaMax)
                alphaDualIneq = full(0.0)
                new_z = torch.addcmul(z, alphaPrimal[:, None], dZ)
                new_nu = torch.addcmul(nu, alphaDualEq[:, None], dNu)
                new_lam, new_mu = lam, mu
                nan_fail = torch.zeros_like(run)
            else:
                maxAlphaP = _clp(Fv, FzdZ)
                maxAlphaDI = _clp(lam, dLam)
                alphaP = maxAlphaP
                if opts.coupledAlphas:
                    alphaP = torch.minimum(alphaP, maxAlphaDI)
                alpha_bt = torch.clamp(alphaP * STEPBACK, max=opts.alphaMax)
                if F_affine:
                    # F affine in z (certified): min F(z + a dZ) =
                    # min(F + a Fz dZ), formed with one rounding as XLA
                    # fuses it
                    def minF(alpha):
                        return torch.addcmul(
                            Fv[:, None, :], alpha[:, :, None], FzdZ[:, None, :]
                        ).amin(-1)
                else:
                    def minF(alpha):
                        zc = torch.addcmul(z[:, None, :], alpha[:, :, None], dZ[:, None, :])
                        return vmap(
                            lambda zz, pe, sfu, sfd, sc_: vmap(
                                scaled_fns(fns, dims, pe, sfu, sfd, sc_)[3])(zz),
                            in_dims=(0, pdims, 0, 0, 0),
                        )(zc, penv, sFu, sFd, sc).amin(-1)

                alphaPrimal, nan_fail = line_search_combined(minF, alpha_bt, opts)
                if opts.coupledAlphas:
                    alphaDualIneq = alphaDualEq = alphaPrimal
                else:
                    alphaDualIneq = torch.minimum(maxAlphaDI * STEPBACK, alpha_bt)
                    alphaDualEq = alphaDualIneq
                new_z = torch.addcmul(z, alphaPrimal[:, None], dZ)
                new_nu = torch.addcmul(nu, alphaDualEq[:, None], dNu)
                new_lam = torch.addcmul(lam, alphaDualIneq[:, None], dLam)

                # mu schedule, the minimize solver's
                # (ipmPDminmax_CSsolver.c:609-676)
                th_grad = g < max(1e-6, opts.gradTolerance)
                th_eq = (torch.ones_like(run) if nG == 0
                         else eq < max(1e-5, opts.equalTolerance))
                aggressive = (alphaPrimal > alpha_bt / 2) & th_grad & th_eq
                mu_aggr = torch.maximum(
                    mu * torch.clamp(torch.sqrt(mu), max=opts.muFactorAggressive), mu_min
                )
                tiny = alphaPrimal < 0.1
                mu_tiny = torch.minimum(mu * 1.1, mu0_t)
                conservative = (alphaPrimal > 0.99) & th_eq
                mu_cons = torch.maximum(mu * opts.muFactorConservative, mu_min)
                new_mu = torch.where(
                    aggressive, mu_aggr,
                    torch.where(tiny, mu_tiny, torch.where(conservative, mu_cons, mu)),
                )
                # evaluated for every instance and kept where the step was tiny
                new_lam = torch.where(tiny[:, None], mu_tiny[:, None] / Fall_at(new_z),
                                      new_lam)
                stalled = ((alphaPrimal < opts.alphaMin) & (alphaDualIneq < opts.alphaMin)
                           & (alphaDualEq < opts.alphaMin))
                new_mu = torch.where(
                    stalled, torch.maximum(new_mu / opts.muFactorConservative ** 2, mu_min),
                    new_mu,
                )
            keep = nan_fail[:, None]
            return MinMaxState(
                z=torch.where(keep, z, new_z),
                nu=torch.where(keep, nu, new_nu),
                lam=torch.where(keep, lam, new_lam),
                mu=new_mu, addU=addU, addU_next=nxt[0], addD=addD, addD_next=nxt[1],
                addEq=addEq, addEq_next=nxt[2], alphaPrimal=alphaPrimal,
                alphaDualIneq=alphaDualIneq, alphaDualEq=alphaDualEq,
                status=torch.where(nan_fail, 4, 0).to(torch.int32),
                it=st.it, done=nan_fail,
            )

        def step(st: MinMaxState) -> MinMaxState:
            it = st.it + 1
            addU, addD, addEq = st.addU_next, st.addD_next, st.addEq_next
            g, eq, gap, ineq, dual, cached = exit_metrics(st)
            status = torch.zeros(B, dtype=torch.int32, device=dev)
            fail_maxiter = it > max_iter_v
            status = torch.where(fail_maxiter, 8, status)
            fail_nan = torch.isnan(g)
            status = torch.where(fail_nan & (status == 0), 4, status)
            early = fail_maxiter | fail_nan
            if nF:
                fail_ineq = ineq <= 0
                status = torch.where(fail_ineq & (status == 0), 1, status)
                fail_dual = dual <= 0
                status = torch.where(fail_dual & (status == 0), 2, status)
                early = early | fail_ineq | fail_dual
            converged = g <= opts.gradTolerance
            if nF:
                converged &= gap <= desired_gap
            if nG:
                converged &= eq <= opts.equalTolerance
            if adapt:
                converged &= addU <= opts.addEye2HessianUtolerance
            early = early | converged
            stop = st._replace(
                it=it, addU=addU, addU_next=addU, addD=addD, addD_next=addD,
                addEq=addEq, addEq_next=addEq, status=status.to(torch.int32),
                done=torch.ones_like(st.done),
            )
            run = ~st.done & ~early
            if bool(run.any()):
                new = iterate(st._replace(it=it, addU=addU, addD=addD, addEq=addEq),
                              g, eq, cached, run)
                stop = _select(run, new, stop)
            return _select(st.done, st, stop)

        lam0 = mu0_t / Fall_at(z0) if nF else z0.new_zeros(B, 0)
        a0 = [full(a if reg else 0.0) for a in (addU0, addD0, addEq0)]
        st = MinMaxState(
            z=z0, nu=torch.ones(B, nG, dtype=dt, device=dev), lam=lam0, mu=full(mu0),
            addU=a0[0], addU_next=a0[0], addD=a0[1], addD_next=a0[1],
            addEq=a0[2], addEq_next=a0[2],
            alphaPrimal=full(0.0), alphaDualIneq=full(0.0), alphaDualEq=full(0.0),
            status=full(0, torch.int32), it=full(0, torch.int32),
            done=full(False, torch.bool),
        )
        while not bool(st.done.all()):
            st = step(st)

        # status completion when maxIter was reached
        g, eq, gap, _, _, _ = exit_metrics(st)
        status = st.status
        is8 = status == 8

        def add_flag(cond, flag, s):
            return torch.where(is8 & cond, s | flag, s)

        status = add_flag(g > opts.gradTolerance, 16, status)
        if nG:
            status = add_flag(eq > opts.equalTolerance, 32, status)
        if nF:
            status = add_flag(gap > desired_gap, 64, status)
            status = add_flag(st.mu > mu_min, 128, status)
            aP, aDI, aDE = st.alphaPrimal, st.alphaDualIneq, st.alphaDualEq
            negl = (aP <= opts.alphaMin) & (aDI < opts.alphaMin) & (aDE < opts.alphaMin)
            small_a = (aP <= 0.1) & (aDI < 0.1) & (aDE < 0.1)
            med_a = (aP <= 0.5) & (aDI < 0.5) & (aDE < 0.5)
            status = add_flag(negl, 1792, status)
            status = add_flag(~negl & small_a, 1536, status)
            status = add_flag(~negl & ~small_a & med_a, 1024, status)

        f_end = vmap(lambda z, pe, sc_: scaled_fns(fns, dims, pe, units[0], units[1], sc_)[0](z),
                     in_dims=(0, pdims, 0))(st.z, penv, sc)
        # addEq reports the final addD, as the JAX package's IPMResult does
        # (minmax.py:1129 there)
        return IPMResult(
            u=st.z, nu=st.nu, lam=st.lam, mu=st.mu, status=status, iters=st.it,
            norminf_grad=g, norminf_eq=eq, gap=gap, f=f_end / sc, addU=st.addU,
            addEq=st.addD, scale_ineq=s_all, scale_cost=sc,
        )

    solve.band_mode = "hoisted" if band_mode else None
    solve.hessd_banded = hessd_banded
    solve.certificates = cert
    return solve


class _BandDirection:
    """The permuted constant bands of a solve (the signed unit saddle
    matrix [[H, Gz', Fsgn'], [Gz, 0, 0], [Fsgn, 0, 0]] and, with a HessD
    plan, its maximizer sub-system) with the inequality scales folded in
    once, and the per-direction assembly: the global diagonal (+addU on
    u, -addD on d, -addEq on the equalities, d3 on the F rows) added to a
    copy.  Permuting by index gives the values of the JAX package's
    one-hot products."""

    def __init__(self, dims, opts, band_plan, hessd_plan, pre, Fz, s_all, sFd):
        nUu, nD, nFu, nFd, nGu, nGd = dims
        nZ, nF, nG, _ = _sizes(dims)
        dt, dev = opts.torch_dtype, s_all.device
        B = s_all.shape[0]
        self.dims = dims
        # Fz: the unit-scale F Jacobians, value-irrelevant parameters masked
        H = pre["H"]
        Gz = pre.get("Gz", torch.zeros(0, nZ, dtype=dt, device=dev))
        self.Fz_all_u, self.H, self.Gz = Fz, H, Gz
        Fsgn = torch.cat([-Fz[..., :nFu, :], Fz[..., nFu:, :]], dim=-2)
        w = int(band_plan.bandwidth)
        self.perm = perm = torch.as_tensor(np.asarray(band_plan.perm), device=dev)
        const_l = extract_band_lower(_stack3(H, Gz, Fsgn, nG, nF)[..., perm, :][..., :, perm], w)
        # g = 1 off the F rows/cols, the inequality scales on them: the
        # scales are fixed for a solve, so they are folded in once
        gp = torch.cat([torch.ones(B, nZ + nG, dtype=dt, device=dev), s_all], dim=1)[:, perm]
        self.band_scaled = const_l * shifted_cols(gp, w) * gp[:, :, None]
        self.m_u = (perm < nUu).to(dt)
        self.m_d = ((perm >= nUu) & (perm < nZ)).to(dt)
        self.m_g = ((perm >= nZ) & (perm < nZ + nG)).to(dt)
        self.zeros_notF = torch.zeros(B, nZ + nG, dtype=dt, device=dev)
        self.diagU = torch.cat([torch.ones(nUu, dtype=dt, device=dev),
                                torch.zeros(nD, dtype=dt, device=dev)])
        self.diagD = 1.0 - self.diagU
        self.q_sgn = torch.cat([-s_all[:, :nFu], s_all[:, nFu:]], dim=1)
        # constant parts of the row-sum bound
        self.absFz = Fz.abs()
        self.absH_sum = H.abs().sum(dim=-1)
        self.gz_col = Gz.abs().sum(dim=-2) if nG else 0.0
        self.r2_const = Gz.abs().sum(dim=-1)
        self.r3_const = self.absFz.sum(dim=-1)
        self.hessd_plan = hessd_plan
        if hessd_plan is not None:
            permD = torch.as_tensor(np.asarray(hessd_plan.perm), device=dev)
            wD = int(hessd_plan.bandwidth)
            WD = _stack3(H[..., nUu:, nUu:], Gz[..., nGu:, nUu:], Fz[..., nFu:, nUu:],
                         nGd, nFd)
            constD = extract_band_lower(WD[..., permD, :][..., :, permD], wD)
            gD = torch.cat([torch.ones(B, nD + nGd, dtype=dt, device=dev), sFd],
                           dim=1)[:, permD]
            self.hd_band_scaled = constD * shifted_cols(gD, wD) * gD[:, :, None]
            self.hd_m_d = (permD < nD).to(dt)
            self.hd_m_g = ((permD >= nD) & (permD < nD + nGd)).to(dt)
            self.hd_zeros_notF = torch.zeros(B, nD + nGd, dtype=dt, device=dev)
            self.permD = permD

    def assemble(self, d3, addU, addD, addEq):
        """BandedOperator of the batch and its row-sum bound."""
        nZ, _, nG, _ = _sizes(self.dims)
        d3p = torch.cat([self.zeros_notF, d3], dim=1)[:, self.perm]
        diag_add = (addU[:, None] * self.m_u - addD[:, None] * self.m_d
                    - addEq[:, None] * self.m_g + d3p)
        lb = self.band_scaled.clone()
        lb[:, :, 0] = lb[:, :, 0] + diag_add
        H, Gz, Fz, q = self.H, self.Gz, self.Fz_all_u, self.q_sgn
        shift = addU[:, None] * self.diagU - addD[:, None] * self.diagD

        def mv(x):
            xz, xn, xf = x[:, :nZ], x[:, nZ: nZ + nG], x[:, nZ + nG:]
            r1 = hdot(H, xz) + shift * xz + hdotT(Gz, xn) + hdotT(Fz, q * xf)
            r2 = hdot(Gz, xz) - addEq[:, None] * xn
            r3 = q * hdot(Fz, xz) + d3 * xf
            return torch.cat([r1, r2, r3], dim=1)

        # row-sum upper bound through the constituents (the f32
        # backward-error scale)
        absq = q.abs()
        r1_ub = (self.absH_sum + addU.abs()[:, None] * self.diagU
                 + addD.abs()[:, None] * self.diagD + self.gz_col
                 + hdotT(self.absFz, absq))
        r2_ub = self.r2_const + addEq.abs()[:, None]
        r3_ub = absq * self.r3_const + d3.abs()
        rowsum_ub = torch.cat([r1_ub, r2_ub, r3_ub], dim=1).amax(dim=1)
        return BandedOperator(lb, self.perm, mv), rowsum_ub

    def hessd_inertia(self, d3D, addD, addEq):
        """Negative pivots of HessD from its band (K3 on the card): the
        adapter is built without refinement and only its inertia is read,
        so its matvec is never called."""
        from ..kkt.fleet_banded import FleetBandedFromBand

        d3p = torch.cat([self.hd_zeros_notF, d3D], dim=1)[:, self.permD]
        diag_add = -addD[:, None] * self.hd_m_d - addEq[:, None] * self.hd_m_g + d3p
        lb = self.hd_band_scaled.clone()
        lb[:, :, 0] = lb[:, :, 0] + diag_add
        op = BandedOperator(lb, self.permD, _no_matvec)
        return FleetBandedFromBand(op, self.hessd_plan, n_refine=0).inertia()[1]


def _no_matvec(x):  # pragma: no cover - the HessD adapter never refines
    raise NotImplementedError("the HessD operator has no matvec")


def _stack3(H, Gz, Fz, nG, nF):
    """[[H, Gz', Fz'], [Gz, 0, 0], [Fz, 0, 0]] over broadcast leading
    dimensions."""
    lead = torch.broadcast_shapes(H.shape[:-2], Gz.shape[:-2], Fz.shape[:-2])
    H, Gz, Fz = (t.expand(lead + t.shape[-2:]) for t in (H, Gz, Fz))
    return torch.cat([
        torch.cat([H, Gz.transpose(-1, -2), Fz.transpose(-1, -2)], dim=-1),
        torch.cat([Gz, Gz.new_zeros(lead + (nG, nG + nF))], dim=-1),
        torch.cat([Fz, Fz.new_zeros(lead + (nF, nG + nF))], dim=-1),
    ], dim=-2)


def _minmax_functions(objective, min_vars, max_vars, minConstraints, maxConstraints,
                      parameters, dt):
    """(fns, dims, packing) of a min-max problem; ``packing`` covers
    z = [u; d].  Minimizer constraints must not depend on maximizer
    variables (ipmPDminmax_CS.m:88-98)."""
    from ..api import _split_constraints

    pack_u, pack_d = Packing(min_vars), Packing(max_vars)
    packing = Packing(list(min_vars) + list(max_vars))
    Fu_e, Gu_e = _split_constraints(minConstraints)
    Fd_e, Gd_e = _split_constraints(maxConstraints)
    dnames = set(pack_d.names)
    for e in Fu_e + Gu_e:
        bad = e.deps & dnames
        if bad:
            raise ValueError(
                "minimizer constraints cannot depend on maximizer "
                f"optimization variables (found {sorted(bad)})"
            )
    known = {p.name for p in parameters} | set(packing.names)
    for e in [objective] + Fu_e + Gu_e + Fd_e + Gd_e:
        extra = e.deps - known
        if extra:
            raise ValueError(
                f"expression depends on undeclared symbols {sorted(extra)}; "
                "declare them as parameters or optimization variables"
            )

    def env_of(z, penv):
        return {**penv, **packing.unpack(z)}

    def mk_stack(exprs):
        def fn(z, penv):
            if not exprs:
                return z.new_zeros(0)
            env = env_of(z, penv)
            # a copy, as api.py's stack: a cast in place keeps a float64 tangent
            return torch.cat([torch.ravel(e(env)) for e in exprs]).to(dt, copy=True)

        return fn

    def f_fn(z, penv):
        return objective(env_of(z, penv)).to(dt).reshape(())

    fns = _MinMaxFns(f=f_fn, Fu=mk_stack(Fu_e), Fd=mk_stack(Fd_e), Gu=mk_stack(Gu_e),
                     Gd=mk_stack(Gd_e))
    dims = (pack_u.total, pack_d.total,
            int(sum(e.size for e in Fu_e)), int(sum(e.size for e in Fd_e)),
            int(sum(e.size for e in Gu_e)), int(sum(e.size for e in Gd_e)))
    return fns, dims, packing


class MinMaxSolver(SolverBase):
    """Min-max solver (reference: cmex2minmaxCS / class2minmaxCS,
    lib/cmex2minmaxCS.m:9-26).  It runs on the card (``device=None``)
    unless the caller asks for the CPU.

    ``kkt_backend``: 'dense'/'ldl' factor the saddle KKT with the
    unpivoted LDL^T of :mod:`tenscalc_tpu_torch.kkt.dense`; 'auto',
    'fleet' and 'fleet_banded' take the fleet backends of
    :func:`tenscalc_tpu_torch.kkt.select.select_game_backend`, and
    'tridiag' (or 'auto' under ``TENSCALC_AUTO_FLEET=0``) its
    block-tridiagonal LDL^T, whose Schur blocks give the saddle KKT's
    inertia.

    As in the JAX package, a result's ``addEq`` field holds the final
    addD (a quirk of its ``IPMResult`` that the port keeps)."""

    def __init__(
        self,
        objective: Expr,
        minOptimizationVariables: Sequence[Variable],
        maxOptimizationVariables: Sequence[Variable],
        minConstraints=(),
        maxConstraints=(),
        parameters: Sequence[Variable] = (),
        outputExpressions: Optional[Mapping[str, Expr]] = None,
        options: Optional[SolverOptions] = None,
        device=None,
        **option_kwargs,
    ):
        from ..kkt.select import compute_banded_plan, select_game_backend

        self.opts = (options or SolverOptions()).replace(**option_kwargs).resolved("minmax")
        if not self.opts.skipAffine:
            # the reference's minmax formulation declares no affine
            # direction (ipmPDminmax_CS.m has no b_a/getRho)
            raise ValueError("minmax solver requires skipAffine=True")
        self.device = resolve_device(device)
        full_precision_matmul()
        dt = self.opts.torch_dtype
        self.min_vars = list(minOptimizationVariables)
        self.max_vars = list(maxOptimizationVariables)
        self.variables = self.min_vars + self.max_vars
        self.parameters = list(parameters)
        self.outputExpressions = dict(outputExpressions or {})
        self._fns, self._ipm_dims, self.packing = _minmax_functions(
            objective, self.min_vars, self.max_vars, minConstraints, maxConstraints,
            self.parameters, dt,
        )
        (self.nUu, self.nD, self.nFu, self.nFd, self.nGu, self.nGd) = self._ipm_dims
        pshapes = {p.name: p.shape for p in self.parameters}
        self._assemble_ww, self._assemble_hessd = dense_minmax_kkt(self._fns, self._ipm_dims)
        nK = _sizes(self._ipm_dims)[3]
        kkt_solver, name, plan = select_game_backend(
            self.opts, nK, lambda: compute_banded_plan(self._probe_assemble, nK),
            symmetric=True,
        )
        self.kkt_plan = plan
        self.kkt_backend_resolved = name
        self.hessd_plan = None
        mD = self.nD + self.nGd + self.nFd
        if (name == "fleet_banded" and self.opts.addEye2Hessian
                and self.opts.adjustAddEye2Hessian and mD >= 32):
            # the HessD inertia gets its own banded plan
            self.hessd_plan = compute_banded_plan(self._probe_hessd, mD)
        self._solve_raw = build_minmax_ipm(
            self._fns, self._ipm_dims, self.opts, kkt_solver=kkt_solver,
            param_shapes=pshapes, band_plan=plan if name == "fleet_banded" else None,
            hessd_plan=self.hessd_plan,
        )
        self.certificates = self._solve_raw.certificates

    def _probe_env(self, seed: int):
        """Random iterate of the structure probes (structurally generic
        values; the JAX package's draws in its order)."""
        dt = self.opts.torch_dtype
        nZ, nF, nG, _ = _sizes(self._ipm_dims)
        rng = np.random.default_rng(seed)
        penv = {p.name: torch.as_tensor(rng.standard_normal(p.shape), dtype=dt)
                for p in self.parameters}
        z = torch.as_tensor(rng.standard_normal(nZ), dtype=dt)
        lam = torch.as_tensor(rng.uniform(0.5, 1.5, nF), dtype=dt)
        nu = torch.as_tensor(rng.standard_normal(nG), dtype=dt)
        return penv, z, nu, lam, _unit_scales(self._ipm_dims, dt)

    def _probe_assemble(self, trial: int):
        """Random-iterate dense saddle KKT for the structure probe."""
        penv, z, nu, lam, units = self._probe_env(trial)
        a = torch.tensor(1e-3, dtype=self.opts.torch_dtype)
        return self._assemble_ww(z, nu, lam, a, a, a, penv, *units, {})[0].numpy()

    def _probe_hessd(self, trial: int):
        """Random-iterate HessD for the sub-system's structure probe."""
        penv, z, nu, lam, units = self._probe_env(1000 + trial)
        a = torch.tensor(1e-3, dtype=self.opts.torch_dtype)
        return self._assemble_hessd(z, nu, lam, a, a, penv, *units, {}).numpy()

    def solve_many(self, parameters: Optional[Mapping[str, Any]] = None,
                   inits: Optional[Mapping[str, Any]] = None, mu0: float = 1.0,
                   max_iter: Optional[int] = None,
                   addEye2Hessian=(1e-9, 1e-9, 1e-9)) -> IPMResult:
        """A fleet: a parameter passed in its declared shape is shared, any
        other carries a leading batch dimension; inits cover the min and
        max variables.  ``addEye2Hessian`` = (addU, addD, addEq) initial
        regularizations.  Returns the batched IPMResult."""
        from ..interop import fleet_from_numpy

        penv, shared, z0 = fleet_from_numpy(
            self, dict(parameters or {}), inits, self.device, self.opts.torch_dtype
        )
        return self._solve_raw(z0, penv, shared, mu0, max_iter, *addEye2Hessian)

    def solve(self, parameters: Optional[Mapping[str, Any]] = None,
              init: Optional[Mapping[str, Any]] = None, mu0: float = 1.0,
              max_iter: Optional[int] = None, addEye2Hessian=(1e-9, 1e-9, 1e-9)):
        """One instance: the fleet path at B = 1, every parameter shared."""
        penv = self._param_env(parameters)
        z0 = self._pack_init(init)[None]
        t0 = time.perf_counter()
        res = self._solve_raw(z0, penv, frozenset(penv), mu0, max_iter, *addEye2Hessian)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._make_solution(res, penv, time.perf_counter() - t0)
