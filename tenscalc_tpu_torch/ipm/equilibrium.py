"""Primal-dual IPM for two-player Nash equilibria with shared latent
variables, over an explicit batch dimension (port of
``tenscalc_tpu/ipm/equilibrium.py``):

    P1:  min_{u,x} f(u,d,x)   s.t. Fu >= 0, Gu == 0, H == 0
    P2:  min_{d,x} g(u,d,x)   s.t. Fd >= 0, Gd == 0, H == 0

Each player optimizes over its own variables and the shared latent x,
subject to the shared latent equalities H (each player has its own
multiplier for H).  The stacked first-order system is unsymmetric (two
Lagrangians share rows), so it is factored by the fleet banded LU.

This slice ports the path the MPC-MHE fleet takes: the large stacked
Newton matrix with ``skipAffine``, its Jacobians certified iteration-
invariant at build time, assembled straight into permuted band storage
(band mode 'hoisted') and factored by K9/K10; the ``addEye2Hessian2``
adaptation loop with the relative float32 direction-error gate and the
progress guard; the combined line search with F affine in z; the mu
schedule; the exit tests and final status flags.  As in
``ipm/solver.py``, the JAX package's ``vmap`` of a ``lax.while_loop``
becomes Python loops over a leading batch dimension B with per-instance
masks, and a single solve is B = 1 through the same code.

Waiting, each raising ``NotImplementedError`` that names ROADMAP item
M13: the condensed ``smallerNewtonMatrix`` branch, the Mehrotra large
branch (``skipAffine=False``), a game outside band mode (per-iteration
dense assembly), and ``kkt_backend='dense'``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ..api import SolverBase, full_precision_matmul, resolve_device
from ..expr import Constraint, Expr, Variable
from ..kkt.band_assemble import (
    BandedOperator,
    extract_band_lower,
    extract_band_upper,
    shifted_cols,
)
from ..kkt.dense import hdot
from ..pack import Packing
from .options import SolverOptions
from .solver import STEPBACK, IPMResult, _clp, _dot, _norminf, _select, line_search_combined

# regularization-adaptation constants (lib/ipmPDeq_CSsolver.c:313-316);
# the direction-error gate is 1e-9 in float64 and, relative to the
# backward-error scale, 1e-6 in float32
ADDE_MAX = 1e-2
ADDE_MIN = 1e-20
MAX_DIRECTION_ERROR = 1e-9
MAX_DIRECTION_ERROR_F32 = 1e-6
MAX_ADAPT_STEPS = 20


def _derr_tol(dt: torch.dtype) -> float:
    return MAX_DIRECTION_ERROR if dt == torch.float64 else MAX_DIRECTION_ERROR_F32


def _deferred(what: str, item: str = "M13"):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


class EqState(NamedTuple):
    """Solver state; every field has the batch as its leading dimension."""

    z: torch.Tensor       # [u; d; x]
    nu: torch.Tensor      # [P1nu; P1xnu; P2nu; P2xnu]
    lam: torch.Tensor     # [P1lambda; P2lambda]
    mu: torch.Tensor
    addE2: torch.Tensor   # adapted addEye2Hessian2 (equality regularization)
    addE2_next: torch.Tensor
    alphaPrimal: torch.Tensor
    alphaDualIneq: torch.Tensor
    alphaDualEq: torch.Tensor
    status: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor


class EqDirection(NamedTuple):
    dx: torch.Tensor      # [dZ; dNu; dLambda]
    derr: torch.Tensor    # ||WW dx - b||_inf
    FzdZ: torch.Tensor    # (scaled Fz) dZ
    bscale: torch.Tensor  # scale the f32 direction-error gate is relative to


class _EqFns(NamedTuple):
    """Problem callables of one instance: (z, penv) -> tensor."""

    f: Callable   # P1 objective
    g: Callable   # P2 objective
    Fu: Callable
    Fd: Callable
    Gu: Callable
    Gd: Callable
    H: Callable


def scaled_fns(fns: _EqFns, dims, penv, sFu, sFd, sc):
    """Single-instance (Fu, Fd, Fall, Gall, Lf, Lg, stat) at scales
    ``sFu``, ``sFd`` (inequalities) and ``sc`` (cost)."""
    nUu, nD, nX, nFu, nFd, nGu, nGd, nH = dims

    def Fu(z):
        return sFu * fns.Fu(z, penv) if nFu else z.new_zeros(0)

    def Fd(z):
        return sFd * fns.Fd(z, penv) if nFd else z.new_zeros(0)

    def Fall(z):
        return torch.cat([Fu(z), Fd(z)])

    def Gall(z):
        parts = [fns.Gu(z, penv) if nGu else z.new_zeros(0),
                 fns.Gd(z, penv) if nGd else z.new_zeros(0),
                 fns.H(z, penv) if nH else z.new_zeros(0)]
        return torch.cat(parts)

    def Lf(z, nu, lam):
        # P1 Lagrangian (ipmPDeqlat_CS.m:193-208)
        val = sc * fns.f(z, penv)
        if nFu:
            val = val - lam[:nFu] @ Fu(z)
        if nGu:
            val = val + nu[:nGu] @ fns.Gu(z, penv)
        if nH:
            val = val + nu[nGu: nGu + nH] @ fns.H(z, penv)
        return val

    def Lg(z, nu, lam):
        # P2 Lagrangian
        val = sc * fns.g(z, penv)
        if nFd:
            val = val - lam[nFu:] @ Fd(z)
        if nGd:
            val = val + nu[nGu + nH: nGu + nH + nGd] @ fns.Gd(z, penv)
        if nH:
            val = val + nu[nGu + nH + nGd:] @ fns.H(z, penv)
        return val

    def stat(z, nu, lam):
        """Stationarity rows [Lf_u; Lg_d; Lf_x; Lg_x]
        (ipmPDeqlat_CS.m:568-583)."""
        gf = grad(Lf, argnums=0)(z, nu, lam)
        gg = grad(Lg, argnums=0)(z, nu, lam)
        return torch.cat(
            [gf[:nUu], gg[nUu: nUu + nD], gf[nUu + nD:], gg[nUu + nD:]]
        )

    return Fu, Fd, Fall, Gall, Lf, Lg, stat


def batched_exit_metrics(fns: _EqFns, dims, pdims):
    """The exit tests' metrics of a batch, as a function of
    ``(z, nu, lam, penv, sFu, sFd, sc)``; ``pdims`` gives each parameter's
    batch dimension (0) or None where it is shared.  Returns (g, eq, gap,
    min F, min lam, (stationarity rows, F, G)): g sums the four
    stationarity norms (ipmPDeqlat_CS.m:243-246), gap = lam . F."""
    nUu, nD, nX = dims[:3]

    def terms(z, nu, lam, pe, sfu, sfd, sc_):
        _, _, Fall, Gall, Lf, Lg, _ = scaled_fns(fns, dims, pe, sfu, sfd, sc_)
        return (grad(Lf, argnums=0)(z, nu, lam), grad(Lg, argnums=0)(z, nu, lam),
                Fall(z), Gall(z))

    terms_b = vmap(terms, in_dims=(0, 0, 0, pdims, 0, 0, 0))

    def metrics(z, nu, lam, penv, sFu, sFd, sc):
        gf, gg, Fv, Gv = terms_b(z, nu, lam, penv, sFu, sFd, sc)
        g = _norminf(gf[:, :nUu]) + _norminf(gg[:, nUu: nUu + nD])
        if nX:
            g = g + _norminf(gf[:, nUu + nD:])
            g = g + _norminf(gg[:, nUu + nD:])
        sv = torch.cat(
            [gf[:, :nUu], gg[:, nUu: nUu + nD], gf[:, nUu + nD:], gg[:, nUu + nD:]],
            dim=1,
        )
        return (g, _norminf(Gv), _dot(lam, Fv), Fv.amin(dim=1), lam.amin(dim=1),
                (sv, Fv, Gv))

    return metrics


def _sizes(dims):
    nUu, nD, nX, nFu, nFd, nGu, nGd, nH = dims
    nZ = nUu + nD + nX
    nF = nFu + nFd
    nGres = nGu + nGd + nH
    nNu = nGu + nH + nGd + nH
    return nZ, nF, nGres, nNu


def _unit_scales(dims, dt, device=None):
    nFu, nFd = dims[3], dims[4]
    return (torch.ones(nFu, dtype=dt, device=device),
            torch.ones(nFd, dtype=dt, device=device),
            torch.ones((), dtype=dt, device=device))


def equilibrium_certificates(fns: _EqFns, dims, opts: SolverOptions,
                             param_shapes) -> dict:
    """Build-time certificates of iteration-invariant Jacobians
    (equilibrium.py:202-373 of the JAX package), through the structural
    taint analysis of :mod:`tenscalc_tpu_torch.ipm.hoist`.

    ``hoist_S``: the stationarity Jacobians Sz, Sn, Sl are independent
    of the iterate; ``hoist_S_sf``: (Sz, Sn) are also independent of the
    runtime scales; ``hoist_Gz``/``hoist_Fz``: the constraint Jacobians
    are independent of z; ``deps_*``: the parameters each hoisted block's
    values depend on (None when not certified).  ``band_ok``: the blocks
    allow direct banded assembly.

    Each block's Jacobian is traced once, with the iterate and every
    parameter as arguments, and every question about it is a taint query
    on that one graph."""
    from .hoist import TaintGraph, output_independent_of

    nZ, nF, nGres, nNu = _sizes(dims)
    dt = opts.torch_dtype
    keys = sorted(param_shapes)
    pvals = [torch.zeros(param_shapes[k], dtype=dt) for k in keys]
    units = _unit_scales(dims, dt)
    z = torch.zeros(nZ, dtype=dt)
    nu = torch.zeros(nNu, dtype=dt)
    lam = torch.ones(nF, dtype=dt)
    cert = dict(hoist_S=False, hoist_S_sf=False, hoist_Gz=False,
                hoist_Fz=False, deps_S=None, deps_G=None, deps_Sl=None,
                deps_Fz=None, band_ok=False)

    def unit_fns(pv):
        return scaled_fns(fns, dims, dict(zip(keys, pv)), *units)

    def deps(graph, n_iter, outputs):
        """Parameters whose values reach the given outputs."""
        out = set()
        for i, k in enumerate(keys):
            hit = graph.tainted_outputs([n_iter + i])
            if any(hit[j] for j in outputs):
                out.add(k)
        return out

    try:
        gS = TaintGraph(
            lambda z_, nu_, lam_, *pv: tuple(
                jacfwd(unit_fns(pv)[6], argnums=a)(z_, nu_, lam_) for a in (0, 1, 2)
            ),
            z, nu, lam, *pvals,
        )
        cert["hoist_S"] = not any(gS.tainted_outputs([0, 1, 2]))
    except Exception:  # pragma: no cover - non-differentiable corner
        cert["hoist_S"] = False
    if cert["hoist_S"]:
        # (Sz, Sn) additionally independent of the scales?  Scales that
        # are statically constant (scaleInequalities off, scaleCost 0)
        # are not tainted
        t_ineq = bool(opts.scaleInequalities) and nF > 0
        t_cost = opts.scaleCost > 0
        if not (t_ineq or t_cost):
            cert["hoist_S_sf"] = True
        else:
            penv_d = dict(zip(keys, pvals))

            def SzSn(z_, nu_, lam_, *scales):
                sfu, sfd, sc = units
                if t_ineq:
                    sfu, sfd = scales[0], scales[1]
                if t_cost:
                    sc = scales[-1]
                st = scaled_fns(fns, dims, penv_d, sfu, sfd, sc)[6]
                return (jacfwd(st, argnums=0)(z_, nu_, lam_),
                        jacfwd(st, argnums=1)(z_, nu_, lam_))

            scales = (list(units[:2]) if t_ineq else []) + (
                [units[2]] if t_cost else [])
            try:
                cert["hoist_S_sf"] = output_independent_of(
                    SzSn, 3 + len(scales), z, nu, lam, *scales
                )
            except Exception:  # pragma: no cover
                cert["hoist_S_sf"] = False
    if cert["hoist_S_sf"]:
        cert["deps_S"] = deps(gS, 3, (0, 1))
    if nGres:
        try:
            gG = TaintGraph(lambda z_, *pv: jacfwd(unit_fns(pv)[3])(z_), z, *pvals)
            cert["hoist_Gz"] = not any(gG.tainted_outputs([0]))
        except Exception:  # pragma: no cover
            cert["hoist_Gz"] = False
        if cert["hoist_Gz"]:
            cert["deps_G"] = deps(gG, 1, (0,))
    if nF:
        try:
            gF = TaintGraph(lambda z_, *pv: jacfwd(unit_fns(pv)[2])(z_), z, *pvals)
            cert["hoist_Fz"] = not any(gF.tainted_outputs([0]))
        except Exception:  # pragma: no cover
            cert["hoist_Fz"] = False
    # direct banded assembly needs every block of the stacked KKT hoisted;
    # (Sz, Sn) enter the constant band verbatim, so they must also be
    # scale-free; the scales of Sl/Fz are exact row/column scalings
    cert["band_ok"] = bool(
        not opts.smallerNewtonMatrix and nF > 0 and cert["hoist_S"]
        and cert["hoist_S_sf"] and cert["hoist_Fz"]
        and (nGres == 0 or cert["hoist_Gz"])
    )
    if cert["band_ok"]:
        cert["deps_Sl"] = deps(gS, 3, (2,))
        cert["deps_Fz"] = deps(gF, 1, (0,))
    return cert


def dense_equilibrium_kkt(fns: _EqFns, dims, opts: SolverOptions):
    """Single-instance dense assembly of the large stacked KKT matrix
    (the branch the build-time structure probe reads):
    ``[[Sz, Sn, Sl], [Gz, 0, 0], [Fz, 0, diag(F/lam)]]`` plus the
    recovery shift +addE1 on the z block and -addE2 on the dual block."""
    nZ, nF, nGres, nNu = _sizes(dims)

    def assemble(z, nu, lam, penv, sFu, sFd, sc, addE1, addE2):
        dt = z.dtype
        _, _, Fall, Gall, _, _, stat = scaled_fns(fns, dims, penv, sFu, sFd, sc)
        Sz, Sn, Sl = (jacfwd(stat, argnums=a)(z, nu, lam) for a in (0, 1, 2))
        Gz = jacfwd(Gall)(z) if nGres else z.new_zeros(0, nZ)
        Fz = jacfwd(Fall)(z) if nF else z.new_zeros(0, nZ)
        Fv = Fall(z)
        row1 = torch.cat([Sz, Sn, Sl], dim=1)
        row2 = torch.cat([Gz, z.new_zeros(nGres, nNu + nF)], dim=1)
        row3 = torch.cat([Fz, z.new_zeros(nF, nNu), torch.diag(Fv / lam)], dim=1)
        WW = torch.cat([row1, row2, row3], dim=0)
        if opts.addEye2Hessian:
            shift = torch.cat([
                torch.full((nZ,), addE1, dtype=dt),
                torch.full((nNu,), -addE2, dtype=dt),
                torch.zeros(WW.shape[0] - nZ - nNu, dtype=dt),
            ])
            WW = WW + torch.diag(shift)
        return WW

    return assemble


def build_equilibrium_ipm(fns: _EqFns, dims, opts: SolverOptions, kkt_solver,
                          param_shapes, band_plan):
    """Build the batched ``solve`` function of a game.

    ``solve(z0, penv, shared, mu0, max_iter, addE10, addE20)``: ``z0`` is
    (B, nZ); each ``penv`` entry has a leading batch dimension except the
    parameters named in ``shared``, which every instance shares.  The
    build-time certificates (:func:`equilibrium_certificates`, from
    ``param_shapes``) are kept as ``solve.certificates``.

    Band mode: every block of the large stacked KKT is certified
    iteration-invariant, so the only varying pieces are the inequality
    scales (whole rows/columns of the F blocks) and three diagonals
    (addE1, -addE2, F/lam).  The permuted band is then
    ``const_band * g[row] * g[col] + diagonal updates`` and the dense
    matrix is never formed (lib/ipmPDeqlat_CS.m:300-415)."""
    nUu, nD, nX, nFu, nFd, nGu, nGd, nH = dims
    nZ, nF, nGres, nNu = _sizes(dims)
    dt = opts.torch_dtype
    f64 = dt == torch.float64
    if opts.smallerNewtonMatrix:
        raise _deferred("the condensed smallerNewtonMatrix branch of the games")
    if not opts.skipAffine:
        raise _deferred("the Mehrotra large branch of the games (skipAffine=False)")
    if not opts.linesearch_affine_F:
        raise _deferred("the exact-F line search of the games")
    cert = equilibrium_certificates(fns, dims, opts, param_shapes)
    band_mode = band_plan is not None and kkt_solver is not None and cert["band_ok"]
    if not band_mode:
        raise _deferred(
            "a game outside hoisted band mode (per-iteration dense assembly)"
        )
    adapt = opts.addEye2Hessian and opts.adjustAddEye2Hessian
    tol = _derr_tol(dt)
    w_band = int(band_plan.bandwidth)
    perm_np = np.asarray(band_plan.perm)

    def solve(z0: torch.Tensor, penv, shared=frozenset(), mu0: float = 1.0,
              max_iter: Optional[int] = None, addE10: float = 1e-9,
              addE20: float = 1e-9) -> IPMResult:
        max_iter_v = opts.maxIter if max_iter is None else int(max_iter)
        dev = z0.device
        z0 = z0.to(dt)
        B = z0.shape[0]
        pdims = {k: (None if k in shared else 0) for k in penv}
        shapes = {k: tuple(v.shape[0 if k in shared else 1:]) for k, v in penv.items()}
        addE1 = addE10 if opts.addEye2Hessian else 0.0
        addE20 = addE20 if opts.addEye2Hessian else 0.0

        def full(v, dtype=dt):
            return torch.full((B,), v, dtype=dtype, device=dev)

        def raw(fn):
            return vmap(fn, in_dims=(0, pdims))

        # scaling factors, computed once at the initial point
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

        def _Fall(z, pe, sfu, sfd, sc_):
            return scaled_fns(fns, dims, pe, sfu, sfd, sc_)[2](z)

        Fall_b = vmap(_Fall, in_dims=(0, pdims, 0, 0, 0))
        exit_b = batched_exit_metrics(fns, dims, pdims)

        def Fall_at(z):
            return Fall_b(z, penv, sFu, sFd, sc)

        # hoisted blocks at the dummy iterate, unit scales, and the
        # parameters a block does not depend on replaced by zeros: with
        # every remaining dependency shared they carry no batch dimension
        z_d = torch.zeros(nZ, dtype=dt, device=dev)
        nu_d = torch.zeros(nNu, dtype=dt, device=dev)
        lam_d = torch.ones(nF, dtype=dt, device=dev)
        units = _unit_scales(dims, dt, dev)

        def hoisted(fn, deps):
            keep = [k for k in penv if deps is None or k in deps]
            env = {
                k: (penv[k] if k in keep
                    else torch.zeros(shapes[k], dtype=dt, device=dev))
                for k in penv
            }
            if all(k in shared for k in keep):
                return fn(env)
            in_dims = {k: (0 if (k in keep and k not in shared) else None) for k in env}
            return vmap(fn, in_dims=(in_dims,))(env)

        def unit_fns(env):
            return scaled_fns(fns, dims, env, *units)

        Sz, Sn = hoisted(
            lambda env: tuple(jacfwd(unit_fns(env)[6], argnums=a)(z_d, nu_d, lam_d)
                              for a in (0, 1)),
            cert["deps_S"],
        )
        Sl_u = hoisted(
            lambda env: jacfwd(unit_fns(env)[6], argnums=2)(z_d, nu_d, lam_d),
            cert["deps_Sl"],
        )
        Fz_u = hoisted(lambda env: jacfwd(unit_fns(env)[2])(z_d), cert["deps_Fz"])
        if nGres:
            Gz = hoisted(lambda env: jacfwd(unit_fns(env)[3])(z_d), cert["deps_G"])
        else:
            Gz = torch.zeros(0, nZ, dtype=dt, device=dev)

        # the permuted constant band of [[Sz, Sn, Sl_u], [Gz, 0, 0],
        # [Fz_u, 0, 0]] and the masks placing the diagonal updates
        perm = torch.as_tensor(perm_np, device=dev)
        blocks = (Sz, Sn, Sl_u, Gz, Fz_u)
        lead = torch.broadcast_shapes(*(b_.shape[:-2] for b_ in blocks))
        Sz_, Sn_, Sl_, Gz_, Fz_ = (b_.expand(lead + b_.shape[-2:]) for b_ in blocks)
        Wconst = torch.cat([
            torch.cat([Sz_, Sn_, Sl_], dim=-1),
            torch.cat([Gz_, Gz_.new_zeros(lead + (nGres, nNu + nF))], dim=-1),
            torch.cat([Fz_, Fz_.new_zeros(lead + (nF, nNu + nF))], dim=-1),
        ], dim=-2)
        Wp0 = Wconst[..., perm, :][..., :, perm]
        band_const_l = extract_band_lower(Wp0, w_band)
        band_const_u = extract_band_upper(Wp0, w_band)
        m_e1 = (perm < nZ).to(dt)
        m_e2 = ((perm >= nZ) & (perm < nZ + nNu)).to(dt)
        # constant pieces of the row-sum bound
        r1_const = Sz.abs().sum(dim=-1) + Sn.abs().sum(dim=-1)
        absSl = Sl_u.abs()
        r2_const = Gz.abs().sum(dim=-1)
        r3_const = Fz_u.abs().sum(dim=-1)
        ones_notF = torch.ones(B, nZ + nNu, dtype=dt, device=dev)
        zeros_notF = torch.zeros(B, nZ + nNu, dtype=dt, device=dev)

        def assemble(Fv, lam, addE2):
            """BandedOperator of the batch and its row-sum bound."""
            # g = 1 off the F rows/cols, the inequality scales on them
            gp = torch.cat([ones_notF, s_all], dim=1)[:, perm]
            gsh = shifted_cols(gp, w_band)                  # gp[c+i]
            lb = band_const_l * gsh * gp[:, :, None]
            ub = band_const_u * gp[:, :, None] * gsh[:, :, 1:]
            d3 = Fv / lam
            d3p = torch.cat([zeros_notF, d3], dim=1)[:, perm]
            diag_add = addE1 * m_e1 - addE2[:, None] * m_e2 + d3p
            lb[:, :, 0] = lb[:, :, 0] + diag_add
            band = torch.cat([lb, ub], dim=2)
            # the addE1/-addE2 regularization acts on the global diagonal
            shift = torch.cat([
                torch.full((B, nZ), addE1, dtype=dt, device=dev),
                -addE2[:, None] * torch.ones(B, nNu, dtype=dt, device=dev),
                torch.zeros(B, nF, dtype=dt, device=dev),
            ], dim=1)

            def mv(x):
                xz, xn, xf = x[:, :nZ], x[:, nZ: nZ + nNu], x[:, nZ + nNu:]
                r1 = hdot(Sz, xz) + hdot(Sn, xn) + hdot(Sl_u, s_all * xf)
                r2 = hdot(Gz, xz)
                r3 = s_all * hdot(Fz_u, xz) + d3 * xf
                return torch.cat([r1, r2, r3], dim=1) + shift * x

            # row-sum upper bound max_r sum_c |WW[r, c]| through the
            # constituents (the f32 backward-error scale)
            r1_ub = r1_const + hdot(absSl, s_all) + abs(addE1)
            r2_ub = r2_const + addE2.abs()[:, None]
            r3_ub = s_all * r3_const + d3.abs()
            rowsum_ub = torch.cat(
                [r1_ub.expand(B, -1), r2_ub.expand(B, -1), r3_ub], dim=1
            ).amax(dim=1)
            return BandedOperator(band, perm, mv), rowsum_ub

        def compute_direction(mu, lam, addE2, cached) -> EqDirection:
            sv, Fv, Gv = cached
            op, rowsum_ub = assemble(Fv, lam, addE2)
            fac = kkt_solver(op)
            b = torch.cat([-sv, -Gv, -Fv + mu[:, None] / lam], dim=1)
            dx = fac.solve(b)
            derr = _norminf(op.matvec(dx) - b)
            if f64:
                bscale = torch.ones_like(mu)
            else:
                bscale = torch.clamp(
                    rowsum_ub * _norminf(dx) + _norminf(b), min=1.0
                )
            FzdZ = s_all * hdot(Fz_u, dx[:, :nZ])
            return EqDirection(dx, derr, FzdZ, bscale)

        def exit_metrics(st: EqState):
            return exit_b(st.z, st.nu, st.lam, penv, sFu, sFd, sc)

        def adapt_directions(mu, lam, addE2, cached, run):
            """The reference solver's adjust loop (ipmPDeq_CSsolver.c:
            330-374): solve at least once; while an instance's direction
            error exceeds the gate, double its addE2 and re-solve, as long
            as the re-solves keep halving the error (f32) and at most
            MAX_ADAPT_STEPS times.  Returns (direction, addE2)."""
            k = torch.zeros(B, dtype=torch.int32, device=dev)
            aE = addE2
            derr_prev = full(math.inf)
            need = run.clone()
            dirn = None
            while bool(need.any()):
                aE2 = torch.where(
                    k == 0, aE,
                    torch.clamp(2.0 * torch.clamp(aE, min=ADDE_MIN), max=ADDE_MAX),
                )
                d = compute_direction(mu, lam, aE2, cached)
                if dirn is None:
                    dirn = d
                else:
                    derr_prev = torch.where(need, dirn.derr, derr_prev)
                    dirn = _select(need, d, dirn)
                aE = torch.where(need, aE2, aE)
                k = torch.where(need, k + 1, k)
                # NaN-safe: a NaN direction error counts as bad
                bad = ~(dirn.derr < tol * dirn.bscale) & (aE < ADDE_MAX)
                if f64:
                    improving = torch.ones_like(need)
                else:
                    improving = (k <= 1) | (dirn.derr < 0.5 * derr_prev)
                need = need & bad & improving & (k <= MAX_ADAPT_STEPS)
            return dirn, aE

        def iterate(st: EqState, g, eq, gap, cached, run) -> EqState:
            z, nu, lam, mu, addE2 = st.z, st.nu, st.lam, st.mu, st.addE2
            _, Fv, _ = cached
            if not adapt:
                dirn = compute_direction(mu, lam, addE2, cached)
                addE2_next = addE2
            else:
                dirn, addE2 = adapt_directions(mu, lam, addE2, cached, run)
                addE2_next = torch.where(
                    (dirn.derr < tol * dirn.bscale) & (addE2 > ADDE_MIN),
                    torch.clamp(0.75 * addE2, min=ADDE_MIN), addE2,
                )
            dx, FzdZ = dirn.dx, dirn.FzdZ
            dZ, dNu, dLam = dx[:, :nZ], dx[:, nZ: nZ + nNu], dx[:, nZ + nNu:]
            nan_fail = torch.isnan(dx).any(dim=1)
            maxAlphaP = _clp(Fv, FzdZ)
            maxAlphaDI = _clp(lam, dLam)
            alphaP = maxAlphaP
            if opts.coupledAlphas:
                alphaP = torch.minimum(alphaP, maxAlphaDI)
            alpha_bt = torch.clamp(alphaP * STEPBACK, max=opts.alphaMax)

            # F is affine in z (certified): min F(z + a dZ) = min(F + a Fz dZ),
            # formed with one rounding as XLA fuses it
            def minF(alpha):
                return torch.addcmul(
                    Fv[:, None, :], alpha[:, :, None], FzdZ[:, None, :]
                ).amin(-1)

            alphaPrimal, nan2 = line_search_combined(minF, alpha_bt, opts)
            nan_fail = nan_fail | nan2
            if opts.coupledAlphas:
                alphaDualIneq = alphaDualEq = alphaPrimal
            else:
                alphaDualIneq = torch.minimum(maxAlphaDI * STEPBACK, alpha_bt)
                alphaDualEq = alphaDualIneq
            new_z = torch.addcmul(z, alphaPrimal[:, None], dZ)
            new_nu = torch.addcmul(nu, alphaDualEq[:, None], dNu)
            new_lam = torch.addcmul(lam, alphaDualIneq[:, None], dLam)

            # mu schedule (lib/ipmPDeq_CSsolver.c, skipAffine branch)
            th_grad = g < max(1e-6, opts.gradTolerance)
            th_eq = (
                torch.ones_like(run) if nGres == 0
                else eq < max(1e-5, opts.equalTolerance)
            )
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
            new_lam = torch.where(
                tiny[:, None], mu_tiny[:, None] / Fall_at(new_z), new_lam
            )
            stalled = (
                (alphaPrimal < opts.alphaMin)
                & (alphaDualIneq < opts.alphaMin)
                & (alphaDualEq < opts.alphaMin)
            )
            new_mu = torch.where(
                stalled,
                torch.maximum(new_mu / opts.muFactorConservative ** 2, mu_min),
                new_mu,
            )
            keep = nan_fail[:, None]
            return EqState(
                z=torch.where(keep, z, new_z),
                nu=torch.where(keep, nu, new_nu),
                lam=torch.where(keep, lam, new_lam),
                mu=new_mu, addE2=addE2, addE2_next=addE2_next,
                alphaPrimal=alphaPrimal, alphaDualIneq=alphaDualIneq,
                alphaDualEq=alphaDualEq,
                status=torch.where(nan_fail, 4, 0).to(torch.int32),
                it=st.it, done=nan_fail,
            )

        def step(st: EqState) -> EqState:
            it = st.it + 1
            addE2 = st.addE2_next  # delayed update (ipmPDeq_CSsolver.c:318-329)
            g, eq, gap, ineq, dual, cached = exit_metrics(st)
            status = torch.zeros(B, dtype=torch.int32, device=dev)
            fail_maxiter = it > max_iter_v
            status = torch.where(fail_maxiter, 8, status)
            fail_nan = torch.isnan(g)
            status = torch.where(fail_nan & (status == 0), 4, status)
            fail_ineq = ineq <= 0
            status = torch.where(fail_ineq & (status == 0), 1, status)
            fail_dual = dual <= 0
            status = torch.where(fail_dual & (status == 0), 2, status)
            converged = (g <= opts.gradTolerance) & (gap <= desired_gap)
            if nGres:
                converged &= eq <= opts.equalTolerance
            early = fail_maxiter | fail_nan | fail_ineq | fail_dual | converged
            stop = st._replace(
                it=it, addE2=addE2, addE2_next=addE2,
                status=status.to(torch.int32), done=torch.ones_like(st.done),
            )
            run = ~st.done & ~early
            if bool(run.any()):
                new = iterate(st._replace(it=it, addE2=addE2), g, eq, gap, cached, run)
                stop = _select(run, new, stop)
            return _select(st.done, st, stop)

        lam0 = mu0_t / Fall_at(z0)
        st = EqState(
            z=z0, nu=torch.ones(B, nNu, dtype=dt, device=dev), lam=lam0,
            mu=full(mu0), addE2=full(addE20), addE2_next=full(addE20),
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
        if nGres:
            status = add_flag(eq > opts.equalTolerance, 32, status)
        status = add_flag(gap > desired_gap, 64, status)
        status = add_flag(st.mu > mu_min, 128, status)
        aP, aDI, aDE = st.alphaPrimal, st.alphaDualIneq, st.alphaDualEq
        negl = (aP <= opts.alphaMin) & (aDI < opts.alphaMin) & (aDE < opts.alphaMin)
        small_a = (aP <= 0.1) & (aDI < 0.1) & (aDE < 0.1)
        med_a = (aP <= 0.5) & (aDI < 0.5) & (aDE < 0.5)
        status = add_flag(negl, 1792, status)
        status = add_flag(~negl & small_a, 1536, status)
        status = add_flag(~negl & ~small_a & med_a, 1024, status)

        return IPMResult(
            u=st.z, nu=st.nu, lam=st.lam, mu=st.mu, status=status,
            iters=st.it, norminf_grad=g, norminf_eq=eq, gap=gap,
            f=raw(fns.f)(st.z, penv), addU=full(addE1), addEq=st.addE2,
            scale_ineq=s_all, scale_cost=sc,
        )

    solve.band_mode = "hoisted"
    solve.certificates = cert
    return solve


def _game_functions(P1objective, P2objective, p1_vars, p2_vars, lat_vars,
                    P1constraints, P2constraints, latentConstraints,
                    parameters, dt):
    """(fns, dims, packing) of a game; ``packing`` covers z = [u; d; x]."""
    from ..api import _split_constraints

    Fu_e, Gu_e = _split_constraints(P1constraints)
    Fd_e, Gd_e = _split_constraints(P2constraints)
    H_ineq, H_e = [], []
    for c in latentConstraints:
        if not isinstance(c, Constraint):
            raise TypeError("latentConstraints must be Constraint objects")
        (H_ineq if c.kind == "ineq" else H_e).append(c.expr)
    if H_ineq:
        raise ValueError(
            "latentConstraints must be equality constraints "
            "(reference: parseConstraints with err on inequalities)"
        )
    packing = Packing(list(p1_vars) + list(p2_vars) + list(lat_vars))
    dims = (
        Packing(p1_vars).total, Packing(p2_vars).total, Packing(lat_vars).total,
        int(sum(e.size for e in Fu_e)), int(sum(e.size for e in Fd_e)),
        int(sum(e.size for e in Gu_e)), int(sum(e.size for e in Gd_e)),
        int(sum(e.size for e in H_e)),
    )
    nH, nX = dims[7], dims[2]
    if nH != nX:
        raise ValueError(
            "equilibrium KKT system is not square: need "
            "#latentConstraints == #latentVariables "
            f"(nH={nH}, nX={nX})"
        )
    known = {p.name for p in parameters} | set(packing.names)
    for e in [P1objective, P2objective] + Fu_e + Gu_e + Fd_e + Gd_e + H_e:
        extra = e.deps - known
        if extra:
            raise ValueError(
                f"expression depends on undeclared symbols {sorted(extra)}; "
                "declare them as parameters or optimization variables"
            )

    def env_of(z, penv):
        return {**penv, **packing.unpack(z)}

    def mk_scalar(expr):
        def fn(z, penv):
            return expr(env_of(z, penv)).to(dt).reshape(())

        return fn

    def mk_stack(exprs):
        def fn(z, penv):
            if not exprs:
                return z.new_zeros(0)
            env = env_of(z, penv)
            # a copy, as api.py's stack: a cast in place keeps a float64 tangent
            return torch.cat([torch.ravel(e(env)) for e in exprs]).to(dt, copy=True)

        return fn

    fns = _EqFns(
        f=mk_scalar(P1objective), g=mk_scalar(P2objective),
        Fu=mk_stack(Fu_e), Fd=mk_stack(Fd_e), Gu=mk_stack(Gu_e),
        Gd=mk_stack(Gd_e), H=mk_stack(H_e),
    )
    return fns, dims, packing


class EquilibriumSolver(SolverBase):
    """Two-player equilibrium solver (reference:
    cmex2equilibriumLatentCS / class2equilibriumLatentCS).  It runs on
    the card (``device=None``) unless the caller asks for the CPU."""

    def __init__(
        self,
        P1objective: Expr,
        P2objective: Expr,
        P1optimizationVariables: Sequence[Variable],
        P2optimizationVariables: Sequence[Variable],
        latentVariables: Sequence[Variable] = (),
        P1constraints: Sequence[Constraint] = (),
        P2constraints: Sequence[Constraint] = (),
        latentConstraints: Sequence[Constraint] = (),
        parameters: Sequence[Variable] = (),
        outputExpressions: Optional[Mapping[str, Expr]] = None,
        options: Optional[SolverOptions] = None,
        device=None,
        **option_kwargs,
    ):
        from ..kkt.select import compute_banded_plan, select_game_backend

        # 'variant' concerns the optimize solver only
        self.opts = (
            (options or SolverOptions())
            .replace(**{"variant": "standard", **option_kwargs})
            .resolved("equilibrium")
        )
        self.device = resolve_device(device)
        full_precision_matmul()
        dt = self.opts.torch_dtype
        self.p1_vars = list(P1optimizationVariables)
        self.p2_vars = list(P2optimizationVariables)
        self.lat_vars = list(latentVariables)
        self.variables = self.p1_vars + self.p2_vars + self.lat_vars
        self.parameters = list(parameters)
        self.outputExpressions = dict(outputExpressions or {})
        self._fns, self._ipm_dims, self.packing = _game_functions(
            P1objective, P2objective, self.p1_vars, self.p2_vars,
            self.lat_vars, P1constraints, P2constraints, latentConstraints,
            self.parameters, dt,
        )
        nZ, nF, nGres, nNu = _sizes(self._ipm_dims)
        nK = nZ + nNu + nF
        kkt_solver, name, plan = select_game_backend(
            self.opts, nK, lambda: compute_banded_plan(self._probe_assemble, nK),
            symmetric=False,
        )
        self.kkt_plan = plan
        self.kkt_backend_resolved = name
        self._solve_raw = build_equilibrium_ipm(
            self._fns, self._ipm_dims, self.opts, kkt_solver,
            {p.name: p.shape for p in self.parameters}, plan,
        )
        self.certificates = self._solve_raw.certificates

    def _probe_assemble(self, trial: int):
        """Random-iterate dense KKT assembly for the structure probe."""
        dt = self.opts.torch_dtype
        dims = self._ipm_dims
        nZ, nF, nGres, nNu = _sizes(dims)
        rng = np.random.default_rng(trial)
        penv = {
            p.name: torch.as_tensor(rng.standard_normal(p.shape), dtype=dt)
            for p in self.parameters
        }
        z = torch.as_tensor(rng.standard_normal(nZ), dtype=dt)
        lam = torch.as_tensor(rng.uniform(0.5, 1.5, nF), dtype=dt)
        nu = torch.as_tensor(rng.standard_normal(nNu), dtype=dt)
        WW = dense_equilibrium_kkt(self._fns, dims, self.opts)(
            z, nu, lam, penv, *_unit_scales(dims, dt), 1e-3, 1e-3,
        )
        return WW.numpy()

    def solve_many(self, parameters: Mapping[str, Any],
                   inits: Optional[Mapping[str, Any]] = None,
                   mu0: float = 1.0, max_iter: Optional[int] = None) -> IPMResult:
        """A fleet: a parameter passed in its declared shape is shared,
        any other carries a leading batch dimension; inits cover the P1,
        P2 and latent variables.  Returns the batched IPMResult."""
        from ..interop import fleet_from_numpy

        penv, shared, z0 = fleet_from_numpy(
            self, parameters, inits, self.device, self.opts.torch_dtype
        )
        return self._solve_raw(z0, penv, shared, mu0, max_iter, 1e-9, 1e-9)

    def exit_metrics(self, parameters: Mapping[str, Any], res: IPMResult) -> dict:
        """The exit tests' metrics of a fleet result ``res`` (from
        :meth:`solve_many` with the same ``parameters``, on any device),
        evaluated again on this solver's device from its final (z, nu,
        lam) and scales: stationarity ``g``, equality ``eq``, ``gap``,
        ``min_F`` and ``min_lam``."""
        from ..interop import fleet_from_numpy

        dt, dev = self.opts.torch_dtype, self.device
        penv, shared, _ = fleet_from_numpy(self, parameters, None, dev, dt)
        pdims = {k: (None if k in shared else 0) for k in penv}
        z, nu, lam, s_all, sc = (
            t.to(dev, dt) for t in (res.u, res.nu, res.lam, res.scale_ineq, res.scale_cost)
        )
        nFu = self._ipm_dims[3]
        g, eq, gap, min_F, min_lam, _ = batched_exit_metrics(
            self._fns, self._ipm_dims, pdims
        )(z, nu, lam, penv, s_all[:, :nFu], s_all[:, nFu:], sc)
        return {"g": g, "eq": eq, "gap": gap, "min_F": min_F, "min_lam": min_lam}

    def solve(self, parameters: Optional[Mapping[str, Any]] = None,
              init: Optional[Mapping[str, Any]] = None, mu0: float = 1.0,
              max_iter: Optional[int] = None):
        """One instance: the fleet path at B = 1, every parameter shared."""
        penv = self._param_env(parameters)
        z0 = self._pack_init(init)[None]
        t0 = time.perf_counter()
        res = self._solve_raw(z0, penv, frozenset(penv), mu0, max_iter, 1e-9, 1e-9)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._make_solution(res, penv, time.perf_counter() - t0)
