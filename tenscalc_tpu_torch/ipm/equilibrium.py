"""Primal-dual IPM for two-player Nash equilibria with shared latent
variables, over an explicit batch dimension (port of
``tenscalc_tpu/ipm/equilibrium.py``):

    P1:  min_{u,x} f(u,d,x)   s.t. Fu >= 0, Gu == 0, H == 0
    P2:  min_{d,x} g(u,d,x)   s.t. Fd >= 0, Gd == 0, H == 0

Each player optimizes over its own variables and the shared latent x,
subject to the shared latent equalities H (each player has its own
multiplier for H).  The stacked first-order system is unsymmetric (two
Lagrangians share rows), so it is factored by the fleet banded LU.

Band mode ('hoisted', the MPC-MHE fleet): the large stacked Newton
matrix, its Jacobians certified iteration-invariant at build time,
assembled straight into permuted band storage and factored by K9/K10.
Outside it the KKT is assembled densely at every iterate, large or
condensed (``smallerNewtonMatrix``), and factored by the fleet banded LU
of a banded plan (K9/K10 on the card), the block-tridiagonal LU
(``'tridiag'``) or the dense pivoted LU (``'dense'``, small or unbanded
games).  Both take the ``skipAffine`` step or Mehrotra's, the
``addEye2Hessian2`` adaptation loop with the relative float32
direction-error gate and the progress guard, the combined line search
(with F exact at the trial points unless it is certified affine), the mu
schedule, the exit tests and final status flags.  As in
``ipm/solver.py``, the JAX package's ``vmap`` of a ``lax.while_loop``
becomes Python loops over a leading batch dimension B with per-instance
masks, and a single solve is B = 1 through the same code.
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
from ..kkt.dense import hdot, kkt_factorize
from ..pack import Packing
from .options import SolverOptions
from .solver import (
    STEPBACK,
    IPMResult,
    _clp,
    _dot,
    _norminf,
    _rough_solve,
    _select,
    line_search_affine,
    line_search_combined,
)

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
    mu: torch.Tensor      # mu after the Mehrotra centering (else unchanged)


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
        if Fv.shape[1]:
            ineq, dual = Fv.amin(dim=1), lam.amin(dim=1)
        else:
            ineq = dual = torch.full_like(g, math.inf)
        return g, _norminf(Gv), _dot(lam, Fv), ineq, dual, (sv, Fv, Gv)

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

    The blocks are traced once, in one graph, with the iterate, the
    scales and every parameter as arguments (each block's Jacobian by its
    own forward pass, so each is its own node), and every question about
    them is a taint query on that graph."""
    from .hoist import TaintGraph

    nZ, nF, nGres, nNu = _sizes(dims)
    dt = opts.torch_dtype
    keys = sorted(param_shapes)
    pvals = [torch.zeros(param_shapes[k], dtype=dt) for k in keys]
    cert = dict(hoist_S=False, hoist_S_sf=False, hoist_Gz=False,
                hoist_Fz=False, deps_S=None, deps_G=None, deps_Sl=None,
                deps_Fz=None, band_ok=False)

    def blocks(z_, nu_, lam_, sfu, sfd, sc, *pv):
        fs = scaled_fns(fns, dims, dict(zip(keys, pv)), sfu, sfd, sc)
        S = tuple(jacfwd(fs[6], argnums=a)(z_, nu_, lam_) for a in (0, 1, 2))
        Gz = jacfwd(fs[3])(z_) if nGres else z_.new_zeros(0, nZ)
        Fz = jacfwd(fs[2])(z_) if nF else z_.new_zeros(0, nZ)
        return (*S, Gz, Fz)  # outputs 0 Sz, 1 Sn, 2 Sl, 3 Gz, 4 Fz

    try:
        graph = TaintGraph(blocks, torch.zeros(nZ, dtype=dt), torch.zeros(nNu, dtype=dt),
                           torch.ones(nF, dtype=dt), *_unit_scales(dims, dt), *pvals)
    except Exception:  # pragma: no cover - non-differentiable corner
        return cert

    def tainted(args, outputs):
        hit = graph.tainted_outputs(args)
        return any(hit[j] for j in outputs)

    def deps(outputs):
        """Parameters whose values reach the given outputs."""
        return {k for i, k in enumerate(keys) if tainted([6 + i], outputs)}

    cert["hoist_S"] = not tainted([0, 1, 2], (0, 1, 2))
    if cert["hoist_S"]:
        # (Sz, Sn) also independent of the scales?  Scales that are
        # statically constant (scaleInequalities off, scaleCost 0) do
        # not count
        scales = ([3, 4] if opts.scaleInequalities and nF > 0 else []) + (
            [5] if opts.scaleCost > 0 else [])
        cert["hoist_S_sf"] = not scales or not tainted(scales, (0, 1))
    if cert["hoist_S_sf"]:
        cert["deps_S"] = deps((0, 1))
    if nGres:
        cert["hoist_Gz"] = not tainted([0], (3,))
        if cert["hoist_Gz"]:
            cert["deps_G"] = deps((3,))
    if nF:
        cert["hoist_Fz"] = not tainted([0], (4,))
    # direct banded assembly needs every block of the stacked KKT hoisted;
    # (Sz, Sn) enter the constant band verbatim, so they must also be
    # scale-free; the scales of Sl/Fz are exact row/column scalings
    cert["band_ok"] = bool(
        not opts.smallerNewtonMatrix and nF > 0 and cert["hoist_S"]
        and cert["hoist_S_sf"] and cert["hoist_Fz"]
        and (nGres == 0 or cert["hoist_Gz"])
    )
    if cert["band_ok"]:
        cert["deps_Sl"] = deps((2,))
        cert["deps_Fz"] = deps((4,))
    return cert


def _eq_pairs(dims):
    """Rows of the equality residual [Gu; Gd; H] and the multiplier columns
    paired with them (Gu <-> P1nu, Gd <-> P2nu, H <-> P1xnu): where the
    condensed matrix carries -addE2 (equilibrium.py:187-200 of the JAX
    package)."""
    nGu, nGd, nH = dims[5], dims[6], dims[7]
    rows = np.concatenate([np.arange(nGu), nGu + np.arange(nGd), nGu + nGd + np.arange(nH)])
    cols = np.concatenate([np.arange(nGu), nGu + nH + np.arange(nGd), nGu + np.arange(nH)])
    return rows.astype(np.int64), cols.astype(np.int64)


def equilibrium_derivatives(fns: _EqFns, dims):
    """Single-instance Jacobians of the stacked first-order system:
    ``derivs(z, nu, lam, penv, sFu, sFd, sc, pre)`` -> (Sz, Sn, Sl, Gz,
    Fz), the stationarity rows' Jacobians in z, nu and lambda and the
    constraint Jacobians, each taken from ``pre`` when it holds the block
    (a hoisted, iteration-invariant one), else formed at z."""
    nZ, nF, nGres, _ = _sizes(dims)

    def derivs(z, nu, lam, penv, sFu, sFd, sc, pre):
        _, _, Fall, Gall, _, _, stat = scaled_fns(fns, dims, penv, sFu, sFd, sc)
        if "Sz" in pre:
            Sz, Sn, Sl = pre["Sz"], pre["Sn"], pre["Sl"]
        else:
            Sz, Sn, Sl = jacfwd(stat, argnums=(0, 1, 2))(z, nu, lam)
        Gz = pre.get("Gz")
        if Gz is None:
            Gz = jacfwd(Gall)(z) if nGres else z.new_zeros(0, nZ)
        Fz = pre.get("Fz")
        if Fz is None:
            Fz = jacfwd(Fall)(z) if nF else z.new_zeros(0, nZ)
        return Sz, Sn, Sl, Gz, Fz

    return derivs


def _diag_shift(nZ, nNu, nF, addE1, addE2):
    """(B, nK) diagonal of the recovery regularization: +addE1 on z,
    -addE2 on the multipliers, 0 on the F block."""
    B = addE2.shape[0]
    return torch.cat([
        addE2.new_full((B, nZ), addE1), -addE2[:, None].expand(B, nNu),
        addE2.new_zeros(B, nF),
    ], dim=1)


def large_kkt(dims, Sz, Sn, Sl, Gz, Fz, d3):
    """The large stacked matrices (B, nK, nK) ``[[Sz, Sn, Sl], [Gz, 0, 0],
    [Fz, 0, diag(d3)]]`` without the regularization; a block without a
    batch dimension is shared."""
    _, nF, nGres, nNu = _sizes(dims)
    B = d3.shape[0]

    def bt(x):
        return x.expand((B,) + x.shape[-2:])

    return torch.cat([
        torch.cat([bt(Sz), bt(Sn), bt(Sl)], dim=2),
        torch.cat([bt(Gz), d3.new_zeros(B, nGres, nNu + nF)], dim=2),
        torch.cat([bt(Fz), d3.new_zeros(B, nF, nNu), torch.diag_embed(d3)], dim=2),
    ], dim=1)


def condensed_kkt(dims, Sz, Sn, Sl, Gz, LFF, addE1, addE2, regularize: bool):
    """The condensed matrices (B, nZ + nNu, nZ + nNu) with dLambda
    eliminated (ipmPDeqlat_CS.m:300-415, small-matrix branch):
    ``[[Sz - Sl LFF + addE1 I, Sn], [Gz, -addE2 at the paired entries]]``;
    addE1 on the leading nZ diagonal entries of the (nS, nZ) block."""
    nZ, _, nGres, nNu = _sizes(dims)
    B = LFF.shape[0]
    top_left = Sz - torch.matmul(Sl, LFF)
    if regularize:
        didx = torch.arange(nZ, device=LFF.device)
        top_left[:, didx, didx] += addE1
    dual = LFF.new_zeros(B, nGres, nNu)
    if regularize and nGres:
        rows, cols = _eq_pairs(dims)
        dual[:, rows, cols] += -addE2[:, None]
    return torch.cat([
        torch.cat([top_left, Sn.expand((B,) + Sn.shape[-2:])], dim=2),
        torch.cat([Gz.expand((B,) + Gz.shape[-2:]), dual], dim=2),
    ], dim=1)


def dense_equilibrium_kkt(fns: _EqFns, dims, opts: SolverOptions):
    """Single-instance dense assembly of the KKT matrix the solver
    factors (the build-time structure probe reads it): the large stacked
    ``[[Sz, Sn, Sl], [Gz, 0, 0], [Fz, 0, diag(F/lam)]]`` plus the recovery
    shift +addE1 on the z block and -addE2 on the dual block, or with
    ``smallerNewtonMatrix`` (and inequalities) the condensed matrix."""
    nZ, nF, _, nNu = _sizes(dims)
    derivs = equilibrium_derivatives(fns, dims)

    def assemble(z, nu, lam, penv, sFu, sFd, sc, addE1, addE2):
        Sz, Sn, Sl, Gz, Fz = derivs(z, nu, lam, penv, sFu, sFd, sc, {})
        Fv = scaled_fns(fns, dims, penv, sFu, sFd, sc)[2](z)
        aE2 = torch.full((1,), addE2, dtype=z.dtype)
        if opts.smallerNewtonMatrix and nF:
            LFF = (lam / Fv)[:, None] * Fz
            return condensed_kkt(dims, Sz, Sn, Sl, Gz, LFF[None], addE1, aE2,
                                 bool(opts.addEye2Hessian))[0]
        WW = large_kkt(dims, Sz, Sn, Sl, Gz, Fz, (Fv / lam)[None])
        if opts.addEye2Hessian:
            WW = WW + torch.diag_embed(_diag_shift(nZ, nNu, nF, addE1, aE2))
        return WW[0]

    return assemble


def build_equilibrium_ipm(fns: _EqFns, dims, opts: SolverOptions, kkt_solver,
                          param_shapes, band_plan):
    """Build the batched ``solve`` function of a game.

    ``solve(z0, penv, shared, mu0, max_iter, addE10, addE20)``: ``z0`` is
    (B, nZ); each ``penv`` entry has a leading batch dimension except the
    parameters named in ``shared``, which every instance shares.  The
    build-time certificates (:func:`equilibrium_certificates`, from
    ``param_shapes``) are kept as ``solve.certificates``.

    Band mode ('hoisted'): every block of the large stacked KKT is
    certified iteration-invariant, so the only varying pieces are the
    inequality scales (whole rows/columns of the F blocks) and three
    diagonals (addE1, -addE2, F/lam).  The permuted band is then
    ``const_band * g[row] * g[col] + diagonal updates`` and the dense
    matrix is never formed (lib/ipmPDeqlat_CS.m:300-415).

    Outside band mode (``solve.band_mode`` None) the KKT is assembled
    densely at every iterate, large or condensed (``smallerNewtonMatrix``),
    from the Jacobians not certified invariant (formed at the iterate) and
    the hoisted ones (formed once a solve), and handed to ``kkt_solver``
    (the fleet banded LU or the block-tridiagonal LU of a banded plan),
    or, without one, to the dense pivoted LU.  The step is ``skipAffine``'s
    or Mehrotra's; the line search evaluates F at the trial points unless
    F is certified affine in z."""
    nFu, nFd = dims[3], dims[4]
    nZ, nF, nGres, nNu = _sizes(dims)
    dt = opts.torch_dtype
    f64 = dt == torch.float64
    cert = equilibrium_certificates(fns, dims, opts, param_shapes)
    band_mode = band_plan is not None and kkt_solver is not None and cert["band_ok"]
    small = bool(opts.smallerNewtonMatrix) and nF > 0
    mehrotra = not opts.skipAffine
    F_affine = nF > 0 and cert["hoist_Fz"] and opts.linesearch_affine_F
    regularize = bool(opts.addEye2Hessian)
    adapt = opts.addEye2Hessian and opts.adjustAddEye2Hessian
    tol = _derr_tol(dt)
    derivs = equilibrium_derivatives(fns, dims)

    def factor(WW):
        if kkt_solver is not None:
            return kkt_solver(WW)
        # unsymmetric system: pivoted LU (the reference's useLDL=false)
        return kkt_factorize(WW, need_inertia=False)

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

        def Fall_trials(z, alpha, dZ):
            """(B, C) min F at the trial points z + alpha dZ, each formed
            with one rounding as XLA fuses it."""
            zc = torch.addcmul(z[:, None, :], alpha[:, :, None], dZ[:, None, :])
            return vmap(
                lambda zz, pe, sfu, sfd, sc_: vmap(
                    scaled_fns(fns, dims, pe, sfu, sfd, sc_)[2])(zz),
                in_dims=(0, pdims, 0, 0, 0),
            )(zc, penv, sFu, sFd, sc).amin(-1)

        # hoisted blocks at the dummy iterate (value-equal by certificate)
        z_d = torch.zeros(nZ, dtype=dt, device=dev)
        nu_d = torch.zeros(nNu, dtype=dt, device=dev)
        lam_d = torch.ones(nF, dtype=dt, device=dev)
        units = _unit_scales(dims, dt, dev)

        def hoisted(fn, deps):
            """``fn`` of a parameter env at unit scales, with the parameters
            a block does not depend on replaced by zeros: with every
            remaining dependency shared it carries no batch dimension."""
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

        def hoisted_scaled(fn):
            """``fn`` of the instance's functions at its runtime scales and
            full parameters (per instance)."""
            return vmap(lambda pe, sfu, sfd, sc_: fn(scaled_fns(fns, dims, pe, sfu, sfd, sc_)),
                        in_dims=(pdims, 0, 0, 0))(penv, sFu, sFd, sc)

        def unit_fns(env):
            return scaled_fns(fns, dims, env, *units)

        pre = {}
        if cert["hoist_S"]:
            if cert["hoist_S_sf"]:
                pre["Sz"], pre["Sn"] = hoisted(
                    lambda env: jacfwd(unit_fns(env)[6], argnums=(0, 1))(z_d, nu_d, lam_d),
                    cert["deps_S"],
                )
            else:
                pre["Sz"], pre["Sn"] = hoisted_scaled(
                    lambda fs: jacfwd(fs[6], argnums=(0, 1))(z_d, nu_d, lam_d))
            if not band_mode:
                pre["Sl"] = hoisted_scaled(lambda fs: jacfwd(fs[6], argnums=2)(z_d, nu_d, lam_d))
        if cert["hoist_Gz"] and nGres:
            pre["Gz"] = hoisted(lambda env: jacfwd(unit_fns(env)[3])(z_d), cert["deps_G"])
        if cert["hoist_Fz"] and nF and not band_mode:
            pre["Fz"] = hoisted_scaled(lambda fs: jacfwd(fs[2])(z_d))

        if band_mode:
            band_op, band_fz_mv = _band_assembly(dims, pre, hoisted, unit_fns, cert, band_plan, s_all,
                                     addE1, z_d, nu_d, lam_d, B)
        else:
            pre_dims = {k: (0 if v.dim() == 3 else None) for k, v in pre.items()}
            derivs_b = vmap(derivs, in_dims=(0, 0, 0, pdims, 0, 0, 0, pre_dims))

        def linearize(z, nu, lam, cached):
            """What every direction of an iteration shares: the band
            assembler, or the dense KKT without its regularization and the
            constraint Jacobian Fz (condensed: also Sl and LFF)."""
            if band_mode:
                return None
            _, Fv, _ = cached
            Sz, Sn, Sl, Gz, Fz = derivs_b(z, nu, lam, penv, sFu, sFd, sc, pre)
            Fz = Fz.expand((B,) + Fz.shape[-2:])
            if small:
                LFF = (lam / Fv)[:, :, None] * Fz
                Sl = Sl.expand((B,) + Sl.shape[-2:])
                return dict(parts=(Sz, Sn, Sl, Gz, LFF), Sl=Sl, Fz=Fz, LFF=LFF)
            return dict(WW0=large_kkt(dims, Sz, Sn, Sl, Gz, Fz, Fv / lam), Fz=Fz)

        def mehrotra_mu(z, lam, mu, Fv, Gv, dZ_a, dLam_a, FzdZ_a):
            """The affine step's centering: mu from sigma = rho^delta
            (ipmPDeqlat_CS.m:660-716), with F at the affine step exact or,
            F certified affine, through Fz dZ."""
            maxAlphaP_a = _clp(Fv, FzdZ_a)
            maxAlphaDI_a = _clp(lam, dLam_a)
            aMax = torch.minimum(torch.clamp(maxAlphaP_a, max=opts.alphaMax), maxAlphaDI_a)
            if F_affine:
                def minF_a(alpha):
                    return torch.addcmul(
                        Fv[:, None, :], alpha[:, :, None], FzdZ_a[:, None, :]).amin(-1)
            else:
                def minF_a(alpha):
                    return Fall_trials(z, alpha, dZ_a)
            alpha_a = line_search_affine(minF_a, aMax, opts)
            if F_affine:
                newF_a = torch.addcmul(Fv, alpha_a[:, None], FzdZ_a)
            else:
                newF_a = Fall_at(torch.addcmul(z, alpha_a[:, None], dZ_a))
            newLam_a = torch.addcmul(lam, alpha_a[:, None], dLam_a)
            gap_now = _dot(lam, Fv)
            rho = _dot(newF_a, newLam_a) / gap_now
            sigma = torch.clamp(rho, 0.0, 1.0)
            sigma = sigma * sigma if opts.delta == 2 else sigma * (sigma * sigma)
            if nGres == 0:
                eq_ok = torch.ones_like(mu, dtype=torch.bool)
            else:
                eq_now = _norminf(Gv)
                eq_ok = (eq_now < 100 * opts.equalTolerance) | (eq_now < 1e-3)
            do_sigma = (alpha_a > opts.alphaMax / 2) & eq_ok
            return torch.where(do_sigma, sigma * gap_now / nF, mu)

        def direction_dense(z, lam, mu, addE2, cached, lin) -> EqDirection:
            sv, Fv, Gv = cached
            Fz = lin["Fz"]
            if small:
                Sz, Sn, Sl, Gz, LFF = lin["parts"]
                WW = condensed_kkt(dims, Sz, Sn, Sl, Gz, LFF, addE1, addE2, regularize)
                fac = factor(WW)
                muF = mu[:, None] / Fv
                stat_ff = sv - hdot(Sl, lam)
                if not mehrotra:
                    b = torch.cat([-stat_ff - hdot(Sl, muF), -Gv], dim=1)
                    dxz = fac.solve(b)
                    dLam = muF - lam - hdot(LFF, dxz[:, :nZ])
                    mu_new = mu
                else:
                    b_a = torch.cat([-stat_ff, -Gv], dim=1)
                    dZ_a = _rough_solve(fac, b_a)[:, :nZ]
                    dLam_a = -lam - hdot(LFF, dZ_a)
                    FzdZ_a = hdot(Fz, dZ_a)
                    mu_new = mehrotra_mu(z, lam, mu, Fv, Gv, dZ_a, dLam_a, FzdZ_a)
                    muF2 = mu_new[:, None] / Fv
                    Meh = FzdZ_a * dLam_a / Fv
                    b = torch.cat([-stat_ff - hdot(Sl, muF2) - hdot(Sl, Meh), -Gv], dim=1)
                    dxz = fac.solve(b)
                    dLam = muF2 - lam - hdot(LFF, dxz[:, :nZ]) - Meh
                dx_solved = dxz
                dx = torch.cat([dxz, dLam], dim=1)
            else:
                WW = lin["WW0"]
                if regularize:
                    WW = WW + torch.diag_embed(_diag_shift(nZ, nNu, nF, addE1, addE2))
                fac = factor(WW)
                if not mehrotra or nF == 0:
                    b = torch.cat([-sv, -Gv, -Fv + mu[:, None] / lam], dim=1)
                    dx = fac.solve(b)
                    mu_new = mu
                else:
                    b_a = torch.cat([-sv, -Gv, -Fv], dim=1)
                    dx_a = _rough_solve(fac, b_a)
                    dZ_a, dLam_a = dx_a[:, :nZ], dx_a[:, nZ + nNu:]
                    FzdZ_a = hdot(Fz, dZ_a)
                    mu_new = mehrotra_mu(z, lam, mu, Fv, Gv, dZ_a, dLam_a, FzdZ_a)
                    Meh = FzdZ_a * dLam_a / lam
                    b = torch.cat([-sv, -Gv, -Fv - Meh + mu_new[:, None] / lam], dim=1)
                    dx = fac.solve(b)
                dx_solved = dx
            derr = _norminf(hdot(WW, dx_solved) - b)
            if f64:
                bscale = torch.ones_like(mu)
            else:
                rs = WW.abs().sum(dim=-1).amax(dim=-1)
                bscale = torch.clamp(rs * _norminf(dx_solved) + _norminf(b), min=1.0)
            return EqDirection(dx, derr, hdot(Fz, dx[:, :nZ]), bscale, mu_new)

        def compute_direction(z, lam, mu, addE2, cached, lin) -> EqDirection:
            if not band_mode:
                return direction_dense(z, lam, mu, addE2, cached, lin)
            sv, Fv, Gv = cached
            op, rowsum_ub = band_op(Fv, lam, addE2)
            fac = kkt_solver(op)
            if not mehrotra:
                b = torch.cat([-sv, -Gv, -Fv + mu[:, None] / lam], dim=1)
                dx = fac.solve(b)
                mu_new = mu
            else:
                b_a = torch.cat([-sv, -Gv, -Fv], dim=1)
                dx_a = _rough_solve(fac, b_a)
                dZ_a, dLam_a = dx_a[:, :nZ], dx_a[:, nZ + nNu:]
                FzdZ_a = band_fz_mv(dZ_a)
                mu_new = mehrotra_mu(z, lam, mu, Fv, Gv, dZ_a, dLam_a, FzdZ_a)
                Meh = FzdZ_a * dLam_a / lam
                b = torch.cat([-sv, -Gv, -Fv - Meh + mu_new[:, None] / lam], dim=1)
                dx = fac.solve(b)
            derr = _norminf(op.matvec(dx) - b)
            if f64:
                bscale = torch.ones_like(mu)
            else:
                bscale = torch.clamp(rowsum_ub * _norminf(dx) + _norminf(b), min=1.0)
            return EqDirection(dx, derr, band_fz_mv(dx[:, :nZ]), bscale, mu_new)

        def exit_metrics(st: EqState):
            return exit_b(st.z, st.nu, st.lam, penv, sFu, sFd, sc)

        def adapt_directions(z, lam, mu, addE2, cached, lin, run):
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
                d = compute_direction(z, lam, mu, aE2, cached, lin)
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
            lin = linearize(z, nu, lam, cached)
            if not adapt:
                dirn = compute_direction(z, lam, mu, addE2, cached, lin)
                addE2_next = addE2
            else:
                dirn, addE2 = adapt_directions(z, lam, mu, addE2, cached, lin, run)
                addE2_next = torch.where(
                    (dirn.derr < tol * dirn.bscale) & (addE2 > ADDE_MIN),
                    torch.clamp(0.75 * addE2, min=ADDE_MIN), addE2,
                )
            if mehrotra:
                mu = torch.maximum(dirn.mu, mu_min)
            dx, FzdZ = dirn.dx, dirn.FzdZ
            dZ, dNu, dLam = dx[:, :nZ], dx[:, nZ: nZ + nNu], dx[:, nZ + nNu:]
            nan_fail = torch.isnan(dx).any(dim=1)
            if nF == 0:
                # no inequalities: the full step, lambda and mu unchanged
                alphaPrimal = full(opts.alphaMax)
                alphaDualEq = full(opts.alphaMax)
                alphaDualIneq = full(0.0)
                new_z = torch.addcmul(z, alphaPrimal[:, None], dZ)
                new_nu = torch.addcmul(nu, alphaDualEq[:, None], dNu)
                new_lam, new_mu = lam, mu
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
                        return Fall_trials(z, alpha, dZ)

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

                # mu schedule (lib/ipmPDeq_CSsolver.c)
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
            converged = g <= opts.gradTolerance
            if nF:
                converged &= gap <= desired_gap
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

        lam0 = mu0_t / Fall_at(z0) if nF else z0.new_zeros(B, 0)
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

        return IPMResult(
            u=st.z, nu=st.nu, lam=st.lam, mu=st.mu, status=status,
            iters=st.it, norminf_grad=g, norminf_eq=eq, gap=gap,
            f=raw(fns.f)(st.z, penv), addU=full(addE1), addEq=st.addE2,
            scale_ineq=s_all, scale_cost=sc,
        )

    solve.band_mode = "hoisted" if band_mode else None
    solve.certificates = cert
    return solve


def _band_assembly(dims, pre, hoisted, unit_fns, cert, band_plan, s_all, addE1,
                   z_d, nu_d, lam_d, B):
    """Band mode's once-a-solve precompute: the unit-scale hoists of Sl
    and Fz, the permuted constant band of [[Sz, Sn, Sl_u], [Gz, 0, 0],
    [Fz_u, 0, 0]] and the masks placing the diagonal updates.  Returns
    ``assemble(Fv, lam, addE2)`` -> (BandedOperator of the batch, row-sum
    bound), and ``fz_mv(x)``, the scaled Fz applied to x."""
    nZ, nF, nGres, nNu = _sizes(dims)
    w_band = int(band_plan.bandwidth)
    Sz, Sn = pre["Sz"], pre["Sn"]
    dt, dev = s_all.dtype, s_all.device
    Sl_u = hoisted(
        lambda env: jacfwd(unit_fns(env)[6], argnums=2)(z_d, nu_d, lam_d),
        cert["deps_Sl"],
    )
    Fz_u = hoisted(lambda env: jacfwd(unit_fns(env)[2])(z_d), cert["deps_Fz"])
    Gz = pre["Gz"] if nGres else torch.zeros(0, nZ, dtype=dt, device=dev)

    perm = torch.as_tensor(np.asarray(band_plan.perm), device=dev)
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

    def fz_mv(x):
        return s_all * hdot(Fz_u, x)

    def assemble(Fv, lam, addE2):
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
        shift = _diag_shift(nZ, nNu, nF, addE1, addE2)

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

    return assemble, fz_mv


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
        # band mode needs the fleet banded LU, which takes a band directly
        self._solve_raw = build_equilibrium_ipm(
            self._fns, self._ipm_dims, self.opts, kkt_solver,
            {p.name: p.shape for p in self.parameters},
            plan if name == "fleet_banded_lu" else None,
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
