"""Primal-dual interior-point method over an explicit batch dimension
(port of ``tenscalc_tpu/ipm/solver.py``).

The JAX package runs ``vmap`` of a ``lax.while_loop`` whose finished
instances are frozen by ``lax.cond(st.done)``, and the in-iteration
``addEye2Hessian`` adaptation loop runs until no instance needs a
retry.  Here both loops are Python loops over a leading batch dimension
B: every tensor of the state carries it, per-instance masks decide what
each instance keeps (``torch.where``), and a single solve is B = 1
through the same code.  Instances that are done, or stop at this
iteration, are computed with the rest and discarded, as under ``vmap``.

The Newton systems share the outer loop (the Mehrotra predictor/corrector,
the ``addEye2Hessian`` adaptation with the relative float32
direction-error gate and the progress guard, both line searches, the mu
schedule, the exit tests and the final status flags) and differ only in
the KKT they linearize at each iterate (:class:`Linearization`):

* the band modes (a banded plan, the condensed matrix with
  inequalities): the KKT assembled directly into band storage
  (``BandKKT``) for the fleet banded LDL^T, from iteration-invariant
  derivatives at a dummy iterate ('hoisted') or, when the certificate
  does not hoist them all, from H and Gu at every iterate ('periter');
* the dense branch (JAX ``band_plan is None``, or a banded plan without
  inequalities or on the large matrix, whose backend takes the dense
  KKT): the condensed matrix
  ``[[H + addU I + Fu' diag(lam/F) Fu, Gu'], [Gu, -addEq I]]``, or the
  large one of the standard variant ``[[H + addU I, Gu', -Fu'],
  [Gu, -addEq I, 0], [-Fu, 0, -diag(F/lam)]]`` or of ``timesLambda``
  (lambda scaling the Fu blocks and ``-diag(F lam)``, with the
  multiplicative lambda step), its derivatives hoisted at the initial
  point where certified iteration-invariant (the scaled Fu among them)
  and evaluated at every iterate where not, for the dense backends: a
  KKT backend given to :func:`build_ipm`, else :func:`.kkt.dense.kkt_factorize`.

A problem without inequality constraints (nF = 0) takes the full step
with lambda and mu frozen, and its exit test has no gap (JAX
``solver.py:1409-1417``).  The nu initializer is the CG on the normal
equations for the fleet backends and a pivoted-LU solve for the others.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as Fn
from torch.func import grad, jacfwd, vmap

from ..kkt.dense import hdot, hdotT, kkt_factorize, lu_solve_mixed
from .options import SolverOptions

STEPBACK = 0.99  # reference: stepback=.99, lib/ipmPD_CSsolver.c:174
K_ADAPT = 14     # x10 bumps enough to climb 1e-9 -> 1e2 in one iteration


class IPMFunctions(NamedTuple):
    """Problem callables of one instance: (u, penv) -> tensor."""

    f: Callable  # scalar objective
    F: Callable  # (nF,) inequality constraints (>= 0)
    G: Callable  # (nG,) equality residuals (== 0)


class IPMState(NamedTuple):
    """Solver state; every field has the batch as its leading dimension."""

    u: torch.Tensor
    nu: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    addU: torch.Tensor
    addEq: torch.Tensor
    addU_next: torch.Tensor
    addEq_next: torch.Tensor
    alphaPrimal: torch.Tensor
    alphaDualIneq: torch.Tensor
    alphaDualEq: torch.Tensor
    status: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    derr_prev: torch.Tensor
    inc_prev: torch.Tensor


HISTORY_COLUMNS = (
    "J", "norminf_grad", "norminf_eq", "gap", "mu", "alphaPrimal",
    "addU", "directionError",
)


class IPMResult(NamedTuple):
    u: torch.Tensor
    nu: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    norminf_grad: torch.Tensor
    norminf_eq: torch.Tensor
    gap: torch.Tensor
    f: torch.Tensor
    addU: torch.Tensor
    addEq: torch.Tensor
    scale_ineq: torch.Tensor
    scale_cost: torch.Tensor
    # profiling: (B, maxIter, len(HISTORY_COLUMNS)), row it-1 written by
    # iteration it (NaN where no iteration ran); None when off
    history: Optional[torch.Tensor] = None
    # allowSave: (u, nu, lam, mu, addU, addEq) at iteration save_iter,
    # after its adaptation (reference: saveWW__, lib/ipmPD_CS.m:511-515);
    # () when off
    saved: tuple = ()
    # profiling: ||residual||_inf of the CG nu-initializer (B,); None
    # when off or when the CG did not run
    nu_init_residual: Optional[torch.Tensor] = None


class Direction(NamedTuple):
    dU: torch.Tensor
    dNu: torch.Tensor
    dLambda: torch.Tensor
    derr: torch.Tensor       # ||WW dx - b||_inf
    curvature: torch.Tensor  # dU' WW11 dU
    mp: torch.Tensor         # positive inertia count (useInertia only)
    mn: torch.Tensor         # negative inertia count (useInertia only)
    mu_new: torch.Tensor     # sigma-updated mu (Mehrotra); mu when skipAffine
    sigma_fired: torch.Tensor
    bscale: torch.Tensor     # scale the f32 direction-error gate is relative to


def _select(mask: torch.Tensor, a, b):
    """Field-wise ``where(mask, a, b)`` of two NamedTuples of batched
    tensors; ``mask`` is (B,)."""
    out = []
    for x, y in zip(a, b):
        m = mask.view((-1,) + (1,) * (x.dim() - 1))
        out.append(torch.where(m, x, y))
    return type(a)(*out)


def _norminf(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return x.abs().amax(dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def _clp(x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """max{alpha >= 0 : x + alpha dx >= 0} per instance, x > 0."""
    neg = dx < 0
    ratio = torch.where(neg, -x / torch.where(neg, dx, -1.0), math.inf)
    return ratio.amin(dim=-1)


def _first_true(ok: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(ok.to(torch.float32), dim=-1, keepdim=True)


def _recip(c: float, dt, dev) -> torch.Tensor:
    """1/c rounded in the working type, as a 0-dim tensor."""
    one = torch.ones((), dtype=dt, device=dev)
    return one / torch.full((), c, dtype=dt, device=dev)


def line_search_combined(minF_of_alpha, alpha_bt, opts: SolverOptions):
    """Combined-direction backtracking search over a batched alpha grid
    (lib/ipmPD_CSsolver.c:679-756).  ``alpha_bt`` (B,) is
    min(stepback*maxAlpha, alphaMax); ``minF_of_alpha`` maps (B, C)
    candidates to (B, C) values of min F.  Returns (alpha, nan_fail)."""
    s = STEPBACK
    K = opts.linesearch_points
    dt, dev = alpha_bt.dtype, alpha_bt.device
    # the reference's compiler turns x / c into x * (1/c), with 1/c
    # rounded in the working type, and folds (x / s) * s into
    # x * ((1/s) * s); the boundary tests below branch on roundings of
    # zero, so the port forms the same numbers
    inv_s = _recip(s, dt, dev)
    inv_10 = _recip(10.0, dt, dev)
    a1 = alpha_bt * inv_s
    grid = alpha_bt[:, None] * 0.95 / (2.0 ** torch.arange(K, dtype=dt, device=dev))
    cands = torch.cat(
        [a1[:, None], torch.full_like(a1[:, None], opts.alphaMin / s), grid], dim=1
    )
    both = minF_of_alpha(torch.cat([cands, cands * s], dim=1))
    vals, vals_sb = both[:, : K + 2], both[:, K + 2:]
    ineq_a1, ineq_min = vals[:, 0], vals[:, 1]
    ineq1_a1 = vals_sb[:, 0]
    nan_fail = torch.isnan(ineq_a1)
    accept_max = (ineq_a1 > 0) & (ineq1_a1 > ineq_a1 * inv_10)
    gv, gs = vals[:, 2:], vals_sb[:, 2:]
    ok = (gv > 0) & (gs > gv * inv_10) & (grid >= opts.alphaMin)
    grid_alpha = torch.where(
        ok.any(dim=1), grid.gather(1, _first_true(ok))[:, 0] * s, 0.0
    )
    alpha_else = torch.where(ineq_min > 0, grid_alpha, 0.0)
    alpha = torch.where(accept_max, alpha_bt * (inv_s * s), alpha_else)
    alpha = torch.where(alpha_bt >= opts.alphaMin, alpha, 0.0)
    return alpha.to(dt), nan_fail


def line_search_affine(minF_of_alpha, alpha_max_, opts: SolverOptions):
    """Affine-direction search (lib/ipmPD_CSsolver.c:583-631)."""
    K = opts.linesearch_points
    dt, dev = alpha_max_.dtype, alpha_max_.device
    grid = alpha_max_[:, None] * 0.95 / (2.0 ** torch.arange(K, dtype=dt, device=dev))
    cands = torch.cat(
        [alpha_max_[:, None], torch.full_like(alpha_max_[:, None], opts.alphaMin),
         grid],
        dim=1,
    )
    vals = minF_of_alpha(cands)
    ok_max = vals[:, 0] >= 0
    ok_min = vals[:, 1] > 0
    ok = (vals[:, 2:] >= 0) & (grid >= opts.alphaMin)
    grid_alpha = torch.where(ok.any(dim=1), grid.gather(1, _first_true(ok))[:, 0], 0.0)
    alpha = torch.where(ok_max, alpha_max_, torch.where(ok_min, grid_alpha, 0.0))
    alpha = torch.where(alpha_max_ >= opts.alphaMin, alpha, 0.0)
    return alpha.to(dt)


class BandKKT:
    """Condensed KKT matrix of a batch in permuted lower-band storage,
    with structured matvecs: the dense (nK, nK) matrix is never formed.

    ``band`` is (B, nK, w+1) with band[b, c, i] = Wp[c+i, c] and
    Wp = WW[perm][:, perm].  H, Fu, Gu are shared (2-D) or per instance
    (3-D); ``dF`` (B, nF) are the barrier weights with the inequality
    scaling folded in."""

    __slots__ = ("band", "perm", "H", "Fu", "Gu", "dF", "addU", "addEq",
                 "nU", "nG")

    def __init__(self, band, perm, H, Fu, Gu, dF, addU, addEq, nU, nG):
        self.band = band
        self.perm = perm
        self.H = H
        self.Fu = Fu
        self.Gu = Gu
        self.dF = dF
        self.addU = addU
        self.addEq = addEq
        self.nU = nU
        self.nG = nG

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """WW @ x through the constituents, x (B, nK)."""
        xu, xn = x[:, : self.nU], x[:, self.nU:]
        yu = hdot(self.H, xu) + self.addU[:, None] * xu
        yu = yu + hdotT(self.Fu, self.dF * hdot(self.Fu, xu))
        if self.nG == 0:
            return yu
        yu = yu + hdotT(self.Gu, xn)
        yn = hdot(self.Gu, xu) - self.addEq[:, None] * xn
        return torch.cat([yu, yn], dim=1)

    def abs_rowsum_max(self) -> torch.Tensor:
        """Upper bound on max_i sum_j |WW[i, j]| per instance (the
        backward-error scale), through the constituents."""
        absFu = self.Fu.abs()
        ru = self.H.abs().sum(dim=-1) + self.addU[:, None].abs()
        ru = ru + hdotT(absFu, self.dF * absFu.sum(dim=-1))
        m = ru.amax(dim=1)
        if self.nG > 0:
            absGu = self.Gu.abs()
            ru_g = absGu.sum(dim=-2)
            rn = absGu.sum(dim=-1) + self.addEq[:, None].abs()
            m = torch.maximum(m, (ru + ru_g).amax(dim=1))
            m = torch.maximum(m, rn.amax(dim=1))
        return m


class _BandIndex(NamedTuple):
    """Where each entry of the lower band of P [[H, Gu'], [Gu, 0]] P' lies
    in H and Gu: band[c, i] = H.flatten(-2)[h[c, i]] where ``in_h``,
    Gu.flatten(-2)[g[c, i]] where ``in_g``, else 0 (the zero block, and
    the slots past the last row)."""

    h: torch.Tensor
    g: torch.Tensor
    in_h: torch.Tensor
    in_g: torch.Tensor


def _band_index(perm: np.ndarray, nU: int, w: int, dev) -> _BandIndex:
    """The flat positions of band[c, i] = Wp[c+i, c], Wp = P W P' with W
    = [[H, Gu'], [Gu, 0]], in H (nU, nU) and Gu (nG, nU): each (nK, w+1)."""
    nK = len(perm)
    c, i = np.arange(nK)[:, None], np.arange(w + 1)[None, :]
    inside = c + i < nK
    r = perm[np.minimum(c + i, nK - 1)]
    s = np.broadcast_to(perm[:, None], r.shape)
    in_h = inside & (r < nU) & (s < nU)
    below = inside & (r >= nU) & (s < nU)   # Gu[r - nU, s]
    above = inside & (r < nU) & (s >= nU)   # Gu'[r, s - nU] = Gu[s - nU, r]
    h = np.where(in_h, r * nU + s, 0)
    g = np.where(below, (r - nU) * nU + s, np.where(above, (s - nU) * nU + r, 0))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return _BandIndex(t(h), t(g), t(in_h), t(below | above))


def _band_gather(H: torch.Tensor, Gu: torch.Tensor, idx: _BandIndex) -> torch.Tensor:
    """Lower band (..., nK, w+1) of P [[H, Gu'], [Gu, 0]] P', read from H
    (..., nU, nU) and Gu (..., nG, nU) by index: the values of the JAX
    package's one-hot permutation products, without forming the matrix."""
    band = torch.where(idx.in_h, H.flatten(-2)[..., idx.h], 0.0)
    if Gu.shape[-2] > 0:
        band = torch.where(idx.in_g, Gu.flatten(-2)[..., idx.g], band)
    return band


def _pair_products(Fu: torch.Tensor, perm: torch.Tensor, nG: int, w: int) -> torch.Tensor:
    """(..., nF, (w+1) nK) pair products of the permuted Jacobian FuP =
    [Fu, 0] P' (nG zero columns): column i nK + c of row k holds
    FuP[k, c+i] FuP[k, c] (zero past the edge)."""
    FuP = torch.cat([Fu, Fu.new_zeros(Fu.shape[:-1] + (nG,))], dim=-1)[..., perm]
    nK = FuP.shape[-1]
    FuPP = torch.stack(
        [Fn.pad(FuP[..., i:] * FuP[..., : nK - i], (0, i)) for i in range(w + 1)],
        dim=-2,
    )  # (..., nF, w+1, nK)
    return FuPP.flatten(-2)


def _barrier_band(ds: torch.Tensor, FuPP: torch.Tensor, w: int) -> torch.Tensor:
    """The barrier's band (B, nK, w+1) of Fu' diag(ds) Fu:
    band[c, i] = sum_k ds_k FuP[k, c+i] FuP[k, c]."""
    if FuPP.dim() == 2:
        flat = ds @ FuPP
    else:
        flat = torch.bmm(ds.unsqueeze(1), FuPP).squeeze(1)
    return flat.view(ds.shape[0], w + 1, -1).transpose(1, 2)


def _rough_solve(fac, rhs: torch.Tensor) -> torch.Tensor:
    """The Mehrotra predictor's solve: unrefined in float32 where the
    backend has such a solve, else its own."""
    f32 = getattr(fac, "_solve32", None)
    if f32 is not None:
        return f32(rhs).to(rhs.dtype)
    return fac.solve(rhs)


def _mvWW(WW, x: torch.Tensor) -> torch.Tensor:
    if isinstance(WW, BandKKT):
        return WW.matvec(x)
    return hdot(WW, x)


def _abs_rowsum_max(WW) -> torch.Tensor:
    """max_i sum_j |WW[i, j]| per instance (a bound through the
    constituents in band mode)."""
    if isinstance(WW, BandKKT):
        return WW.abs_rowsum_max()
    return WW.abs().sum(dim=-1).amax(dim=-1)


class Linearization(NamedTuple):
    """The Newton system at one iterate, for any regularization.

    ``fu_mv``/``fuT_mv`` apply the scaled inequality Jacobian and its
    transpose, ``lpg_mv`` applies diag(lam/F) Fu, and ``assemble(addU,
    addEq)`` returns the KKT matrix (a ``BandKKT`` or a dense (B, nK, nK)
    tensor) with the matvec of its regularized Hessian block
    WW11 = H + addU I."""

    fu_mv: Callable
    fuT_mv: Callable
    lpg_mv: Callable
    assemble: Callable


def _large_kkt(WW11, Fu, Gu, Fval, lam, addEq, times_lambda: bool):
    """The large Newton matrix of a batch, (B, nU + nG + nF) square:
    ``[[WW11, Gu', -Fu'], [Gu, -addEq I, 0], [-Fu, 0, -diag(F/lam)]]``, or
    with ``times_lambda`` its multiplicative-lambda form
    ``[[WW11, Gu', -Fu' diag(lam)], [Gu, -addEq I, 0],
    [-diag(lam) Fu, 0, -diag(F lam)]]`` (JAX ``solver.py:555-584``)."""
    B, nF, nG = WW11.shape[0], Fu.shape[1], Gu.shape[1]
    if times_lambda:
        FuT, Fb, dg = -(Fu.transpose(1, 2) * lam[:, None, :]), -(lam[:, :, None] * Fu), Fval * lam
    else:
        FuT, Fb, dg = -Fu.transpose(1, 2), -Fu, Fval / lam
    eye_g = torch.eye(nG, dtype=WW11.dtype, device=WW11.device)
    zGF = WW11.new_zeros(B, nG, nF)
    return torch.cat(
        [torch.cat([WW11, Gu.transpose(1, 2), FuT], dim=2),
         torch.cat([Gu, -addEq[:, None, None] * eye_g, zGF], dim=2),
         torch.cat([Fb, zGF.transpose(1, 2), -torch.diag_embed(dg)], dim=2)],
        dim=1,
    )


def dense_kkt(fns: IPMFunctions, nU: int, nF: int, nG: int, opts: SolverOptions,
              parts: bool = False):
    """Single-instance dense KKT assembly of the options' Newton matrix
    (the branch the build-time structure probe reads): the condensed
    ``[[H + addU I + Fu' diag(lam/F) Fu, Gu'], [Gu, -addEq I]]`` or the
    large matrix of the standard or ``timesLambda`` variant.  With
    ``parts`` the assembly returns the JAX package's ``_assemble_ww``
    dict instead (``WW``, ``WW11`` = H + addU I, the scaled ``Fu``,
    ``Gu``, ``f_u`` = the scaled objective's gradient, ``Fval``,
    ``Gval``), what :mod:`tenscalc_tpu_torch.diagnostics` reads."""
    small = bool(opts.smallerNewtonMatrix)
    times_lambda = opts.variant == "timesLambda"

    def assemble(u, nu, lam, addU, addEq, penv, scale_ineq, scale_cost):
        dt, dev = u.dtype, u.device

        def Fs(uu):
            return scale_ineq * fns.F(uu, penv)

        def Gs(uu):
            return fns.G(uu, penv)

        def lagr(uu, nn, ll):
            val = scale_cost * fns.f(uu, penv)
            if nF > 0:
                val = val - ll @ Fs(uu)
            if nG > 0:
                val = val + nn @ Gs(uu)
            return val

        H = jacfwd(grad(lagr, argnums=0), argnums=0)(u, nu, lam)
        H = 0.5 * (H + H.T)
        WW11 = H + addU * torch.eye(nU, dtype=dt, device=dev)
        Fu = jacfwd(Fs)(u) if nF > 0 else u.new_zeros(0, nU)
        Gu = jacfwd(Gs)(u) if nG > 0 else u.new_zeros(0, nU)
        Fval = Fs(u)
        if not small:
            WW = _large_kkt(WW11[None], Fu[None], Gu[None], Fval[None], lam[None],
                            torch.full((1,), float(addEq), dtype=dt, device=dev),
                            times_lambda)[0]
        else:
            WW = WW11
            if nF > 0:
                Fdiv = Fval if dt == torch.float64 else torch.clamp(Fval, min=1e-8)
                WW = WW + Fu.T @ ((lam / Fdiv)[:, None] * Fu)
            if nG > 0:
                WW = torch.cat(
                    [torch.cat([WW, Gu.T], dim=1),
                     torch.cat([Gu, -addEq * torch.eye(nG, dtype=dt, device=dev)], dim=1)],
                    dim=0,
                )
        if not parts:
            return WW
        f_u = grad(lambda uu: scale_cost * fns.f(uu, penv))(u)
        return dict(WW=WW, WW11=WW11, Fu=Fu, Gu=Gu, f_u=f_u, Fval=Fval, Gval=Gs(u))

    return assemble


def build_ipm(fns: IPMFunctions, nU: int, nF: int, nG: int,
              opts: SolverOptions, kkt_solver, hoist, band_plan=None,
              hoist_scale_free: bool = False, hoist_param_deps=None,
              fleet_init: bool = True):
    """Build the batched ``solve`` function for a problem.

    ``solve(u0, penv, shared, mu0, max_iter, addU0, addEq0, save_iter)``:
    ``u0`` is (B, nU); each ``penv`` entry has a leading batch dimension
    except the parameters named in ``shared``, which every instance
    shares.  Under ``opts.profiling`` the result carries the history
    (:data:`HISTORY_COLUMNS`, a row an iteration) and the CG
    nu-initializer's residual; under ``opts.allowSave`` the state at
    iteration ``save_iter``.  With both off the loop launches what it
    launches without them.

    ``kkt_solver`` factors the KKT each direction assembles: a
    ``BandKKT`` in band mode (``band_plan`` given), else the dense
    (B, nK, nK) matrix; ``None`` means :func:`.kkt.dense.kkt_factorize`
    (the ``'dense'`` backend).  ``hoist`` = (H, Fu, Gu) iteration-invariance
    flags from :func:`tenscalc_tpu_torch.ipm.hoist.analyze_hoistable`.
    ``fleet_init`` picks the CG nu-initializer (the fleet backends) over
    the pivoted-LU solve."""
    hoist_H, hoist_Fu, hoist_Gu = hoist
    dt = opts.torch_dtype
    f64 = dt == torch.float64
    small = bool(opts.smallerNewtonMatrix)
    times_lambda = opts.variant == "timesLambda" and not small
    prof, save = bool(opts.profiling), bool(opts.allowSave)
    nK = nU + nG + (0 if small else nF)
    # the band's own assembly needs the condensed matrix with
    # inequalities and a banded backend; otherwise a banded plan's
    # backend takes the dense KKT (FleetBandedFactorization)
    band_any = band_plan is not None and small and nF > 0 and kkt_solver is not None
    band_mode = (
        band_any
        and hoist_H
        and hoist_Fu
        and (nG == 0 or hoist_Gu)
        and (hoist_scale_free or not (opts.scaleInequalities or opts.scaleCost > 0))
    )
    # per-iteration band mode: the plan's band structure holds at every
    # iterate, and the scales fold into the barrier weights, so it needs
    # no scale-free certificate
    band_periter = band_any and not band_mode
    mp_desired = float(nU)
    mn_desired = float(nG if small else nF + nG)

    def factor(WW):
        if kkt_solver is not None:
            return kkt_solver(WW)
        return kkt_factorize(WW, need_inertia=opts.useInertia, block=opts.ldl_block,
                             n_refine=opts.refine_for("dense"))
    adapt = opts.addEye2Hessian and opts.adjustAddEye2Hessian
    F_affine = hoist_Fu and opts.linesearch_affine_F

    def _lagr(u, nu, lam, penv, si, sc):
        Fv = si * fns.F(u, penv)
        Gv = fns.G(u, penv) if nG > 0 else u.new_zeros(0)
        val = sc * fns.f(u, penv)
        if nF > 0:
            val = val - lam @ Fv
        if nG > 0:
            val = val + nu @ Gv
        return val, (Fv, Gv)

    def solve(u0: torch.Tensor, penv, shared=frozenset(), mu0: float = 1.0,
              max_iter: Optional[int] = None, addU0: float = 1e-9,
              addEq0: float = 1e-9, save_iter: int = -1) -> IPMResult:
        max_iter_v = opts.maxIter if max_iter is None else int(max_iter)
        dev = u0.device
        u0 = u0.to(dt)
        B = u0.shape[0]
        pdims = {k: (None if k in shared else 0) for k in penv}
        addU0 = addU0 if opts.addEye2Hessian else 0.0
        addEq0 = addEq0 if opts.addEye2Hessian else 0.0

        def full(v, dtype=dt):
            return torch.full((B,), v, dtype=dtype, device=dev)

        no_rows = u0.new_zeros(B, 0, nU)  # the Jacobian of no constraint

        F_b = vmap(fns.F, in_dims=(0, pdims))
        f_b = vmap(fns.f, in_dims=(0, pdims))
        lagr_grad = vmap(
            grad(_lagr, argnums=0, has_aux=True),
            in_dims=(0, 0, 0, pdims, 0, 0),
        )

        # scaling factors, computed once at the initial point
        F0 = F_b(u0, penv)
        if opts.scaleInequalities:
            scale_ineq = torch.abs(1.0 / F0).to(dt)
        else:
            scale_ineq = torch.ones_like(F0)
        if opts.scaleCost > 0:
            scale_cost = torch.abs(opts.scaleCost / f_b(u0, penv)).to(dt)
            desired_gap = opts.desiredDualityGap * scale_cost
        else:
            scale_cost = full(1.0)
            desired_gap = full(opts.desiredDualityGap)
        mu_min = desired_gap / max(nF, 1) / 2.0
        si, sc = scale_ineq, scale_cost

        def Fs(u):
            return si * F_b(u, penv)

        # the scaled derivatives at batched iterates
        def H_at(u, nu, lam):
            def one(uu, nn, ll, pe, s_i, s_c):
                H0 = jacfwd(grad(lambda v: _lagr(v, nn, ll, pe, s_i, s_c)[0]))(uu)
                return 0.5 * (H0 + H0.transpose(-1, -2))

            return vmap(one, in_dims=(0, 0, 0, pdims, 0, 0))(u, nu, lam, penv, si, sc)

        def Fu_at(u):
            return vmap(lambda uu, pe, s_i: jacfwd(lambda v: s_i * fns.F(v, pe))(uu),
                        in_dims=(0, pdims, 0))(u, penv, si)

        def Gu_at(u):
            return vmap(lambda uu, pe: jacfwd(lambda v: fns.G(v, pe))(uu),
                        in_dims=(0, pdims))(u, penv)

        nu_init_res = None  # set by the CG nu-initializer under profiling
        # dual initialization: lam = mu0 / F; nu from
        # [I, Gu'; Gu, -eps I][x; nu] = [Fu' lam - f_u; 0], by CG on the
        # normal equations (Gu Gu' + eps I) nu = Gu (Fu' lam - f_u) for
        # the fleet backends, by a pivoted-LU solve for the others
        lam0 = mu0 / (si * F0)
        if nG > 0:
            Gu0 = Gu_at(u0)
            Fu0 = Fu_at(u0) if nF > 0 else no_rows
            f_u0 = vmap(grad(lambda uu, pe, c: c * fns.f(uu, pe)),
                        in_dims=(0, pdims, 0))(u0, penv, sc)
            btop = hdotT(Fu0, lam0) - f_u0
            if fleet_init:
                rhs0 = hdot(Gu0, btop)
                eps0 = max(addEq0, 1e-8)
                Mdiag = (Gu0 * Gu0).sum(dim=2) + eps0
                x, r = torch.zeros_like(rhs0), rhs0
                p = rhs0 / Mdiag
                rz = _dot(rhs0, p)
                for _ in range(min(2 * nG, 100)):
                    Ap = hdot(Gu0, hdotT(Gu0, p)) + eps0 * p
                    alpha = rz / torch.clamp(_dot(p, Ap), min=1e-30)
                    x = x + alpha[:, None] * p
                    r = r - alpha[:, None] * Ap
                    z = r / Mdiag
                    rz_new = _dot(r, z)
                    beta = rz_new / torch.clamp(rz, min=1e-30)
                    p = z + beta[:, None] * p
                    rz = rz_new
                nu0 = x
                if prof:
                    nu_init_res = _norminf(r)
            else:
                eye_u = torch.eye(nU, dtype=dt, device=dev).expand(B, nU, nU)
                eye_g = torch.eye(nG, dtype=dt, device=dev).expand(B, nG, nG)
                WW0 = torch.cat(
                    [torch.cat([eye_u, Gu0.transpose(1, 2)], dim=2),
                     torch.cat([Gu0, -addEq0 * eye_g], dim=2)],
                    dim=1,
                )
                b0 = torch.cat([btop, btop.new_zeros(B, nG)], dim=1)
                nu0 = lu_solve_mixed(WW0, b0)[:, nU:]
        else:
            nu0 = u0.new_zeros(B, 0)

        def Fu_raw_at(u):
            """The unscaled Jacobian of F at batched iterates."""
            return vmap(lambda uu, pe: jacfwd(lambda v: fns.F(v, pe))(uu),
                        in_dims=(0, pdims))(u, penv)

        def hoisted_at_dummy():
            """Band mode's iteration-invariant H, unscaled Fu and Gu at a
            dummy iterate with unit scales and the value-irrelevant
            parameters masked to zeros: with every remaining dependency
            shared they are computed once, unbatched."""
            h_deps, fu_deps, gu_deps = (
                hoist_param_deps if hoist_param_deps is not None else (None,) * 3
            )
            shapes = {k: tuple(v.shape[0 if k in shared else 1:])
                      for k, v in penv.items()}

            def hoisted(fn, deps):
                keep = [k for k in penv if deps is None or k in deps]
                env = {
                    k: (penv[k] if k in keep
                        else torch.zeros(shapes[k], dtype=dt, device=dev))
                    for k in penv
                }
                if all(k in shared for k in keep):
                    return fn(env)
                dims = {k: (0 if (k in keep and k not in shared) else None)
                        for k in env}
                return vmap(fn, in_dims=(dims,))(env)

            u_d = torch.zeros(nU, dtype=dt, device=dev)
            nu_d = torch.zeros(nG, dtype=dt, device=dev)
            lam_d = torch.ones(nF, dtype=dt, device=dev)
            ones_f = torch.ones(nF, dtype=dt, device=dev)
            one_c = torch.ones((), dtype=dt, device=dev)

            def H_of(env):
                H0 = jacfwd(grad(
                    lambda uu: _lagr(uu, nu_d, lam_d, env, ones_f, one_c)[0]
                ))(u_d)
                return 0.5 * (H0 + H0.transpose(-1, -2))

            H = hoisted(H_of, h_deps)
            Fu = hoisted(lambda env: jacfwd(lambda uu: fns.F(uu, env))(u_d), fu_deps)
            if nG > 0:
                Gu = hoisted(lambda env: jacfwd(lambda uu: fns.G(uu, env))(u_d), gu_deps)
            else:
                Gu = torch.zeros(0, nU, dtype=dt, device=dev)
            return H, Fu, Gu

        def band_linearization():
            """The condensed KKT assembled straight into the permuted band
            of the plan, for the fleet banded LDL^T.  Band mode
            ('hoisted'): H, Fu and Gu iteration-invariant, taken at a dummy
            iterate, their band gathered once a solve.  Per-iteration band
            mode ('periter'): H and Gu at every iterate where the
            certificate does not hoist them (hoisted ones at u0), their
            band gathered at each iterate.  The barrier's band comes from
            the pair products of the permuted UNSCALED Jacobian, formed once
            a solve where Fu is hoisted, weighted by
            ds = lam / F * scale_ineq^2 (the scale folds into the weights):
            band_F[c, i] = sum_k ds_k FuP[k, c+i] FuP[k, c]."""
            if band_mode:
                H, Fu, Gu = hoisted_at_dummy()
            else:
                H = H_at(u0, nu0, lam0) if hoist_H else None
                Fu = Fu_raw_at(u0) if hoist_Fu else None
                Gu = no_rows if nG == 0 else (Gu_at(u0) if hoist_Gu else None)
            w_band = int(band_plan.bandwidth)
            perm_np = np.asarray(band_plan.perm)
            perm = torch.as_tensor(perm_np, device=dev)
            idx = _band_index(perm_np, nU, w_band, dev)
            band_HG = _band_gather(H, Gu, idx) if H is not None and Gu is not None else None
            FuPP = _pair_products(Fu, perm, nG, w_band) if Fu is not None else None
            bmask_u = (perm < nU).to(dt)
            bmask_g = (perm >= nU).to(dt)

            def linearize(u, nu, lam, Fval):
                H_ = H if H is not None else H_at(u, nu, lam)
                Gu_ = Gu if Gu is not None else Gu_at(u)
                Fu_ = Fu if Fu is not None else Fu_raw_at(u)
                bandHG = band_HG if band_HG is not None else _band_gather(H_, Gu_, idx)
                FuPP_ = FuPP if FuPP is not None else _pair_products(Fu_, perm, nG, w_band)
                dF = lam / (Fval if f64 else torch.clamp(Fval, min=1e-8))
                ds = dF * si * si
                base = bandHG + _barrier_band(ds, FuPP_, w_band)

                def fu_mv(x):
                    return si * hdot(Fu_, x)

                def fuT_mv(y):
                    return hdotT(Fu_, si * y)

                # the adaptation trips share the band and re-add its diagonal
                def assemble(addU, addEq):
                    bandv = base.clone()
                    bandv[:, :, 0] += addU[:, None] * bmask_u - addEq[:, None] * bmask_g
                    WW = BandKKT(bandv, perm, H_, Fu_, Gu_, ds, addU, addEq, nU, nG)
                    return WW, lambda x: hdot(H_, x) + addU[:, None] * x

                return Linearization(fu_mv, fuT_mv, lambda x: dF * fu_mv(x), assemble)

            return linearize

        def dense_linearization():
            """The dense KKT (condensed or large): H, the scaled Fu and Gu
            hoisted at (u0, nu0, lam0) where certified iteration-invariant,
            else evaluated at each iterate."""
            H0 = H_at(u0, nu0, lam0) if hoist_H else None
            Fu0_ = Fu_at(u0) if (hoist_Fu and nF > 0) else None
            Gu0_ = Gu_at(u0) if (hoist_Gu and nG > 0) else None
            eye_u = torch.eye(nU, dtype=dt, device=dev)
            eye_g = torch.eye(nG, dtype=dt, device=dev)

            def linearize(u, nu, lam, Fval):
                H = H0 if H0 is not None else H_at(u, nu, lam)
                if nF == 0:
                    Fu = no_rows
                else:
                    Fu = Fu0_ if Fu0_ is not None else Fu_at(u)
                if nG > 0:
                    Gu = Gu0_ if Gu0_ is not None else Gu_at(u)
                else:
                    Gu = no_rows
                Fdiv = Fval if f64 else torch.clamp(Fval, min=1e-8)
                LPG = (lam / Fdiv)[:, :, None] * Fu
                lin_F = (lambda x: hdot(Fu, x), lambda y: hdotT(Fu, y),
                         lambda x: hdot(LPG, x))
                if not small:
                    def assemble_large(addU, addEq):
                        WW11 = H + addU[:, None, None] * eye_u
                        WW = _large_kkt(WW11, Fu, Gu, Fval, lam, addEq, times_lambda)
                        return WW, lambda x: hdot(WW11, x)

                    return Linearization(*lin_F, assemble_large)
                # the barrier block is absent without inequalities (JAX
                # adds a scalar 0 there)
                FtLPG = torch.bmm(Fu.transpose(1, 2), LPG) if nF > 0 else None

                def assemble(addU, addEq):
                    WW11 = H + addU[:, None, None] * eye_u
                    WW = WW11 + FtLPG if FtLPG is not None else WW11
                    if nG > 0:
                        WW = torch.cat(
                            [torch.cat([WW, Gu.transpose(1, 2)], dim=2),
                             torch.cat([Gu, -addEq[:, None, None] * eye_g], dim=2)],
                            dim=1,
                        )
                    return WW, lambda x: hdot(WW11, x)

                return Linearization(*lin_F, assemble)

            return linearize

        linearize = band_linearization() if band_any else dense_linearization()

        inf_B = full(math.inf)

        def exit_metrics(st: IPMState):
            grad_u, (Fval, Gval) = lagr_grad(st.u, st.nu, st.lam, penv, si, sc)
            if nF > 0:
                gap, ineq, dual = _dot(st.lam, Fval), Fval.amin(dim=1), st.lam.amin(dim=1)
            else:
                gap, ineq, dual = full(0.0), inf_B, inf_B
            return _norminf(grad_u), _norminf(Gval), gap, ineq, dual, (grad_u, Fval, Gval)

        def compute_direction(lin: Linearization, lam, mu, addU, addEq,
                              cached, mehrotra_mu) -> Direction:
            grad_u, Fval, Gval = cached
            Fdiv = Fval if f64 else torch.clamp(Fval, min=1e-8)
            muF = mu[:, None] / Fdiv
            fu_mv, fuT_mv, lpg_mv = lin.fu_mv, lin.fuT_mv, lin.lpg_mv
            WW, ww11_mv = lin.assemble(addU, addEq)
            fac = factor(WW)
            mu_new = mu
            sigma_fired = torch.zeros(B, dtype=torch.bool, device=dev)
            # the Mehrotra predictor; without inequalities it feeds
            # nothing (the JAX package's compiler drops its solve), so
            # its caller passes no mehrotra_mu and it is not formed
            affine = mehrotra_mu is not None
            if not small:
                # the large system (JAX solver.py:680-714)
                if times_lambda:
                    b3 = lam * Fval - mu[:, None]
                elif not affine:
                    b3 = Fval - mu[:, None] / lam
                else:
                    b_a = torch.cat([-grad_u, -Gval, Fval], dim=1)
                    dx_a = _rough_solve(fac, b_a)
                    dU_a, dLambda_a = dx_a[:, :nU], dx_a[:, nU + nG:]
                    mu_new, sigma_fired = mehrotra_mu(dU_a, dLambda_a, Fval)
                    use_corr = sigma_fired.to(dt)
                    corr = (use_corr[:, None] * fu_mv(dU_a) * dLambda_a / lam
                            - mu_new[:, None] / lam)
                    b3 = Fval + corr
                b = torch.cat([-grad_u, -Gval, b3], dim=1)
                dx = fac.solve(b)
                dU, dNu, dLambda = dx[:, :nU], dx[:, nU: nU + nG], dx[:, nU + nG:]
            else:
                if affine:
                    # the predictor takes the unrefined float32 solve
                    b_a = torch.cat([-grad_u - fuT_mv(lam), -Gval], dim=1)
                    dx_a = _rough_solve(fac, b_a)
                    dU_a = dx_a[:, :nU]
                    dLambda_a = -lpg_mv(dU_a) - lam
                    mu_new, sigma_fired = mehrotra_mu(dU_a, dLambda_a, Fval)
                    use_corr = sigma_fired.to(dt)
                    muF_c = mu_new[:, None] / Fdiv
                    Meh = use_corr[:, None] * fu_mv(dU_a) * dLambda_a / Fdiv
                    r1 = -grad_u - fuT_mv(lam - muF_c + Meh)
                elif nF > 0:
                    muF_c = muF
                    r1 = -grad_u - fuT_mv(lam - muF)
                else:
                    r1 = -grad_u
                b = torch.cat([r1, -Gval], dim=1)
                dx = fac.solve(b)
                dU, dNu = dx[:, :nU], dx[:, nU:]
                if nF > 0:
                    dLambda = muF_c - lpg_mv(dU) - lam
                    if affine:
                        dLambda = dLambda - Meh
                else:
                    dLambda = lam  # (B, 0)
            derr = _norminf(_mvWW(WW, dx) - b)
            curvature = _dot(dU, ww11_mv(dU))
            if opts.useInertia:
                # after the solves: reuses their factor, never launches a
                # factor-only kernel
                mp, mn = fac.inertia()
            else:
                mp = mn = torch.zeros_like(mu)
            if f64:
                bscale = _norminf(b)
            else:
                # backward-error scale bound ||WW||_inf ||dx||_inf + ||b||
                bscale = _abs_rowsum_max(WW) * _norminf(dx) + _norminf(b)
            return Direction(dU, dNu, dLambda, derr, curvature, mp, mn,
                             mu_new, sigma_fired, bscale)

        # x + a * d is formed with one rounding (addcmul), as XLA fuses
        # it: the step to the boundary makes min F(u + a dU) a rounding
        # of zero, and the line search branches on its sign
        def min_F(Fval, FdU, u, dU):
            """(B, C) candidates -> (B, C) values of min F(u + a dU)."""
            if F_affine:
                def fn(alpha):
                    return torch.addcmul(
                        Fval[:, None, :], alpha[:, :, None], FdU[:, None, :]
                    ).amin(-1)
            else:
                def fn(alpha):
                    return torch.stack(
                        [Fs(u + alpha[:, j: j + 1] * dU).amin(dim=1)
                         for j in range(alpha.shape[1])],
                        dim=1,
                    )
            return fn

        def iterate(st: IPMState, ng, ne, gap, cached, run) -> IPMState:
            u, nu, lam, mu = st.u, st.nu, st.lam, st.mu
            addU, addEq = st.addU, st.addEq
            _, Fval, _ = cached
            # the KKT's derivatives do not depend on the regularization,
            # so the adaptation trips share one linearization
            lin = linearize(u, nu, lam, Fval)
            fu_mv = lin.fu_mv

            def mehrotra_mu(dU_a, dLambda_a, Fval_):
                # affine line search + sigma = rho^delta mu update,
                # applied before the combined solve
                # (lib/ipmPD_CSsolver.c:579-665)
                FdU_a = fu_mv(dU_a)
                aMax = torch.minimum(
                    torch.clamp(_clp(Fval_, FdU_a), max=opts.alphaMax),
                    _clp(lam, dLambda_a),
                )
                alpha_a = line_search_affine(min_F(Fval_, FdU_a, u, dU_a), aMax, opts)
                if F_affine:
                    newF_a = torch.addcmul(Fval_, alpha_a[:, None], FdU_a)
                else:
                    newF_a = Fs(u + alpha_a[:, None] * dU_a)
                newLam_a = torch.addcmul(lam, alpha_a[:, None], dLambda_a)
                rho = _dot(newF_a, newLam_a) / gap
                sigma = torch.clamp(rho, 0.0, 1.0) ** opts.delta
                eq_ok = (
                    torch.ones_like(run) if nG == 0
                    else (ne < 100 * opts.equalTolerance) | (ne < 1e-3)
                )
                do_sigma = (alpha_a > opts.alphaMax / 2) & eq_ok
                # one iteration may cut mu by at most
                # min(muFactorAggressive, sqrt(mu))
                mu_floor = mu * torch.clamp(torch.sqrt(mu), max=opts.muFactorAggressive)
                mu_c = torch.where(
                    do_sigma,
                    torch.maximum(torch.maximum(sigma * gap / nF, mu_floor), mu_min),
                    mu,
                )
                return mu_c, do_sigma

            meh = mehrotra_mu if (not opts.skipAffine and nF > 0) else None

            def direction(aU, aE):
                return compute_direction(lin, lam, mu, aU, aE, cached, meh)

            addU_next, addEq_next = addU, addEq
            inc_state = torch.zeros_like(run)
            if not adapt:
                dirn = direction(addU, addEq)
            else:
                MIN, MAX = opts.addEye2HessianMIN, opts.addEye2HessianMAX

                def is_good(d):
                    g = d.curvature > 0
                    if opts.useInertia:
                        g |= (d.mp == mp_desired) & (d.mn == mn_desired)
                    return g & torch.isfinite(d.derr) & torch.isfinite(d.bscale)

                # solve at least once; retry an instance whose direction
                # is bad with a larger regularization: finite-but-bad
                # directions retry once, non-finite ones keep climbing
                k = torch.zeros(B, dtype=torch.int32, device=dev)
                need = run.clone()
                dirn = None
                while bool(need.any()):
                    d = direction(addU, addEq)
                    finite = torch.isfinite(d.derr) & torch.isfinite(d.bscale)
                    retry = ~is_good(d) & torch.where(finite, k == 0, k < K_ADAPT)
                    if opts.useInertia:
                        few_pos = d.mp < mp_desired
                        facU = torch.where(few_pos, 10.0, 2.0).to(dt)
                        facE = torch.where(few_pos, 2.0, 10.0).to(dt)
                    else:
                        facU = facE = 10.0
                    aU2 = torch.where(
                        retry & (addU < MAX),
                        torch.clamp(facU * torch.clamp(addU, min=MIN), max=MAX), addU,
                    )
                    aE2 = torch.where(
                        retry & (addEq < MAX),
                        torch.clamp(facE * torch.clamp(addEq, min=MIN), max=MAX), addEq,
                    )
                    dirn = d if dirn is None else _select(need, d, dirn)
                    k = torch.where(need, k + 1, k)
                    addU = torch.where(need, aU2, addU)
                    addEq = torch.where(need, aE2, addEq)
                    need = need & retry
                was_retry = k > 1

                # delayed adjustment for the next iteration: absolute 1e-6
                # gate in f64, relative to the backward-error scale in f32
                derr = dirn.derr
                if f64:
                    derr_gate = torch.full_like(derr, opts.maxDirectionError)
                else:
                    derr_gate = opts.maxDirectionError * torch.clamp(
                        torch.clamp(dirn.bscale, max=1e30), min=1.0
                    )
                dec = derr < derr_gate
                inc_guard = torch.ones_like(run)
                if not f64:
                    # progress guard: raising again after a raise that did
                    # not halve derr cannot help
                    inc_guard = (~st.inc_prev) | (derr < 0.5 * st.derr_prev)
                inc = ~(derr <= derr_gate) & inc_guard
                addU_next = torch.where(
                    dec & (addU > MIN), torch.clamp(0.75 * addU, min=MIN), addU
                )
                addU_next = torch.where(
                    inc & (addU < MAX),
                    torch.clamp(10.0 * torch.clamp(addU, min=MIN), max=MAX), addU_next,
                )
                addEq_next = torch.where(
                    dec & (addEq > MIN), torch.clamp(0.75 * addEq, min=MIN), addEq
                )
                addEq_next = torch.where(
                    inc & (addEq < MAX),
                    torch.clamp(10.0 * torch.clamp(addEq, min=MIN), max=MAX), addEq_next,
                )
                addU_next = torch.where(was_retry, addU, addU_next)
                addEq_next = torch.where(was_retry, addEq, addEq_next)
                inc_state = inc

            dU, dNu, dLambda = dirn.dU, dirn.dNu, dirn.dLambda
            if nF == 0:
                # no inequalities: the full step, lambda and mu frozen
                # (lib/ipmPD_CSsolver.c:550-569)
                alphaPrimal = alphaDualEq = full(opts.alphaMax)
                alphaDualIneq = full(0.0)
                new_u = torch.addcmul(u, alphaPrimal[:, None], dU)
                new_nu = torch.addcmul(nu, alphaDualEq[:, None], dNu)
                new_lam, new_mu = lam, mu
                nan_fail = torch.zeros_like(run)
            else:
                FdU = fu_mv(dU)
                # timesLambda steps lambda multiplicatively,
                # lam (1 + alpha dLambda) (JAX solver.py:1425-1450)
                maxAlphaDualIneq = _clp(torch.ones_like(lam) if times_lambda else lam,
                                        dLambda)
                alphaP = _clp(Fval, FdU)
                if opts.coupledAlphas:
                    alphaP = torch.minimum(alphaP, maxAlphaDualIneq)
                alpha_bt = torch.clamp(alphaP * STEPBACK, max=opts.alphaMax)
                alphaPrimal, nan_fail = line_search_combined(
                    min_F(Fval, FdU, u, dU), alpha_bt, opts
                )
                if opts.coupledAlphas:
                    alphaDualIneq = alphaDualEq = alphaPrimal
                else:
                    alphaDualIneq = torch.minimum(maxAlphaDualIneq * STEPBACK, alpha_bt)
                    alphaDualEq = alphaDualIneq
                new_u = torch.addcmul(u, alphaPrimal[:, None], dU)
                new_nu = torch.addcmul(nu, alphaDualEq[:, None], dNu)
                if times_lambda:
                    new_lam = lam * torch.addcmul(torch.ones_like(lam),
                                                  alphaDualIneq[:, None], dLambda)
                else:
                    new_lam = torch.addcmul(lam, alphaDualIneq[:, None], dLambda)

                # mu schedule (lib/ipmPD_CSsolver.c:782-859): the update with
                # skipAffine, the fallback when the sigma update did not fire
                th_grad = ng < max(1e-6, opts.gradTolerance)
                th_eq = (
                    torch.ones_like(run) if nG == 0
                    else ne < max(1e-5, opts.equalTolerance)
                )
                aggressive = (alphaPrimal > alpha_bt / 2) & th_grad & th_eq
                mu_aggr = torch.maximum(
                    mu * torch.clamp(torch.sqrt(mu), max=opts.muFactorAggressive), mu_min
                )
                tiny_alpha = alphaPrimal < 0.1
                mu_tiny = torch.clamp(mu * 1.1, max=mu0)
                conservative = (alphaPrimal > 0.99) & th_eq
                mu_cons = torch.maximum(mu * opts.muFactorConservative, mu_min)
                mu_sched = torch.where(
                    aggressive, mu_aggr,
                    torch.where(tiny_alpha, mu_tiny, torch.where(conservative, mu_cons, mu)),
                )
                if opts.skipAffine:
                    new_mu = mu_sched
                    new_lam = torch.where(
                        tiny_alpha[:, None], mu_tiny[:, None] / Fs(new_u), new_lam
                    )
                else:
                    new_mu = torch.where(dirn.sigma_fired, dirn.mu_new, mu_sched)
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
            done = nan_fail
            keep = done[:, None]
            new_st = IPMState(
                u=torch.where(keep, u, new_u),
                nu=torch.where(keep, nu, new_nu),
                lam=torch.where(keep, lam, new_lam),
                mu=new_mu, addU=addU, addEq=addEq,
                addU_next=addU_next, addEq_next=addEq_next,
                alphaPrimal=alphaPrimal, alphaDualIneq=alphaDualIneq,
                alphaDualEq=alphaDualEq,
                status=torch.where(nan_fail, 4, 0).to(torch.int32),
                it=st.it, done=done,
                derr_prev=dirn.derr.to(dt), inc_prev=inc_state,
            )
            # the history row of this iteration (J at the iterate it
            # started from, the exit metrics, the new mu, the step, the
            # adapted regularization, the direction error) and the
            # allowSave snapshot's candidate (the iterate, after adaptation)
            row = None
            if prof:
                row = torch.stack([(sc * f_b(u, penv)) / sc, ng, ne, gap, new_mu,
                                   alphaPrimal, addU, dirn.derr.to(dt)], dim=1)
            cur = (u, nu, lam, mu, addU, addEq) if save else None
            return new_st, row, cur

        def infeasible(v):
            # f32: a legitimately active constraint rounds to 0 or -eps
            return v <= 0 if f64 else v < -1e-6

        def step(st: IPMState) -> IPMState:
            it = st.it + 1
            addU, addEq = st.addU_next, st.addEq_next
            ng, ne, gap, ineq, dual, cached = exit_metrics(st)
            status = torch.zeros(B, dtype=torch.int32, device=dev)
            fail_maxiter = it > max_iter_v
            status = torch.where(fail_maxiter, 8, status)
            fail_nan = torch.isnan(ng)
            status = torch.where(fail_nan & (status == 0), 4, status)
            fail_ineq = infeasible(ineq)
            status = torch.where(fail_ineq & (status == 0), 1, status)
            fail_dual = infeasible(dual)
            status = torch.where(fail_dual & (status == 0), 2, status)
            converged = ng <= opts.gradTolerance
            if nF > 0:
                converged &= gap <= desired_gap
            if nG > 0:
                converged &= ne <= opts.equalTolerance
            if adapt:
                converged &= addU <= opts.addEye2HessianUtolerance
            early = fail_maxiter | fail_nan | fail_ineq | fail_dual | converged
            stop = st._replace(
                it=it, addU=addU, addEq=addEq, addU_next=addU, addEq_next=addEq,
                status=status.to(torch.int32), done=torch.ones_like(st.done),
            )
            run = ~st.done & ~early
            if bool(run.any()):
                new, row, cur = iterate(
                    st._replace(it=it, addU=addU, addEq=addEq),
                    ng, ne, gap, cached, run,
                )
                stop = _select(run, new, stop)
                record(run, row, cur)
            return _select(st.done, st, stop)

        # The instances that iterate run in lockstep: at the k-th step
        # each of them is at iteration k, so its history row and its
        # snapshot are chosen on the host, and a finished instance, which
        # no longer iterates, keeps its rows and its snapshot unwritten
        # (the JAX package's lax.cond(st.done) freezes its whole state).
        hist = torch.full((B, opts.maxIter, len(HISTORY_COLUMNS)), math.nan,
                          dtype=dt, device=dev) if prof else None
        snap = ((u0.new_zeros(B, nU), u0.new_zeros(B, nG), u0.new_zeros(B, nF),
                 full(0.0), full(0.0), full(0.0)) if save else ())
        k_step = [0]

        def record(run, row, cur):
            nonlocal snap
            k = k_step[0]
            if row is not None:
                j = min(k - 1, opts.maxIter - 1)
                hist[:, j] = torch.where(run[:, None], row, hist[:, j])
            if cur is not None and k == save_iter:
                snap = tuple(torch.where(run.view((-1,) + (1,) * (c.dim() - 1)), c, s)
                             for c, s in zip(cur, snap))

        st = IPMState(
            u=u0, nu=nu0, lam=lam0, mu=full(mu0),
            addU=full(addU0), addEq=full(addEq0),
            addU_next=full(addU0), addEq_next=full(addEq0),
            alphaPrimal=full(0.0), alphaDualIneq=full(0.0), alphaDualEq=full(0.0),
            status=full(0, torch.int32), it=full(0, torch.int32),
            done=full(False, torch.bool),
            derr_prev=full(math.inf), inc_prev=full(False, torch.bool),
        )
        while not bool(st.done.all()):
            k_step[0] += 1
            st = step(st)

        # status completion when maxIter was reached
        # (lib/ipmPD_CSsolver.c:885-920)
        ng, ne, gap, _, _, _ = exit_metrics(st)
        status = st.status
        is8 = status == 8

        def add_flag(cond, flag, s):
            return torch.where(is8 & cond, s | flag, s)

        status = add_flag(ng > opts.gradTolerance, 16, status)
        if nG > 0:
            status = add_flag(ne > opts.equalTolerance, 32, status)
        if nF > 0:
            status = add_flag(gap > desired_gap, 64, status)
            status = add_flag(st.mu > mu_min, 128, status)
            aP, aDI, aDE = st.alphaPrimal, st.alphaDualIneq, st.alphaDualEq
            negl = (aP <= opts.alphaMin) & (aDI < opts.alphaMin) & (aDE < opts.alphaMin)
            small_a = (aP <= 0.1) & (aDI < 0.1) & (aDE < 0.1)
            med_a = (aP <= 0.5) & (aDI < 0.5) & (aDE < 0.5)
            status = add_flag(negl, 1792, status)
            status = add_flag(~negl & small_a, 1536, status)
            status = add_flag(~negl & ~small_a & med_a, 1024, status)
        if adapt:
            status = add_flag(st.addU > opts.addEye2HessianUtolerance, 2048, status)

        return IPMResult(
            u=st.u, nu=st.nu, lam=st.lam, mu=st.mu, status=status,
            iters=st.it, norminf_grad=ng, norminf_eq=ne, gap=gap,
            f=(sc * f_b(st.u, penv)) / sc, addU=st.addU, addEq=st.addEq,
            scale_ineq=scale_ineq, scale_cost=scale_cost,
            history=hist, saved=snap, nu_init_residual=nu_init_res,
        )

    solve.band_mode = "hoisted" if band_mode else ("periter" if band_periter else None)
    return solve
