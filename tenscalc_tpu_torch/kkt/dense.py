"""Dense KKT factorizations (port of ``tenscalc_tpu/kkt/dense.py``):
``hdot``, the unpivoted LDL^T (``ldl_factor`` blocked,
``ldl_factor_unblocked``, ``ldl_solve``, ``ldl_inertia``,
``symmetric_solve``), and the IPM's dense backend ``kkt_factorize`` with
its ``KKTFactorization`` kinds ``'lu'``, ``'lu_ir'``, ``'ldl_ir'`` and
``'ldl'``, and ``lu_solve_mixed``.

The JAX package casts an LU to float32 only on a TPU, whose LU takes
nothing else (``_lu_needs_f32``); on the CPU and GPU it factors in the
matrix's own dtype.  The port follows that branch everywhere: a float64
KKT gets a float64 pivoted LU (``torch.linalg.lu_factor``, as XLA's LU
is the JAX package's, outside any Pallas kernel), with no cast and no
refinement; the float32 inertia path factors by LU in float32, refines
against the matrix, and counts the inertia by a Bunch-Kaufman
elimination (:mod:`.bunchkaufman`).

Every product here runs in full precision: the solver turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, float32 matmul
precision "highest") where it is built, as the JAX package computes
these products at ``Precision.HIGHEST``.  Refinement residuals and the
direction-error metric must be exact, or the 1e-6 direction-error gate
can never pass.

The LDL^T pieces are XLA code in the JAX package, not Pallas kernels, so
plain PyTorch is their port on the card (``torch.linalg.solve_triangular``
and full-precision products).  On the CPU their triangular solves call
LAPACK's BLAS ``?trsm`` through scipy, the routine XLA's CPU backend
calls, so that a factor and its solves there repeat the reference's
roundings: an unpivoted factor of a saddle KKT amplifies a last-bit
difference by its pivot growth (1e9 in the min-max solver's case 5.5),
and the direction-error gate then decides on noise.  They take a
leading batch dimension (``A`` is (..., n, n)); like the reference they
never pivot (lib/@csparse/sparsity_ldl.m:188), and inertia is the sign
count of d.
"""

from __future__ import annotations

import numpy as np
import torch


def hdot(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a batch of vectors ``x`` (B, n).  ``A`` is (m, n)
    and shared by the batch, or (B, m, n) per instance.  Returns (B, m)."""
    if A.dim() == 2:
        return x @ A.T
    return torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)


def equilibration_scale(norm: torch.Tensor) -> torch.Tensor:
    """The equilibration scale 1/sqrt(max(norm, 1e-30)) of row or column
    norms, in their dtype.  Of float32 norms it is correctly rounded:
    formed in float64, then rounded once.  torch's float32 ``rsqrt`` is
    off in the last bit for about a quarter of the inputs, and differently
    on the CPU and the card; the scaled matrix feeds an unpivoted
    elimination whose clamped pivots can turn a last-bit change into
    another IPM path.  Of float64 norms it is 1/sqrt in float64."""
    s = 1.0 / torch.sqrt(torch.clamp(norm, min=1e-30).double())
    return s.to(norm.dtype)


def hdotT(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``A.T @ y`` for a batch of vectors ``y`` (B, m), with ``A`` as in
    :func:`hdot`.  Returns (B, n)."""
    if A.dim() == 2:
        return y @ A
    return torch.bmm(y.unsqueeze(1), A).squeeze(1)


def _trsm(A: torch.Tensor, X: torch.Tensor, left: bool, trans: bool) -> torch.Tensor:
    """Solve op(A) Y = X (``left``) or Y op(A) = X for unit lower
    triangular A (..., n, n), op(A) = A^T when ``trans``; X (..., n, k) or
    (..., k, n).  The CPU calls BLAS ?trsm an instance at a time."""
    if A.device.type != "cpu":
        At = A.mT if trans else A
        return torch.linalg.solve_triangular(At, X, upper=trans, left=left,
                                             unitriangular=True)
    from scipy.linalg import blas

    trsm = blas.dtrsm if A.dtype == torch.float64 else blas.strsm
    An = A.detach().reshape((-1,) + A.shape[-2:]).numpy()
    Xn = X.detach().expand(A.shape[:-2] + X.shape[-2:]).reshape(
        (-1,) + X.shape[-2:]).numpy()
    out = [trsm(1.0, a, x, side=0 if left else 1, lower=1, trans_a=int(trans), diag=1)
           for a, x in zip(An, Xn)]
    return torch.from_numpy(np.stack(out)).reshape(A.shape[:-2] + X.shape[-2:])


def _ldl_block(M: torch.Tensor, clamp: float = 0.0):
    """Unblocked LDL^T of (..., b, b) blocks, one rank-1 update a column.
    ``clamp > 0`` modifies pivots Cheng-Higham style,
    d_j <- sign(d_j) max(|d_j|, clamp) with sign(0) = +.  Returns (unit
    lower L, d)."""
    b = M.shape[-1]
    M = M.clone()
    L = torch.zeros_like(M)
    d = M.new_zeros(M.shape[:-1])
    for j in range(b):
        dj = M[..., j, j]
        if clamp > 0.0:
            s = torch.where(dj >= 0, 1.0, -1.0).to(dj.dtype)
            dj = s * torch.clamp(dj.abs(), min=clamp)
        col = M[..., j + 1:, j] / dj[..., None]
        L[..., j + 1:, j] = col
        d[..., j] = dj
        # M - dj (col col^T) in one rounding, as XLA contracts it
        M[..., j + 1:, j + 1:] = torch.addcmul(
            M[..., j + 1:, j + 1:], -dj[..., None, None], col[..., :, None] * col[..., None, :]
        )
    return L + torch.eye(b, dtype=M.dtype, device=M.device), d


def ldl_factor(A: torch.Tensor, block: int = 64, clamp: float = 0.0):
    """Blocked right-looking unpivoted LDL^T of (..., n, n) matrices.

    ``block`` columns at a time: the diagonal block is factored by the
    unblocked elimination, the panel below it by a unit-triangular solve,
    and the trailing matrix is updated by one product.  ``n`` is padded
    with identity to a multiple of ``block``, which leaves the leading
    factor unchanged.  Returns (unit lower L, d)."""
    n = A.shape[-1]
    if n == 0:
        return torch.zeros_like(A), A.new_zeros(A.shape[:-1])
    if n <= block:
        return _ldl_block(A, clamp)
    nb = -(-n // block)
    npad = nb * block
    if npad != n:
        Ap = torch.eye(npad, dtype=A.dtype, device=A.device).expand(
            A.shape[:-2] + (npad, npad)).clone()
        Ap[..., :n, :n] = A
        L, d = ldl_factor(Ap, block, clamp)
        return L[..., :n, :n], d[..., :n]
    M = A.clone()
    L = torch.zeros_like(A)
    d = A.new_zeros(A.shape[:-1])
    for k in range(nb):
        j0, j1 = k * block, (k + 1) * block
        Lkk, dk = _ldl_block(M[..., j0:j1, j0:j1], clamp)
        L[..., j0:j1, j0:j1] = Lkk
        d[..., j0:j1] = dk
        if j1 < n:
            # the rows below the block: X (Lkk dk)^T = panel
            X = _trsm(Lkk, M[..., j1:, j0:j1], left=False, trans=True) / dk[..., None, :]
            M[..., j1:, j1:] -= (X * dk[..., None, :]) @ X.mT
            L[..., j1:, j0:j1] = X
    return L, d


def ldl_factor_unblocked(A: torch.Tensor):
    """Column-by-column unpivoted LDL^T, A = L diag(d) L^T, of (..., n, n)
    matrices: one rank-1 update of the trailing matrix a column, the
    JAX tests' oracle.  Returns (unit lower L, d)."""
    if A.shape[-1] == 0:
        return torch.zeros_like(A), A.new_zeros(A.shape[:-1])
    return _ldl_block(A)


def ldl_solve(L: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with (L diag(d) L^T) x = b for a batch: L (..., n, n), d (..., n),
    and b (..., n) or a block of right-hand sides (..., n, k)."""
    vec = b.dim() == L.dim() - 1
    bb = b.unsqueeze(-1) if vec else b
    y = _trsm(L, bb, left=True, trans=False) / d.unsqueeze(-1)
    x = _trsm(L, y, left=True, trans=True)
    return x.squeeze(-1) if vec else x


def ldl_inertia(d: torch.Tensor, tol: float = 0.0):
    """(#positive, #negative) pivots of d (..., n), each pivot equal to
    ``tol`` counting one half, as the reference's
    ``sum(heaviside(+-dHess - tol))`` does (lib/ipmPD_CS.m:277-279)."""
    one, half, zero = (torch.tensor(v, dtype=d.dtype, device=d.device)
                       for v in (1.0, 0.5, 0.0))
    mp = torch.where(d > tol, one, torch.where(d == tol, half, zero)).sum(dim=-1)
    mn = torch.where(-d > tol, one, torch.where(-d == tol, half, zero)).sum(dim=-1)
    return mp, mn


def symmetric_solve(A: torch.Tensor, b: torch.Tensor, block: int = 64):
    """Factor, solve and the pivots in one call: returns (x, d, L)."""
    L, d = ldl_factor(A, block=block)
    return ldl_solve(L, d, b), d, L


class KKTFactorization:
    """A factored batch of KKT matrices WW (B, n, n).

    ``'lu'``: the pivoted LU (a = LU, b = pivots) in WW's dtype.
    ``'lu_ir'``: a float32 LU whose solves are refined ``n_refine`` times
    against WW in its own dtype.  ``'ldl'``: the unpivoted LDL^T
    (a = L, b = d).  ``'ldl_ir'``: a clamped LDL^T refined as ``'lu_ir'``.
    Inertia: the sign counts of d for the LDL^T kinds, the Bunch-Kaufman
    counts ``bk`` where given, else zeros (an LU carries none)."""

    __slots__ = ("kind", "a", "b", "WW", "n_refine", "bk")

    def __init__(self, kind: str, a: torch.Tensor, b: torch.Tensor, WW=None,
                 n_refine: int = 0, bk=None):
        if kind not in ("lu", "lu_ir", "ldl", "ldl_ir"):
            raise ValueError(f"unknown KKTFactorization kind {kind!r}")
        self.kind = kind
        self.a = a
        self.b = b
        self.WW = WW
        self.n_refine = n_refine
        self.bk = bk

    def _lu_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        return torch.linalg.lu_solve(self.a, self.b, rhs.unsqueeze(-1)).squeeze(-1)

    def _refined(self, solve_f, rhs: torch.Tensor) -> torch.Tensor:
        dt, fdt = rhs.dtype, self.a.dtype

        def solve1(r):
            return solve_f(r.to(fdt)).to(dt)

        x = solve1(rhs)
        for _ in range(self.n_refine):
            x = x + solve1(rhs - hdot(self.WW, x))
        return x

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if self.kind == "lu":
            return self._lu_solve(rhs)
        if self.kind == "lu_ir":
            return self._refined(self._lu_solve, rhs)
        if self.kind == "ldl_ir":
            return self._refined(lambda r: ldl_solve(self.a, self.b, r), rhs)
        return ldl_solve(self.a, self.b, rhs)

    def inertia(self, tol: float = 0.0):
        if self.bk is not None:
            if tol != 0.0:
                raise ValueError(
                    "inertia(tol != 0) is not available on the Bunch-Kaufman path: "
                    "its counts are taken at factor time with tol = 0"
                )
            dt = (self.WW if self.WW is not None else self.a).dtype
            return self.bk[0].to(dt), self.bk[1].to(dt)
        if self.kind in ("ldl", "ldl_ir"):
            return ldl_inertia(self.b, tol)
        z = self.a.new_zeros(self.a.shape[:-2])
        return z, z


def kkt_factorize(WW: torch.Tensor, need_inertia: bool, block: int = 64,
                  n_refine: int = 2, force_ldl: bool = False) -> KKTFactorization:
    """The IPM's dense KKT backend for a batch WW (B, n, n), as the JAX
    package's on the CPU and GPU: a pivoted LU in WW's dtype; with
    ``need_inertia`` an LDL^T in float64, or in float32 an LU refined
    against WW with Bunch-Kaufman inertia; with ``force_ldl`` (the
    ``'ldl'`` backend) the blocked LDL^T, clamped at 1e-7 and refined at
    least twice below float64."""
    if force_ldl:
        if WW.dtype != torch.float64:
            L, d = ldl_factor(WW, block=block, clamp=1e-7)
            return KKTFactorization("ldl_ir", L, d, WW=WW, n_refine=max(n_refine, 2))
        L, d = ldl_factor(WW, block=block)
        return KKTFactorization("ldl", L, d)
    if need_inertia:
        if WW.dtype == torch.float64:
            L, d = ldl_factor(WW, block=block)
            return KKTFactorization("ldl", L, d)
        from .bunchkaufman import bk_inertia

        W32 = WW.to(torch.float32)
        LU, piv = torch.linalg.lu_factor_ex(W32)[:2]
        return KKTFactorization("lu_ir", LU, piv, WW=WW, n_refine=n_refine,
                                bk=bk_inertia(W32))
    # no error check: a singular WW gives a solve of infinities and NaN,
    # as LAPACK's getrf/getrs do in the JAX package
    LU, piv = torch.linalg.lu_factor_ex(WW)[:2]
    return KKTFactorization("lu", LU, piv)


def lu_solve_mixed(WW: torch.Tensor, rhs: torch.Tensor, n_refine: int = 2) -> torch.Tensor:
    """One pivoted-LU solve of a batch, WW (B, n, n), rhs (B, n), through
    :func:`kkt_factorize`: in WW's dtype, unrefined."""
    return kkt_factorize(WW, need_inertia=False, n_refine=n_refine).solve(rhs)
