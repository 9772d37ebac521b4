"""Dense KKT helpers (port of ``tenscalc_tpu/kkt/dense.py``): ``hdot``,
``lu_solve_mixed``, and the unpivoted LDL^T pieces the min-max solver
calls (``ldl_factor``, ``ldl_solve``, ``ldl_inertia`` and
``KKTFactorization`` of kind ``'ldl'``).  The other factorization kinds
and ``kkt_factorize`` are ROADMAP item M4.

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


def hdotT(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``A.T @ y`` for a batch of vectors ``y`` (B, m), with ``A`` as in
    :func:`hdot`.  Returns (B, n)."""
    if A.dim() == 2:
        return y @ A
    return torch.bmm(y.unsqueeze(1), A).squeeze(1)


def lu_solve_mixed(WW: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """One-shot pivoted-LU solve of a batch, WW (B, n, n), rhs (B, n), in
    WW's dtype: the CPU/GPU branch of the JAX ``kkt_factorize``
    (``dense.py:350-354``), which neither casts to float32 nor refines."""
    LU, piv = torch.linalg.lu_factor(WW)
    return torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1)).squeeze(-1)


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


def ldl_solve(L: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with (L diag(d) L^T) x = b for a batch: L (..., n, n), d and b
    (..., n)."""
    y = _trsm(L, b.unsqueeze(-1), left=True, trans=False) / d.unsqueeze(-1)
    return _trsm(L, y, left=True, trans=True).squeeze(-1)


def ldl_inertia(d: torch.Tensor, tol: float = 0.0):
    """(#positive, #negative) pivots of d (..., n), each pivot equal to
    ``tol`` counting one half, as the reference's
    ``sum(heaviside(+-dHess - tol))`` does (lib/ipmPD_CS.m:277-279)."""
    one, half, zero = (torch.tensor(v, dtype=d.dtype, device=d.device)
                       for v in (1.0, 0.5, 0.0))
    mp = torch.where(d > tol, one, torch.where(d == tol, half, zero)).sum(dim=-1)
    mn = torch.where(-d > tol, one, torch.where(-d == tol, half, zero)).sum(dim=-1)
    return mp, mn


class KKTFactorization:
    """A factored KKT matrix of kind ``'ldl'`` (the min-max solver's dense
    default: solve and inertia from one unpivoted factorization).  The
    JAX package's other kinds (``'lu'``, ``'lu_ir'``, ``'ldl_ir'``,
    Bunch-Kaufman inertia) are ROADMAP item M4."""

    __slots__ = ("kind", "a", "b")

    def __init__(self, kind: str, a: torch.Tensor, b: torch.Tensor):
        if kind != "ldl":
            raise NotImplementedError(
                f"KKTFactorization of kind {kind!r} is not ported yet (ROADMAP item M4)"
            )
        self.kind = kind
        self.a = a
        self.b = b

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        return ldl_solve(self.a, self.b, rhs)

    def inertia(self, tol: float = 0.0):
        return ldl_inertia(self.b, tol)
