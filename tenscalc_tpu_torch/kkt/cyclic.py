"""Block cyclic reduction for symmetric block-tridiagonal systems (port
of ``tenscalc_tpu/kkt/cyclic.py``): the log-depth alternative to the
sequential recursion of :mod:`.tridiag`.

Each level eliminates the even-indexed block rows of the chain at once
(batched s x s LU solves and products over the level's rows), halving
it; log2(nb) levels reach one root block, and the back-substitution
replays the levels in reverse.  The chain is padded with identity blocks
to 2^m - 1.  Everything runs in the matrix's dtype: the odd/even order
amplifies pivot growth on quasi-definite KKT systems, so the JAX package
recommends float64 and treats float32 as fit only for well-conditioned
systems.  Plain PyTorch, as the JAX package's XLA code is; batched over
the fleet (a leading dimension on every argument).
"""

from __future__ import annotations

import torch

from .structure import BandedPlan
from .tridiag import _to_blocks


def _solve_blocks(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """A[..., i] X = R[..., i] for (..., s, s) blocks: a batched pivoted
    LU and its solve."""
    lu, piv = torch.linalg.lu_factor_ex(A)[:2]
    return torch.linalg.lu_solve(lu, piv, R)


def _rows(x: torch.Tensor, count: int) -> torch.Tensor:
    """The first ``count`` chain rows of x (Bn, m, ...), zero-padded."""
    m = x.shape[1]
    if m >= count:
        return x[:, :count]
    return torch.cat([x, x.new_zeros((x.shape[0], count - m) + x.shape[2:])], dim=1)


def cr_solve(A: torch.Tensor, B: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a batch of symmetric block-tridiagonal systems by cyclic
    reduction.  A: (Bn, nb, s, s) diagonal blocks; B: (Bn, nb, s, s)
    subdiagonal blocks (B[:, i] couples block i to i-1, B[:, 0] = 0); b:
    (Bn, nb, s).  Returns x (Bn, nb, s), computed in A's dtype."""
    Bn, nb, s, _ = A.shape
    m = 1
    while 2 ** m - 1 < nb:
        m += 1
    npad = 2 ** m - 1
    if npad != nb:
        eye = torch.eye(s, dtype=A.dtype, device=A.device).expand(Bn, npad - nb, s, s)
        A = torch.cat([A, eye], dim=1)
        B = torch.cat([B, B.new_zeros(Bn, npad - nb, s, s)], dim=1)
        b = torch.cat([b, b.new_zeros(Bn, npad - nb, s)], dim=1)

    levels = []
    Acur, Bcur, bcur = A, B, b
    n_cur = npad
    while n_cur > 1:
        # eliminated rows E = even indices 2i, kept rows K = odd 2i+1:
        # B[2i] x_{2i-1} + A[2i] x_{2i} + B[2i+1]^T x_{2i+1} = b[2i]
        Ao = Acur[:, 0::2]
        Ae = Acur[:, 1::2]
        nE, nK = Ao.shape[1], Ae.shape[1]
        Lc = Bcur[:, 0::2]                       # coupling to the left kept row
        Rc = _rows(Bcur[:, 1::2], nE)            # B[2i+1]: kept row -> elim row
        be = bcur[:, 0::2]
        sols = _solve_blocks(Ao, torch.cat([Lc, Rc.mT, be[..., None]], dim=-1))
        XL = sols[..., :s]                       # A^{-1} L
        XR = sols[..., s:2 * s]                  # A^{-1} R^T
        xb = sols[..., -1]                       # A^{-1} b
        Rk = Bcur[:, 1::2]                       # kept row -> left elim row
        Lk_next = _rows(Bcur[:, 2::2], nK)       # right elim row -> kept row
        XL_right = _rows(XL[:, 1:nK + 1], nK)
        A_new = (Ae - torch.matmul(Rk, XR[:, :nK])
                 - torch.matmul(Lk_next.mT, XL_right))
        B_new = -torch.matmul(Rk, XL[:, :nK])
        B_new[:, 0] = 0
        b_new = (bcur[:, 1::2]
                 - torch.matmul(Rk, xb[:, :nK, :, None])[..., 0]
                 - torch.matmul(Lk_next.mT, _rows(xb[:, 1:nK + 1], nK)[..., None])[..., 0])
        levels.append((nE, XL, XR, xb))
        Acur, Bcur, bcur = A_new, B_new, b_new
        n_cur = (n_cur - 1) // 2

    xs = torch.linalg.solve(Acur[:, 0], bcur[:, 0])[:, None]
    for nE, XL, XR, xb in reversed(levels):
        nK = xs.shape[1]
        zero = xs.new_zeros(Bn, 1, s)
        x_left = torch.cat([zero, xs], dim=1)[:, :nE]
        x_right = torch.cat([xs, zero], dim=1)[:, :nE]
        xe = (xb - torch.matmul(XL, x_left[..., None])[..., 0]
              - torch.matmul(XR, x_right[..., None])[..., 0])
        out = xs.new_zeros(Bn, nE + nK, s)
        out[:, 0::2] = xe
        out[:, 1::2] = xs
        xs = out
    return xs[:, :nb]


def cr_solve_permuted(WW: torch.Tensor, plan: BandedPlan, rhs: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Permute a batch of banded matrices WW (B, n, n) by the plan, solve
    for rhs (B, n) by cyclic reduction in ``dtype``, and return x in the
    original order."""
    perm = torch.as_tensor(plan.perm, device=WW.device)
    iperm = torch.as_tensor(plan.iperm, device=WW.device)
    A, B = _to_blocks(WW[:, perm][:, :, perm].to(dtype), plan)
    s, nb, n = plan.block, plan.n_blocks, plan.n
    Bn = rhs.shape[0]
    bp = rhs[:, perm].to(dtype)
    bp = torch.cat([bp, bp.new_zeros(Bn, nb * s - n)], dim=1)
    x = cr_solve(A, B, bp.view(Bn, nb, s))
    return x.reshape(Bn, nb * s)[:, :n][:, iperm]


class CyclicFactorization:
    """KKT-backend adapter: the reduction is redone at every solve (it is
    cheap and log-depth), in the matrix's dtype, with one refinement."""

    def __init__(self, WW: torch.Tensor, plan: BandedPlan, n_refine: int = 1):
        self.WW = WW
        self.plan = plan
        self.n_refine = n_refine

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if rhs.dim() == 3:
            return torch.stack([self.solve(rhs[..., j]) for j in range(rhs.shape[-1])],
                               dim=-1)
        dt, wdt = rhs.dtype, self.WW.dtype
        x = cr_solve_permuted(self.WW, self.plan, rhs, dtype=wdt).to(dt)
        for _ in range(self.n_refine):
            r = rhs - torch.bmm(self.WW, x.unsqueeze(-1)).squeeze(-1)
            x = x + cr_solve_permuted(self.WW, self.plan, r, dtype=wdt).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        """No inertia (the JAX package's (0, 0)), per instance."""
        z = self.WW.new_zeros(self.WW.shape[0])
        return z, z
