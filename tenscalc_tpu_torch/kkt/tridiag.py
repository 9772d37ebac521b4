"""Block-tridiagonal KKT factorization (port of
``tenscalc_tpu/kkt/tridiag.py``): the structured path for MPC horizons.

After the planner (:mod:`.structure`) permutes the KKT to half bandwidth
s, the matrix is block-tridiagonal in s-blocks and is factored by the
block recursion

    D_0 = A_0,   L_i = B_i D_{i-1}^{-1},   D_i = A_i - L_i B_i^T,

each D_i by a pivoted LU (``torch.linalg.lu_factor_ex``).  The JAX
package runs this in XLA (``lax.scan``, ``lu_factor``/``lu_solve``), no
Pallas kernel, so plain PyTorch is its port on the card too.  Every
adapter of the port works on a batch: WW is (B, n, n) and a right-hand
side (B, n) or (B, n, k); the recursion's stages run one after another,
each batched over the fleet.
"""

from __future__ import annotations

import torch

from .dense import equilibration_scale
from .structure import BandedPlan

# the block pivot clamp of a float32 factor (JAX tridiag.py:195-207)
CLAMP = 1e-7
# Schur blocks one batched eigvalsh call takes: cuSOLVER's batched
# eigensolver (CUDA 12.8, on the H100) refused 32,767 blocks a call of
# s = 4, 6 and 10 and took 16,385
EIG_CHUNK = 16384


def _factor_dtype(WW: torch.Tensor) -> torch.dtype:
    """The dtype a block-tridiagonal factor is formed in: WW's own, on
    every device.  That is the JAX package's rule off the TPU (on the TPU
    it factors in float32, whose LU takes nothing else): a float32 problem
    factors in float32 on the card as on the TPU, a float64 one in
    float64.  :func:`tridiag_factorize` and
    :func:`.banded_lu.tridiag_lu_factorize` both use it."""
    return WW.dtype


def _block_view(Wp: torch.Tensor, plan: BandedPlan) -> torch.Tensor:
    """A batch of permuted matrices (B, n, n) padded to whole blocks with
    identity rows, as a (B, nb, nb, s, s) view: [:, i, k] is block (i, k).
    The padding leaves the factorization of the leading n x n unchanged."""
    s, nb, n = plan.block, plan.n_blocks, plan.n
    npad = nb * s
    Bn = Wp.shape[0]
    W = torch.eye(npad, dtype=Wp.dtype, device=Wp.device).repeat(Bn, 1, 1)
    W[:, :n, :n] = Wp
    return W.view(Bn, nb, s, nb, s).transpose(2, 3)


def _to_blocks(Wp: torch.Tensor, plan: BandedPlan):
    """Diagonal blocks A_i and subdiagonal blocks B_i (block (i, i-1),
    B_0 = 0) of a batch of permuted matrices, each (B, nb, s, s)."""
    blocks = _block_view(Wp, plan)
    idx = torch.arange(plan.n_blocks, device=Wp.device)
    A = blocks[:, idx, idx]
    Bs = torch.zeros_like(A)
    Bs[:, 1:] = blocks[:, idx[1:], idx[:-1]]
    return A, Bs


def _clamp_lu(lu: torch.Tensor, clamp: float) -> torch.Tensor:
    """U's diagonal of a pivoted block LU set to ±clamp where smaller in
    magnitude, sign(0) = +: the block-level analog of the Cheng-Higham
    pivot clamp (the block recursion itself is unpivoted)."""
    if clamp == 0.0:
        return lu
    d = torch.diagonal(lu, dim1=-2, dim2=-1)
    dc = torch.where(d.abs() < clamp,
                     torch.where(d >= 0, clamp, -clamp).to(lu.dtype), d)
    lu = lu.clone()
    torch.diagonal(lu, dim1=-2, dim2=-1).copy_(dc)
    return lu


def block_ldl(A: torch.Tensor, B: torch.Tensor, clamp: float = 0.0):
    """The block recursion of a batch of chains, A (N, m, s, s) diagonal
    and B (N, m, s, s) subdiagonal blocks (B[:, 0] unused): L_i = B_i
    D_{i-1}^{-1} by a transposed LU solve, D_i = A_i - L_i B_i^T, each D_i
    by a pivoted LU, its U pivots clamped at ``clamp`` (0: none).
    Returns (Ls, Ds, lus, pivs), each stacked over the chain."""
    lu, piv = torch.linalg.lu_factor_ex(A[:, 0])[:2]
    lu = _clamp_lu(lu, clamp)
    Ls, Ds, lus, pivs = [torch.zeros_like(A[:, 0])], [A[:, 0]], [lu], [piv]
    for i in range(1, A.shape[1]):
        # L_i = B_i D_{i-1}^{-1}  <=>  D_{i-1}^T L_i^T = B_i^T
        L = torch.linalg.lu_solve(lu, piv, B[:, i].mT, adjoint=True).mT
        D = A[:, i] - torch.matmul(L, B[:, i].mT)
        lu, piv = torch.linalg.lu_factor_ex(D)[:2]
        lu = _clamp_lu(lu, clamp)
        Ls.append(L)
        Ds.append(D)
        lus.append(lu)
        pivs.append(piv)
    return torch.stack(Ls, 1), torch.stack(Ds, 1), torch.stack(lus, 1), torch.stack(pivs, 1)


def block_ldl_solve(Ls, lus, pivs, b: torch.Tensor) -> torch.Tensor:
    """Solve the chains of :func:`block_ldl` for b (N, m, s, k): forward
    y_i = b_i - L_i y_{i-1}, the diagonal z_i = D_i^{-1} y_i (every block
    at once), backward x_i = z_i - L_{i+1}^T x_{i+1}."""
    m = Ls.shape[1]
    ys = [b[:, 0]]
    for i in range(1, m):
        ys.append(b[:, i] - torch.matmul(Ls[:, i], ys[-1]))
    zs = torch.linalg.lu_solve(lus, pivs, torch.stack(ys, 1))
    xs = [None] * m
    x = xs[m - 1] = zs[:, m - 1]
    for i in range(m - 2, -1, -1):
        x = xs[i] = zs[:, i] - torch.matmul(Ls[:, i + 1].mT, x)
    return torch.stack(xs, 1)


class TridiagFactorization:
    """Factor of a batch of permuted, padded block-tridiagonal matrices:
    solves in the factor's dtype, refined ``n_refine`` times against WW
    with the JAX package's safeguard, decided per instance (and per
    column of a matrix right-hand side, as JAX's ``vmap`` decides it)."""

    def __init__(self, Ls, Ds, lus, pivs, plan: BandedPlan, WW, n_refine: int = 2,
                 scale=None):
        self.Ls = Ls            # (B, nb, s, s) L_i (L_0 = 0)
        self.Ds = Ds            # (B, nb, s, s) Schur diagonal blocks
        self.lus, self.pivs = lus, pivs  # their pivoted LUs
        self.plan = plan
        self.WW = WW            # the unpermuted matrix (B, n, n)
        self.n_refine = n_refine
        self.scale = scale      # (B, n) Jacobi scale, permuted order
        self.perm = torch.as_tensor(plan.perm, device=WW.device)
        self.iperm = torch.as_tensor(plan.iperm, device=WW.device)

    def _solve32(self, b: torch.Tensor) -> torch.Tensor:
        """One solve of the permuted padded system, b (B, n), in the
        factor's dtype, unrefined."""
        s, nb, n = self.plan.block, self.plan.n_blocks, self.plan.n
        Bn = b.shape[0]
        bp = b[:, self.perm].to(self.Ls.dtype)
        if self.scale is not None:
            bp = self.scale * bp
        bb = torch.cat([bp, bp.new_zeros(Bn, nb * s - n)], dim=1).view(Bn, nb, s, 1)
        x = block_ldl_solve(self.Ls, self.lus, self.pivs, bb).reshape(Bn, nb * s)[:, :n]
        if self.scale is not None:
            x = self.scale * x
        return x[:, self.iperm]

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if rhs.dim() == 3:
            # a column at a time, as the JAX package vmaps its columns
            return torch.stack([self.solve(rhs[..., j]) for j in range(rhs.shape[-1])],
                               dim=-1)
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        # safeguarded refinement: the factor can be a divergent
        # preconditioner on ill-conditioned IPM-endgame systems; an
        # instance keeps a refined iterate only where it lowers the
        # residual and is finite
        x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=dt, device=x.device))
        r = rhs - torch.bmm(self.WW, x.unsqueeze(-1)).squeeze(-1)
        for _ in range(self.n_refine):
            x2 = x + self._solve32(r).to(dt)
            r2 = rhs - torch.bmm(self.WW, x2.unsqueeze(-1)).squeeze(-1)
            better = (r2.abs().amax(dim=1) < r.abs().amax(dim=1)) & torch.isfinite(x2).all(dim=1)
            x = torch.where(better[:, None], x2, x)
            r = torch.where(better[:, None], r2, r)
        return x

    def inertia(self, tol: float = 0.0):
        """Eigenvalue-sign counts per instance: the inertia of W is the sum
        of the D_i's (Sylvester on the block LDL^T); the identity padding's
        +1 eigenvalues are taken off.  A block with a non-finite entry
        counts no eigenvalue, as NaN eigenvalues count none in the JAX
        package (cuSOLVER refuses such a block, so it is zeroed first)."""
        Ds = 0.5 * (self.Ds + self.Ds.mT)
        finite = torch.isfinite(Ds).flatten(-2).all(dim=-1)
        Ds = torch.where(finite[..., None, None], Ds, torch.zeros_like(Ds)).flatten(0, 1)
        w = torch.cat([torch.linalg.eigvalsh(c) for c in Ds.split(EIG_CHUNK)])
        w = w.view(finite.shape + w.shape[-1:])
        w = torch.where(finite[..., None], w, torch.full_like(w, float("nan"))).flatten(1)
        extra = self.plan.n_blocks * self.plan.block - self.plan.n
        mp = (w > tol).sum(dim=1) - extra
        mn = (w < -tol).sum(dim=1)
        return mp.to(w.dtype), mn.to(w.dtype)


def tridiag_factorize(WW: torch.Tensor, plan: BandedPlan,
                      n_refine: int = 2) -> TridiagFactorization:
    """Permute, equilibrate and factor a batch of block-tridiagonal KKT
    matrices WW (B, n, n).  The Jacobi scale s = 1/sqrt(max(|diag|,
    1e-30)) compresses the pivots' range (without it the float32 block
    elimination loses the IPM endgame); it is formed by
    :func:`.dense.equilibration_scale`, correctly rounded where XLA's
    ``rsqrt`` may be off in the last bit.  A float32 factor clamps each
    diagonal block's U pivots at 1e-7 (:func:`_clamp_lu`)."""
    perm = torch.as_tensor(plan.perm, device=WW.device)
    fdt = _factor_dtype(WW)
    WWp = WW[:, perm][:, :, perm].to(fdt)
    s_eq = equilibration_scale(torch.diagonal(WWp, dim1=-2, dim2=-1).abs())
    WWp = WWp * s_eq[:, :, None] * s_eq[:, None, :]
    A, Bs = _to_blocks(WWp, plan)
    Ls, Ds, lus, pivs = block_ldl(A, Bs, CLAMP if fdt == torch.float32 else 0.0)
    return TridiagFactorization(Ls, Ds, lus, pivs, plan, WW, n_refine=n_refine, scale=s_eq)
