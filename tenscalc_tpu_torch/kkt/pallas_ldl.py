"""Single-instance dense LDL^T (port of ``tenscalc_tpu/kkt/pallas_ldl.py``).

``pallas_ldl_factor`` returns ``(Lt, d)`` with ``Lt = L^T`` (row c holds
column c of the unit-lower L, 1 on the diagonal); pivots are clamped
(Cheng-Higham) ``d <- sign(d) * max(|d|, clamp)`` with sign(0) = +, and
there is no pivoting.  Every entry point takes one matrix (n, n) or a
batch (B, n, n), as the JAX kernels batch under ``vmap``: at n <= 32 a
CTA of one warp an instance (K6 and K8 the warp factor, K8 and K7 the
warp solve of K5), above it the tiles route, a launch a 32-column panel
of one-warp CTAs over the instance's tiles, then for K8 and K7 a CTA an
instance by 32-row blocks (``dense_ldl.factor_plan``).

A CPU tensor goes to the plain PyTorch version (``*_plain``); a CUDA
tensor goes to the hand-written kernels of ``csrc/dense_ldl.cu`` (K6
factor, K7 solve, K8 factor+solve), or the call raises.  The plain
versions repeat the kernels' arithmetic and reduction order, so on the
card the two agree to the last bit.  The TPU kernel's 128-wide panels
and trailing GEMM are not repeated: for n > 128 both round differently
from it, within float32 accuracy.
"""

from __future__ import annotations

import torch

from .dense import hdot
from .dense_ldl import (
    SINGLE_MAX_N,
    block_threads,
    check_matrix,
    check_vector,
    launch_factor,
    launch_factor_solve,
    launch_solve,
    solve_rows_plain,
)
from .fleet_banded import _clamp_pivot


def pallas_ldl_factor_plain(A: torch.Tensor, clamp: float = 0.0):
    """Plain version of K6: A (B, n, n) -> (Lt, d)."""
    B, n, _ = A.shape
    M = A.clone()
    Lt = torch.zeros_like(A)
    d = A.new_empty(B, n)
    for c in range(n):
        dc = _clamp_pivot(M[:, c, c], clamp)
        r = M[:, c, c + 1:] / dc[:, None]
        Lt[:, c, c] = 1.0
        Lt[:, c, c + 1:] = r
        d[:, c] = dc
        M[:, c + 1:, c + 1:] -= dc[:, None, None] * (r[:, :, None] * r[:, None, :])
    return Lt, d


def pallas_ldl_solve_plain(Lt: torch.Tensor, d: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: x with (L diag(d) L^T) x = b."""
    return solve_rows_plain(Lt, d, b, block_threads(b.shape[-1]))


def pallas_ldl_factor_solve_plain(A: torch.Tensor, b: torch.Tensor,
                                  clamp: float = 0.0):
    """Plain version of K8: (Lt, d, x)."""
    Lt, d = pallas_ldl_factor_plain(A, clamp)
    return Lt, d, pallas_ldl_solve_plain(Lt, d, b)


def _batched(*ts):
    """Whether the call is unbatched (a matrix (n, n) first), and its
    tensors with a batch dimension."""
    single = ts[0].dim() == 2
    return single, [t[None] if single else t for t in ts]


def pallas_ldl_factor(A: torch.Tensor, clamp: float = 0.0):
    """LDL^T of a symmetric float32 matrix (n, n), or a batch (B, n, n):
    returns (Lt, d)."""
    single, (A,) = _batched(A)
    check_matrix(A, SINGLE_MAX_N)
    if A.device.type == "cpu":
        Lt, d = pallas_ldl_factor_plain(A, clamp)
    else:
        A = A.contiguous()
        Lt, d = torch.empty_like(A), A.new_empty(A.shape[:2])
        launch_factor(A, Lt, d, clamp)
    return (Lt[0], d[0]) if single else (Lt, d)


def pallas_ldl_solve(Lt: torch.Tensor, d: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Solve (L diag(d) L^T) x = b against the factor of
    :func:`pallas_ldl_factor`."""
    single, (Lt, d, b) = _batched(Lt, d, b)
    check_matrix(Lt, SINGLE_MAX_N)
    check_vector(Lt, d, "d")
    check_vector(Lt, b)
    if Lt.device.type == "cpu":
        x = pallas_ldl_solve_plain(Lt, d, b)
    else:
        x = torch.empty_like(b)
        launch_solve(Lt.contiguous(), d.contiguous(), b.contiguous(), x)
    return x[0] if single else x


def pallas_ldl_factor_solve(A: torch.Tensor, b: torch.Tensor,
                            clamp: float = 0.0):
    """Factor and one solve in one launch: returns (Lt, d, x)."""
    single, (A, b) = _batched(A, b)
    check_matrix(A, SINGLE_MAX_N)
    check_vector(A, b)
    if A.device.type == "cpu":
        Lt, d, x = pallas_ldl_factor_solve_plain(A, b, clamp)
    else:
        A, b = A.contiguous(), b.contiguous()
        Lt, d, x = torch.empty_like(A), A.new_empty(A.shape[:2]), torch.empty_like(b)
        launch_factor_solve(A, b, Lt, d, x, clamp)
    return (Lt[0], d[0], x[0]) if single else (Lt, d, x)


class PallasLDLFactorization:
    """KKT-backend adapter for a batch WW (B, n, n): the float32 factor
    (K6) at construction, float32 solves (K7) refined ``n_refine`` times
    against WW in its own dtype, and inertia from the D diagonal."""

    def __init__(self, WW: torch.Tensor, n_refine: int = 2, clamp: float = 0.0):
        self.WW = WW
        self.n_refine = n_refine
        self.Lt, self.d = pallas_ldl_factor(WW.to(torch.float32), clamp=clamp)

    def _solve32(self, rhs: torch.Tensor) -> torch.Tensor:
        return pallas_ldl_solve(self.Lt, self.d, rhs.to(torch.float32))

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        for _ in range(self.n_refine):
            x = x + self._solve32(rhs - hdot(self.WW, x)).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        rt = self.WW.dtype
        return (self.d > tol).sum(dim=1).to(rt), (self.d < -tol).sum(dim=1).to(rt)


def pallas_kkt_factorize(WW: torch.Tensor, n_refine: int = 2,
                         clamp: float = 0.0) -> PallasLDLFactorization:
    return PallasLDLFactorization(WW, n_refine=n_refine, clamp=clamp)
