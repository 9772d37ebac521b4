"""Fleet dense LDL^T: a batch of unpivoted factorizations (port of
``tenscalc_tpu/kkt/fleet.py``).

The IPM's condensed KKT of a small problem (nK < 64), or of one without
a worthwhile band, is factored densely.  ``fleet_ldl_factor_batched``
returns ``(L, d)`` in the JAX layout: row j of L holds column j of the
unit-lower factor, with the pivot at [j, j] and zeros before it.  Pivots
are clamped (Cheng-Higham) ``d <- sign(d) * max(|d|, clamp)`` with
sign(0) = +; there is no pivoting.

A CPU tensor goes to the plain PyTorch version (``*_plain``); a CUDA
tensor goes to the hand-written kernels of ``csrc/dense_ldl.cu`` (K4
factor, K5 solve), or the call raises.  The plain versions repeat the
kernels' arithmetic and reduction order, so on the card the two agree
to the last bit.

The JAX per-instance API (``fleet_ldl_factor``/``_solve``/
``_factor_solve``) is ``custom_vmap``: unbatched it takes the
single-instance kernels, under ``vmap`` the fleet kernels.  Here it
takes a batch and dispatches on its size: B = 1 (n <= 896) goes to the
single-instance K6-K8 of :mod:`.pallas_ldl`, which return ``Lt`` with a
unit diagonal; B > 1 goes to K4/K5.  Above the kernels' caps the JAX
package's own size rule applies, as it does there: the batched entry
points take a fleet of n > 160 (``fleet.py:54-57``), and a single
instance of n > 896 (``fleet.py:263-320``), to the blocked LDL^T of
:mod:`.dense` (clamp 1e-7, 64-column panels, in float32), whose factor is
a standard unit-lower L.  The route is a function of the shape alone,
chosen before any launch, and the factor and its solves pass through the
same dispatch, so each solve reads the layout its factor call produced.
"""

from __future__ import annotations

import torch

from .dense import equilibration_scale, hdot, ldl_factor, ldl_solve
from .dense_ldl import (
    CLAMP,
    FLEET_MAX_N,
    SINGLE_MAX_N,
    check_matrix,
    check_vector,
    launch_fleet_factor,
    launch_fleet_solve,
    solve_rows_plain,
)
from .fleet_banded import _clamp_pivot
from .pallas_ldl import pallas_ldl_factor, pallas_ldl_factor_solve, pallas_ldl_solve


def fleet_ldl_factor_plain(A: torch.Tensor, clamp: float = 0.0):
    """Plain version of K4: A (B, n, n) -> (L, d)."""
    B, n, _ = A.shape
    M = A.clone()
    L = torch.zeros_like(A)
    d = A.new_empty(B, n)
    for j in range(n):
        dj = _clamp_pivot(M[:, j, j], clamp)
        r = M[:, j, j + 1:] / dj[:, None]
        L[:, j, j] = dj
        L[:, j, j + 1:] = r
        d[:, j] = dj
        M[:, j + 1:, j + 1:] -= (dj[:, None] * r)[:, :, None] * r[:, None, :]
    return L, d


def fleet_ldl_solve_plain(L: torch.Tensor, d: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (one warp per instance)."""
    return solve_rows_plain(L, d, b, 32)


def fleet_ldl_factor_batched(A: torch.Tensor, clamp: float = 0.0):
    """LDL^T of a batch: A (B, n, n) float32 -> (L (B, n, n), d (B, n)).
    Above n = 160 the blocked LDL^T, whose L is unit lower."""
    check_matrix(A)
    if A.shape[-1] > FLEET_MAX_N:
        return ldl_factor(A, clamp=clamp)
    if A.device.type == "cpu":
        return fleet_ldl_factor_plain(A, clamp)
    A = A.contiguous()
    L, d = torch.empty_like(A), A.new_empty(A.shape[:2])
    launch_fleet_factor(A, L, d, clamp)
    return L, d


def fleet_ldl_solve_batched(L: torch.Tensor, d: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Solve (L diag(d) L^T) x = b for a batch: (B, n, n), (B, n), (B, n),
    against :func:`fleet_ldl_factor_batched`'s factor."""
    check_matrix(L)
    check_vector(L, d, "d")
    check_vector(L, b)
    if L.shape[-1] > FLEET_MAX_N:
        return ldl_solve(L, d, b)
    if L.device.type == "cpu":
        return fleet_ldl_solve_plain(L, d, b)
    x = torch.empty_like(b)
    launch_fleet_solve(L.contiguous(), d.contiguous(), b.contiguous(), x)
    return x


def _single_route(A: torch.Tensor) -> bool:
    return A.shape[0] == 1 and A.shape[-1] <= SINGLE_MAX_N


def fleet_ldl_factor(A: torch.Tensor):
    """Factor a batch, clamp 1e-7: K6 at B = 1 and n <= 896, else
    :func:`fleet_ldl_factor_batched` (K4 to n = 160, the blocked LDL^T
    above)."""
    if _single_route(A):
        return pallas_ldl_factor(A, clamp=CLAMP)
    return fleet_ldl_factor_batched(A, clamp=CLAMP)


def fleet_ldl_solve(L: torch.Tensor, d: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Solve against :func:`fleet_ldl_factor`'s factor, on its route: K7,
    K5 or the blocked LDL^T's substitutions."""
    if _single_route(L):
        return pallas_ldl_solve(L, d, b)
    return fleet_ldl_solve_batched(L, d, b)


def fleet_ldl_factor_solve(A: torch.Tensor, b: torch.Tensor):
    """Factor and one solve, clamp 1e-7: (L, d, x).  K8 (one launch) at
    B = 1 and n <= 896, else the batched factor and its solve."""
    if _single_route(A):
        return pallas_ldl_factor_solve(A, b, clamp=CLAMP)
    L, d = fleet_ldl_factor_batched(A, clamp=CLAMP)
    return L, d, fleet_ldl_solve_batched(L, d, b)


class FleetLDLFactorization:
    """KKT-backend adapter for a batch WW (B, n, n): float32 factor and
    solves, refined ``n_refine`` times against WW in its own dtype;
    inertia from d.

    WW is symmetrically Jacobi-equilibrated first, S W S with
    S = diag(1 / sqrt(max_k |W[i, k]|)) correctly rounded
    (:func:`.dense.equilibration_scale`, as the banded adapters), and
    factored lazily: the first solve fuses factor and solve.  Congruence
    keeps the inertia."""

    def __init__(self, WW: torch.Tensor, n_refine: int = 2):
        self.WW = WW
        self.n_refine = n_refine
        W32 = WW.to(torch.float32)
        s = equilibration_scale(W32.abs().amax(dim=-1))
        self.s = s
        self._Ws = s[:, :, None] * W32 * s[:, None, :]
        self.L = self.d = None  # lazy: the first solve fuses factor + solve

    def _solve32(self, rhs: torch.Tensor) -> torch.Tensor:
        bs = self.s * rhs.to(torch.float32)
        if self.L is None:
            self.L, self.d, y = fleet_ldl_factor_solve(self._Ws, bs)
        else:
            y = fleet_ldl_solve(self.L, self.d, bs)
        return self.s * y

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        for _ in range(self.n_refine):
            x = x + self._solve32(rhs - hdot(self.WW, x)).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        if self.d is None:
            self.L, self.d = fleet_ldl_factor(self._Ws)
        rt = self.WW.dtype
        return (self.d > tol).sum(dim=1).to(rt), (self.d < -tol).sum(dim=1).to(rt)


def fleet_kkt_factorize(WW: torch.Tensor, n_refine: int = 2) -> FleetLDLFactorization:
    return FleetLDLFactorization(WW, n_refine=n_refine)
