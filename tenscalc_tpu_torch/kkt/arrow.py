"""Arrow-plus-band KKT factorization (port of ``tenscalc_tpu/kkt/arrow.py``).

MPC-family problems with a few global variables (a sampling time, shared
parameters being estimated) have a KKT that is banded except for a few
dense rows and columns, the "arrow".  The plan takes the rows of high
degree as the arrow, orders them last, and RCM-orders the rest into a
band.  The factor eliminates by blocks:

    W = [[B, C], [C^T, D]],  B banded (:mod:`.tridiag`),
    S = D - C^T B^{-1} C     (the dense |arrow| x |arrow| Schur complement),
    x_arrow = S^{-1}(b_2 - C^T B^{-1} b_1),  x_band = B^{-1}(b_1 - C x_arrow).

Plain PyTorch, as the JAX package's XLA code is; batched over the fleet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .structure import BandedPlan, plan_banded
from .tridiag import _factor_dtype, tridiag_factorize


@dataclasses.dataclass
class ArrowPlan:
    arrow: np.ndarray        # indices of the arrow rows (original order)
    band: np.ndarray         # indices of the band rows (original order)
    band_plan: BandedPlan    # plan of the band block (band-local indices)
    n: int

    @property
    def worthwhile(self) -> bool:
        return self.band_plan.worthwhile and len(self.arrow) < 0.25 * self.n

    @property
    def n_arrow(self) -> int:
        return len(self.arrow)


def plan_arrow(pattern: np.ndarray, degree_factor: float = 4.0,
               max_arrow_frac: float = 0.2) -> Optional[ArrowPlan]:
    """The arrow set: rows whose degree exceeds ``degree_factor`` x the
    median degree (numpy's median), at most ``max_arrow_frac`` of n.
    None when there is no arrow, too large a one, or no worthwhile band
    under it."""
    n = pattern.shape[0]
    deg = pattern.sum(axis=1)
    med = np.median(deg)
    arrow_mask = deg > degree_factor * max(med, 1)
    n_arrow = int(arrow_mask.sum())
    if n_arrow == 0 or n_arrow > max_arrow_frac * n:
        return None
    arrow = np.nonzero(arrow_mask)[0]
    band = np.nonzero(~arrow_mask)[0]
    bp = plan_banded(pattern[np.ix_(band, band)])
    if not bp.worthwhile:
        return None
    return ArrowPlan(arrow=arrow, band=band, band_plan=bp, n=n)


class ArrowFactorization:
    """KKT-backend adapter: the band block by the block-tridiagonal
    factor (unrefined), the Schur complement by a pivoted LU, both in
    :func:`.tridiag._factor_dtype`; two refinements against WW (B, n, n),
    unconditional as in the JAX package."""

    def __init__(self, WW: torch.Tensor, plan: ArrowPlan, n_refine: int = 2):
        self.WW = WW
        self.plan = plan
        self.n_refine = n_refine
        dev = WW.device
        self._band = band = torch.as_tensor(plan.band, device=dev)
        self._arrow = arrow = torch.as_tensor(plan.arrow, device=dev)
        fdt = self._fdt = _factor_dtype(WW)
        rows = WW[:, band]
        self.C = rows[:, :, arrow].to(fdt)                 # (B, n_band, n_arrow)
        D = WW[:, arrow][:, :, arrow].to(fdt)
        self.bfac = tridiag_factorize(rows[:, :, band], plan.band_plan, n_refine=0)
        # S = D - C^T B^{-1} C
        BC = self.bfac.solve(self.C.to(WW.dtype)).to(fdt)
        S = D - torch.matmul(self.C.mT, BC)
        self.S_lu, self.S_piv = torch.linalg.lu_factor_ex(S)[:2]

    def _solve32(self, rhs: torch.Tensor) -> torch.Tensor:
        fdt = self._fdt
        b1 = rhs[:, self._band].to(fdt)
        b2 = rhs[:, self._arrow].to(fdt)
        y1 = self.bfac._solve32(b1).to(fdt)
        r2 = b2 - torch.matmul(self.C.mT, y1.unsqueeze(-1)).squeeze(-1)
        x2 = torch.linalg.lu_solve(self.S_lu, self.S_piv, r2.unsqueeze(-1)).squeeze(-1)
        x1 = self.bfac._solve32(
            (b1 - torch.matmul(self.C, x2.unsqueeze(-1)).squeeze(-1)).to(fdt)).to(fdt)
        out = rhs.new_zeros(rhs.shape, dtype=fdt)
        out[:, self._band] = x1
        out[:, self._arrow] = x2
        return out

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if rhs.dim() == 3:
            return torch.stack([self.solve(rhs[..., j]) for j in range(rhs.shape[-1])],
                               dim=-1)
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        for _ in range(self.n_refine):
            r = rhs - torch.bmm(self.WW, x.unsqueeze(-1)).squeeze(-1)
            x = x + self._solve32(r).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        """No inertia (the JAX package's (0, 0)), per instance."""
        z = self.WW.new_zeros(self.WW.shape[0])
        return z, z
