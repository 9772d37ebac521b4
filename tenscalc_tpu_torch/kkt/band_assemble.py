"""Direct banded-KKT assembly helpers of the game solvers (port of
``tenscalc_tpu/kkt/band_assemble.py``).

When a game's derivative matrices are certified iteration-invariant, the
permuted band of its KKT matrix is assembled straight from the hoisted
constituents, and the dense (nK, nK) matrix is never formed in the
iteration loop.  This module holds the shared pieces:

* band extraction of a permuted matrix (its constant part, once per
  solve), by diagonals;
* per-diagonal pair products for rank-structured terms A diag(wts) B:
  band[c, i] = (wts @ (AP[:, i:] * BP[:, :n-i]))[c], one product a
  diagonal;
* static masks that place global (row, col) entries into band slots;
* the per-slot shifted copies of a vector (row scalings of a band);
* :class:`BandedOperator`, the band plus a structured matvec, which the
  FromBand factorization adapters consume.

The JAX package permutes by one-hot matrix products at HIGHEST
precision; the port indexes by the permutation, which gives the same
values.  No solver of either package calls the pair products; they are
here so that the module is whole.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn


def extract_band_lower(Wp: torch.Tensor, w: int) -> torch.Tensor:
    """Lower band of a permuted matrix (..., n, n): out[..., c, i] =
    Wp[..., c+i, c] for i = 0..w (zero past the edge) -> (..., n, w+1)."""
    cols = [
        Fn.pad(torch.diagonal(Wp, offset=-i, dim1=-2, dim2=-1), (0, i))
        for i in range(w + 1)
    ]
    return torch.stack(cols, dim=-1)


def extract_band_upper(Wp: torch.Tensor, w: int) -> torch.Tensor:
    """Upper band: out[..., c, q-1] = Wp[..., c, c+q] for q = 1..w ->
    (..., n, w)."""
    if w == 0:
        return Wp.new_zeros(Wp.shape[:-1] + (0,))
    cols = [
        Fn.pad(torch.diagonal(Wp, offset=q, dim1=-2, dim2=-1), (0, q))
        for q in range(1, w + 1)
    ]
    return torch.stack(cols, dim=-1)


def pair_products_lower(AP: torch.Tensor, BP: torch.Tensor, w: int) -> torch.Tensor:
    """(..., nF, n) pairs -> (..., w+1, nF, n) with out[..., i, k, c] =
    AP[..., k, c+i] * BP[..., k, c] (zero past the edge): the lower-band
    contribution of sum_k wts_k A[:, k] B[k, :] is ``wts @ out[..., i, :, :]``
    on diagonal i."""
    n = AP.shape[-1]
    return torch.stack(
        [Fn.pad(AP[..., i:] * BP[..., : n - i], (0, i)) for i in range(w + 1)],
        dim=-3,
    )


def pair_products_upper(AP: torch.Tensor, BP: torch.Tensor, w: int) -> torch.Tensor:
    """(..., nF, n) pairs -> (..., w, nF, n) with out[..., q-1, k, c] =
    AP[..., k, c] * BP[..., k, c+q] (zero past the edge)."""
    n = AP.shape[-1]
    if w == 0:
        return AP.new_zeros(AP.shape[:-2] + (0,) + AP.shape[-2:])
    return torch.stack(
        [Fn.pad(AP[..., : n - q] * BP[..., q:], (0, q)) for q in range(1, w + 1)],
        dim=-3,
    )


def entry_masks(perm: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                w: int, dt, device=None):
    """Static masks placing unit entries at global positions
    (rows[j], cols[j]) into permuted band storage.

    Returns ``(lmask (n, w+1), umask (n, w))`` such that adding
    ``coef * lmask`` to the lower band and ``coef * umask`` to the upper
    band adds ``coef`` at every listed position.  Raises if a position
    falls outside the band."""
    n = len(perm)
    iperm = np.empty(n, dtype=np.int64)
    iperm[np.asarray(perm)] = np.arange(n)
    lm = np.zeros((n, w + 1))
    um = np.zeros((n, max(w, 0)))
    for r, c in zip(np.asarray(rows), np.asarray(cols)):
        a, b = iperm[r], iperm[c]
        off = a - b
        if off >= 0:
            if off > w:
                raise ValueError(
                    f"regularization entry ({r},{c}) falls outside the "
                    f"band (offset {off} > w={w})"
                )
            lm[b, off] += 1.0
        else:
            if -off > w:
                raise ValueError(
                    f"regularization entry ({r},{c}) falls outside the "
                    f"band (offset {off} < -w={w})"
                )
            um[a, -off - 1] += 1.0
    return (torch.as_tensor(lm, dtype=dt, device=device),
            torch.as_tensor(um, dtype=dt, device=device))


def shifted_cols(v: torch.Tensor, w: int, start: int = 0) -> torch.Tensor:
    """(..., n) -> (..., n, w+1-start) with out[..., c, i] = v[..., c+start+i]
    (zero-padded): the per-slot row-index factors of a band."""
    n = v.shape[-1]
    vp = Fn.pad(v, (0, w))
    return torch.stack(
        [vp[..., i: i + n] for i in range(start, w + 1)], dim=-1
    )


class BandedOperator:
    """Directly assembled permuted band + a structured matvec closure,
    the handle the FromBand factorization adapters consume.  ``band`` is
    (B, n, w+1) lower storage for the symmetric LDL^T kernels, or
    (B, n, 2w+1) full storage ([diag, sub 1..w, super 1..w]) for the
    unsymmetric LU kernels; ``perm`` (n,) is the permutation as an index:
    band row a belongs to original row ``perm[a]``."""

    __slots__ = ("band", "perm", "_mv")

    def __init__(self, band, perm, matvec):
        self.band = band
        self.perm = perm
        self._mv = matvec

    def matvec(self, x):
        return self._mv(x)
