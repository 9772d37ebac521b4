"""Dense KKT helpers (port of ``tenscalc_tpu/kkt/dense.py``: ``hdot`` and
``lu_solve_mixed``; the dense LDL/LU backends are ROADMAP item M4).

Every product here runs in full precision: the solver turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, float32 matmul
precision "highest") where it is built, as the JAX package computes
these products at ``Precision.HIGHEST``.  Refinement residuals and the
direction-error metric must be exact, or the 1e-6 direction-error gate
can never pass.
"""

from __future__ import annotations

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
