"""Bunch-Kaufman pivoted symmetric-indefinite elimination for inertia
(port of ``tenscalc_tpu/kkt/bunchkaufman.py``).

The float32 ``useInertia`` path of :func:`.dense.kkt_factorize` solves by
a pivoted LU and takes the inertia from this elimination: its 1x1 and
2x2 pivot blocks bound element growth, so the eigenvalue sign counts
(Sylvester's law) stay exact in float32 where an unpivoted LDL^T's
pivots collapse.  Only the counts are kept.

The JAX package runs one instance under a ``lax.while_loop`` and batches
it by ``vmap``; here every instance of a batch (B, n, n) steps at once,
each at its own column k, with masked full-matrix rank-1 and rank-2
updates.  An instance moves on one or two columns a step, so n steps
finish every instance; one that has finished is left as it is.
"""

from __future__ import annotations

import torch

_ALPHA = (1.0 + 17.0 ** 0.5) / 8.0  # Bunch-Kaufman growth-optimal threshold


def _col(M: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Column j[b] of each M[b]: (B, n)."""
    B, n, _ = M.shape
    return M.gather(2, j.view(B, 1, 1).expand(B, n, 1))[..., 0]


def _entry(M: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """M[b, i[b], j[b]]: (B,)."""
    return M[torch.arange(M.shape[0], device=M.device), i, j]


def _swap_sym(M: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Symmetric row and column swap i[b] <-> j[b] of each M[b]."""
    B, n, _ = M.shape
    p = torch.arange(n, device=M.device).expand(B, n)
    p = p.scatter(1, i[:, None], j[:, None]).scatter(1, j[:, None], i[:, None])
    M = M.gather(1, p[:, :, None].expand(B, n, n))
    return M.gather(2, p[:, None, :].expand(B, n, n))


def _outer_mask(keep: torch.Tensor) -> torch.Tensor:
    return keep[:, :, None] & keep[:, None, :]


def bk_inertia(A: torch.Tensor, tol: float = 0.0):
    """(#positive, #negative) eigenvalue counts of symmetric A, one
    matrix (n, n) or a batch (B, n, n), each count in A's dtype.

    At step k a 1x1 pivot (with an optional symmetric swap) or a 2x2
    pivot (an indefinite block: one eigenvalue of each sign when its
    determinant is negative); zero active columns count as zero
    eigenvalues."""
    single = A.dim() == 2
    if single:
        A = A[None]
    B, n, _ = A.shape
    dt, dev = A.dtype, A.device
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    idx = torch.arange(n, device=dev)[None, :]
    M = (A + A.mT) * 0.5
    k = torch.zeros(B, dtype=torch.long, device=dev)
    mp = torch.zeros(B, dtype=dt, device=dev)
    mn = torch.zeros(B, dtype=dt, device=dev)

    def pivot1(M, k):
        d = _entry(M, k, k)
        safe = torch.where(d == 0, one, d)
        col = torch.where(idx > k[:, None], _col(M, k) / safe[:, None], zero)
        Mn = torch.addcmul(M, -d[:, None, None], col[:, :, None] * col[:, None, :])
        Mn = torch.where(_outer_mask(idx > k[:, None]), Mn, zero)
        return Mn, k + 1, (d > tol).to(dt), (d < -tol).to(dt)

    def pivot2(M, k, r):
        kk = torch.clamp(k + 1, max=n - 1)
        M = _swap_sym(M, kk, r)
        a, b, c = _entry(M, k, k), _entry(M, kk, k), _entry(M, kk, kk)
        detE = a * c - b * b
        safe = torch.where(detE == 0, one, detE)
        below2 = (idx > kk[:, None])[:, :, None]
        W = torch.where(below2, torch.stack([_col(M, k), _col(M, kk)], dim=2), zero)
        Einv = torch.stack([torch.stack([c, -b], -1), torch.stack([-b, a], -1)], -2)
        U = W @ (Einv / safe[:, None, None])
        Mn = M - U @ W.mT
        Mn = torch.where(_outer_mask(idx > kk[:, None]), Mn, zero)
        tr = a + c
        both_pos = (detE > 0) & (tr > tol)
        both_neg = (detE > 0) & (tr < -tol)
        dp = torch.where(detE < 0, one, torch.where(both_pos, 2 * one, zero))
        dn = torch.where(detE < 0, one, torch.where(both_neg, 2 * one, zero))
        dp = dp + torch.where((detE == 0) & (tr > tol), one, zero)
        dn = dn + torch.where((detE == 0) & (tr < -tol), one, zero)
        return Mn, k + 2, dp, dn

    for _ in range(n):
        live = k < n
        kc = torch.clamp(k, max=n - 1)
        colk = torch.where(idx > kc[:, None], _col(M, kc), zero)
        lam = colk.abs().amax(dim=1)
        r = torch.argmax(colk.abs(), dim=1)
        akk = _entry(M, kc, kc)
        colr = torch.where((idx >= kc[:, None]) & (idx != r[:, None]), _col(M, r), zero)
        sigma = colr.abs().amax(dim=1)
        case1 = ((akk.abs() >= _ALPHA * lam) | (lam <= tol)
                 | (akk.abs() * sigma >= _ALPHA * lam * lam))
        case2 = _entry(M, r, r).abs() >= _ALPHA * sigma
        outs = (pivot1(M, kc), pivot1(_swap_sym(M, kc, r), kc), pivot2(M, kc, r))
        pick = [live & case1, live & ~case1 & case2, live & ~case1 & ~case2]
        newM, newk, dmp, dmn = M, k, torch.zeros_like(mp), torch.zeros_like(mn)
        for sel, (Mo, ko, dp, dn) in zip(pick, outs):
            newM = torch.where(sel[:, None, None], Mo, newM)
            newk = torch.where(sel, ko, newk)
            dmp = torch.where(sel, dp, dmp)
            dmn = torch.where(sel, dn, dmn)
        M, k, mp, mn = newM, newk, mp + dmp, mn + dmn
    return (mp[0], mn[0]) if single else (mp, mn)
