"""Horizon-parallel block-tridiagonal solve over a device mesh (port of
``tenscalc_tpu/kkt/spike.py``): one-level Schur-complement domain
decomposition, SPIKE-style.

1. The nb stage blocks split into P chunks, one a mesh entry; the last
   block of a chunk is an *interface*, the rest its *interior*.
2. Each chunk factors its interior chain and eliminates it from its
   couplings to the neighbouring interfaces (the spikes).
3. The reduced block-tridiagonal system over the P interfaces is
   gathered onto every device and factored there.
4. The interiors back-substitute.

The mesh is :class:`tenscalc_tpu_torch.parallel.mesh.Mesh`: a process
drives its entries, the JAX ``all_gather`` becomes copies onto each
device (and, on a mesh across processes, an exchange of host copies
over the process group, :func:`..parallel.mesh.exchange`), and the
chunks that share a device run as one batch over the chunk axis.  Each
process factors its own chunks and the (small) reduced system, and
every process returns the whole solution.  Everything is batched over
the fleet as well: A and B are (Bn, nb, s, s), b is (Bn, nb, s).  Plain
PyTorch (the JAX package's XLA scans and LU solves; no Pallas kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.mesh import Mesh, exchange
from .tridiag import _to_blocks, block_ldl, block_ldl_solve


def _check_partition(nb: int, Pn: int) -> int:
    if nb % Pn != 0 or nb // Pn < 2:
        raise ValueError(f"nb={nb} must be a multiple of mesh size {Pn} (>=2 per chunk)")
    return nb // Pn


class _Chunks(NamedTuple):
    """The factor of the chunks on one device, each tensor (Bn * Pd, ...)
    with the device's Pd chunks adjacent per instance."""
    device: torch.device
    idx: list
    Ls: torch.Tensor
    lus: torch.Tensor
    pivs: torch.Tensor
    Zw: torch.Tensor
    Zv: torch.Tensor
    W: torch.Tensor
    V: torch.Tensor


class SpikeFactor(NamedTuple):
    """:func:`spike_factor`'s result: each device's chunks, and the
    reduced interface system's factor on each device (redundant, as the
    JAX package's replicated output)."""
    chunks: list
    reduced: dict
    Bn: int
    Pn: int
    m: int
    s: int


def _gather(parts: dict, mesh: Mesh, Bn: int, shape, dtype, device) -> torch.Tensor:
    """The all_gather: every chunk's piece (Bn, Pd, *shape per device)
    copied into chunk order (Bn, P, *shape) on ``device``; on a mesh
    across processes the other processes' chunks come by exchange."""
    out = torch.empty((Bn, mesh.size) + tuple(shape), dtype=dtype, device=device)
    for (_, idx), piece in parts.items():
        out[:, list(idx)] = piece.to(device)
    if mesh.spans_processes:
        out = exchange(out, mesh.ranks, 1)
    return out


def spike_factor(A: torch.Tensor, B: torch.Tensor, mesh: Mesh,
                 axis: str = "stages") -> SpikeFactor:
    """Factor a batch of symmetric block-tridiagonal systems over the
    mesh, independent of any right-hand side.  A: (Bn, nb, s, s) diagonal
    blocks; B: (Bn, nb, s, s) subdiagonal blocks (B[:, i] couples block i
    to i-1; B[:, 0] = 0).  nb must be a multiple of the mesh size P with
    nb / P >= 2.  The interior factors, the spikes Zw, Zv (2s columns a
    chunk) and the reduced system's factor are formed once here; a
    right-hand side then costs two single-column chain sweeps and one
    gather of O(P s)."""
    Bn, nb, s, _ = A.shape
    Pn = mesh.shape[axis]
    m = _check_partition(nb, Pn)
    mi = m - 1
    Ac = A.view(Bn, Pn, m, s, s)
    Bc = B.view(Bn, Pn, m, s, s)
    groups = mesh.groups()
    if not groups:
        raise ValueError("this process owns no entry of the mesh")
    chunks, parts = [], {}
    for dev, idx in groups:
        Pd = len(idx)
        A_c = Ac[:, idx].to(dev).reshape(Bn * Pd, m, s, s)
        B_c = Bc[:, idx].to(dev).reshape(Bn * Pd, m, s, s)
        # B_c[:, 0] couples the first interior block to the previous
        # chunk's interface (through V), not to the interior chain
        Bi = B_c[:, :mi].clone()
        Bi[:, 0] = 0
        W = B_c[:, mi]                         # interface <- last interior
        V = B_c[:, 0]                          # first interior <- previous interface
        Ls, _, lus, pivs = block_ldl(A_c[:, :mi], Bi)
        rhs = A_c.new_zeros(Bn * Pd, mi, s, 2 * s)
        rhs[:, mi - 1, :, :s] = W.mT
        rhs[:, 0, :, s:] = V
        Z = block_ldl_solve(Ls, lus, pivs, rhs)
        Zw, Zv = Z[..., :s], Z[..., s:]
        S_self = A_c[:, mi] - torch.matmul(W, Zw[:, mi - 1])
        S_prev = -torch.matmul(W, Zv[:, mi - 1])
        S_next_corr = -torch.matmul(Zv[:, 0].mT, V)
        chunks.append(_Chunks(dev, idx, Ls, lus, pivs, Zw, Zv, W, V))
        parts[(dev, tuple(idx))] = torch.stack(
            [S_self, S_prev, S_next_corr], 1).view(Bn, Pd, 3, s, s)
    reduced = {}
    # one gather a call: every process makes the same exchanges
    G_all = _gather(parts, mesh, Bn, (3, s, s), A.dtype, groups[0][0])
    for dev, _ in groups:
        G = G_all.to(dev)
        Sd, Sp, Sc = G[:, :, 0], G[:, :, 1], G[:, :, 2]
        diag = Sd.clone()
        diag[:, :Pn - 1] += Sc[:, 1:]
        sub = torch.cat([torch.zeros_like(Sd[:, :1]), Sp[:, 1:]], dim=1)
        Lr, _, r_lus, r_pivs = block_ldl(diag, sub)
        reduced[dev] = (Lr, r_lus, r_pivs)
    return SpikeFactor(chunks, reduced, Bn, Pn, m, s)


def spike_apply(factor: SpikeFactor, b: torch.Tensor, mesh: Mesh,
                axis: str = "stages") -> torch.Tensor:
    """Solve for one right-hand side b (Bn, nb, s) with a cached
    :func:`spike_factor`; x on b's device."""
    Bn, Pn, m, s = factor.Bn, factor.Pn, factor.m, factor.s
    if mesh.shape[axis] != Pn:
        raise ValueError(f"the factor has {Pn} chunks, the mesh {mesh.shape[axis]}")
    mi = m - 1
    bc = b.view(Bn, Pn, m, s)
    ys, parts = [], {}
    for ch in factor.chunks:
        Pd = len(ch.idx)
        b_c = bc[:, ch.idx].to(ch.device).reshape(Bn * Pd, m, s)
        y = block_ldl_solve(ch.Ls, ch.lus, ch.pivs, b_c[:, :mi, :, None])[..., 0]
        r_self = b_c[:, mi] - torch.matmul(ch.W, y[:, mi - 1, :, None])[..., 0]
        r_next_corr = -torch.matmul(ch.V.mT, y[:, 0, :, None])[..., 0]
        ys.append(y)
        # one gather of the concatenated (2s,) payload
        parts[(ch.device, tuple(ch.idx))] = torch.cat(
            [r_self, r_next_corr], dim=-1).view(Bn, Pd, 2 * s)
    out = torch.empty(Bn, Pn, m, s, dtype=b.dtype, device=b.device)
    R_all = _gather(parts, mesh, Bn, (2 * s,), b.dtype, factor.chunks[0].device)
    for ch, y in zip(factor.chunks, ys):
        Pd = len(ch.idx)
        R = R_all.to(ch.device)
        rhs_red = R[..., :s].clone()
        rhs_red[:, :Pn - 1] += R[:, 1:, s:]
        Lr, r_lus, r_pivs = factor.reduced[ch.device]
        t = block_ldl_solve(Lr, r_lus, r_pivs, rhs_red[..., None])[..., 0]  # (Bn, P, s)
        t_prev_all = torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)
        t_self = t[:, ch.idx].reshape(Bn * Pd, s)
        t_prev = t_prev_all[:, ch.idx].reshape(Bn * Pd, s)
        xI = (y - torch.matmul(ch.Zw, t_self[:, None, :, None])[..., 0]
              - torch.matmul(ch.Zv, t_prev[:, None, :, None])[..., 0])
        xc = torch.cat([xI, t_self[:, None]], dim=1).view(Bn, Pd, m, s)
        out[:, ch.idx] = xc.to(b.device)
    if mesh.spans_processes:
        out = exchange(out, mesh.ranks, 1)
    return out.view(Bn, Pn * m, s)


def spike_solve(A, B, b, mesh: Mesh, axis: str = "stages") -> torch.Tensor:
    """Factor and one apply (for repeated right-hand sides use
    :func:`spike_factor` and :func:`spike_apply`).  A, B: (Bn, nb, s, s);
    b: (Bn, nb, s).  Returns x (Bn, nb, s)."""
    return spike_apply(spike_factor(A, B, mesh, axis=axis), b, mesh, axis=axis)


class SpikeFactorization:
    """KKT-backend adapter: the mesh-distributed banded solve, factored
    once a KKT matrix in float32 (always, as the JAX package's), every
    solve and refinement through the cached factor, two refinements
    against WW in its own dtype.  The block count is padded with identity
    blocks to a multiple of the mesh size, at least 2 blocks a chunk."""

    def __init__(self, WW: torch.Tensor, plan, mesh: Mesh, axis: str = "stages",
                 n_refine: int = 2):
        self.WW = WW
        self.plan = plan
        self.mesh = mesh
        self.axis = axis
        self.n_refine = n_refine
        self.perm = torch.as_tensor(plan.perm, device=WW.device)
        self.iperm = torch.as_tensor(plan.iperm, device=WW.device)
        A, B = dense_to_blocks(WW[:, self.perm][:, :, self.perm].to(torch.float32),
                               plan.block)
        Pn = mesh.shape[axis]
        Bn, nb, s, _ = A.shape
        nb2 = max(-(-nb // Pn), 2) * Pn
        if nb2 != nb:
            eye = torch.eye(s, dtype=A.dtype, device=A.device).expand(Bn, nb2 - nb, s, s)
            A = torch.cat([A, eye], dim=1)
            B = torch.cat([B, B.new_zeros(Bn, nb2 - nb, s, s)], dim=1)
        self.nb2 = nb2
        self.factor = spike_factor(A, B, mesh, axis=axis)

    def _solve32(self, rhs: torch.Tensor) -> torch.Tensor:
        s, n = self.plan.block, self.plan.n
        Bn = rhs.shape[0]
        bp = rhs[:, self.perm].to(torch.float32)
        bp = torch.cat([bp, bp.new_zeros(Bn, self.nb2 * s - n)], dim=1)
        x = spike_apply(self.factor, bp.view(Bn, self.nb2, s), self.mesh, axis=self.axis)
        return x.reshape(Bn, self.nb2 * s)[:, :n][:, self.iperm]

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


class _Blocks(NamedTuple):
    block: int
    n_blocks: int
    n: int


def dense_to_blocks(WW: torch.Tensor, s: int):
    """Chop a batch of banded matrices (B, n, n) (half bandwidth <= s)
    into (B, nb, s, s) diagonal and subdiagonal block sequences, padded
    with identity rows."""
    n = WW.shape[-1]
    return _to_blocks(WW, _Blocks(s, -(-n // s), n))
