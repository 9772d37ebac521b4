"""A device mesh for the port: a tuple of ``torch.device`` entries and
axis names, the counterpart of a JAX ``Mesh``.

A JAX mesh is one controller over many devices, and ``shard_map``'s
collectives run inside that one program.  Here a process drives the
entries it owns.  A mesh built without ``ranks`` belongs to this process
alone, with no ``torch.distributed`` process group: a chunk of work goes
to its entry's device, an ``all_gather`` becomes copies onto each
device, and the chunks that share a device are batched over the chunk
axis, so each device runs one batched computation.

Entries may repeat.  A mesh of P copies of one device is a *virtual*
mesh, the counterpart of the JAX tests' eight virtual CPU devices: it
runs the sharded code path (the partition, the gathers, the reduced
systems) on one device.

A mesh across processes (:func:`process_mesh`, the counterpart of a JAX
global mesh under ``jax.distributed``) gives each entry the rank of the
process that owns it.  Every process runs the same program on the whole
data; each computes only its own entries' part, and the parts meet by
:func:`exchange`: an ``all_gather`` of host copies over the default
process group, which is gloo (NCCL refuses two ranks on one card, and
the host copies need no GPU transport).

Listing devices (:func:`devices`, the counterpart of ``jax.devices()``):
the CUDA devices of this process (``cuda:0`` ... ``cuda:{n-1}``), or
``[cpu]`` where CUDA is missing.  A virtual list is spelled out by the
caller, ``virtual_devices("cpu", 8)`` or ``virtual_devices("cuda:0",
4)``, and given to :func:`.batch.make_mesh` or
:func:`.scaling.measure_scaling` as ``devices=``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def devices() -> List[torch.device]:
    """The CUDA devices of this process, or ``[cpu]`` without CUDA."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def virtual_devices(device, n: int) -> List[torch.device]:
    """n entries of one device: a virtual mesh's device list."""
    return [torch.device(device)] * n


class Mesh:
    """A one-dimensional mesh: ``devices`` (entries may repeat) along one
    named axis.  ``shape`` maps the axis name to its size, as a JAX
    mesh's does.  ``ranks`` (one process rank an entry) makes it a mesh
    across the processes of the default process group; without it every
    entry is this process's."""

    def __init__(self, devs: Sequence, axis_names: Tuple[str, ...] = ("batch",),
                 ranks: Optional[Sequence[int]] = None):
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"the port's mesh has one axis; got {axis_names}")
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devs)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = axis_names
        self.ranks: Optional[Tuple[int, ...]] = None
        if ranks is not None:
            self.ranks = tuple(int(r) for r in ranks)
            if len(self.ranks) != len(self.devices):
                raise ValueError(f"{len(self.ranks)} ranks for {len(self.devices)} entries")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}

    @property
    def spans_processes(self) -> bool:
        """Whether the entries' parts meet through the process group."""
        return self.ranks is not None

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """This process's distinct devices, in order of first appearance,
        each with the positions of its entries (every entry's, for a mesh
        of this process alone)."""
        me = _rank() if self.spans_processes else None
        out: Dict[torch.device, List[int]] = {}
        for i, d in enumerate(self.devices):
            if me is None or self.ranks[i] == me:
                out.setdefault(d, []).append(i)
        return list(out.items())

    def __repr__(self) -> str:
        ranks = "" if self.ranks is None else f", ranks={list(self.ranks)}"
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names}{ranks})"


def _rank() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh across processes needs the process group "
                           "(parallel.scaling.init_distributed)")
    return dist.get_rank()


def process_mesh(n_local: int = 1, axis: str = "batch", device=None) -> Mesh:
    """A mesh over every process of the default process group: each
    process adds ``n_local`` entries of ``device`` (default: its first of
    :func:`devices`), in rank order.  Every process calls it, and each
    learns the others' entries from the group, so each lists the whole
    mesh, as ``jax.devices()`` does across processes."""
    import torch.distributed as dist

    dev = str(torch.device(device) if device is not None else devices()[0])
    _rank()
    listed: List = [None] * dist.get_world_size()
    dist.all_gather_object(listed, (dev, int(n_local)))
    devs = [d for d, n in listed for _ in range(n)]
    ranks = [r for r, (_, n) in enumerate(listed) for _ in range(n)]
    return Mesh(devs, (axis,), ranks=ranks)


def exchange(t: torch.Tensor, owners: Sequence[int], dim: int) -> torch.Tensor:
    """``t`` with each slice along ``dim`` taken from the process that owns
    it (``owners[i]`` the rank of slice i; this process's own slices are
    its own, the others arbitrary): one ``all_gather`` of host copies of
    the whole tensor over the default group, the result on t's device.
    Every process calls it with the same shape, in the same order."""
    import torch.distributed as dist

    host = t.detach().cpu().contiguous()
    # gloo moves no bool: its bytes travel as uint8
    wire = host.view(torch.uint8) if host.dtype == torch.bool else host
    bufs = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, wire)
    owners_t = torch.as_tensor(list(owners))
    out = host.clone()
    for r, buf in enumerate(bufs):
        idx = (owners_t == r).nonzero().flatten()
        if idx.numel():
            out.index_copy_(dim, idx, buf.view(host.dtype).index_select(dim, idx))
    return out.to(t.device)
