"""A device mesh for the port: a tuple of ``torch.device`` entries and
axis names, the counterpart of a JAX ``Mesh``.

A JAX mesh is one controller over many devices, and ``shard_map``'s
collectives run inside that one program.  Here one process drives every
entry of the mesh, with no ``torch.distributed`` process group: a chunk
of work goes to its entry's device, an ``all_gather`` becomes copies
onto each device, and the chunks that share a device are batched over
the chunk axis, so each device runs one batched computation.

Entries may repeat.  A mesh of P copies of one device is a *virtual*
mesh, the counterpart of the JAX tests' eight virtual CPU devices: it
runs the sharded code path (the partition, the gathers, the reduced
systems) on one device.

Listing devices (:func:`devices`, the counterpart of ``jax.devices()``):
the CUDA devices of this process (``cuda:0`` ... ``cuda:{n-1}``), or
``[cpu]`` where CUDA is missing.  A virtual list is spelled out by the
caller, ``virtual_devices("cpu", 8)`` or ``virtual_devices("cuda:0",
4)``, and given to :func:`.batch.make_mesh` or
:func:`.scaling.measure_scaling` as ``devices=``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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
    mesh's does."""

    def __init__(self, devs: Sequence, axis_names: Tuple[str, ...] = ("batch",)):
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"the port's mesh has one axis; got {axis_names}")
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devs)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = axis_names

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """The mesh's distinct devices, in order of first appearance, each
        with the positions of its entries."""
        out: Dict[torch.device, List[int]] = {}
        for i, d in enumerate(self.devices):
            out.setdefault(d, []).append(i)
        return list(out.items())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"
