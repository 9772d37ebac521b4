"""Batched solving of a fleet, optionally split over a device mesh (port
of ``tenscalc_tpu/parallel/batch.py``).

The fleet is the solver's own batch dimension: every instance runs in
lockstep, and each keeps its own iterates, status and iteration count.
A parameter passed in its declared (unbatched) shape is shared, so any
hoisted derivative that depends only on shared parameters is computed
once for the whole fleet.

With a mesh (:class:`.mesh.Mesh`), the fleet is split into as many
equal shards as the mesh has entries, shard j on entry j's device, the
shared parameters replicated onto every device; as in the JAX package's
``shard_map``, the solve itself needs no communication.  The shards
that share a device run as one fleet on it (their instances in shard
order), and the result comes back on the solver's device in the
fleet's order.  On a mesh across processes (:func:`.mesh.process_mesh`)
every process is given the whole fleet, solves its own entries' shards,
and the results meet by :func:`.mesh.exchange`, so each process returns
the whole result (the JAX worker's ``process_allgather``).

A limit, documented and not lifted: one process runs its distinct
devices one after another (a loop over :meth:`.mesh.Mesh.groups`), as
the JAX package's one process dispatches them (JAX
``parallel/batch.py:52-60``), so a mesh of several cards driven by one
process does not solve them at the same time; one process a card does.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch

from ..interop import inits_from_numpy, map_fields, params_from_numpy
from .mesh import Mesh, devices as list_devices, exchange


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              devices: Optional[Sequence] = None) -> Mesh:
    """A one-axis mesh over the first ``n_devices`` of ``devices``
    (default :func:`.mesh.devices`: the CUDA devices, or the CPU)."""
    devs = list(devices) if devices is not None else list_devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} devices asked, {len(devs)} listed")
    return Mesh(devs[:n], (axis,))


def solve_sharded(solver, u0: torch.Tensor, penv, shared, mesh: Mesh,
                  mu0: float = 1.0, max_iter: Optional[int] = None,
                  addEye2Hessian=(1e-9, 1e-9)):
    """The fleet (u0 (B, nU), ``penv`` batched but for the names in
    ``shared``) split over ``mesh``; B must be a multiple of its size.
    Returns the batched result on u0's device."""
    P = mesh.size
    B = u0.shape[0]
    if B % P != 0:
        raise ValueError(f"batch {B} must be a multiple of the mesh size {P}")
    kind = torch.device(solver.device).type
    if any(d.type != kind for d in mesh.devices):
        raise ValueError(f"a mesh of {kind} devices is needed for a solver on {solver.device}")
    per = B // P
    pieces = []
    for dev, idx in mesh.groups():
        rows = torch.cat([torch.arange(j * per, (j + 1) * per) for j in idx]).to(u0.device)
        pe = {k: (v.to(dev) if k in shared else v[rows].to(dev)) for k, v in penv.items()}
        res = solver._solve_raw(u0[rows].to(dev), pe, shared, mu0, max_iter,
                                *addEye2Hessian)
        pieces.append((rows, res))
    if not pieces:
        raise ValueError("this process owns no entry of the mesh")
    out = type(pieces[0][1])(*(
        _merge([res[k] for _, res in pieces], [rows for rows, _ in pieces], B, u0.device)
        for k in range(len(pieces[0][1]))))
    if mesh.spans_processes:
        owners = [r for r in mesh.ranks for _ in range(per)]
        out = map_fields(lambda v: exchange(v, owners, 0), out)
    return out


def _merge(values, rows, B: int, device):
    """One result field of the fleet from its shards' (rows of each): a
    tensor (B, ...) on ``device``, a tuple field entry by entry, None
    kept."""
    first = values[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_merge([v[i] for v in values], rows, B, device)
                     for i in range(len(first)))
    out = first.new_empty((B,) + tuple(first.shape[1:]), device=device)
    for r, v in zip(rows, values):
        out[r] = v.to(device)
    return out


def solve_batched(solver, parameters: Mapping[str, Any],
                  inits: Optional[Mapping[str, Any]] = None,
                  mu0: float = 1.0, max_iter: Optional[int] = None,
                  addEye2Hessian=(1e-9, 1e-9), mesh: Optional[Mesh] = None):
    """Solve a fleet on the solver's device, or split over ``mesh``;
    returns the batched IPMResult (tensors on the solver's device).
    ``addEye2Hessian`` holds the solver's initial regularizations: (addU,
    addEq) for a minimization, (addU, addD, addEq) for a min-max
    problem."""
    dt = solver.opts.torch_dtype
    penv, shared, B = params_from_numpy(solver, parameters, solver.device, dt)
    u0 = inits_from_numpy(solver, inits, B, solver.device, dt)
    if mesh is not None:
        return solve_sharded(solver, u0, penv, shared, mesh, mu0, max_iter,
                             addEye2Hessian)
    return solver._solve_raw(u0, penv, shared, mu0, max_iter, *addEye2Hessian)
