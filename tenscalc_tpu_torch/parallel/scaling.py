"""Fleet-scaling measurement (port of ``tenscalc_tpu/parallel/scaling.py``).

:func:`measure_scaling` runs the same per-device workload on growing
mesh slices (weak scaling) and reports solves/s and the efficiency
against the one-device rate.  Its device list is :func:`.mesh.devices`
(the CUDA devices) unless ``devices=`` names one: a virtual list
(:func:`.mesh.virtual_devices`) runs the sharded path on one device, and
then measures no scaling, only that every mesh size gives the same
answers.  :func:`init_distributed` wraps
``torch.distributed.init_process_group`` for runs over several processes
(a no-op for one process, as the JAX package's is), which
:mod:`.distributed_smoke` drives.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from .batch import make_mesh, solve_sharded
from .mesh import devices as list_devices


# a rendezvous or a collective that waits longer raises, so a process
# whose peer died fails instead of hanging
GROUP_TIMEOUT_S = 300.0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "gloo") -> None:
    """Join the default process group of ``num_processes`` (no-op for one
    process) through ``backend``.  ``coordinator_address`` is
    ``host:port`` (``tcp://`` added when missing).  gloo by default: a
    mesh across processes (:func:`.mesh.process_mesh`) exchanges host
    copies, and NCCL refuses two ranks on one card."""
    if num_processes is None or num_processes <= 1:
        return
    import datetime

    import torch.distributed as dist

    if coordinator_address is None:
        raise ValueError("coordinator_address is needed for more than one process")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _sync(devs) -> None:
    for d in {torch.device(d) for d in devs}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measure_scaling(solver, make_batch, per_device_batch: int = 16,
                    device_counts: Sequence[int] = (1, 2, 4, 8),
                    mu0: float = 1e-3, max_iter: int = 100, reps: int = 3,
                    devices: Optional[Sequence] = None):
    """Weak-scaling sweep: for each count n of ``device_counts`` (up to
    the devices listed), a fleet of ``per_device_batch * n`` from
    ``make_batch(B)`` -> (u0 (B, nU), penv with a leading batch
    dimension) solved over a mesh of the first n devices, once to warm
    up, then ``reps`` times timed.  Returns a list of dicts: devices,
    batch, solves_per_s, efficiency, converged."""
    devs = list(devices) if devices is not None else list_devices()
    dt = solver.opts.torch_dtype
    results = []
    base_rate = None
    for n_dev in device_counts:
        if n_dev > len(devs):
            break
        B = per_device_batch * n_dev
        mesh = make_mesh(n_dev, devices=devs)
        u0, penv = make_batch(B)
        u0 = torch.as_tensor(u0, dtype=dt, device=solver.device)
        penv = {k: torch.as_tensor(v, dtype=dt, device=solver.device)
                for k, v in penv.items()}

        def run():
            res = solve_sharded(solver, u0, penv, frozenset(), mesh, mu0, max_iter)
            _sync(mesh.devices)
            return res

        statuses = run().status.cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        elapsed = (time.perf_counter() - t0) / reps
        rate = B / elapsed
        if base_rate is None:
            base_rate = rate / n_dev
        results.append(dict(devices=n_dev, batch=B, solves_per_s=rate,
                            efficiency=rate / (base_rate * n_dev),
                            converged=int((statuses == 0).sum())))
    return results
