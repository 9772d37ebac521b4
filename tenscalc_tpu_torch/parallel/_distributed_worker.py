"""One process of the run across processes (:mod:`.distributed_smoke`;
the port of ``tools/_distributed_worker.py``).

    python -m tenscalc_tpu_torch.parallel._distributed_worker RANK NPROC HOST:PORT \
        [--device cuda|cpu] [--n-local 2] [--flagship DIR]

It joins the gloo process group at HOST:PORT as RANK of NPROC, builds a
mesh of ``--n-local`` entries of its device a process
(:func:`.mesh.process_mesh`), and runs the JAX worker's workload over it:

1. a batch-sharded ``mpc_dcmotor`` fleet (T = 6, B = 2 entries a mesh
   entry, mu0 = 1e-3, max_iter = 40), every process solving its own
   entries' shards and holding the whole result;
2. the 16-stage ``'spike'`` KKT solve split over the same processes.

With ``--flagship DIR`` (on the card) it also splits the flagship fleet
(``mpc_dcmotor`` T = 30, B = 1024, float32, K1/K2) over the mesh, times
one solve after a warm-up, and writes the whole result to
``DIR/flagship_rank{RANK}.npz``.  It prints one ``RESULT:`` JSON line.
It runs on the card unless ``--device cpu`` asks for the CPU, and fails
when CUDA is missing; it reports the libraries it had to build (the
run's parent builds them first).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FLEET_T, FLEET_B = 30, 1024


def oracle_fleet(mesh, device: str) -> dict:
    """The JAX worker's phase 1 over ``mesh``."""
    from ..examples import mpc_dcmotor

    T, ns = 6, "dw_"
    solver = mpc_dcmotor.build_solver(T=T, namespace=ns, device=device)
    base = mpc_dcmotor.default_params(T, ns)
    B = 2 * mesh.size
    rng = np.random.default_rng(0)
    params = {}
    for k, v in base.items():
        arr = np.asarray(v, float)
        params[k] = np.broadcast_to(arr, (B,) + arr.shape).copy()
    params[ns + "ref"] = np.stack(
        [mpc_dcmotor.reference_signal(t0 + np.arange(T) * 0.1)[None, :]
         for t0 in np.linspace(0.0, 2.0, B)]
    )
    params[ns + "xinit"] = rng.uniform(-0.1, 0.1, (B, 2, 1))
    inits = {
        ns + "x": params[ns + "xinit"] + 0.01 * rng.random((B, 2, T)),
        ns + "u": 0.01 * rng.random((B, 1, T - 1)),
    }
    res = solver.solve_many(params, inits=inits, mu0=1e-3, max_iter=40, mesh=mesh)
    statuses = res.status.cpu().numpy()
    return dict(fleet_batch=B, fleet_converged=int((statuses == 0).sum()),
                fleet_statuses=statuses.tolist(), fleet_iters=res.iters.cpu().tolist(),
                fleet_backend=solver.kkt_backend_resolved)


def oracle_spike(mesh, device: str) -> dict:
    """The JAX worker's phase 2: the 16-stage 'spike' solve over ``mesh``
    (its axis 'stages')."""
    from .. import api
    from ..expr import parameter, variable
    from ..ops.fns import norm2

    ns, Ts_, n_ = "dw_", 16, 2
    x = variable(ns + "spk_x", (Ts_, n_))
    u = variable(ns + "spk_u", (Ts_,))
    x0 = parameter(ns + "spk_x0", (n_,))
    A = np.array([[0.95, 0.1], [0.0, 0.9]])
    Bm = np.array([0.0, 1.0])
    dyn = x[1:] - (x[:-1] @ A.T + u[:-1, None] * Bm)
    J = norm2(x) + 0.1 * norm2(u)
    spk = api.optimize(
        J, [x, u], constraints=[dyn == 0, x[0] == x0, u >= -1.0, u <= 1.0],
        parameters=[x0], kkt_backend="spike", kkt_mesh=mesh, device=device,
    )
    sol = spk.solve(
        parameters={ns + "spk_x0": np.array([1.0, -0.5])},
        init={ns + "spk_x": np.zeros((Ts_, n_)), ns + "spk_u": np.zeros(Ts_)},
        max_iter=40,
    )
    return dict(spike_status=int(sol.status), spike_iters=int(sol.iters),
                spike_J=float(sol.objective), spike_backend=spk.kkt_backend_resolved)


def flagship(mesh, device: str, out_dir: str, rank: int) -> dict:
    """The flagship fleet split over ``mesh``: one warm-up, one timed
    solve, the kernels' launch counts around it, the result written for
    the parent."""
    from ..examples import mpc_dcmotor as mpc
    from ..kkt import fleet_banded as fb

    ns = "fleet_"
    solver = mpc.build_solver(T=FLEET_T, namespace=ns, dtype="float32", device=device)
    params, inits = mpc.fleet_inputs(FLEET_T, FLEET_B, ns, seed=0)

    def run():
        res = solver.solve_many(params, inits=inits, mu0=1e-3, max_iter=100, mesh=mesh)
        if res.u.device.type == "cuda":
            torch.cuda.synchronize()
        return res

    run()
    for k in fb.LAUNCHES:
        fb.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    iters = res.iters.cpu().numpy()
    per = FLEET_B // mesh.size
    own = np.concatenate([np.arange(j * per, (j + 1) * per)
                          for j, r in enumerate(mesh.ranks) if r == rank])
    np.savez(f"{out_dir}/flagship_rank{rank}.npz", u=res.u.cpu().numpy(),
             status=res.status.cpu().numpy(), iters=iters, f=res.f.cpu().numpy())
    return dict(flagship_batch=FLEET_B, flagship_wall_s=wall,
                flagship_solves_per_s=FLEET_B / wall, flagship_launches=launches,
                flagship_local_lockstep=int(iters[own].max()) - 1,
                flagship_backend=solver.kkt_backend_resolved,
                flagship_u_device=str(res.u.device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("address")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n-local", type=int, default=2)
    ap.add_argument("--flagship", default=None, metavar="DIR")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("worker: CUDA is not available; no solve on the CPU in its place",
              file=sys.stderr)
        return 2
    if args.device == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist

    from .._build import BUILD_DIR
    from .mesh import process_mesh
    from .scaling import init_distributed

    before = set(BUILD_DIR.glob("*.so"))
    init_distributed(args.address, args.nproc, args.rank)
    try:
        local = "cuda:0" if args.device == "cuda" else "cpu"
        mesh = process_mesh(args.n_local, "batch", local)
        smesh = process_mesh(args.n_local, "stages", local)
        out = dict(process=args.rank, n_local=args.n_local, n_global=mesh.size,
                   device=args.device, ranks=list(mesh.ranks))
        if args.device == "cuda":
            from ..kkt import dense_ldl as dl

            for k in dl.LAUNCHES:
                dl.LAUNCHES[k] = 0
        out.update(oracle_fleet(mesh, args.device))
        if args.device == "cuda":
            out["oracle_launches"] = dict(dl.LAUNCHES)
        out.update(oracle_spike(smesh, args.device))
        if args.flagship:
            out.update(flagship(mesh, args.device, args.flagship, args.rank))
    finally:
        dist.destroy_process_group()
    out["built"] = sorted(p.name for p in set(BUILD_DIR.glob("*.so")) - before)
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    print("RESULT:" + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
