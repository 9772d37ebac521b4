"""Fleet MPC, written for the PyTorch port (the JAX package's
``examples/mpc_fleet.py`` runs the same loop): B independent DC-motor
plants controlled in lockstep on one card, the workload the reference
can only run sequentially ("solving the same small problem thousands of
times").

Each plant has its own pole, gain, reference phase and initial state;
every control period ONE batched solve (``solver.solve_many``) produces
all B control moves, warm-started from the shifted previous solutions.
At T = 20 the condensed KKT has nU + nG = 59 + 40 rows and a band, so
``kkt_backend='auto'`` resolves to the fleet banded LDL^T: K1/K2 on the
card."""

from __future__ import annotations

import numpy as np

from tenscalc_tpu_torch.examples import mpc_dcmotor


def run_fleet(B=64, T=20, n_steps=20, ns="fleet_", seed=0, **options):
    """The closed loop of B plants over ``n_steps`` periods; ``options``
    go to :func:`tenscalc_tpu_torch.optimize` (``device``, ``dtype``
    (float64 by default), ...).  Returns the history as numpy arrays:
    ``x`` and ``u`` (a row a period), ``status`` (a period's B statuses),
    ``iters_max``; the loop stops after a period with an instance not at
    status 0."""
    solver = mpc_dcmotor.build_solver(
        T=T, namespace=ns, dtype=options.pop("dtype", "float64"), **options
    )
    rng = np.random.default_rng(seed)
    base = mpc_dcmotor.default_params(T, ns)
    Ts = base[ns + "Ts"]

    # heterogeneous plants: random poles/gains, phase-shifted references
    poles = rng.uniform(-3.0, -1.0, B)
    gains = rng.uniform(0.7, 1.4, B)
    phases = rng.uniform(0.0, 6.0, B)
    xinit = rng.uniform(-0.15, 0.15, (B, 2, 1))

    params = {}
    for k, v in base.items():
        arr = np.asarray(v, float)
        params[k] = np.broadcast_to(arr, (B,) + arr.shape).copy()
    params[ns + "p"] = poles
    params[ns + "k"] = gains

    xWarm = xinit + 0.01 * rng.random((B, 2, T))
    uWarm = 0.01 * rng.random((B, 1, T - 1))

    t = 0.0
    hist = {"x": [], "u": [], "status": [], "iters_max": []}
    for step in range(n_steps):
        params[ns + "ref"] = np.stack(
            [
                mpc_dcmotor.reference_signal(ph + t + np.arange(T) * Ts)[None, :]
                for ph in phases
            ]
        )
        params[ns + "xinit"] = xinit
        res = solver.solve_many(
            params,
            inits={ns + "x": xWarm, ns + "u": uWarm},
            mu0=1e-3,
            max_iter=100,
        )
        statuses = res.status.cpu().numpy()
        hist["status"].append(statuses.copy())
        hist["iters_max"].append(int(res.iters.max()))
        if (statuses != 0).any():
            break
        # unpack batched solutions: the u block is the first nU*(T-1) entries
        u_all = res.u.cpu().numpy()
        us = u_all[:, : T - 1].reshape(B, 1, T - 1)
        xs = u_all[:, T - 1 :].reshape(B, 2, T)
        u0 = us[:, :, 0:1]
        hist["x"].append(xinit[:, :, 0].copy())
        hist["u"].append(u0[:, :, 0].copy())
        # per-plant plant step (forward Euler like the model)
        A = np.zeros((B, 2, 2))
        A[:, 0, 1] = 1.0
        A[:, 1, 1] = poles
        Bm = np.zeros((B, 2, 1))
        Bm[:, 1, 0] = gains
        xinit = xinit + Ts * (A @ xinit + Bm * u0)
        # shift warm starts
        uWarm = np.concatenate([us[:, :, 1:], np.zeros((B, 1, 1))], axis=2)
        xWarm = np.concatenate([xs[:, :, 1:], xs[:, :, -1:]], axis=2)
        xWarm = np.clip(xWarm, -0.38, 0.38)
        t += Ts
    return {k: np.asarray(v) for k, v in hist.items()}


if __name__ == "__main__":
    import time

    t0 = time.time()
    hist = run_fleet(B=64, T=20, n_steps=20)
    print(f"fleet 64 plants x 20 steps in {time.time()-t0:.1f}s")
    print("all converged:", (hist["status"] == 0).all())
    print("max iters per step:", hist["iters_max"].tolist())
