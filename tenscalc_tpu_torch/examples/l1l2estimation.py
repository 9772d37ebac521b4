"""Robust l1/l2 trajectory estimation, written for the PyTorch port (the
JAX package's ``examples/l1l2estimation.py`` builds the same problems,
after the reference's examples/l1l2estimationCS.m).

Estimates a smooth position trajectory from integer-rounded noisy
measurements with outliers, by least squares on measurement noise and
acceleration (``build_l2``), optionally adding sparse l1 noise and
acceleration terms that absorb outliers (``build_l1l2``).

At N = 200 the l1l2 problem has nU = 996 and nF = 796; its condensed KKT
is banded (RCM half-bandwidth 10), so ``kkt_backend='auto'`` resolves to
the fleet banded LDL^T with the band assembled from the hoisted
derivatives: K1/K2 on the card.  ``bench_inputs`` gives one estimation's
inputs as the JAX package's ``bench.py`` sets them, ``fleet_inputs`` a
fleet of estimations, each from its own ``make_data`` seed.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc

# bench.py's l1l2 row in float32: its f64 tolerances are below the f32
# noise floor of this problem's gradient, the duality gap still
# certifies optimality (solved with mu0 = 1, max_iter = 60)
BENCH_OPTIONS = {"dtype": "float32", "gradTolerance": 0.2, "desiredDualityGap": 5e-3}
BENCH_MU0 = 1.0
BENCH_MAX_ITER = 60


def make_data(N=200, noise=1.0, p_outlier=0.1, seed=1):
    """(t, true_position, measurement, dt1, k_outlier) from numpy seed
    ``seed``: a sine trajectory at irregular integer times, rounded noisy
    measurements, a share ``p_outlier`` of them replaced by outliers."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(np.ceil(rng.random(N)))
    true_position = 5 * np.sin(np.abs(t - 100) / 5)
    measurement = np.round(true_position + noise * rng.standard_normal(N))
    k_outlier = np.nonzero(rng.random(N) < p_outlier)[0]
    measurement[k_outlier] = np.round(10 * rng.standard_normal(len(k_outlier)))
    dt1 = 1.0 / (t[1:] - t[:-1])
    return t, true_position, measurement, dt1, k_outlier


def build_l2(N=200, ns="l2e_", **options):
    """Least squares on the measurement noise and the acceleration;
    ``options`` go to :func:`tenscalc_tpu_torch.optimize` (``device``,
    ``dtype``, ...)."""
    measurement = tc.variable(ns + "measurement", (N,))
    dt1 = tc.variable(ns + "dt1", (N - 1,))
    w2acc = tc.variable(ns + "weight2acceleration", ())
    position = tc.variable(ns + "position", (N,))

    velocity = (position[1:] - position[:-1]) * dt1
    acceleration = (velocity[1:] - velocity[:-1]) * dt1[:-1]
    J = tc.norm2(measurement - position) + w2acc * tc.norm2(acceleration)
    return tc.optimize(
        objective=J,
        optimizationVariables=[position],
        parameters=[measurement, dt1, w2acc],
        outputExpressions={"J": J, "position": position},
        **options,
    )


def build_l1l2(N=200, ns="l12e_", **options):
    """l1 terms absorb outliers: epigraph variables noise1abs and
    acceleration1abs with box constraints (l1l2estimationCS.m:113-160)."""
    measurement = tc.variable(ns + "measurement", (N,))
    dt1 = tc.variable(ns + "dt1", (N - 1,))
    w2acc = tc.variable(ns + "weight2acceleration", ())
    w1acc = tc.variable(ns + "weight1acceleration", ())
    w1noise = tc.variable(ns + "weight1noise", ())
    position = tc.variable(ns + "position", (N,))
    noise1 = tc.variable(ns + "noise1", (N,))
    acc1 = tc.variable(ns + "acceleration1", (N - 2,))
    noise1abs = tc.variable(ns + "noise1abs", (N,))
    acc1abs = tc.variable(ns + "acceleration1abs", (N - 2,))

    velocity = (position[1:] - position[:-1]) * dt1
    acceleration = (velocity[1:] - velocity[:-1]) * dt1[:-1]
    noise2 = measurement - position - noise1
    acceleration2 = acceleration - acc1
    J = (
        tc.norm2(noise2)
        + w2acc * tc.norm2(acceleration2)
        + w1noise * noise1abs.sum()
        + w1acc * acc1abs.sum()
    )
    constraints = [
        noise1 <= noise1abs,
        noise1 >= -noise1abs,
        acc1 <= acc1abs,
        acc1 >= -acc1abs,
    ]
    return tc.optimize(
        objective=J,
        optimizationVariables=[position, noise1, acc1, noise1abs, acc1abs],
        constraints=constraints,
        parameters=[measurement, dt1, w2acc, w1acc, w1noise],
        outputExpressions={
            "J": J,
            "position": position,
            "noise1": noise1,
            "acceleration1": acc1,
        },
        **options,
    )


def l1l2_params(measurement, dt1, ns="l12e_"):
    """build_l1l2's parameters at the reference's weights (10, 2, 2)."""
    return {
        ns + "measurement": measurement,
        ns + "dt1": dt1,
        ns + "weight2acceleration": 10.0,
        ns + "weight1acceleration": 2.0,
        ns + "weight1noise": 2.0,
    }


def l1l2_init(N=200, ns="l12e_"):
    """build_l1l2's strictly feasible init: zeros, the epigraph
    variables at one."""
    return {
        ns + "position": np.zeros(N),
        ns + "noise1": np.zeros(N),
        ns + "acceleration1": np.zeros(N - 2),
        ns + "noise1abs": np.ones(N),
        ns + "acceleration1abs": np.ones(N - 2),
    }


def bench_inputs(N=200, ns="l12e_", seed=1):
    """(params, init, true_position) of one estimation as bench.py's
    l1l2 row sets them (``make_data(N)``'s default seed)."""
    _, true_position, measurement, dt1, _ = make_data(N=N, seed=seed)
    return l1l2_params(measurement, dt1, ns), l1l2_init(N, ns), true_position


def fleet_inputs(B, N=200, ns="l12e_"):
    """(params, inits, true_positions) of B estimations, instance i from
    ``make_data(N, seed=i)``: its own sample times (dt1) and
    measurements, the weights shared; numpy arrays with a leading batch
    dimension where they differ."""
    data = [make_data(N=N, seed=i) for i in range(B)]
    params = l1l2_params(np.stack([d[2] for d in data]), np.stack([d[3] for d in data]), ns)
    inits = {k: np.broadcast_to(v, (B,) + v.shape).copy()
             for k, v in l1l2_init(N, ns).items()}
    return params, inits, np.stack([d[1] for d in data])


if __name__ == "__main__":
    N = 200
    t, true_pos, meas, dt1, outliers = make_data(N)
    s2 = build_l2(N)
    sol2 = s2.solve(
        {"l2e_measurement": meas, "l2e_dt1": dt1, "l2e_weight2acceleration": 10.0},
        init={"l2e_position": np.zeros(N)},
        mu0=0.1,
    )
    err2 = np.abs(sol2.outputs["position"] - true_pos).mean()
    print(f"l2:   {sol2.describe()} iters={sol2.iters} mean err={err2:.3f}")

    s12 = build_l1l2(N)
    sol12 = s12.solve(l1l2_params(meas, dt1), init=l1l2_init(N), mu0=0.1)
    err12 = np.abs(sol12.outputs["position"] - true_pos).mean()
    print(f"l1l2: {sol12.describe()} iters={sol12.iters} mean err={err12:.3f}")
