"""A fleet of four quadcopters (T = 6, the large Newton matrix, float64,
``mpc_quadcopter.fleet_inputs``: each its own target) on ``'auto'``
(``fleet_banded``, the dense KKT to K1/K2's plain versions on the CPU)
against the same four solved one at a time, over 20 iterations: every
instance at the same status and iteration count as its single solve,
its variables within 1e-8; a spy on the fleet banded entry points counts
K1 at least once a lockstep iteration, K2 beside it, and no K3 (the
solver reads no inertia here).

In float64 the fleet's KKT and its single solve's differ only in the
last bits of batched products, which the float32 band almost never
sees; in float32 they reach the band, whose clamped pivots turn them
into another path within two iterations (tests/test_torch_quadcopter_auto.py),
so the fleet is held in float64."""

import numpy as np
import pytest
import torch

import tenscalc_tpu_torch as ttc
from tenscalc_tpu_torch.examples import mpc_quadcopter as tq
from tenscalc_tpu_torch.kkt import fleet_banded as tfb

torch.set_num_threads(1)

T, B, ITERS = 6, 4, 20
NS = "tqf_"
ATOL = 1e-8


@pytest.fixture
def launches(monkeypatch):
    """Calls of the fleet banded entry points, where the card launches
    K1, K2 and K3."""
    calls = {"K1": 0, "K2": 0, "K3": 0}

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    for key, name in (("K1", "fleet_banded_factor_solve_batched"),
                      ("K2", "fleet_banded_solve_batched"), ("K3", "fleet_banded_factor_batched")):
        monkeypatch.setattr(tfb, name, count(key, getattr(tfb, name)))
    return calls


def test_fleet_matches_single_solves(launches):
    ttc.clear_variables()
    st = tq.build_solver(T, ns=NS, dtype="float64", smallerNewtonMatrix=False, device="cpu")
    assert st.kkt_backend_resolved == "fleet_banded" and st._solve_raw.band_mode is None
    assert (st.kkt_plan.n, st.kkt_plan.bandwidth) == (14 * T + 6, 25)
    params, inits = tq.fleet_inputs(T, B, ns=NS, seed=0)
    res = st.solve_many(params, inits=inits, mu0=0.1, max_iter=ITERS)
    assert bool(torch.isfinite(res.u).all())
    lockstep = int(res.iters.max()) - 1
    assert launches["K1"] >= lockstep and launches["K2"] >= 1 and launches["K3"] == 0, launches
    for b in range(B):
        one = {k: (v[b] if k == NS + "pdesired" else v) for k, v in params.items()}
        sol = st.solve(one, init={k: v[b] for k, v in inits.items()}, mu0=0.1, max_iter=ITERS)
        assert sol.status == int(res.status[b]) and sol.iters == int(res.iters[b])
        z = np.concatenate([np.ravel(sol.variables[v.name]) for v in st.variables])
        np.testing.assert_allclose(res.u[b].numpy(), z, rtol=0, atol=ATOL)
    ttc.clear_variables()
