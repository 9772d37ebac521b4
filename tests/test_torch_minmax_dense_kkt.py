"""The min-max solver outside band mode on the fleet banded LDL^T:
tests/test_game_backends.py's chain (n = 40: saddle KKT nK = 240, RCM
w = 6) with a quartic difference term, whose Hessian depends on u, so
no certificate hoists it and the dense saddle KKT goes to
``FleetBandedFactorization`` (K1/K2, their plain versions on the CPU),
the HessD inertia to the dense LDL^T; against the JAX package with
``TENSCALC_AUTO_FLEET=1`` in float64 and float32."""

import numpy as np
import pytest
import torch

import tenscalc_tpu as jtc
import tenscalc_tpu_torch as ttc
from tenscalc_tpu_torch.kkt import fleet_banded as tfb

torch.set_num_threads(1)

# test_torch_minmax_fleet.py's tolerances on u
U_ATOL = {"float64": 1e-4, "float32": 2e-3}
N_MM, NS = 40, "mq_"


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


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


def _minmax(m, dtype, **kw):
    """tests/test_game_backends.py's chain-coupled saddle problem with a
    quartic difference term: the Hessian depends on u."""
    u, d = m.variable(NS + "u", (N_MM,)), m.variable(NS + "d", (N_MM,))
    p = m.parameter(NS + "p", (N_MM,))
    sq = m.norm2 if m is jtc else (lambda e: (e * e).sum())
    f = (sq(u - p) + 2.0 * sq(u[1:] - u[:-1]) + ((u[1:] - u[:-1]) ** 4).sum()
         + u @ d - sq(d))
    return m.minmax(objective=f, minOptimizationVariables=[u], maxOptimizationVariables=[d],
                    minConstraints=[u >= -2.0, u <= 2.0], maxConstraints=[d >= -2.0, d <= 2.0],
                    parameters=[p], dtype=dtype, **kw)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_minmax_outside_band_mode_matches_jax(dtype, launches):
    sj, st = _minmax(jtc, dtype), _minmax(ttc, dtype, device="cpu")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode is sj._solve_raw._band_mode is None
    assert st._solve_raw.certificates["hoist_H"] is False
    assert (st.kkt_plan.n, st.kkt_plan.bandwidth) == (sj.kkt_plan.n, sj.kkt_plan.bandwidth) \
        == (240, 6)
    rng = np.random.default_rng(0)
    one = {NS + "p": 0.5 * rng.standard_normal(N_MM)}
    init = {NS + "u": np.zeros(N_MM), NS + "d": np.zeros(N_MM)}
    sol_j, sol_t = sj.solve(one, init=init), st.solve(one, init=init)
    assert sol_t.status == 0 and sol_j.status == 0, (sol_t.describe(), sol_j.describe())
    assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
    np.testing.assert_allclose(sol_t.variables[NS + "u"], np.asarray(sol_j.variables[NS + "u"]),
                               rtol=0, atol=U_ATOL[dtype])
    # the saddle KKT's inertia reads K1's factor after its solve; HessD's
    # goes by the dense LDL^T
    assert launches["K1"] > 0 and launches["K3"] == 0, launches
