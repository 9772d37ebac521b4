"""Banded plans whose KKT the solver assembles densely, handed to the
fleet banded LDL^T of a dense matrix (``FleetBandedFactorization``:
K1/K2, their plain versions on the CPU), against the JAX package with
``TENSCALC_AUTO_FLEET=1`` (its adapter's Pallas kernels in interpret
mode): test_torch_optimize_dense.py's smoothing chain without
inequalities (n = 80, nK = 81) and the same chain with a bound on the
large Newton matrix (nK = 160).  test_torch_minmax_dense_kkt.py holds
the min-max solver's dense saddle KKT on the same backend."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt import fleet_banded as tfb  # noqa: E402

torch.set_num_threads(1)

# float64: both sides factor in float32 and refine in float64
X_ATOL = {"float64": 1e-8, "float32": 2e-3}


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


def _opt(mod, *args, **kw):
    if mod is ttc:
        kw["device"] = "cpu"
    return mod.optimize(*args, **kw)


def _chain(mod, dtype):
    p, x = mod.variable("ch_p", (80,)), mod.variable("ch_x", (80,))
    J = mod.norm2(x - p) + mod.norm2(x[1:] - x[:-1])
    return _opt(mod, J, [x], constraints=[x[0] == 0.0], parameters=[p], dtype=dtype)


def _large(mod, dtype):
    p, x = mod.variable("ch_p", (80,)), mod.variable("ch_x", (80,))
    J = mod.norm2(x - p) + mod.norm2(x[1:] - x[:-1])
    return _opt(mod, J, [x], constraints=[x >= -1.0], parameters=[p], dtype=dtype,
                smallerNewtonMatrix=False)


@pytest.mark.parametrize("problem,nK", [(_chain, 81), (_large, 160)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_optimize_dense_kkt_on_fleet_banded_matches_jax(problem, nK, dtype, launches):
    sj, st = problem(jtc, dtype), problem(ttc, dtype)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode is sj._solve_raw._band_mode is None
    assert st.kkt_plan.n == sj.kkt_plan.n == nK
    assert st.kkt_plan.bandwidth == sj.kkt_plan.bandwidth
    p = np.linspace(0.0, 1.0, 80)
    args = dict(init={"ch_x": np.zeros(80)})
    sol_j = sj.solve({"ch_p": p}, **args)
    sol_t = st.solve({"ch_p": p}, **args)
    assert sol_t.ok and sol_j.ok, (sol_t.describe(), sol_j.describe())
    assert sol_t.iters == sol_j.iters
    np.testing.assert_allclose(sol_t.variables["ch_x"], np.asarray(sol_j.variables["ch_x"]),
                               rtol=0, atol=X_ATOL[dtype])
    # one factorization (K1) an adaptation trip, the inertia never asked
    # first (no K3), the later solves K2
    assert launches["K1"] >= sol_t.iters - 1 and launches["K3"] == 0, launches
    assert launches["K2"] >= launches["K1"], launches
