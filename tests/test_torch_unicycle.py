"""The nonlinear unicycle (``examples/mpc_unicycle.py``) at T = 10
(nU = 59, nG = 50, nF = 18; the condensed KKT nK = 109 with an RCM band
w = 9) on the port's per-iteration band mode against the JAX package's,
on tests/test_band_mode.py's inputs: the JAX side on its fleet backends
(``TENSCALC_AUTO_FLEET=1``, Pallas in interpret mode), the port on the
CPU (the kernels' plain versions); float64 at that test's tolerances,
float32 at the reference's."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_unicycle as jm  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_unicycle as tm  # noqa: E402

torch.set_num_threads(1)

T, NS = 10, "un_"
# float32: the reference's cross-backend tolerance on u
U_ATOL_F32 = 2e-3
# float64: tests/test_band_mode.py's periter-against-dense tolerances
U_ATOL_F64, J_RTOL_F64 = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _unicycle_inputs():
    """tests/test_band_mode.py's inputs of one pursuit at T = 10."""
    rng = np.random.default_rng(0)
    xinit = np.array([0.0, 0.0, 0.5, 2.0, 1.0])[:, None]
    xW = np.tile(xinit, (1, T)) + 0.01 * rng.random((5, T))
    uW = 0.01 * rng.random((1, T - 1))
    params = dict(tm.default_params(NS))
    params[NS + "xinit"] = xinit
    return params, {NS + "x": xW, NS + "u": uW}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_unicycle_matches_jax(dtype):
    sj = jm.build_solver(T=T, ns=NS, dtype=dtype)
    st = tm.build_solver(T=T, ns=NS, dtype=dtype, device="cpu")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode == sj._solve_raw._band_mode == "periter"
    assert tuple(st._hoist) == tuple(sj._hoist) == (False, True, False)
    assert (st.nU, st.nG, st.nF) == (sj.nU, sj.nG, sj.nF) == (59, 50, 18)
    assert (st.kkt_plan.n, st.kkt_plan.bandwidth) == (sj.kkt_plan.n, sj.kkt_plan.bandwidth) \
        == (109, 9)
    params, init = _unicycle_inputs()
    sol_j = sj.solve(params, init=init, mu0=1e-1, max_iter=200)
    sol_t = st.solve(params, init=init, mu0=1e-1, max_iter=200)
    assert sol_t.status == 0 and sol_j.status == 0, (sol_t.describe(), sol_j.describe())
    u_t, u_j = sol_t.variables[NS + "u"], np.asarray(sol_j.variables[NS + "u"])
    if dtype == "float64":
        assert sol_t.iters == sol_j.iters
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=U_ATOL_F64)
        np.testing.assert_allclose(sol_t.objective, sol_j.objective, rtol=J_RTOL_F64)
    else:
        assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=U_ATOL_F32)
