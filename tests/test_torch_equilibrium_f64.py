"""The port's equilibrium slice in float64 against the JAX package's: the
MPC-MHE game at T = 6, L = 8 (tests/test_game_backends.py's inputs), both
sides on the CPU and on their fleet banded LU backend
(``TENSCALC_AUTO_FLEET=1``).  Both factor in float32 and refine in
float64, so the float32 convergence ball (~4e-3 wide in uFuture) does not
hide a fault of the port here: the answers agree to ~1e-12."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpcmhe_dcmotor as jmm  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpcmhe_dcmotor as tmm  # noqa: E402

torch.set_num_threads(1)

T, L = 6, 8
NS = "t64_"
# measured 8.5e-13 (and 1.8e-11 on a fleet of three); a float64 port
# fault would show far above this
U_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def test_float64_game_matches_jax(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    jtc.expr.clear_variables()
    sj = jmm.build_solver(T=T, L=L, ns=NS, dtype="float64")
    st = tmm.build_solver(T=T, L=L, ns=NS, dtype="float64", device="cpu")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet_banded_lu"
    params = dict(jmm.default_params(NS))
    params[NS + "lambda_n"] = np.asarray(20.0)
    params[NS + "uPast"] = np.zeros((1, L))
    params[NS + "yPast"] = 0.05 * np.sin(0.5 * (np.arange(-L, 0) * 0.05)).reshape(1, L)
    params[NS + "ref"] = jmm.reference_signal(np.arange(T) * 0.05)[None, :]
    sol_j = sj.solve(params, mu0=1e-3, max_iter=100)
    sol_t = st.solve(params, mu0=1e-3, max_iter=100)
    assert sol_t.status == sol_j.status == 0, sol_t.describe()
    assert sol_t.iters == sol_j.iters
    np.testing.assert_allclose(sol_t.variables[NS + "uFuture"], sol_j.variables[NS + "uFuture"],
                               atol=U_ATOL)
    np.testing.assert_allclose(sol_t.objective, sol_j.objective, rtol=1e-9)
