"""The nonlinear MPC-MHE pursuit game (T = 5, L = 4; nK = 177, w = 22) in
float32 on the fleet banded LU against the JAX package (K9/K10 in
interpret mode on its side, their plain versions on the port's): the
closed loop's first game solve reaches status 0 on both sides within one
iteration of each other, with uFuture within the reference's float32
tolerance 2e-3.  The JAX side probes its KKT pattern as
tests/test_torch_mpcmhe_unicycle.py's does."""

import numpy as np
import pytest
import torch

import tenscalc_tpu_torch as ttc
from test_torch_mpcmhe_unicycle import NS, build_pair, first_game_solve, jax_fleet_env  # noqa: F401

torch.set_num_threads(1)

# the reference's cross-backend float32 tolerance on u
U_ATOL_F32 = 2e-3


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def test_first_solve_float32_matches_jax(jax_fleet_env):  # noqa: F811
    sj, st = build_pair("float32", NS + "s_")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded_lu"
    assert st._solve_raw.band_mode is None
    params, init, kw, sol_j = first_game_solve(sj)
    sol_t = st.solve(params, init=init, **kw)
    assert sol_j.status == 0 and sol_t.status == 0, sol_t.describe()
    assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
    np.testing.assert_allclose(sol_t.outputs["uFuture"], np.asarray(sol_j.outputs["uFuture"]),
                               rtol=0, atol=U_ATOL_F32)
