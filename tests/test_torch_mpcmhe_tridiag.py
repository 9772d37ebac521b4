"""The nonlinear MPC-MHE pursuit game (T = 5, L = 4; nK = 177, w = 22) on
``kkt_backend='tridiag'``, the block-tridiagonal LU of its RCM plan,
against the JAX package's ``tridiag_lu`` (its CPU route): the closed
loop (``run_closed_loop``) over L + 3 steps in float64, every solve at
status 0 in the same iterations, states and controls within 1e-8; and in
float32 the first game solve stops at status 4 (FACTORIZATION_NAN) on
both sides, which the JAX package does too (a diagonal block of the
float32 factorization is singular).  The JAX side probes its KKT pattern
as tests/test_torch_mpcmhe_unicycle.py's does."""

import numpy as np
import pytest
import torch

import tenscalc_tpu_torch as ttc
from examples import mpcmhe_unicycle as jmu
from tenscalc_tpu_torch.examples import mpcmhe_unicycle as tmu
from test_torch_mpcmhe_unicycle import L, NS, build_pair, jax_fleet_env  # noqa: F401

torch.set_num_threads(1)

ATOL = 1e-8


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def test_closed_loop_float64_matches_jax(jax_fleet_env):  # noqa: F811
    sj, st = build_pair("float64", NS + "t_", kkt_backend="tridiag")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "tridiag_lu"
    assert st.kkt_plan.bandwidth == 22 and st._solve_raw.band_mode is None
    hj = jmu.run_closed_loop(sj, n_steps=L + 3, seed=0)
    ht = tmu.run_closed_loop(st, n_steps=L + 3, seed=0)
    np.testing.assert_array_equal(ht["status"], hj["status"])
    assert (ht["status"] == 0).all() and len(ht["status"]) == L + 3
    np.testing.assert_array_equal(ht["iters"], hj["iters"])
    for k in ("x", "u", "dist"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=ATOL, err_msg=k)


def test_float32_stops_at_factorization_nan_as_jax(jax_fleet_env):  # noqa: F811
    sj, st = build_pair("float32", NS + "n_", kkt_backend="tridiag")
    hj = jmu.run_closed_loop(sj, n_steps=L + 1, seed=0)
    ht = tmu.run_closed_loop(st, n_steps=L + 1, seed=0)
    assert list(hj["status"]) == [0] * L + [4]
    np.testing.assert_array_equal(ht["status"], hj["status"])
