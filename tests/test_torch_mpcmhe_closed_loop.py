"""The MPC-MHE DC-motor game (examples/mpcmhe_dcmotor: T = 6, L = 8,
lambda_n = 20) on ``kkt_backend='dense'`` in float64 against the JAX
package: the receding-horizon loop (``run_closed_loop``) over L + 3
steps, every solve at status 0 in the same iterations, states, controls
and estimates within 1e-8; and a solve whose line search evaluates F at
its trial points (``linesearch_affine_F=False``) instead of through Fz,
with the same iterations and uFuture within 1e-8.  (Band mode, the
fleet's path, is held against JAX in tests/test_torch_equilibrium*.py;
the loop and the line search do not depend on the backend.)"""

import numpy as np
import pytest
import torch

import tenscalc_tpu as jtc
import tenscalc_tpu_torch as ttc
from examples import mpcmhe_dcmotor as jmm
from tenscalc_tpu_torch.examples import mpcmhe_dcmotor as tmm

torch.set_num_threads(1)

T, L = 6, 8
ATOL = 1e-8
OVERRIDES = {"lambda_n": 20.0}


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _pair(ns, **opts):
    jtc.expr.clear_variables()
    kw = dict(T=T, L=L, ns=ns, dtype="float64", kkt_backend="dense", **opts)
    sj, st = jmm.build_solver(**kw), tmm.build_solver(device="cpu", **kw)
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "dense"
    return sj, st


def test_closed_loop_matches_jax():
    sj, st = _pair("tc_")
    hj = jmm.run_closed_loop(sj, n_steps=L + 3, param_overrides=OVERRIDES)
    ht = tmm.run_closed_loop(st, n_steps=L + 3, param_overrides=OVERRIDES)
    assert (ht["status"] == 0).all() and len(ht["status"]) == L + 3
    np.testing.assert_array_equal(ht["status"], hj["status"])
    np.testing.assert_array_equal(ht["iters"], hj["iters"])
    for k in ("x", "u", "xEst"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=ATOL, err_msg=k)


def test_exact_F_line_search_matches_jax():
    ns = "tx_"
    sj, st = _pair(ns, linesearch_affine_F=False)
    params = dict(jmm.default_params(ns))
    params[ns + "lambda_n"] = np.asarray(20.0)
    params[ns + "uPast"] = np.zeros((1, L))
    params[ns + "yPast"] = 0.05 * np.sin(0.5 * (np.arange(-L, 0) * 0.05)).reshape(1, L)
    params[ns + "ref"] = jmm.reference_signal(np.arange(T) * 0.05)[None, :]
    sol_j = sj.solve(params, mu0=1e-3, max_iter=100)
    sol_t = st.solve(params, mu0=1e-3, max_iter=100)
    assert sol_j.status == 0 and sol_t.status == 0, sol_t.describe()
    assert sol_t.iters == sol_j.iters
    np.testing.assert_allclose(sol_t.outputs["uFuture"], np.asarray(sol_j.outputs["uFuture"]),
                               rtol=0, atol=ATOL)
