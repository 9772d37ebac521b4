"""The port's MPC-MHE fleet against the JAX package's (T = 6, L = 8,
float32, B = 3): the plant model and the weights shared, the past input
and output windows and the reference per instance, as the JAX package's
bench.py builds them; the JAX side on its fleet banded LU backend
(``TENSCALC_AUTO_FLEET=1``)."""

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
from tenscalc_tpu_torch.interop import fleet_from_numpy, result_to_numpy  # noqa: E402

torch.set_num_threads(1)

T, L, B = 6, 8, 3
NS = "tf_"
PER_INSTANCE = (NS + "uPast", NS + "yPast", NS + "ref")
# the reference's own cross-backend tolerance on uFuture
# (tests/test_game_backends.py): f32 solves stop at slightly different
# points inside the same tolerance ball
U_ATOL = 2e-3
# float32 objective of two solves that agree to U_ATOL
F_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


@pytest.fixture(scope="module")
def solvers():
    mp = pytest.MonkeyPatch()
    mp.setenv("TENSCALC_AUTO_FLEET", "1")
    jtc.expr.clear_variables()
    sj = jmm.build_solver(T=T, L=L, ns=NS, dtype="float32")
    st = tmm.build_solver(T=T, L=L, ns=NS, dtype="float32", device="cpu")
    yield sj, st
    mp.undo()


def test_fleet_matches_jax_and_single(solvers):
    sj, st = solvers
    params = tmm.fleet_inputs(T, L, B, NS, seed=0)
    res_j = sj.solve_many(params, mu0=1e-3, max_iter=100)
    res_t = result_to_numpy(st.solve_many(params, mu0=1e-3, max_iter=100))
    nUu = st._ipm_dims[0]
    assert (res_t["status"] == 0).all() and (np.asarray(res_j.status) == 0).all()
    assert (np.abs(res_t["iters"] - np.asarray(res_j.iters)) <= 1).all()
    np.testing.assert_allclose(
        res_t["u"][:, :nUu], np.asarray(res_j.u)[:, :nUu], atol=U_ATOL
    )
    np.testing.assert_allclose(res_t["f"], np.asarray(res_j.f), rtol=F_RTOL)
    # the B = 1 solve is the fleet's instance: the same code path with
    # per-instance masks.  Only the batch size of each product differs,
    # which changes float32 summation orders, so uFuture agrees to the
    # reference's own tolerance
    for b in range(B):
        sp = {k: (v[b] if k in PER_INSTANCE else v) for k, v in params.items()}
        single = st.solve(sp, mu0=1e-3, max_iter=100)
        assert single.status == 0 and single.iters == res_t["iters"][b]
        np.testing.assert_allclose(
            single.variables[NS + "uFuture"].ravel(), res_t["u"][b, :nUu],
            atol=U_ATOL,
        )


def test_exit_metrics_of_a_result(solvers):
    """Evaluated again from a result's final iterate, the exit metrics are
    the ones the solve stopped on, and they pass the exit tests; an answer
    stopped one or more updates short of convergence fails the gap test."""
    _, st = solvers
    opts = st.opts
    params = tmm.fleet_inputs(T, L, B, NS, seed=0)
    res = st.solve_many(params, mu0=1e-3, max_iter=100)
    m = st.exit_metrics(params, res)
    # the same code on the same device and batch: the same float32 values
    for key, ref in (("g", res.norminf_grad), ("eq", res.norminf_eq), ("gap", res.gap)):
        torch.testing.assert_close(m[key], ref, rtol=0, atol=0)
    assert (m["g"] <= opts.gradTolerance).all()
    assert (m["eq"] <= opts.equalTolerance).all()
    assert (m["gap"] <= opts.desiredDualityGap).all()
    assert (m["min_F"] > 0).all() and (m["min_lam"] > 0).all()
    short = st.solve_many(params, mu0=1e-3, max_iter=int(res.iters.min()) - 2)
    assert (short.status != 0).all()
    assert (st.exit_metrics(params, short)["gap"] > opts.desiredDualityGap).all()


def test_fleet_inputs_split_shared_and_batched(solvers):
    """A parameter in its declared shape is shared; any other carries a
    leading batch dimension; without one, the inits give the fleet size
    (equilibrium.py:1347-1365 of the JAX package)."""
    _, st = solvers
    params = tmm.fleet_inputs(T, L, B, NS, seed=1)
    penv, shared, z0 = fleet_from_numpy(st, params, None, "cpu", torch.float32)
    assert shared == frozenset(params) - set(PER_INSTANCE)
    assert tuple(z0.shape) == (B, sum(st._ipm_dims[:3])) and not z0.any()
    single = {k: (v[0] if k in PER_INSTANCE else v) for k, v in params.items()}
    rng = np.random.default_rng(2)
    inits = {NS + "uFuture": rng.random((2, 1, T)), NS + "x1": rng.random((2, 2, L + T))}
    penv, shared, z0 = fleet_from_numpy(st, single, inits, "cpu", torch.float32)
    assert shared == frozenset(params) and z0.shape[0] == 2
    np.testing.assert_array_equal(
        z0[1].numpy(), st._pack_init({k: v[1] for k, v in inits.items()}).numpy()
    )
    with pytest.raises(ValueError, match="batched parameter or init"):
        fleet_from_numpy(st, single, None, "cpu", torch.float32)
