"""The port's equilibrium slice against the JAX package: the MPC-MHE game
(T = 6, L = 8, float32; stacked KKT n = 146, band w = 10) built and
solved once, with the JAX side on its fleet banded LU backend
(``TENSCALC_AUTO_FLEET=1``), as tests/test_game_backends.py runs it.
The fleet is held against JAX in tests/test_torch_equilibrium_fleet.py."""

import inspect
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
NS = "te_"
# the reference's own cross-backend tolerance on uFuture
# (tests/test_game_backends.py): f32 solves stop at slightly different
# points inside the same tolerance ball
U_ATOL = 2e-3
# float32 objective of two solves that agree to U_ATOL
F_RTOL = 1e-3
CERT_KEYS = ("hoist_S", "hoist_S_sf", "hoist_Gz", "hoist_Fz",
             "deps_S", "deps_G", "deps_Sl", "deps_Fz")


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


def _jax_certificates(solver):
    """The JAX build's certificates, read from the closure of its solve
    function (the JAX package keeps them as local variables)."""
    cv = inspect.getclosurevars(solver._solve_raw).nonlocals
    return {k: cv[k] for k in CERT_KEYS}


def _single_params(ns):
    """tests/test_game_backends.py's inputs."""
    params = dict(jmm.default_params(ns))
    params[ns + "lambda_n"] = np.asarray(20.0)
    params[ns + "uPast"] = np.zeros((1, L))
    params[ns + "yPast"] = 0.05 * np.sin(0.5 * (np.arange(-L, 0) * 0.05)).reshape(1, L)
    params[ns + "ref"] = jmm.reference_signal(np.arange(T) * 0.05)[None, :]
    return params


def test_build_matches_jax(solvers):
    sj, st = solvers
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet_banded_lu"
    assert sj._solve_raw._band_mode == st._solve_raw.band_mode == "hoisted"
    assert st._ipm_dims == sj._ipm_dims == (6, 16, 28, 12, 28, 0, 0, 28)
    assert st.kkt_plan.n == sj.kkt_plan.n == 146
    assert st.kkt_plan.bandwidth == sj.kkt_plan.bandwidth == 10
    np.testing.assert_array_equal(st.kkt_plan.perm, sj.kkt_plan.perm)
    cj = _jax_certificates(sj)
    assert {k: st.certificates[k] for k in CERT_KEYS} == cj
    # the fleet's per-instance parameters enter no hoisted block, so the
    # hoisted blocks and the constant band carry no batch dimension
    per_instance = {NS + "uPast", NS + "yPast", NS + "ref"}
    for k in ("deps_S", "deps_G", "deps_Sl", "deps_Fz"):
        assert not (st.certificates[k] & per_instance), k


def test_single_solve_matches_jax(solvers):
    sj, st = solvers
    params = _single_params(NS)
    sol_j = sj.solve(params, mu0=1e-3, max_iter=100)
    sol_t = st.solve(params, mu0=1e-3, max_iter=100)
    assert sol_j.status == 0 and sol_t.status == 0, sol_t.describe()
    assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
    np.testing.assert_allclose(
        sol_t.variables[NS + "uFuture"], sol_j.variables[NS + "uFuture"],
        atol=U_ATOL,
    )
    np.testing.assert_allclose(sol_t.objective, sol_j.objective, rtol=F_RTOL)
    np.testing.assert_allclose(
        sol_t.outputs["uFuture"], sol_j.outputs["uFuture"], atol=U_ATOL
    )


def test_equilibrium_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmm.build_solver(T=T, L=L, ns="td_", dtype="float32")


@pytest.mark.parametrize("opt,backend,band_mode", [
    ({"smallerNewtonMatrix": True}, "dense", None),
    ({"skipAffine": False}, "fleet_banded_lu", "hoisted"),
    ({"kkt_backend": "dense"}, "dense", None),
    ({"kkt_backend": "tridiag"}, "tridiag_lu", None),
], ids=["opt0", "opt1", "opt2", "opt3"])
def test_deferred_branches_raise(opt, backend, band_mode):
    """The branches that once raised at build time (the condensed matrix,
    Mehrotra's step, the dense and block-tridiagonal backends) now build
    (on the T = 3, L = 4 game) and resolve as the JAX package does: the
    condensed matrix and the tridiagonal LU outside band mode, Mehrotra's
    step in it; tests/test_torch_equilibrium_dense.py and
    tests/test_torch_mpcmhe_unicycle.py hold their solves against it."""
    st = tmm.build_solver(T=3, L=4, ns="tdb_", dtype="float32", device="cpu", **opt)
    assert st.kkt_backend_resolved == backend
    assert st._solve_raw.band_mode == band_mode
