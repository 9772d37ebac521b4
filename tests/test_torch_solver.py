"""The port's slice end to end against the JAX package: the flagship MPC
problem (T = 14) through ``solve`` and ``solve_many``, with the JAX side
on its fleet banded backend (``TENSCALC_AUTO_FLEET=1``), as
tests/test_band_mode.py runs it."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from examples import mpc_dcmotor as jmpc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_dcmotor as tmpc  # noqa: E402
from tenscalc_tpu_torch.interop import result_to_numpy  # noqa: E402

torch.set_num_threads(1)

T = 14
NS = "ts_"
# the reference's own batched-vs-single float32 tolerance
# (tests/test_band_mode.py): f32 solves stop at slightly different
# points inside the same tolerance ball
U_ATOL = 2e-3


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


@pytest.fixture(scope="module")
def solvers():
    mp = pytest.MonkeyPatch()
    mp.setenv("TENSCALC_AUTO_FLEET", "1")
    sj = jmpc.build_solver(T=T, namespace=NS, dtype="float32")
    st = tmpc.build_solver(T=T, namespace=NS, dtype="float32", device="cpu")
    yield sj, st
    mp.undo()


def _single_inputs():
    params = dict(jmpc.default_params(T, NS))
    params[NS + "ref"] = jmpc.reference_signal(np.arange(T) * 0.1)[None, :]
    params[NS + "xinit"] = np.array([[0.15], [0.1]])
    init = {
        NS + "x": params[NS + "xinit"] + 0.01 * np.ones((2, T)),
        NS + "u": 0.01 * np.ones((1, T - 1)),
    }
    return params, init


def _fleet_inputs(B=3):
    rng = np.random.default_rng(0)
    params = dict(jmpc.default_params(T, NS))
    params[NS + "ref"] = np.stack([
        jmpc.reference_signal(t0 + np.arange(T) * 0.1)[None, :]
        for t0 in np.linspace(0, 2, B)
    ])
    params[NS + "xinit"] = rng.uniform(-0.1, 0.1, (B, 2, 1))
    inits = {
        NS + "x": params[NS + "xinit"] + 0.01 * rng.random((B, 2, T)),
        NS + "u": 0.01 * rng.random((B, 1, T - 1)),
    }
    return params, inits


def _packed(sol):
    return np.concatenate(
        [sol.variables[NS + "u"].ravel(), sol.variables[NS + "x"].ravel()]
    )


def test_single_solve_matches_jax(solvers):
    sj, st = solvers
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet_banded"
    assert sj._solve_raw._band_mode == st._solve_raw.band_mode == "hoisted"
    params, init = _single_inputs()
    sol_j = sj.solve(params, init=init, mu0=1e-3, max_iter=100)
    sol_t = st.solve(params, init=init, mu0=1e-3, max_iter=100)
    assert sol_j.status == 0 and sol_t.status == 0, sol_t.describe()
    assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
    np.testing.assert_allclose(_packed(sol_t), _packed(sol_j), atol=U_ATOL)
    np.testing.assert_allclose(sol_t.objective, sol_j.objective, rtol=1e-3)


def test_fleet_matches_jax_and_single(solvers):
    sj, st = solvers
    params, inits = _fleet_inputs()
    res_j = sj.solve_many(params, inits=inits, mu0=1e-3, max_iter=100)
    res_t = result_to_numpy(
        st.solve_many(params, inits=inits, mu0=1e-3, max_iter=100)
    )
    assert (res_t["status"] == 0).all() and (np.asarray(res_j.status) == 0).all()
    assert (np.abs(res_t["iters"] - np.asarray(res_j.iters)) <= 1).all()
    np.testing.assert_allclose(res_t["u"], np.asarray(res_j.u), atol=U_ATOL)
    # the B = 1 solve is the fleet's instance: the same code path with
    # per-instance masks.  Only the batch size of each product differs,
    # which changes float32 summation orders, so u agrees to the
    # reference's own batched-vs-single tolerance
    for b in range(3):
        sp = {k: (v[b] if k in (NS + "ref", NS + "xinit") else v)
              for k, v in params.items()}
        single = st.solve(sp, init={k: v[b] for k, v in inits.items()},
                          mu0=1e-3, max_iter=100)
        assert single.status == 0 and single.iters == res_t["iters"][b]
        np.testing.assert_allclose(_packed(single), res_t["u"][b], atol=U_ATOL)


def test_fleet_with_per_instance_plant_matches_jax(solvers):
    """A plant parameter given per instance makes the hoisted equality
    Jacobian, and with it the KKT band's constant part, per instance."""
    sj, st = solvers
    params, inits = _fleet_inputs(B=2)
    params[NS + "p"] = np.array([-2.0, -1.5])
    res_j = sj.solve_many(params, inits=inits, mu0=1e-3, max_iter=100)
    res_t = result_to_numpy(
        st.solve_many(params, inits=inits, mu0=1e-3, max_iter=100)
    )
    assert (res_t["status"] == 0).all() and (np.asarray(res_j.status) == 0).all()
    assert (np.abs(res_t["iters"] - np.asarray(res_j.iters)) <= 1).all()
    np.testing.assert_allclose(res_t["u"], np.asarray(res_j.u), atol=U_ATOL)


def test_fleet_inputs_split_shared_and_batched(solvers):
    """A parameter in its declared shape is shared; any other carries a
    leading batch dimension (batch.py:110-127)."""
    from tenscalc_tpu_torch.interop import inits_from_numpy, params_from_numpy

    _, st = solvers
    params, inits = _fleet_inputs(B=3)
    penv, shared, B = params_from_numpy(st, params, "cpu", torch.float32)
    assert B == 3 and shared == frozenset(params) - {NS + "ref", NS + "xinit"}
    u0 = inits_from_numpy(st, inits, B, "cpu", torch.float32)
    assert tuple(u0.shape) == (3, st.nU)
    np.testing.assert_array_equal(u0[1].numpy(), st._pack_init(
        {k: v[1] for k, v in inits.items()}).numpy())
    bad = dict(params, **{NS + "xinit": np.zeros((3, 2, 2))})
    with pytest.raises(ValueError, match="xinit"):
        params_from_numpy(st, bad, "cpu", torch.float32)
    bad = dict(params, **{NS + "ref": params[NS + "ref"][:2]})
    with pytest.raises(ValueError, match="inconsistent"):
        params_from_numpy(st, bad, "cpu", torch.float32)
    single = {k: (v[0] if k in (NS + "ref", NS + "xinit") else v)
              for k, v in params.items()}
    with pytest.raises(ValueError, match="batched parameter"):
        params_from_numpy(st, single, "cpu", torch.float32)


def test_optimize_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    x = ttc.variable("td_x", (3,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttc.optimize(((x - 1.0) ** 2).sum(), [x], constraints=[x >= 0])


def test_deferred_backends_raise():
    """'tridiag' is ported now: a problem whose KKT has fewer than 64 rows
    resolves to 'dense', as in the JAX package (its api.py:348)."""
    import tenscalc_tpu as jtc

    x = ttc.variable("tdb_x", (3,))
    st = ttc.optimize((x ** 2).sum(), [x], device="cpu", kkt_backend="tridiag")
    jtc.expr.clear_variables()
    xj = jtc.variable("tdb_x", (3,))
    sj = jtc.optimize((xj ** 2).sum(), [xj], kkt_backend="tridiag")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "dense"


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, tenscalc_tpu_torch, tenscalc_tpu_torch.examples.mpc_dcmotor\n"
        "import tenscalc_tpu_torch.examples.mpcmhe_dcmotor\n"
        "import tenscalc_tpu_torch.ipm.equilibrium, tenscalc_tpu_torch.kkt.banded_lu\n"
        "import tenscalc_tpu_torch.kkt.band_assemble, tenscalc_tpu_torch.kkt.select\n"
        "import tenscalc_tpu_torch.kkt.fleet, tenscalc_tpu_torch.kkt.pallas_ldl\n"
        "import tenscalc_tpu_torch.kkt.dense_ldl, tenscalc_tpu_torch.examples.sls\n"
        "import tenscalc_tpu_torch.kkt.tridiag, tenscalc_tpu_torch.kkt.arrow\n"
        "import tenscalc_tpu_torch.kkt.cyclic, tenscalc_tpu_torch.kkt.spike\n"
        "import tenscalc_tpu_torch.parallel.scaling\n"
        "import tenscalc_tpu_torch.diagnostics, tenscalc_tpu_torch.introspect\n"
        "import tenscalc_tpu_torch.profiling, tenscalc_tpu_torch.cgexport\n"
        "import tenscalc_tpu_torch.parallel.distributed_smoke\n"
        "import tenscalc_tpu_torch.parallel._distributed_worker\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tenscalc_tpu' or m.startswith('tenscalc_tpu.')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
