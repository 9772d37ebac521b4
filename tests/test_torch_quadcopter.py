"""The quadcopter (examples/mpc_quadcopter) at T = 6 with the large
Newton matrix (nK = 14 T + 6 = 90) against the JAX package with
``TENSCALC_AUTO_FLEET=1``, in float64: the plan, the backend and the
band mode on ``'auto'`` (``fleet_banded``, RCM w = 25, no band mode: the
square root of the thrust makes every Hessian depend on the iterate, so
the dense KKT goes to ``FleetBandedFactorization``); the problem's
functions, derivatives and dense KKT at the hover init and off it
(within 1e-12); and the solve on ``'dense'`` (iterations equal, p and u
within 1e-6).  tests/test_torch_quadcopter_auto.py holds the solves on
``'auto'``, tests/test_torch_quadcopter_fleet.py a fleet.

The JAX package probes the KKT pattern with eager operations; here its
``_assemble_ww`` is compiled once with ``jax.jit`` for that probe (the
same operations and plan)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_quadcopter as jq  # noqa: E402
from tenscalc_tpu import api as japi  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_quadcopter as tq  # noqa: E402
from tenscalc_tpu_torch.ipm.solver import dense_kkt  # noqa: E402

torch.set_num_threads(1)

T = 6
NS = "tq_"
VAL = 1e-12


@pytest.fixture(scope="module")
def jax_fleet_env():
    mp = pytest.MonkeyPatch()
    mp.setenv("TENSCALC_AUTO_FLEET", "1")
    build_ipm = japi.build_ipm

    def jit_probe(*a, **k):
        solve = build_ipm(*a, **k)
        solve._assemble_ww = jax.jit(solve._assemble_ww)
        return solve

    mp.setattr(japi, "build_ipm", jit_probe)
    yield
    mp.undo()


def build_pair(dtype, ns, **opts):
    jtc.expr.clear_variables()
    ttc.clear_variables()
    sj = jq.build_solver(T, ns=ns, dtype=dtype, smallerNewtonMatrix=False, **opts)
    st = tq.build_solver(T, ns=ns, dtype=dtype, smallerNewtonMatrix=False, device="cpu",
                         **opts)
    return sj, st


@pytest.fixture(scope="module")
def auto64(jax_fleet_env):
    return build_pair("float64", NS + "a_")


def test_example_inputs_match_jax():
    ns = NS + "i_"
    for k, v in jq.default_params(ns).items():
        np.testing.assert_array_equal(tq.default_params(ns)[k], v)
    for k, v in jq.hover_init(T, ns).items():
        np.testing.assert_array_equal(tq.hover_init(T, ns)[k], v)
    params, inits = tq.fleet_inputs(T, 3, ns, seed=0)
    pd = params[ns + "pdesired"]
    assert pd.shape == (3, 3, 1)
    assert (np.abs(pd - np.array([[0.0], [5.0], [-2.5]])) <= 0.5).all()
    for b in range(3):
        one = jq.hover_init(T, ns)
        one[ns + "p"] = (params[ns + "pinit"]
                         + (pd[b] - params[ns + "pinit"]) * np.linspace(0, 1, T)[None, :])
        for k, v in one.items():
            np.testing.assert_allclose(inits[k][b], v, rtol=0, atol=1e-15)


def test_plan_backend_and_band_mode_match_jax(auto64):
    sj, st = auto64
    assert (st.nU, st.nF, st.nG) == (sj.nU, sj.nF, sj.nG) == (7 * T, 3 * T, 5 * T)
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode is None
    jp, tp = sj._band_plan, st.kkt_plan
    assert tp.n == jp.n == 14 * T + 6
    assert tp.bandwidth == jp.bandwidth == 25
    np.testing.assert_array_equal(np.asarray(tp.perm), np.asarray(jp.perm))
    assert tuple(st._hoist) == (False, False, False)  # H, Fu and Gu all move


def test_functions_derivatives_and_kkt_match_jax(auto64):
    sj, st = auto64
    params = jq.default_params(NS + "a_")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(np.asarray(v, float)) for k, v in params.items()}
    u0 = np.asarray(sj._pack_init(jq.hover_init(T, NS + "a_")))
    np.testing.assert_array_equal(st._pack_init(tq.hover_init(T, NS + "a_")).numpy(), u0)
    rng = np.random.default_rng(0)
    assemble = dense_kkt(st._fns, st.nU, st.nF, st.nG, st.opts)
    for u in (u0, u0 + 0.1 * rng.standard_normal(u0.shape)):
        ju, tu = jnp.asarray(u), torch.as_tensor(u)
        for name in ("f", "F", "G"):
            jf, tf = getattr(sj._fns, name), getattr(st._fns, name)
            np.testing.assert_allclose(tf(tu, tp).numpy(), np.asarray(jf(ju, jp)),
                                       rtol=VAL, atol=VAL)
            d = torch.func.grad if name == "f" else torch.func.jacfwd
            jd = jax.grad if name == "f" else jax.jacfwd
            np.testing.assert_allclose(d(lambda v: tf(v, tp))(tu).numpy(),
                                       np.asarray(jd(lambda v: jf(v, jp))(ju)),
                                       rtol=VAL, atol=VAL)
        lam = rng.uniform(0.5, 1.5, st.nF)
        nu = rng.standard_normal(st.nG)
        ones = np.ones(st.nF)
        WWj = sj._solve_raw._assemble_ww(ju, jnp.asarray(nu), jnp.asarray(lam), 0.1, 1e-3,
                                         1e-3, jp, jnp.asarray(ones), jnp.ones(()))["WW"]
        WWt = assemble(tu, torch.as_tensor(nu), torch.as_tensor(lam), 1e-3, 1e-3, tp,
                       torch.as_tensor(ones), torch.ones((), dtype=torch.float64))
        np.testing.assert_allclose(WWt.numpy(), np.asarray(WWj), rtol=VAL, atol=VAL)


def _same_answer(a, b, p_tol, u_tol, f_tol):
    assert a.status == b.status == 0, (a.status, b.status)
    for k, tol in (("p", p_tol), ("u", u_tol), ("positive2", u_tol)):
        key = [n for n in a.variables if n.endswith(k) and n[-len(k) - 1] == "_"][0]
        np.testing.assert_allclose(np.asarray(b.variables[key]), np.asarray(a.variables[key]),
                                   rtol=0, atol=tol, err_msg=k)
    J_a, J_b = float(np.asarray(a.outputs["J"])), float(np.asarray(b.outputs["J"]))
    assert abs(J_a - J_b) <= f_tol * abs(J_a), (J_a, J_b)


def test_dense_solve_matches_jax(jax_fleet_env):
    sj, st = build_pair("float64", NS + "d_", kkt_backend="dense")
    ns = NS + "d_"
    params, init = jq.default_params(ns), jq.hover_init(T, ns)
    a = sj.solve(params, init=init, mu0=0.1, max_iter=300)
    b = st.solve(params, init=init, mu0=0.1, max_iter=300)
    assert a.iters == b.iters == 17
    _same_answer(a, b, 1e-6, 1e-6, 1e-10)
