"""The port's expression layer (Expr, Packing, tsIntegral, lift) held
against the JAX package's on the flagship MPC problem: the objective,
the inequality/equality stacks, their derivatives and the output
expressions, in float64 on random environments."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from examples import mpc_dcmotor as jmpc  # noqa: E402
from tenscalc_tpu_torch import expr as texpr  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_dcmotor as tmpc  # noqa: E402
from tenscalc_tpu_torch.pack import Packing  # noqa: E402

torch.set_num_threads(1)

# the same float64 arithmetic up to summation order
RTOL = 1e-12
ATOL = 1e-12
T = 14


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


@pytest.fixture(scope="module")
def solvers():
    ns = "te_"
    sj = jmpc.build_solver(T=T, namespace=ns, dtype="float64", kkt_backend="dense")
    st = tmpc.build_solver(T=T, namespace=ns, dtype="float64", device="cpu")
    return ns, sj, st


def _random_env(solver, seed):
    rng = np.random.default_rng(seed)
    penv = {p.name: rng.standard_normal(p.shape) for p in solver.parameters}
    u = rng.standard_normal(solver.nU)
    return penv, u


@pytest.mark.parametrize("seed", [0, 1])
def test_problem_functions_and_derivatives_match_jax(solvers, seed):
    _, sj, st = solvers
    assert (st.nU, st.nF, st.nG) == (sj.nU, sj.nF, sj.nG) == (41, 78, 28)
    penv, u = _random_env(sj, seed)
    jp = {k: jnp.asarray(v) for k, v in penv.items()}
    tp = {k: torch.as_tensor(v) for k, v in penv.items()}
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    for name in ("f", "F", "G"):
        jf = getattr(sj._fns, name)
        tf = getattr(st._fns, name)
        np.testing.assert_allclose(
            tf(tu, tp).numpy(), np.asarray(jf(ju, jp)), rtol=RTOL, atol=ATOL
        )
        d = torch.func.grad if name == "f" else torch.func.jacfwd
        jd = jax.grad if name == "f" else jax.jacfwd
        np.testing.assert_allclose(
            d(lambda v: tf(v, tp))(tu).numpy(),
            np.asarray(jd(lambda v: jf(v, jp))(ju)),
            rtol=RTOL, atol=ATOL,
        )
    H_t = torch.func.hessian(lambda v: st._fns.f(v, tp))(tu)
    H_j = jax.hessian(lambda v: sj._fns.f(v, jp))(ju)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=RTOL, atol=ATOL)


def test_output_expressions_match_jax(solvers):
    """Includes the lifted warm-start clamp (torch.clamp vs jnp.clip) and
    the concat with Tzeros."""
    ns, sj, st = solvers
    penv, u = _random_env(sj, 7)
    jenv = {**{k: jnp.asarray(v) for k, v in penv.items()},
            **sj.packing.unpack(jnp.asarray(u))}
    tenv = {**{k: torch.as_tensor(v) for k, v in penv.items()},
            **st.packing.unpack(torch.as_tensor(u))}
    for name, je in sj.outputExpressions.items():
        te = st.outputExpressions[name]
        assert te.shape == je.shape, name
        np.testing.assert_allclose(
            te(tenv).numpy(), np.asarray(je(jenv)), rtol=RTOL, atol=ATOL,
            err_msg=name,
        )


def test_packing_round_trip_and_layout(solvers):
    """Packing is C order in both packages: the same init gives the same
    packed vector, and unpack inverts pack."""
    ns, sj, st = solvers
    rng = np.random.default_rng(3)
    init = {v.name: rng.standard_normal(v.shape) for v in st.variables}
    ut = st._pack_init(init)
    uj = sj._pack_init(init)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    back = st.packing.pack(st.packing.unpack(ut))
    assert torch.equal(back, ut)
    p = Packing(st.variables)
    assert p.slice_of(ns + "x") == sj.packing.slice_of(ns + "x")


def test_expr_shapes_and_constraints():
    x = texpr.variable("tx_x", (3, 4))
    y = texpr.parameter("tx_y", (4,))
    e = (x @ y) * 2.0 - 1
    assert e.shape == (3,)
    assert (x.T).shape == (4, 3)
    assert x.sum(axis=1).shape == (3,)
    c = x[:, 1:] >= 0.5
    assert c.kind == "ineq" and c.expr.shape == (3, 3)
    assert (e == 0).kind == "eq"
    env = {"tx_x": torch.ones(3, 4, dtype=torch.float64),
           "tx_y": torch.arange(4, dtype=torch.float64)}
    np.testing.assert_array_equal(e(env).numpy(), np.full(3, 11.0))
    with pytest.raises(ValueError):
        texpr.variable("tx_x", (2, 2))
    with pytest.raises(TypeError):
        bool(c)
