"""The port's hoist certificate (``ipm/hoist.py``) on the operators of
the expression layer, and tests/test_hoist.py's cases in their PyTorch
form.  The certificate must never call a value that depends on the
iterate constant: a false "constant" freezes a Jacobian outside the IPM
loop.  JAX's ``lax.scan`` cases become Python loops traced by
``make_fx``; its ``while_loop`` case becomes a loop whose condition
reads a tensor's value, which ``make_fx`` cannot trace and which must
come out not certified."""

import pytest
import torch

import tenscalc_tpu_torch as ttc
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.ipm.hoist import output_independent_of, param_value_deps
from tenscalc_tpu_torch.ops import fns, tseries

torch.set_num_threads(1)

jacfwd, jacrev, hessian = torch.func.jacfwd, torch.func.jacrev, torch.func.hessian
Z3 = torch.zeros(3, dtype=torch.float64)
ONES3 = torch.ones(3, dtype=torch.float64)


@pytest.fixture(autouse=True)
def _fresh_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


def jac_of(f):
    return lambda z: jacfwd(f)(z)


# ---------------------------------------------------------------------------
# tests/test_hoist.py's cases
# ---------------------------------------------------------------------------

def test_scan_carry_taint_is_not_lost():
    """A loop emitting the pre-update carry of c += z_i**2: the summed
    output's Jacobian is 2 z_j, not constant."""
    def f(z):
        c, ys = torch.zeros((), dtype=z.dtype), []
        for i in range(z.shape[0]):
            ys.append(c)
            c = c + z[i] ** 2
        return torch.stack(ys).sum()

    z = torch.zeros(4, dtype=torch.float64)
    assert not output_independent_of(jac_of(f), 1, z)
    assert not torch.allclose(jacfwd(f)(torch.ones(4, dtype=torch.float64)),
                              jacfwd(f)(2.0 * torch.ones(4, dtype=torch.float64)))


def test_scan_any_tainted_input_taints_outputs():
    def f(z):
        c, ys = torch.zeros((), dtype=z.dtype), []
        for i in range(z.shape[0]):
            c = c + z[i]
            ys.append(c)
        return c + torch.stack(ys).sum()

    assert not output_independent_of(f, 1, Z3)


def test_scan_untainted_is_still_certified():
    w = torch.arange(3.0, dtype=torch.float64)

    def f(z):
        c = torch.zeros((), dtype=z.dtype)
        for i in range(3):
            c = c + w[i]
        return c  # z unused

    assert output_independent_of(f, 1, torch.zeros((), dtype=torch.float64))


def test_while_loop_stays_opaque():
    """A loop whose condition reads the iterate's value: make_fx refuses
    to trace it, and the function certifies nothing."""
    def f(z):
        v = torch.ones((), dtype=z.dtype)
        while v < 3:
            v = v + z[0]
        return v

    assert not output_independent_of(f, 1, torch.ones(2, dtype=torch.float64))
    assert not output_independent_of(jac_of(f), 1, torch.ones(2, dtype=torch.float64))
    assert param_value_deps(lambda p, z: f(z) * p["a"], {"a": torch.ones(()),
                                                         "b": torch.ones(())},
                            torch.ones(2)) == {"a", "b"}


def test_helper_keeps_precision():
    """A linear helper concatenating the iterate with a constant: its
    Jacobian is certified (the tangent of the constant stays zero)."""
    c = torch.ones(2, dtype=torch.float64)

    def helper(a, b):
        return torch.cat([a, b])

    assert output_independent_of(jac_of(lambda v: helper(v, c)), 1,
                                 torch.zeros(2, dtype=torch.float64))


def test_quadratic_hessian_certified():
    assert output_independent_of(lambda z: hessian(lambda v: 0.5 * v @ v + v.sum())(z), 1, Z3)


def test_cubic_hessian_not_certified():
    assert not output_independent_of(lambda z: hessian(lambda v: (v ** 3).sum())(z), 1, Z3)


def test_lifted_rollout_jacobian_not_hoisted():
    def rollout(x0):
        x = x0
        for _ in range(5):
            x = x + 0.1 * x ** 2
        return x

    assert not output_independent_of(jac_of(rollout), 1, torch.ones(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the operators of the expression layer
# ---------------------------------------------------------------------------

def _expr_jacobian(build):
    """d build(x) / dx of a port expression, as a function of the
    iterate (the way the solver's derivatives are traced)."""
    x = ttc.variable("h_x", (3,))
    e = build(x)
    return lambda z: jacfwd(lambda v: e({"h_x": v}))(z)


# operators whose Jacobian depends on the iterate: each must taint
TAINTING = {
    "sqrt": lambda x: fns.sqrt(x * x + 1.0),
    "exp": fns.exp, "log": lambda x: fns.log(x * x + 1.0), "sin": fns.sin,
    "tan": fns.tan, "atan": fns.atan, "normpdf": fns.normpdf, "srelu": fns.srelu,
    "lngamma": lambda x: fns.lngamma(x * x + 1.0), "sheaviside": fns.sheaviside,
    "cube": fns.cube, "norm": lambda x: fns.norm(x + 2.0) * x,
    "logdet": lambda x: fns.logdet(ttc.Teye(3) * 3.0 + fns.diag(x)) * x,
    "chol": lambda x: fns.chol(ttc.Teye(3) * 3.0 + fns.diag(x)) @ x,
    "ldl": lambda x: fns.ldl_d(fns.ldl(ttc.Teye(3) * 3.0 + fns.diag(x))) * x,
    "lu": lambda x: fns.lu_u(fns.lu(ttc.Teye(3) * 3.0 + fns.diag(x))) @ x,
    "interpolate": lambda x: fns.interpolate(x, [-1.0, 0.0, 0.5, 2.0], [1.0, 0.0, 3.0, 2.0]),
    "gaussian": lambda x: fns.interpolate(x, ttc.constant([[0.0, 1.0, 2.0]] * 3),
                                          ttc.constant([[1.0, 2.0, 0.5]]), 0.7,
                                          method="ngaussian"),
    "tsDerivative": lambda x: tseries.tsDerivative(x[None, :] ** 2, 0.1)[0],
    "tsRotation": lambda x: tseries.tsRotation(
        fns.sin(ttc.vertcat(x, x[:1]))[:, None], x[:, None])[:, 0],
    "at": lambda x: x.at[0].set(x[1] * x[2]),
    "substitute": lambda x: texpr.substitute(x * x, x, x + 1.0),
}
# piecewise-constant operators: their derivative is zero almost
# everywhere, but their value depends on the iterate, so a product with
# the iterate taints (the analysis over-approximates, never under)
STEPS = {
    "floor": fns.floor, "ceil": fns.ceil, "round": fns.round, "sign": fns.sign,
    "heaviside": fns.heaviside, "relu": lambda x: fns.relu(x) / (x + 3.0),
    "absv": fns.absv, "min2": lambda x: fns.min2(x, 0.5), "clp": lambda x: fns.clp(x + 2.0, x),
}


@pytest.mark.parametrize("name", sorted(TAINTING))
def test_nonlinear_operators_taint(name):
    assert not output_independent_of(_expr_jacobian(TAINTING[name]), 1, ONES3 * 0.3)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_operators_taint_their_products(name):
    f = STEPS[name]
    assert not output_independent_of(_expr_jacobian(lambda x: f(x) * x), 1, ONES3 * 0.3)


# linear maps built from the new operators: their Jacobians are constant
LINEAR = {
    "at": lambda x: x.at[1].set(2.0 * x[0]).at[2].add(x[1]),
    "vertcat": lambda x: ttc.vertcat(x, x * 2.0, ttc.Tones(2)),
    "stack": lambda x: ttc.stack([x, -x]).sum(0),
    "Teye": lambda x: (ttc.Teye(3) * 2.0) @ x,
    "substitute": lambda x: texpr.substitute(x * 3.0, x, x + 1.0),
    "chol of a constant": lambda x: fns.chol(ttc.constant([[4.0, 1, 0], [1, 3, 0], [0, 0, 2]])) @ x,
    "tsDerivative": lambda x: tseries.tsDerivative(ttc.vertcat(x, x)[None, :], 0.2)[0],
    "tsIntegrate": lambda x: tseries.tsIntegrate(x[None, :], 1.0, 0.1, "trapezoidal")[0],
    "tsCross": lambda x: tseries.tsCross(x[:, None], ttc.constant([[1.0], [2.0], [3.0]]))[:, 0],
    "interpolate table": lambda x: fns.interpolate(ttc.constant([0.2, 0.7]), [0.0, 1.0],
                                                   [1.0, 3.0]).sum() * x,
}


@pytest.mark.parametrize("name", sorted(LINEAR))
def test_linear_maps_of_the_new_operators_certified(name):
    assert output_independent_of(_expr_jacobian(LINEAR[name]), 1, ONES3 * 0.3)


def test_a_hessian_through_searchsorted_and_cholesky_traces():
    """searchsorted and linalg_cholesky appear in the traces of the
    Hessians of problems that use them, and the trace holds together."""
    def quad_of(build):
        x = ttc.variable("h_q", (3,))
        e = ttc.norm2(build(x))
        return lambda z: hessian(lambda v: e({"h_q": v}))(z)

    interp = quad_of(lambda x: fns.interpolate(x, [0.0, 1.0, 2.0], [0.0, 2.0, 0.0]))
    chol = quad_of(lambda x: fns.chol(ttc.Teye(3) * 4.0 + fns.diag(x)) @ x)
    for f in (interp, chol):
        assert not output_independent_of(f, 1, ONES3 * 0.3)
    const_chol = quad_of(lambda x: fns.chol(ttc.Teye(3) * 4.0) @ x)
    assert output_independent_of(const_chol, 1, ONES3 * 0.3)
