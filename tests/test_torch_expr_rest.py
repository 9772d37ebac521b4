"""The rest of the port's expression layer (``Expr.at``, ``Teye``,
``vertcat``/``horzcat``/``stack``, ``substitute``, ``gradient``,
``jacobian``, ``hessian``) held against the JAX package on
tests/test_expr.py's and tests/test_gradient.py's cases, in float64 on
the same random environments: values within 1e-12, derivatives within
1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tenscalc_tpu as jtc
import tenscalc_tpu_torch as ttc
from tenscalc_tpu import expr as jexpr
from tenscalc_tpu_torch import expr as texpr

torch.set_num_threads(1)

VAL = 1e-12  # values: the same float64 operations
DER = 1e-10  # derivatives: JAX's and torch.func's AD orders


@pytest.fixture(autouse=True)
def _fresh_variables():
    jexpr.clear_variables()
    texpr.clear_variables()
    yield
    jexpr.clear_variables()
    texpr.clear_variables()


def both(build):
    """``build`` applied to the JAX package and to the port."""
    return build(jtc), build(ttc)


def values(pair, env):
    je, te = pair
    jv = np.asarray(je({k: jnp.asarray(v) for k, v in env.items()}))
    tv = te({k: torch.as_tensor(v) for k, v in env.items()}).numpy()
    return jv, tv


def assert_same(pair, env, tol=VAL):
    jv, tv = values(pair, env)
    assert jv.shape == tv.shape == tuple(pair[1].shape)
    assert pair[0].shape == pair[1].shape
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol)
    return tv


def test_variable_arithmetic_matmul_indexing(rng):
    def build(m):
        x, y = m.variable("x", (4,)), m.variable("y", (4,))
        A, z = m.variable("A", (5, 4)), m.variable("z", (2, 6))
        return [2.0 * x + y / 3.0 - x * y + x ** 2, A @ x,
                z[:, 1:4].reshape(6).sum(), x]

    env = {"x": rng.standard_normal(4), "y": rng.standard_normal(4),
           "A": rng.standard_normal((5, 4)), "z": rng.standard_normal((2, 6))}
    for pair in zip(*both(build)):
        assert_same(pair, env)
    assert both(build)[1][0].deps == {"x", "y"}


def test_constraints_parse(rng):
    def build(m):
        x = m.variable("x", (3,))
        return [x >= 0, x <= 0.05, x == 1.0]

    env = {"x": rng.standard_normal(3)}
    for jc, tc in zip(*both(build)):
        assert isinstance(tc, texpr.Constraint) and tc.kind == jc.kind
        assert_same((jc.expr, tc.expr), env)


def test_substitute(rng):
    def build(m):
        x, d = m.variable("x", (3,)), m.variable("d", (3,))
        return m.expr.substitute((x * x).sum(), x, x + 2.0 * d)

    pair = both(build)
    assert pair[1].deps == {"x", "d"}
    v = assert_same(pair, {"x": rng.standard_normal(3), "d": rng.standard_normal(3)})
    assert v.shape == ()


def test_substitute_several_variables(rng):
    def build(m):
        x, y, a = m.variable("x", (3,)), m.variable("y", (2,)), m.variable("a", (3,))
        e = m.norm2(x) + (y * y).sum() * x[0]
        return m.expr.substitute(e, [x, y], [a * 3.0, y + 1.0])

    pair = both(build)
    assert pair[1].deps == {"a", "y"}
    assert_same(pair, {"a": rng.standard_normal(3), "y": rng.standard_normal(2)})
    with pytest.raises(ValueError, match="mismatched"):
        x = ttc.variable("x", (3,))
        ttc.substitute(x, [x], [])


def test_shape_redeclare_mismatch():
    ttc.variable("z", (3,))
    with pytest.raises(ValueError):
        ttc.variable("z", (4,))
    ttc.variable("z", (3,))  # the same shape is fine


def test_concat_vertcat_horzcat_stack(rng):
    def build(m):
        x, y = m.variable("x", (3,)), m.variable("y", (2,))
        P, Q = m.variable("P", (2, 3)), m.variable("Q", (2, 2))
        return [m.expr.concat([x, y]), m.expr.vertcat(x, y, x), m.expr.horzcat(P, Q),
                m.expr.vertcat(P, m.Teye(3)), m.expr.stack([x, x * 2.0]),
                m.expr.stack([P, P + 1.0], axis=2)]

    env = {"x": rng.standard_normal(3), "y": rng.standard_normal(2),
           "P": rng.standard_normal((2, 3)), "Q": rng.standard_normal((2, 2))}
    shapes = [(5,), (8,), (2, 5), (5, 3), (2, 3), (2, 3, 2)]
    for pair, shape in zip(zip(*both(build)), shapes):
        assert pair[1].shape == shape
        assert_same(pair, env)


def test_zeros_ones_eye():
    for e, want in [(ttc.Tzeros((2, 3)), np.zeros((2, 3))), (ttc.Tones(4), np.ones(4)),
                    (ttc.Teye(3), np.eye(3)), (ttc.Teye(2, 4), np.eye(2, 4))]:
        v = e({})
        assert v.dtype == torch.float64 and tuple(e.shape) == want.shape
        np.testing.assert_array_equal(v.numpy(), want)
    x = ttc.variable("x", (2,))
    e = ttc.Teye(2) @ x
    assert e({"x": torch.ones(2, dtype=torch.float32)}).dtype == torch.float32
    np.testing.assert_array_equal(jtc.Teye(2, 4)({}), ttc.Teye(2, 4)({}).numpy())


def test_at_indexed_assignment(rng):
    """Expr.at[...] set/add/multiply, and the gradient through both the
    base and the inserted value."""
    def build(m):
        x = m.variable("at_x", (4,))
        return [x.at[1].set(0.0), x.at[:2].add(x[2:] * 3.0), x.at[3].multiply(x[0]),
                x.at[1:3].set(m.Teye(2)[0]), (x.at[0].set(x[3] * 2.0) ** 2).sum()]

    v = rng.standard_normal(4)
    jes, tes = both(build)
    for pair in zip(jes, tes):
        assert_same(pair, {"at_x": v})
    gj = jax.grad(lambda val: jes[-1]({"at_x": val}))(jnp.asarray(v))
    gt = torch.func.grad(lambda val: tes[-1]({"at_x": val}))(torch.as_tensor(v))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=DER, atol=DER)
    w = v.copy()
    w[0] = 2 * v[3]
    want = 2 * w
    want[0] = 0.0
    want[3] += 4 * w[0]
    np.testing.assert_allclose(gt.numpy(), want, rtol=DER)


def test_grad_through_expr(rng):
    """torch.func.grad drives a port Expr as jax.grad drives the JAX one."""
    def build(m):
        A, x, b = m.variable("A", (5, 3)), m.variable("x", (3,)), m.variable("b", (5,))
        return m.norm2(A @ x - b)

    je, te = both(build)
    Av, bv, xv = rng.standard_normal((5, 3)), rng.standard_normal(5), rng.standard_normal(3)
    gj = jax.grad(lambda v: je({"A": jnp.asarray(Av), "b": jnp.asarray(bv), "x": v}))(
        jnp.asarray(xv))
    gt = torch.func.grad(lambda v: te({"A": torch.as_tensor(Av), "b": torch.as_tensor(bv),
                                       "x": v}))(torch.as_tensor(xv))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=DER, atol=DER)
    np.testing.assert_allclose(gt.numpy(), 2 * Av.T @ (Av @ xv - bv), rtol=DER)


# ---------------------------------------------------------------------------
# tests/test_gradient.py's cases
# ---------------------------------------------------------------------------

def test_gradient_scalar_wrt_vector():
    def build(m):
        x, A = m.variable("tg_x", (5,)), m.variable("tg_A", (5, 5))
        return m.gradient(m.norm2(A @ x), x)

    pair = both(build)
    assert pair[1].shape == (5,)
    rng = np.random.default_rng(0)
    env = {"tg_x": rng.random(5), "tg_A": rng.random((5, 5))}
    got = assert_same(pair, env, DER)
    np.testing.assert_allclose(got, 2.0 * env["tg_A"].T @ env["tg_A"] @ env["tg_x"],
                               rtol=DER)


def test_gradient_tensor_shapes():
    def build(m):
        W, v = m.variable("tg_W", (3, 4)), m.variable("tg_v", (4,))
        return [m.gradient(W @ v, W), m.gradient(W @ v, v), m.gradient(W * 2.0, W)]

    rng = np.random.default_rng(1)
    env = {"tg_W": rng.random((3, 4)), "tg_v": rng.random(4)}
    shapes = [(3, 3, 4), (3, 4), (3, 4, 3, 4)]
    outs = [assert_same(pair, env, DER) for pair in zip(*both(build))]
    assert [o.shape for o in outs] == shapes
    np.testing.assert_allclose(outs[0], np.einsum("ij,k->ijk", np.eye(3), env["tg_v"]),
                               rtol=DER)


def test_jacobian_alias():
    def build(m):
        x = m.variable("tg_jx", (4,))
        return m.jacobian(m.to_expr(2.0) * x, x)

    got = assert_same(both(build), {"tg_jx": np.arange(4.0)}, DER)
    np.testing.assert_allclose(got, 2.0 * np.eye(4))


def test_hessian_matches_the_composition():
    def build(m):
        x, Q = m.variable("tg_hx", (3,)), m.variable("tg_hQ", (3, 3))
        f = x @ (Q @ x)
        return [m.hessian(f, x), m.gradient(m.gradient(f, x), x)]

    rng = np.random.default_rng(2)
    env = {"tg_hx": rng.random(3), "tg_hQ": rng.random((3, 3))}
    h, hh = (assert_same(pair, env, DER) for pair in zip(*both(build)))
    np.testing.assert_allclose(h, env["tg_hQ"] + env["tg_hQ"].T, rtol=DER)
    np.testing.assert_array_equal(h, hh)


def test_hessian_mixed_variables():
    def build(m):
        x, y, C = m.variable("tg_mx", (3,)), m.variable("tg_my", (2,)), m.variable("tg_mC", (3, 2))
        return m.hessian(x @ (C @ y), x, y)

    rng = np.random.default_rng(3)
    env = {"tg_mx": rng.random(3), "tg_my": rng.random(2), "tg_mC": rng.random((3, 2))}
    got = assert_same(both(build), env, DER)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, env["tg_mC"], rtol=DER)


def test_nonlinear_hessian_forward_and_reverse(rng):
    """A vector f larger than x takes forward mode, a scalar reverse
    mode; both against JAX's."""
    def build(m):
        x = m.variable("tg_nx", (3,))
        f = m.expr.concat([x * x, x[0] * x, m.tsIntegral(x[None, :] ** 3, 0.1)])
        return [m.gradient(f, x), m.hessian(m.norm2(f), x), m.hessian(f, x)]

    env = {"tg_nx": rng.standard_normal(3)}
    shapes = [(7, 3), (3, 3), (7, 3, 3)]
    for pair, shape in zip(zip(*both(build)), shapes):
        assert assert_same(pair, env, DER).shape == shape


def test_gradient_of_an_independent_variable_is_zero():
    def build(m):
        x, z = m.variable("tg_zx", (3,)), m.variable("tg_zz", (2,))
        return m.gradient(m.norm2(x), z)

    got = assert_same(both(build), {"tg_zx": np.ones(3), "tg_zz": np.ones(2)})
    np.testing.assert_array_equal(got, np.zeros(2))


def test_gradient_requires_a_variable():
    x = ttc.variable("tg_rx", (3,))
    with pytest.raises(TypeError, match="Variable"):
        ttc.gradient(ttc.norm2(x), x + 1.0)


def test_cost_gradient_and_hessian_of_a_least_squares():
    """The tutorialLQ pattern (cost, gradient, Hessian of one
    expression), evaluated directly."""
    def build(m):
        A, u = m.variable("tg_cA", (10, 3)), m.variable("tg_cu", (3,))
        J = m.norm2(A @ u)
        return [J, m.gradient(J, u), m.hessian(J, u)]

    rng = np.random.default_rng(4)
    Av, uv = rng.random((10, 3)), rng.random(3)
    env = {"tg_cA": Av, "tg_cu": uv}
    J, g, h = (assert_same(pair, env, DER) for pair in zip(*both(build)))
    np.testing.assert_allclose(g, 2 * Av.T @ Av @ uv, rtol=DER)
    np.testing.assert_allclose(h, 2 * Av.T @ Av, rtol=DER)


def test_new_operators_keep_float32_and_weak_numbers():
    """A float32 environment stays float32 through .at, Teye, the cats,
    substitute and the derivatives; a Python number beside a float32
    tensor stays weak."""
    x = ttc.variable("w_x", (3,))
    es = [x.at[0].set(1.5), x.at[1:].add(2.0), ttc.vertcat(x, ttc.Teye(3)[0] * 0.5),
          ttc.substitute(x * 0.1, x, x + 1.0), ttc.hessian(ttc.norm2(x) * 0.5, x),
          ttc.gradient(x * 3.0, x), ttc.stack([x, x]) * 2.0]
    env = {"w_x": torch.arange(3, dtype=torch.float32)}
    for e in es:
        v = e(env)
        assert v.dtype == torch.float32 and tuple(v.shape) == e.shape
