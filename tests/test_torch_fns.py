"""The port's operator library (``ops/fns.py``) held against the JAX
package's on tests/test_fns.py's 19 cases, in float64: the same inputs
through ``tenscalc_tpu.ops.fns`` and ``tenscalc_tpu_torch.ops.fns``,
and the numpy/scipy oracles of those cases.  The derivatives of the
componentwise functions and of ``logdet``, ``chol``, ``ldl`` and ``lu``
taken with the port's ``gradient`` against ``jax.grad`` within 1e-9."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import tenscalc_tpu as jtc
import tenscalc_tpu_torch as ttc
from tenscalc_tpu import expr as jexpr
from tenscalc_tpu.ops import fns as jfns
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.ops import fns as tfns

torch.set_num_threads(1)

TOL = 1e-12  # the same float64 operations up to library rounding
DER = 1e-9


@pytest.fixture(autouse=True)
def _fresh_variables():
    jexpr.clear_variables()
    texpr.clear_variables()
    yield
    jexpr.clear_variables()
    texpr.clear_variables()


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def same(name, *args, tol=TOL, **kw):
    """fns.<name> of the JAX package on numpy inputs and of the port on
    the same tensors: equal within ``tol``; returns the port's."""
    jv = np.asarray(getattr(jfns, name)(*args, **kw))
    tv = getattr(tfns, name)(*[T(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
    tv = tv.numpy()
    assert jv.shape == tv.shape, name
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol, err_msg=name)
    return tv


def test_norms(rng):
    v = rng.standard_normal((3, 4))
    np.testing.assert_allclose(same("norm1", v), np.abs(v).sum(), rtol=TOL)
    np.testing.assert_allclose(same("norm2", v), (v ** 2).sum(), rtol=TOL)
    np.testing.assert_allclose(same("norminf", v), np.abs(v).max(), rtol=TOL)
    S = rng.standard_normal((3, 3))
    same("norm2", v[:, 0], S[:, :])


def test_norms_on_expr(rng):
    v = rng.standard_normal(4)
    x = ttc.variable("x", (4,))
    e = ttc.norm2(x)
    jx = jtc.variable("x", (4,))
    np.testing.assert_allclose(e({"x": T(v)}).numpy(), jtc.norm2(jx)({"x": v}), rtol=TOL)
    for name in ("norm1", "norminf"):
        got = getattr(tfns, name)(x)({"x": T(v)}).numpy()
        np.testing.assert_allclose(got, getattr(jfns, name)(jx)({"x": v}), rtol=TOL)


def test_logdet_traceinv(rng):
    A = rng.standard_normal((5, 5))
    A = A @ A.T + 5 * np.eye(5)
    np.testing.assert_allclose(same("logdet", A, tol=1e-11), np.linalg.slogdet(A)[1],
                               rtol=1e-10)
    np.testing.assert_allclose(same("traceinv", A, tol=1e-11),
                               np.trace(np.linalg.inv(A)), rtol=1e-10)
    for name in ("det", "inv", "trace"):
        same(name, A, tol=1e-11)
    same("mldivide", A, rng.standard_normal(5), tol=1e-11)
    same("diag", rng.standard_normal(4))
    same("diag", A)


def test_componentwise(rng):
    v = rng.standard_normal(6)
    np.testing.assert_allclose(same("relu", v), np.maximum(v, 0))
    np.testing.assert_allclose(same("srelu", v), np.log1p(np.exp(v)), rtol=1e-10)
    np.testing.assert_allclose(same("sqr", v), v * v)
    np.testing.assert_allclose(same("cube", v), v ** 3, rtol=TOL)
    np.testing.assert_allclose(same("heaviside", np.array([-1.0, 0.0, 2.0])), [0.0, 0.5, 1.0])
    for name in ("sign", "exp", "sin", "cos", "tan", "atan", "normpdf", "absv"):
        same(name, v)
    for name in ("sqrt", "log", "bitrate"):
        same(name, np.abs(v) + 0.1)


def test_clp():
    x = np.array([1.0, 2.0, 3.0])
    dx = np.array([-1.0, 1.0, -6.0])
    np.testing.assert_allclose(same("clp", x, dx), 0.5)
    assert np.isinf(same("clp", x, np.abs(dx)))
    same("clp", np.array(2.0), np.array(-4.0))


def test_tprod_matmul(rng):
    A, B = rng.standard_normal((4, 3)), rng.standard_normal((3, 5))
    np.testing.assert_allclose(same("tprod", A, [1, -1], B, [-1, 2]), A @ B, rtol=TOL)


def test_tprod_inner(rng):
    a, b = rng.standard_normal(7), rng.standard_normal(7)
    np.testing.assert_allclose(same("tprod", a, [-1], b, [-1]), a @ b, rtol=TOL)


def test_tprod_transpose_outer(rng):
    A = rng.standard_normal((4, 3))
    np.testing.assert_allclose(same("tprod", A, [2, 1]), A.T, rtol=TOL)
    a, b = rng.standard_normal(3), rng.standard_normal(5)
    np.testing.assert_allclose(same("tprod", a, [1], b, [2]), np.outer(a, b), rtol=TOL)


def test_tprod_on_expr(rng):
    A = rng.standard_normal((3, 3))
    v = rng.standard_normal(3)
    x = ttc.variable("x", (3,))
    e = tfns.tprod(x, [-1], tfns.tprod(ttc.constant(A), [1, -1], x, [-1]), [-1])
    np.testing.assert_allclose(e({"x": T(v)}).numpy(), v @ A @ v, rtol=TOL)


def test_vec2tensor(rng):
    v = np.arange(6.0)
    np.testing.assert_array_equal(same("vec2tensor", v, (2, 3)), v.reshape((2, 3), order="F"))
    M = rng.standard_normal((3, 4))
    np.testing.assert_array_equal(same("vec2tensor", M, (2, 6)),
                                  M.reshape((2, 6), order="F"))
    x = ttc.variable("x", (6,))
    np.testing.assert_array_equal(tfns.vec2tensor(x, (3, 2))({"x": T(v)}).numpy(),
                                  v.reshape((3, 2), order="F"))


def test_pdist2t(rng):
    x, y = rng.standard_normal((3, 4)), rng.standard_normal((3, 5))
    want = ((x[:, :, None] - y[:, None, :]) ** 2).sum(0)
    np.testing.assert_allclose(same("pdist2t", x, y), want, rtol=TOL)


def test_interpolate_linear(rng):
    xs = np.linspace(0.0, 1.0, 11)
    ys = np.sin(xs)
    # inside, at the knots, and beyond both ends
    q = np.concatenate([rng.uniform(0.05, 0.95, 7), xs[[0, 3, 10]], [-0.5, 1.5]])
    np.testing.assert_allclose(same("interpolate", q, xs, ys), np.interp(q, xs, ys),
                               rtol=1e-15, atol=0)
    g = same("Ginterpolate", np.array(0.123), xs, ys)
    seg = int(0.123 * 10)
    np.testing.assert_allclose(g, (ys[seg + 1] - ys[seg]) / (xs[seg + 1] - xs[seg]),
                               rtol=1e-10)
    same("Ginterpolate", q, xs, ys)
    same("Hinterpolate", q, xs, ys)


def test_interpolate_gaussian_oracle(rng):
    nq, K, m = 2, 9, 3
    Xi, Yi = rng.standard_normal((nq, K)), rng.standard_normal((m, K))
    x, S = rng.standard_normal(nq), 0.7
    w = np.exp(-((Xi - x[:, None]) ** 2).sum(0) / (2 * S ** 2))
    np.testing.assert_allclose(same("interpolate", x, Xi, Yi, S, method="ugaussian"),
                               Yi @ w, rtol=1e-12)
    np.testing.assert_allclose(same("interpolate", x, Xi, Yi, S, method="ngaussian"),
                               Yi @ w / w.sum(), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown interpolation"):
        tfns.interpolate(T(x), T(Xi), T(Yi), S, method="cubic")


def test_ginterpolate_hinterpolate(rng):
    nq, K, m = 2, 6, 2
    Xi, Yi = rng.standard_normal((nq, K)), rng.standard_normal((m, K))
    x, S = 0.3 * rng.standard_normal(nq), 1.1
    for method in ("ugaussian", "ngaussian"):
        G = same("Ginterpolate", x, Xi, Yi, S, method=method, tol=1e-11)
        H = same("Hinterpolate", x, Xi, Yi, S, method=method, tol=1e-11)
        assert G.shape == (m, nq) and H.shape == (m, nq, nq)
        eps = 1e-4
        f = lambda q: tfns.interpolate(T(q), T(Xi), T(Yi), S, method=method).numpy()
        for j in range(nq):
            e = np.zeros(nq)
            e[j] = eps
            np.testing.assert_allclose(G[:, j], (f(x + e) - f(x - e)) / (2 * eps),
                                       rtol=2e-3, atol=1e-6)


def test_interpolate_on_expr(rng):
    K = 8
    Xi = np.linspace(-1, 1, K).reshape(1, K)
    Yi = (Xi ** 2).reshape(1, K)
    x = ttc.variable("itp_x", (1,))
    val = tfns.interpolate(x, Xi, Yi, 0.5, method="ngaussian")({"itp_x": T([0.2])}).numpy()
    w = np.exp(-((Xi - 0.2) ** 2).sum(0) / (2 * 0.25))
    np.testing.assert_allclose(val, Yi @ w / w.sum(), rtol=1e-12)
    q = ttc.variable("itp_q", (3,))
    xs, ys = np.linspace(0, 1, 5), np.linspace(0, 1, 5) ** 2
    e = tfns.interpolate(q, xs, ys)
    g = ttc.gradient(ttc.norm2(e), q)({"itp_q": T([0.1, 0.55, 0.9])}).numpy()
    jq = jtc.variable("itp_q", (3,))
    jg = jax.grad(lambda v: jtc.norm2(jfns.interpolate(jq, xs, ys))({"itp_q": v}))(
        jnp.asarray([0.1, 0.55, 0.9]))
    np.testing.assert_allclose(g, np.asarray(jg), rtol=DER, atol=DER)


def test_componentwise_extras(rng):
    x = rng.standard_normal((3, 4)) * 2
    x[0, :2] = [0.5, 2.5]  # halves round to even
    np.testing.assert_array_equal(same("round", x), np.round(x))
    np.testing.assert_array_equal(same("ceil", x), np.ceil(x))
    np.testing.assert_array_equal(same("floor", x), np.floor(x))
    xp = np.abs(x) + 0.5
    np.testing.assert_allclose(same("lngamma", xp, tol=1e-12), scipy.special.gammaln(xp),
                               rtol=1e-10)
    np.testing.assert_allclose(same("sheaviside", x), 1 / (1 + np.exp(-x)), rtol=1e-12)
    np.testing.assert_allclose(same("dsheaviside", x), 1 / (2 + np.exp(x) + np.exp(-x)),
                               rtol=1e-10, atol=1e-12)


def test_compose(rng):
    x = rng.standard_normal((2, 3))
    y = tfns.compose(T(x), lambda s: torch.sin(s) + s).numpy()
    np.testing.assert_allclose(y, np.asarray(jfns.compose(x, lambda s: jnp.sin(s) + s)),
                               rtol=TOL)
    y2 = tfns.compose(T(x), lambda s: torch.stack([s, s * s]))
    assert tuple(y2.shape) == (2, 3, 2)
    np.testing.assert_allclose(y2[..., 1].numpy(), x * x, rtol=TOL)
    v = ttc.variable("cmp_x", (3,))
    e = tfns.norm2(tfns.compose(v, torch.tanh))
    xd = np.array([0.1, -0.2, 0.4])
    g = torch.func.grad(lambda val: e({"cmp_x": val}))(T(xd)).numpy()
    np.testing.assert_allclose(g, 2 * np.tanh(xd) * (1 - np.tanh(xd) ** 2), rtol=DER)


def test_minmax_all_any_norm_repmat_permute(rng):
    x, y = rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    np.testing.assert_array_equal(same("min2", x, y), np.minimum(x, y))
    np.testing.assert_array_equal(same("max2", x, y), np.maximum(x, y))
    b = (x > 0).astype(float)
    np.testing.assert_array_equal(same("allv", b, axis=0), b.all(axis=0).astype(float))
    np.testing.assert_array_equal(same("anyv", b, axis=1), b.any(axis=1).astype(float))
    np.testing.assert_array_equal(same("allv", b), float(b.all()))
    np.testing.assert_allclose(same("norm", x, 1), np.abs(x).sum(), rtol=TOL)
    np.testing.assert_allclose(same("norm", x, 2), np.linalg.norm(x.ravel()), rtol=TOL)
    np.testing.assert_allclose(same("norm", x, np.inf), np.abs(x).max(), rtol=TOL)
    with pytest.raises(ValueError, match="unsupported order"):
        tfns.norm(T(x), 3)
    np.testing.assert_array_equal(same("repmat", x, 2, 3), np.tile(x, (2, 3)))
    z = rng.standard_normal((2, 3, 4))
    np.testing.assert_array_equal(same("permute", z, [3, 1, 2]), np.transpose(z, (2, 0, 1)))
    np.testing.assert_array_equal(same("permute", z, [2, 0, 1]), np.transpose(z, (2, 0, 1)))
    w = ttc.variable("mm_w", (3, 4))
    np.testing.assert_array_equal(tfns.min2(w, 0.0)({"mm_w": T(x)}).numpy(), np.minimum(x, 0))
    np.testing.assert_array_equal(tfns.max2(1.0, w)({"mm_w": T(x)}).numpy(), np.maximum(x, 1))


def test_factorization_expressions(rng):
    n = 7
    M = rng.standard_normal((n, n))
    A_spd = M @ M.T + n * np.eye(n)
    Asym = 0.5 * (M + M.T) + n * np.eye(n)
    Agen = M + n * np.eye(n)
    Av, bv = ttc.parameter("fac_A", (n, n)), ttc.parameter("fac_b", (n,))
    jA, jb = jtc.parameter("fac_A", (n, n)), jtc.parameter("fac_b", (n,))
    b = rng.standard_normal(n)

    def check(build, A, tol=1e-11):
        tv = build(ttc, Av, bv)({"fac_A": T(A), "fac_b": T(b)}).numpy()
        jv = np.asarray(build(jtc, jA, jb)({"fac_A": A, "fac_b": b}))
        np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol)
        return tv

    L = check(lambda m, A, _: m.chol(A), A_spd)
    np.testing.assert_allclose(L @ L.T, A_spd, atol=1e-10)
    x = check(lambda m, A, bb: m.pptrs(m.chol(A), bb), A_spd)
    np.testing.assert_allclose(x, np.linalg.solve(A_spd, b), atol=1e-10)
    Lu_ = check(lambda m, A, _: m.ldl_l(m.ldl(A)), Asym)
    d_ = check(lambda m, A, _: m.ldl_d(m.ldl(A)), Asym)
    np.testing.assert_allclose(Lu_ @ np.diag(d_) @ Lu_.T, Asym, atol=1e-9)
    ld = check(lambda m, A, _: m.ldl_d(m.ldl(A)), A_spd)
    np.testing.assert_allclose(np.sum(np.log(ld)), np.linalg.slogdet(A_spd)[1], rtol=1e-10)
    Lg = check(lambda m, A, _: m.lu_l(m.lu(A)), Agen)
    Ug = check(lambda m, A, _: m.lu_u(m.lu(A)), Agen)
    np.testing.assert_allclose(Lg @ Ug, Agen, atol=1e-9)
    dg = check(lambda m, A, _: m.lu_d(m.lu(A)), Agen)
    np.testing.assert_allclose(np.prod(dg), np.linalg.det(Agen), rtol=1e-8)
    # sum(log(ldl_d(A + s I))) has derivative trace(inv(A + s I)) in s
    s = ttc.variable("fac_s", ())
    f = tfns.log(tfns.ldl_d(tfns.ldl(ttc.constant(A_spd) + s * ttc.Teye(n)))).sum()
    g = ttc.gradient(f, s)({"fac_s": T(0.5)}).numpy()
    np.testing.assert_allclose(g, np.trace(np.linalg.inv(A_spd + 0.5 * np.eye(n))), rtol=1e-8)


# ---------------------------------------------------------------------------
# derivatives through the port's gradient against jax.grad
# ---------------------------------------------------------------------------

# (name, input map onto the function's domain)
COMPONENTWISE = [
    ("relu", None), ("srelu", None), ("heaviside", None), ("sqr", None), ("cube", None),
    ("sign", None), ("sqrt", "pos"), ("exp", None), ("log", "pos"), ("sin", None),
    ("cos", None), ("tan", "small"), ("atan", None), ("normpdf", None), ("absv", None),
    ("round", None), ("ceil", None), ("floor", None), ("lngamma", "pos"),
    ("sheaviside", None), ("dsheaviside", None), ("bitrate", "pos"),
]


@pytest.mark.parametrize("name,domain", COMPONENTWISE)
def test_componentwise_derivatives(name, domain):
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    v = rng.standard_normal(5) * 1.5 + 0.1
    v = {None: v, "pos": np.abs(v) + 0.2, "small": 0.5 * np.tanh(v)}[domain]
    wt = rng.standard_normal(5)
    x = ttc.variable("d_x", (5,))
    f = (getattr(tfns, name)(x) * ttc.constant(wt)).sum()
    g = ttc.gradient(f, x)({"d_x": T(v)}).numpy()
    h = ttc.hessian(f, x)({"d_x": T(v)}).numpy()
    jfun = lambda u: jnp.sum(getattr(jfns, name)(u) * wt)
    jg = np.asarray(jax.grad(jfun)(jnp.asarray(v)))
    jh = np.asarray(jax.hessian(jfun)(jnp.asarray(v)))
    np.testing.assert_allclose(g, jg, rtol=DER, atol=DER)
    np.testing.assert_allclose(h, jh, rtol=DER, atol=DER)


@pytest.mark.parametrize("name", ["logdet", "chol", "ldl", "lu"])
def test_factorization_derivatives(name):
    n = 5
    rng = np.random.default_rng(len(name))
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    W = rng.standard_normal((n, n))
    X = ttc.variable("d_A", (n, n))
    y = getattr(tfns, name)(X)
    f = y if name == "logdet" else (y * ttc.constant(W)).sum()
    g = ttc.gradient(f, X)({"d_A": T(A)}).numpy()
    if name == "logdet":
        jfun = lambda U: jfns.logdet(U)
    else:
        jfun = lambda U: jnp.sum(getattr(jfns, name)(U) * W)
    jg = np.asarray(jax.grad(jfun)(jnp.asarray(A)))
    assert g.shape == (n, n)
    np.testing.assert_allclose(g, jg, rtol=DER, atol=DER)
    if name == "logdet":
        np.testing.assert_allclose(g, np.linalg.inv(A), rtol=1e-9)


def test_round_stays_out_of_all():
    assert "round" not in ttc.__all__ and ttc.round is tfns.round
    assert {"allv", "anyv", "interpolate", "pptrs", "tsODE"} <= set(ttc.__all__)
    assert math.isclose(float(tfns.normpdf(torch.zeros((), dtype=torch.float64))),
                        1 / math.sqrt(2 * math.pi))
