"""The Lasso and NLSS apps (``apps/lasso.py``, ``apps/nlss.py``) on the
port against the JAX package in float64 with ``TENSCALC_AUTO_FLEET=1``:
tests/test_apps.py:109 (the fit on both sides: status equal, the
support recovered, the objective no worse than scipy's; the weights
that the l1 term drives to zero sit where both epigraph constraints
are active, so the KKT there is ill-conditioned and the two sides'
last bits move the final iterate: iterations within one (9 and 10
measured), W and c to 1e-6, the zero weights apart by 1.3e-7) and :145, :161, :169 (simulations and the symbolic
dynamics constraints, equal to the JAX package's to 1e-12)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt import pallas_ldl as tpl  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def test_lasso_matches_jax(monkeypatch):
    calls = {"K8": 0, "K7": 0}
    for key, name in (("K8", "pallas_ldl_factor_solve_plain"), ("K7", "pallas_ldl_solve_plain")):
        def spy(*a, _f=getattr(tpl, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tpl, name, spy)
    rng = np.random.default_rng(0)
    n, m = 8, 60
    w_true = np.zeros(n)
    w_true[[1, 4]] = [2.0, -1.5]
    X = rng.standard_normal((m, n))
    y = X @ w_true + 1.0 + 0.01 * rng.standard_normal(m)

    lt = ttc.Lasso(n_features=n, n_points=m, device="cpu")
    lj = jtc.Lasso(n_features=n, n_points=m)
    # nK = 2 n + 1 = 17: the fleet dense LDL^T, one instance: K8 then K7
    assert lt.solver.kkt_backend_resolved == lj.solver.kkt_backend_resolved == "fleet"
    sol = lt.fit(X, y, l1weight=1.0)
    ref = lj.fit(X, y, l1weight=1.0)
    assert sol.ok, sol.describe()
    assert sol.status == ref.status and abs(sol.iters - ref.iters) <= 1, (sol.iters, ref.iters)
    assert calls["K8"] == sol.iters - 1 and calls["K7"] >= calls["K8"], calls
    W, c = sol.outputs["W"], sol.outputs["c"]
    np.testing.assert_allclose(W, np.asarray(ref.outputs["W"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c, np.asarray(ref.outputs["c"]), rtol=0, atol=1e-6)
    assert abs(W[1] - 2.0) < 0.2 and abs(W[4] + 1.5) < 0.2
    mask = np.ones(n, bool)
    mask[[1, 4]] = False
    assert np.abs(W[mask]).max() < 0.1 and abs(c - 1.0) < 0.2

    from scipy.optimize import minimize as sp_minimize

    def obj(z):
        return np.sum((X @ z[:n] + z[n] - y) ** 2) + np.abs(z[:n]).sum()

    best = sp_minimize(obj, np.zeros(n + 1), method="Nelder-Mead",
                       options={"maxiter": 20000, "xatol": 1e-10, "fatol": 1e-12})
    assert obj(np.concatenate([W, [float(c)]])) <= best.fun + 1e-3
    with pytest.raises(ValueError, match="X must be"):
        lt.fit(X[:, :3], y, l1weight=1.0)


def test_lasso_without_constant():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((30, 4))
    y = X @ np.array([1.0, 0.0, -0.5, 0.0]) + 0.01 * rng.standard_normal(30)
    sol = ttc.Lasso(4, 30, add_constant=False, name="lnc", device="cpu").fit(X, y, 0.5)
    ref = jtc.Lasso(4, 30, add_constant=False, name="lnc").fit(X, y, 0.5)
    assert sol.ok and "c" not in sol.outputs and abs(sol.iters - ref.iters) <= 1
    np.testing.assert_allclose(sol.outputs["W"], np.asarray(ref.outputs["W"]), rtol=0, atol=1e-6)


def test_nlss_discrete_simulation():
    out = []
    for tc in (ttc, jtc):
        sys_ = tc.NLSS(f=lambda x, u, t: 0.9 * x + u, g=lambda x, u, t: 2.0 * x,
                       discrete=True, x0=[1.0])
        out.append(sys_.simulate(np.ones((1, 5))))
    (xs, ys), (xj, yj) = out
    expect = [1.0]
    for _ in range(5):
        expect.append(0.9 * expect[-1] + 1.0)
    np.testing.assert_allclose(xs[0], expect, rtol=1e-12)
    np.testing.assert_allclose(ys[0], 2.0 * np.asarray(expect[:-1]), rtol=1e-12)
    np.testing.assert_array_equal(xs, xj)
    np.testing.assert_array_equal(ys, yj)


def test_nlss_continuous_simulation():
    out = []
    for tc in (ttc, jtc):
        sys_ = tc.NLSS(f=lambda x, u, t: -x, discrete=False, x0=[1.0])
        out.append(sys_.simulate(np.zeros((1, 10)), ts=0.1)[0])
    np.testing.assert_allclose(out[0][0, -1], np.exp(-1.0), rtol=1e-3)
    np.testing.assert_array_equal(out[0], out[1])
    with pytest.raises(ValueError, match="requires ts"):
        ttc.NLSS(f=lambda x, u, t: -x, discrete=False, x0=[1.0]).simulate(np.zeros((1, 2)))


def test_nlss_symbolic_constraints():
    xv = np.array([[1.0, 0.5 + 1, 0.25 + 0.5 + 1, 3.0]])
    uv = np.ones((1, 3))
    res = []
    for tc in (ttc, jtc):
        sys_ = tc.NLSS(f=lambda x, u, t: 0.5 * x + u, discrete=True, x0=[0.0])
        x = sys_.symbolic_state(4)
        u = tc.variable("nl_u", (1, 3))
        cons = sys_.dynamics_constraints(x, u)
        assert len(cons) == 1 and cons[0].kind == "eq" and x.shape == (1, 4)
        res.append(cons[0].expr)
    r = res[0]({"x": torch.as_tensor(xv), "nl_u": torch.as_tensor(uv)}).numpy()
    np.testing.assert_allclose(r[0, :2], 0.0, atol=1e-12)
    assert abs(r[0, 2]) > 0.1
    np.testing.assert_allclose(r, np.asarray(res[1]({"x": xv, "nl_u": uv})), atol=1e-12)
    cont = ttc.NLSS(f=lambda x, u, t: -x, discrete=False, x0=[0.0, 1.0])
    assert cont.n_states == 2
    xc = ttc.variable("xc", (2, 3))
    (c,) = cont.dynamics_constraints(xc, ttc.variable("uc", (1, 2)), ts=0.1)
    assert c.expr.shape == (2, 2)


def _lasso():
    return ttc.Lasso(3, 10, name="dvl")


def _mpcmhe():
    x = ttc.variable("dvm_x", (1, 6))
    d = ttc.variable("dvm_d", (1, 5))
    uf = ttc.variable("dvm_uf", (1, 3))
    return ttc.Mpcmhe(
        objective=ttc.norm2(x) + ttc.norm2(uf) - ttc.norm2(d), state_variable=x,
        past_output_variable=ttc.variable("dvm_y", (1, 3)),
        past_control_variable=ttc.variable("dvm_up", (1, 2)),
        future_control_variable=uf, disturbance_variable=d,
        state_derivative=lambda xs, us, ds: us + ds, output_function=lambda xs: xs,
        sample_time=1.0, backward_horizon=2, forward_horizon=3)


def _sysid():
    return ttc.Sysid(f=lambda x, u, a: a * x, g=lambda x, a: x, n_states=1, n_outputs=1,
                     n_inputs=1, horizon=5, parameters=[ttc.ParameterSpec("a", ())],
                     name="dvs")


@pytest.mark.parametrize("build", [_lasso, _mpcmhe, _sysid], ids=["Lasso", "Mpcmhe", "Sysid"])
def test_apps_default_to_the_card(build):
    """Without ``device`` an app's solver is the card's, so without CUDA
    it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
