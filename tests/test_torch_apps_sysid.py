"""The Sysid app (``apps/sysid.py``) on the port against the JAX package in
float64 with ``TENSCALC_AUTO_FLEET=1``: tests/test_apps.py's seven sysid
tests (:187, :291, :323, the stochastic-model check, :450, :479)
on both sides from the same seeded data.

Each pair of fits names its branch.  These problems' KKTs have fewer
than 64 rows, so 'auto' resolves to the fleet dense LDL^T (K8/K7 on the
card) on both sides; with the noise variance estimated that branch
stops at the iteration limit on both sides (its pivot clamp at a
log-barrier variance term), so the tests run the pairs on 'dense', the
JAX package's own branch for them without ``TENSCALC_AUTO_FLEET``, and
hold the fit on 'auto' once.  Each fit is held to the JAX package's
(status and iterations equal, the estimates to 1e-8).  The Laplace computations, ``forecast`` and
``parameter_std`` (``torch.func.hessian`` and ``torch.linalg`` on the
port's side, ``jax.hessian`` and ``jnp.linalg`` on the JAX package's),
are held to 1e-8 relative at one solution, the JAX package's, so the
comparison sees the Hessians and not the fits; the report text is
equal line for line but for the solve's wall time.  The calibration
test (:420) is in test_torch_apps_sysid_calibration.py."""

import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-8


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _linear_data(rng, N, a, b, sv=0.0, sy=0.001):
    u_seq = rng.standard_normal((1, N))
    x_seq = np.zeros((1, N))
    for k in range(N - 1):
        x_seq[0, k + 1] = a * x_seq[0, k] + b * u_seq[0, k] + (
            sv * rng.standard_normal() if sv else 0.0)
    return u_seq, x_seq + sy * rng.standard_normal((1, N))


def _pair(make, backend="dense"):
    """make(tc, kw) on both packages on ``backend``: (port's, JAX
    package's)."""
    return (make(ttc, {"device": "cpu", "kkt_backend": backend}),
            make(jtc, {"kkt_backend": backend}))


def _ab(tc, kw, N, name, upper_a=1.0, **noise):
    return tc.Sysid(
        f=lambda x, u, a, b: a * x + b * u, g=lambda x, a, b: x,
        n_states=1, n_outputs=1, n_inputs=1, horizon=N,
        parameters=[tc.ParameterSpec("a", (), lower=0.0, upper=upper_a),
                    tc.ParameterSpec("b", (), lower=-2.0, upper=2.0)],
        name=name, **noise, **kw,
    )


def _hold_fit(ft, fj, names=("a", "b"), atol=1e-8):
    (st, et), (sj, ej) = ft, fj
    assert (st.status, st.iters) == (sj.status, sj.iters), (st.describe(), st.iters, sj.iters)
    for k in names:
        np.testing.assert_allclose(float(et[k]), float(ej[k]), rtol=0, atol=atol)
    np.testing.assert_allclose(np.asarray(st.outputs["x"]), np.asarray(sj.outputs["x"]),
                               rtol=0, atol=atol)


def _hold_std(sysid_t, sysid_j, sol_j):
    """parameter_std at the JAX package's solution on both sides."""
    std_t, std_j = sysid_t.parameter_std(sol_j), sysid_j.parameter_std(sol_j)
    for k, v in std_j["theta"].items():
        np.testing.assert_allclose(std_t["theta"][k], np.asarray(v), rtol=RTOL)
    if std_j["x"] is None:
        assert std_t["x"] is None
    else:
        np.testing.assert_allclose(std_t["x"], np.asarray(std_j["x"]), rtol=RTOL)
    return std_t


def test_sysid_recovers_parameters():
    """On 'auto', the card's branch: the fleet dense LDL^T."""
    rng = np.random.default_rng(0)
    N = 40
    u_seq, y_seq = _linear_data(rng, N, 0.8, 0.5)
    st, sj = _pair(lambda tc, kw: _ab(tc, kw, N, "sysid"), backend="auto")
    assert st.solver.kkt_backend_resolved == sj.solver.kkt_backend_resolved == "fleet"
    ft = st.fit(u_seq, y_seq, x0=y_seq)
    assert ft[0].ok, ft[0].describe()
    _hold_fit(ft, sj.fit(u_seq, y_seq, x0=y_seq))
    np.testing.assert_allclose(float(ft[1]["a"]), 0.8, atol=5e-3)
    np.testing.assert_allclose(float(ft[1]["b"]), 0.5, atol=5e-3)


def test_sysid_estimates_noise_variance():
    rng = np.random.default_rng(0)
    N, sigma = 60, 0.05
    u_seq, y_seq = _linear_data(rng, N, 0.8, 0.5, sy=sigma)
    st, sj = _pair(lambda tc, kw: _ab(tc, kw, N, "sysv", noise_std="estimate"))
    assert st.solver.kkt_backend_resolved == sj.solver.kkt_backend_resolved == "dense"
    ft, fj = st.fit(u_seq, y_seq, x0=y_seq), sj.fit(u_seq, y_seq, x0=y_seq)
    assert ft[0].ok, ft[0].describe()
    _hold_fit(ft, fj)
    np.testing.assert_allclose(float(ft[1]["a"]), 0.8, atol=0.05)
    np.testing.assert_allclose(float(ft[1]["b"]), 0.5, atol=0.05)
    shat = float(ft[0].outputs["noiseStdDev"])
    assert 0.5 * sigma < shat < 1.6 * sigma, shat
    np.testing.assert_allclose(shat, float(np.asarray(fj[0].outputs["noiseStdDev"])), rtol=RTOL)
    np.testing.assert_allclose(float(ft[0].outputs["logJoint"]),
                               float(np.asarray(fj[0].outputs["logJoint"])), rtol=RTOL)
    assert st._extra_names == sj._extra_names == ["sysv_noiseInvVariance"]
    ttc.clear_variables()
    fleet = _ab(ttc, {"device": "cpu"}, N, "sysv", noise_std="estimate")
    assert fleet.solver.kkt_backend_resolved == "fleet"
    assert fleet.fit(u_seq, y_seq, x0=y_seq, max_iter=20)[0].status != 0


def test_sysid_forecast_laplace_oracle():
    rng = np.random.default_rng(0)
    N, a_true, sigma_y, sigma_v = 40, 0.9, 0.1, 0.05
    u_seq = rng.standard_normal((1, N))
    x_seq = np.zeros((1, N))
    for k in range(N - 1):
        x_seq[0, k + 1] = (a_true * x_seq[0, k] + 0.5 * u_seq[0, k]
                           + sigma_v * rng.standard_normal())
    y_seq = x_seq + sigma_y * rng.standard_normal((1, N))
    inst = np.array([5, 20, 35])

    def make(tc, kw):
        return tc.Sysid(
            f=lambda x, u, a: a * x + 0.5 * u, g=lambda x, a: x,
            n_states=1, n_outputs=1, n_inputs=1, horizon=N,
            parameters=[tc.ParameterSpec("a", (), lower=-2.0, upper=2.0)],
            name="sysf", noise_std=sigma_y, disturbance_std=sigma_v,
            forecast_instants=inst, **kw)

    st, sj = _pair(make)
    ft, fj = st.fit(u_seq, y_seq, x0=y_seq, mu0=1.0), sj.fit(u_seq, y_seq, x0=y_seq, mu0=1.0)
    assert ft[0].ok, ft[0].describe()
    _hold_fit(ft, fj, names=("a",))
    rep = st.forecast(ft[0], u_seq, y_seq)
    assert rep["H_sign"] > 0 and np.isfinite(rep["logMarginal"])
    np.testing.assert_allclose(rep["mean"], np.asarray(ft[0].outputs["x"])[:, inst], rtol=1e-8)
    # the Laplace pieces at the JAX package's solution, on both sides
    rt, rj = st.forecast(fj[0], u_seq, y_seq), sj.forecast(fj[0], u_seq, y_seq)
    for k in ("mean", "std", "logJoint", "logMarginal", "logdetH", "H_sign"):
        np.testing.assert_allclose(np.asarray(rt[k]), np.asarray(rj[k]), rtol=RTOL, err_msg=k)
    # the exact Hessian of the quadratic model (test_apps.py's oracle)
    a = float(ft[1]["a"])
    wY, wV = 1.0 / sigma_y**2, 1.0 / sigma_v**2
    D = np.zeros((N - 1, N))
    for k in range(N - 1):
        D[k, k], D[k, k + 1] = -a, 1.0
    S = np.zeros((len(inst), N))
    S[np.arange(len(inst)), inst] = 1.0
    H = np.zeros((N + len(inst), N + len(inst)))
    H[:N, :N] = wY * np.eye(N) + wV * D.T @ D + wY * S.T @ S
    H[:N, N:] = -wY * S.T
    H[N:, :N] = -wY * S
    H[N:, N:] = wY * np.eye(len(inst))
    var = np.diag(np.linalg.inv(H))[N:]
    np.testing.assert_allclose(rep["std"].ravel(), np.sqrt(var), rtol=1e-6)
    assert (rep["std"].ravel() ** 2 > 1.0 / wY).all()


def test_sysid_forecast_requires_soft_dynamics():
    for tc in (ttc, jtc):
        with pytest.raises(ValueError, match="stochastic"):
            tc.Sysid(f=lambda x, u, a: a * x, g=lambda x, a: x, n_states=1, n_outputs=1,
                     n_inputs=1, horizon=10, parameters=[tc.ParameterSpec("a", ())],
                     name="sysh", forecast_instants=[3])


def _soft(tc, kw, rng, N=40, upper_a=1.0, name="sidr"):
    kw = {"kkt_backend": "dense", **kw}
    u_seq, y_seq = _linear_data(rng, N, 0.8, 0.5, sv=0.02, sy=0.05)
    sysid = _ab(tc, kw, N, name, upper_a=upper_a, noise_std=0.05, disturbance_std=0.02)
    return sysid, sysid.fit(u_seq, y_seq, x0=y_seq, restarts=2)


def _report_lines(text):
    """The report without the solve's wall time."""
    return [re.sub(r"in +[0-9.]+ ms", "in <t> ms", line) for line in text.splitlines()]


def test_sysid_report_text_and_bound_warning():
    """tests/test_apps.py:450: an active bound's hitting-upper warning,
    report() and plot_cost() line for line as the JAX package's."""
    st, (sol, est) = _soft(ttc, {"device": "cpu"}, np.random.default_rng(0), upper_a=0.6,
                           name="sidb_")
    sj, (sol_j, est_j) = _soft(jtc, {}, np.random.default_rng(0), upper_a=0.6, name="sidb_")
    assert sol.ok, sol.describe()
    assert float(est["a"]) == pytest.approx(0.6, abs=1e-3)
    _hold_fit((sol, est), (sol_j, est_j))
    _hold_std(st, sj, sol_j)
    texts = []
    for sysid in (st, sj):
        buf = io.StringIO()
        sysid.report(sol_j, file=buf)
        sysid.plot_cost(sol_j, file=buf)
        texts.append(buf.getvalue())
    out = texts[0]
    for piece in ("Parameter estimates", "State estimates", "Outputs", "hitting upper",
                  "[std =", "model std", "measurementNoise", "disturbance", "histogram"):
        assert piece in out, piece
    assert _report_lines(out) == _report_lines(texts[1])


def test_sysid_report_hard_dynamics():
    """tests/test_apps.py:479: the reduced-rollout Hessian of a model
    with hard dynamics."""
    rng = np.random.default_rng(0)
    N = 40
    u_seq, y_seq = _linear_data(rng, N, 0.8, 0.5)
    st, sj = _pair(lambda tc, kw: _ab(tc, kw, N, "sidh_"))
    ft, fj = st.fit(u_seq, y_seq, x0=y_seq), sj.fit(u_seq, y_seq, x0=y_seq)
    assert ft[0].ok
    _hold_fit(ft, fj)
    std = _hold_std(st, sj, fj[0])
    assert std["x"] is None and (std["theta"]["a"] > 0).all()
    bufs = [io.StringIO(), io.StringIO()]
    st.report(fj[0], file=bufs[0])
    sj.report(fj[0], file=bufs[1])
    assert "Parameter estimates" in bufs[0].getvalue()
    assert _report_lines(bufs[0].getvalue()) == _report_lines(bufs[1].getvalue())
