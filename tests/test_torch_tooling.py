"""The IPM's history and snapshot and the diagnostics on them (M17)
against the JAX package on the same seeded inputs, in float64 on the
CPU: the profiling history (test_diagnostics.py's QP and
test_profiling.py's least squares: the same shape and iterations,
columns 0-6 to 1e-8 relative, the direction error, a rounding residue,
to 1e-10 absolute), the diagnostics on it (the JAX tests' assertions),
``capture_ww`` (WW at it = 2 to 1e-8 of the largest entry; it = None
localizes the mis-scaled variable as test_diagnostics.py:193-231 does),
``solve_result(save_iter=)``, and the flagship fleet with ``profiling``
and ``allowSave`` on: status, iterations and u bitwise those of a run
with both off; on the least squares also ``xla_cost``, ``phase_times``
and ``print_profile`` (test_profiling.py's assertions; the kernel
profilers return None off the card).  test_torch_tooling_profiling.py
and test_torch_tooling_introspect.py hold the rest of M17.

Both packages take the dense LU on these small problems
(``TENSCALC_AUTO_FLEET=0``, the JAX package's CPU branch), so their
directions agree to rounding."""

import copy
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from tenscalc_tpu import diagnostics as jdiag  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch import diagnostics as tdiag  # noqa: E402
from tenscalc_tpu_torch import profiling as tprof  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_dcmotor as tmpc  # noqa: E402
from tenscalc_tpu_torch.ipm.solver import HISTORY_COLUMNS  # noqa: E402

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _qp(tc, **kw):
    """tests/test_diagnostics.py's qp fixture (rng seed 0)."""
    rng = np.random.default_rng(0)
    n = 5
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T + n * np.eye(n)
    c = rng.standard_normal(n)
    Qv, cv, x = tc.variable("dg_Q", (n, n)), tc.variable("dg_c", (n,)), tc.variable("dg_x", (n,))
    J = 0.5 * tc.tprod(x, [-1], Qv @ x, [-1]) + tc.tprod(cv, [-1], x, [-1])
    solver = tc.optimize(objective=J, optimizationVariables=[x],
                         constraints=[x >= -1.0, x <= 1.0], parameters=[Qv, cv],
                         outputExpressions={"x": x}, profiling=True, maxIter=100, **kw)
    return solver, {"dg_Q": Q, "dg_c": c}, {"dg_x": np.zeros(n)}


def _ls(tc, ns="pf_", **kw):
    """tests/test_profiling.py's least squares, its parameters from seed 0,
    with profiling on."""
    n = 8
    A, b = tc.variable(ns + "A", (20, n)), tc.variable(ns + "b", (20,))
    x = tc.variable(ns + "x", (n,))
    solver = tc.optimize(objective=tc.norm2(A @ x - b), optimizationVariables=[x],
                         constraints=[x >= -1.0, x <= 1.0], parameters=[A, b],
                         profiling=True, **kw)
    rng = np.random.default_rng(0)
    return solver, {ns + "A": rng.random((20, 8)), ns + "b": rng.random(20)}, None


@pytest.fixture(scope="module")
def ls_solvers():
    """The least squares built by each package on the dense branch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TENSCALC_AUTO_FLEET", "0")
        js, params, _ = _ls(jtc)
        ts, _, _ = _ls(ttc, **CPU)
    return js, ts, params


@pytest.fixture(scope="module")
def qp_solves():
    """The QP solved once by each package on the dense branch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TENSCALC_AUTO_FLEET", "0")
        js, params, init = _qp(jtc)
        ts, _, _ = _qp(ttc, **CPU)
    return js, ts, params, init, js.solve(params, init=init), ts.solve(params, init=init)


def check_history(ts, jsol, tsol):
    """The port's history against JAX's: shape, iterations, columns 0-6
    to 1e-8 relative, the direction error to 1e-10 absolute, and
    tests/test_diagnostics.py::test_history_recorded's own checks."""
    assert ts.kkt_backend_resolved == "dense"
    assert tsol.status == jsol.status == 0 and tsol.iters == jsol.iters
    jh, th = np.asarray(jsol.history), tsol.history
    assert th.shape == jh.shape == (tsol.iters - 1, len(HISTORY_COLUMNS))
    # rtol 1e-8; an absolute 1e-12 for the entries that are rounding
    # residues themselves (|grad| once a Newton step has solved the QP)
    np.testing.assert_allclose(th[:, :7], jh[:, :7], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(th[:, 7], jh[:, 7], rtol=0, atol=1e-10)
    gap, mu = th[:, HISTORY_COLUMNS.index("gap")], th[:, HISTORY_COLUMNS.index("mu")]
    assert gap[-1] < gap[0] * 1e-2 and mu[-1] < mu[0] and not np.isnan(th).any()


def test_history_matches_jax(qp_solves):
    _, ts, _, _, jsol, tsol = qp_solves
    check_history(ts, jsol, tsol)


def test_diagnostics_on_the_history(qp_solves, capsys):
    """test_iteration_table_and_analysis, test_plot_convergence and
    test_analyze_hessian's assertions, and the reports equal JAX's."""
    js, ts, params, init, jsol, sol = qp_solves
    tdiag.print_iteration_table(sol)
    out = capsys.readouterr().out
    assert "Iter" in out and len(out.splitlines()) == sol.iters

    rep = tdiag.debug_convergence_analysis(sol)
    assert rep["iters"] == sol.iters - 1 and isinstance(rep["findings"], list)
    assert rep["findings"] == jdiag.debug_convergence_analysis(jsol)["findings"]

    tdiag.plot_convergence(sol)
    out = capsys.readouterr().out
    assert "gap" in out and "mu" in out and "alphaPrimal" in out
    assert out.count("*") >= 4 * (sol.iters - 1)

    class NoHist:
        history = None

    tdiag.plot_convergence(NoHist())
    assert "no history" in capsys.readouterr().out
    with pytest.raises(ValueError, match="profiling=True"):
        tdiag.debug_convergence_analysis(NoHist())

    rep = tdiag.analyze_hessian(ts, params, init=init)
    jrep = jdiag.analyze_hessian(js, params, init=init)
    assert rep["nU"] == 5 and rep["nF"] == 10 and "dg_x" in rep["variables"]
    assert rep["kkt_cond"] > 1.0
    np.testing.assert_allclose(rep["kkt_cond"], jrep["kkt_cond"], rtol=1e-8)
    for k, v in rep["variables"]["dg_x"].items():
        np.testing.assert_allclose(v, jrep["variables"]["dg_x"][k], rtol=1e-10)


def test_flagship_flags_change_nothing(monkeypatch):
    """profiling and allowSave on the flagship fleet (T = 14, B = 4, the
    fleet branch): status, iterations and u bitwise as with both off;
    each instance's rows finite up to its iters - 1 and NaN after; the
    CG nu-initializer's residual recorded."""
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    T, B = 14, 4
    off = tmpc.build_solver(T=T, namespace="tfa_", dtype="float32", **CPU)
    # the same problem and plan, its IPM built again with both flags on
    on = copy.copy(off)
    on.opts = off.opts.replace(profiling=True, allowSave=True)
    on._install_backend(off._kkt_solver, off.kkt_backend_resolved, band_plan=off.kkt_plan)
    assert off.kkt_backend_resolved == "fleet_banded"
    assert on._solve_raw.band_mode == off._solve_raw.band_mode == "hoisted"
    runs = []
    params, inits = tmpc.fleet_inputs(T, B, "tfa_", seed=0)
    for s in (off, on):
        runs.append(s.solve_many(params, inits=inits, mu0=1.0, max_iter=100))
    r0, r1 = runs
    assert r0.history is None and r0.saved == () and r0.nu_init_residual is None
    assert torch.equal(r0.status, r1.status) and torch.equal(r0.iters, r1.iters)
    assert torch.equal(r0.u, r1.u) and (r1.status == 0).all()
    assert r1.history.shape == (B, on.opts.maxIter, len(HISTORY_COLUMNS))
    for b in range(B):
        k = int(r1.iters[b]) - 1
        assert torch.isfinite(r1.history[b, :k]).all() and torch.isnan(r1.history[b, k:]).all()
    assert r1.nu_init_residual.shape == (B,) and torch.isfinite(r1.nu_init_residual).all()
    assert len(r1.saved) == 6 and all(v.shape[0] == B for v in r1.saved)


def test_history_matches_jax_least_squares(ls_solvers):
    js, ts, params = ls_solvers
    check_history(ts, js.solve(params), ts.solve(params))


def test_profile_report_and_timers(ls_solvers):
    """test_profiling.py's xla_cost, phase_times and print_profile
    assertions; off the card the kernel profilers return None."""
    _, s, params = ls_solvers
    assert tprof.xla_cost(s, params)["flops"] > 0
    times = tprof.phase_times(s, params, iters=5)
    assert times["factor_plus_solve"] > 0
    assert times["iteration_estimate"] >= times["factor_plus_solve"]
    buf = io.StringIO()
    rep = tprof.print_profile(s, file=buf)
    assert "factorization" in buf.getvalue() and "TOTAL" in buf.getvalue()
    assert rep["flops"]["total_per_iteration"] > 0
    assert {"factor_solve_kernel", "solve_kernel", "lu_factor_solve_kernel",
            "tile_factor_kernel"} <= set(tprof.csrc_kernel_names())
    if not torch.cuda.is_available():
        assert tprof.kernel_times(lambda: s.solve(params)) is None
        assert tprof.measure_device_time(lambda: s.solve(params)) is None
