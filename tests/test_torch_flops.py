"""The port's main path of problems without inequalities, in float32 under
``kkt_backend='auto'`` as bench.py runs them, against the JAX package
with ``TENSCALC_AUTO_FLEET=1`` (its 'auto' takes the fleet backends as
the port's does on every device): bench.py's flops curve at N = 30 and
100 (``examples/flops.py``), tests/test_examples.py's reduced slseq
(N = 500, n = 80, m = 8) and bench.py's two mls rows (N = 100, n = 8).

One instance with a dense KKT of up to 896 rows goes to the fleet dense
backend's single route, K8 (factor and first solve) and K7: the port
runs their plain versions on the CPU, and a spy counts them.  The JAX
package's single solve on the CPU factors with XLA's blocked LDL^T, so
the two are held to iterations within one and x within 2e-3."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import flops as jfl  # noqa: E402
from examples import sls as jsls  # noqa: E402
from examples import slseq as jsq  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import flops as tfl  # noqa: E402
from tenscalc_tpu_torch.examples import sls as tsls  # noqa: E402
from tenscalc_tpu_torch.examples import slseq as tsq  # noqa: E402
from tenscalc_tpu_torch.kkt import fleet as tfleet  # noqa: E402
from tenscalc_tpu_torch.kkt import pallas_ldl as tpl  # noqa: E402

torch.set_num_threads(1)

X_ATOL = 2e-3  # the reference's float32 cross-backend tolerance


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


@pytest.fixture
def single_route(monkeypatch):
    """Counts of the plain K8 and K7 (their kernels on the card); K4-K6
    must not run."""
    calls = {"K8": 0, "K7": 0}

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    def refuse(*a, **k):
        raise AssertionError("K4-K6 are off the single route")

    monkeypatch.setattr(tpl, "pallas_ldl_factor_solve_plain",
                        count("K8", tpl.pallas_ldl_factor_solve_plain))
    monkeypatch.setattr(tpl, "pallas_ldl_solve_plain", count("K7", tpl.pallas_ldl_solve_plain))
    for mod, name in ((tfleet, "fleet_ldl_factor_plain"), (tfleet, "fleet_ldl_solve_plain"),
                      (tfleet, "pallas_ldl_factor")):
        monkeypatch.setattr(mod, name, refuse)
    return calls


def _hold(sol_t, sol_j, key):
    assert sol_t.status == 0 and sol_j.status == 0, (sol_t.describe(), sol_j.describe())
    assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
    np.testing.assert_allclose(sol_t.variables[key], np.asarray(sol_j.variables[key]),
                               rtol=0, atol=X_ATOL)


def _route(calls, solver, sol):
    """K8 once an iteration (the last trip runs only the exit tests), K7
    for the refinements."""
    assert solver.kkt_backend_resolved == "fleet" and solver.nF == 0
    assert calls["K8"] == sol.iters - 1, (calls, sol.iters)
    assert calls["K7"] >= calls["K8"]


@pytest.mark.parametrize("N", [30, 100])
def test_flops_matches_jax(N, single_route):
    st, ns = tfl.build_solver(N, dtype="float32", device="cpu")
    sj, _ = jfl.build_solver(N, dtype="float32")
    assert (st.nU, st.nF, st.nG) == (N, 0, N // 2)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet"
    params, init = tfl.default_data(N, ns)
    sol_t = st.solve(params, init=init, mu0=1.0, max_iter=60)
    _route(single_route, st, sol_t)
    sol_j = sj.solve(params, init=init, mu0=1.0, max_iter=60)
    _hold(sol_t, sol_j, ns + "x")
    np.testing.assert_allclose(sol_t.outputs["J"], sol_j.outputs["J"], rtol=1e-4)
    one = st.solve(params, init=init, mu0=1.0, max_iter=1)
    assert one.status & 8 and one.iters == 2


def test_slseq_reduced_matches_jax_and_oracle(single_route):
    """tests/test_examples.py::test_slseq_equality_ls's size, in float32."""
    N, n, m = 500, 80, 8
    st = tsq.build_solver(N, n, m, ns="slqt_", dtype="float32", device="cpu")
    sj = jsq.build_solver(N, n, m, ns="slqt_", dtype="float32")
    A, b, C, d = tsq.default_data(N, n, m)
    for x, y in zip((A, b, C, d), jsq.default_data(N, n, m)):
        np.testing.assert_array_equal(x, y)
    params = {"slqt_A": A, "slqt_b": b, "slqt_C": C, "slqt_d": d}
    init = {"slqt_x": np.zeros(n)}
    sol_t = st.solve(params, init=init, mu0=1.0, max_iter=60)
    _route(single_route, st, sol_t)
    _hold(sol_t, sj.solve(params, init=init, mu0=1.0, max_iter=60), "slqt_x")
    xref = tsq.kkt_oracle(A, b, C, d)
    np.testing.assert_allclose(sol_t.outputs["x"], xref, atol=1e-4)
    assert np.abs(C @ sol_t.outputs["x"] - d).max() < 1e-4


@pytest.mark.parametrize("row", ["unconstrained", "constrained"])
def test_mls_rows_match_jax(row):
    """bench_mls: N = 100, n = 8, x0 = 0.02 rand, mu0 = 1, max_iter = 20."""
    N, n = 100, 8
    rng = np.random.default_rng(0)
    A, b, x0 = rng.random((N, n)), rng.random(N), 0.02 * rng.random(n)
    ns = "bmlu_" if row == "unconstrained" else "bmlc_"
    build_t = getattr(tsls, f"build_{row}")
    build_j = getattr(jsls, f"build_{row}")
    st = build_t(N=N, n=n, ns=ns, dtype="float32", device="cpu")
    sj = build_j(N=N, n=n, ns=ns, dtype="float32")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet"
    params = {ns + "A": A, ns + "b": b}
    sol_t = st.solve(params, init={ns + "x": x0}, mu0=1.0, max_iter=20)
    sol_j = sj.solve(params, init={ns + "x": x0}, mu0=1.0, max_iter=20)
    _hold(sol_t, sol_j, ns + "x")
    if row == "unconstrained":
        np.testing.assert_allclose(sol_t.variables[ns + "x"],
                                   np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-3)


def test_sls_slack_formulation_matches_jax():
    """examples/sls.py's slack formulation (one 0-dim inequality)."""
    d = tsls.default_data(N=100, n=8)
    st = tsls.build_slack(N=100, n=8, ns="slv_", dtype="float32", device="cpu")
    sj = jsls.build_slack(N=100, n=8, ns="slv_", dtype="float32")
    params = {"slv_A": d["A"], "slv_b": d["b"]}
    init = {"slv_x": d["x0"], "slv_v": 1.0}
    _hold(st.solve(params, init=init, mu0=1.0, max_iter=60),
          sj.solve(params, init=init, mu0=1.0, max_iter=60), "slv_x")
