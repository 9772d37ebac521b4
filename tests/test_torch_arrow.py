"""Arrow-plus-band KKT factorization (``kkt/arrow.py``) against the JAX
package's on the same seeded inputs (its oracles are tests/test_arrow.py
and tests/test_planner.py:44-74): ``plan_arrow`` picks the same arrow
and band indices, the arrow solve of a batch of 3 matches JAX's per
instance (1e-10 relative in float64), and the Sysid of
tests/test_planner.py:44 resolves to 'arrow' under
``TENSCALC_AUTO_FLEET=0`` in both packages and fits a, b as the JAX
package does (status and iterations equal, a and b within 1e-8 in
float64)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

import tenscalc_tpu as jtc  # noqa: E402
from tenscalc_tpu.kkt.arrow import ArrowFactorization as JArrow  # noqa: E402
from tenscalc_tpu.kkt.arrow import plan_arrow as jplan_arrow  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt.arrow import ArrowFactorization, ArrowPlan, plan_arrow  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _band_plus_arrow(rng, n_band, bw, n_arrow):
    """tests/test_arrow.py's matrix: a band with a few dense rows."""
    n = n_band + n_arrow
    A = np.zeros((n, n))
    for k in range(-bw, bw + 1):
        A[:n_band, :n_band] += np.diag(rng.standard_normal(n_band - abs(k)), k)
    A[:n_band, :n_band] = 0.5 * (A[:n_band, :n_band] + A[:n_band, :n_band].T)
    C = rng.standard_normal((n_band, n_arrow))
    A[:n_band, n_band:] = C
    A[n_band:, :n_band] = C.T
    D = rng.standard_normal((n_arrow, n_arrow))
    A[n_band:, n_band:] = D + D.T
    return A + 4 * (bw + n_arrow + 2) * np.eye(n)


@pytest.mark.parametrize("n_band,bw,n_arrow", [(120, 4, 3), (150, 5, 4)])
def test_plan_arrow_matches_jax(n_band, bw, n_arrow):
    rng = np.random.default_rng(0)
    A = _band_plus_arrow(rng, n_band, bw, n_arrow)
    p = rng.permutation(A.shape[0])
    pattern = np.abs(A[p][:, p]) > 0
    pt, pj = plan_arrow(pattern), jplan_arrow(pattern)
    assert pt is not None and pt.worthwhile and pj.worthwhile
    assert pt.n_arrow == len(pj.arrow) == n_arrow
    np.testing.assert_array_equal(pt.arrow, pj.arrow)
    np.testing.assert_array_equal(pt.band, pj.band)
    np.testing.assert_array_equal(pt.band_plan.perm, pj.band_plan.perm)
    assert (pt.band_plan.block, pt.band_plan.n_blocks) == (
        pj.band_plan.block, pj.band_plan.n_blocks)
    # no dense row: no arrow plan, on both sides
    band_only = np.abs(A[:n_band, :n_band]) > 0
    assert plan_arrow(band_only) is None and jplan_arrow(band_only) is None


def test_arrow_solve_matches_jax():
    rng = np.random.default_rng(1)
    p = None
    As = []
    for _ in range(3):
        A = _band_plus_arrow(rng, 150, 5, 4)
        p = rng.permutation(A.shape[0]) if p is None else p
        As.append(A[p][:, p])
    As = np.stack(As)
    plan = plan_arrow(np.abs(As).sum(axis=0) > 0)
    assert isinstance(plan, ArrowPlan)
    b = rng.standard_normal((3, plan.n))
    fac = ArrowFactorization(torch.from_numpy(As), plan)
    x = fac.solve(torch.from_numpy(b)).numpy()
    X = fac.solve(torch.from_numpy(b[..., None].repeat(2, axis=-1))).numpy()
    mp, mn = fac.inertia()
    assert mp.shape == (3,) and not mp.any() and not mn.any()
    for i in range(3):
        xj = np.asarray(JArrow(jnp.asarray(As[i]), plan).solve(jnp.asarray(b[i])))
        np.testing.assert_allclose(x[i], xj, rtol=0, atol=1e-10 * np.abs(xj).max())
        np.testing.assert_allclose(x[i], np.linalg.solve(As[i], b[i]), rtol=1e-8)
        np.testing.assert_allclose(X[i, :, 1], x[i], rtol=0, atol=0)


def _sysid(tc, **kw):
    """tests/test_planner.py:44's Sysid: global physical parameters couple
    every stage of the horizon."""
    return tc.Sysid(
        f=lambda x, u, a, b: a * x + b * u, g=lambda x, a, b: x,
        n_states=1, n_outputs=1, n_inputs=1, horizon=40,
        parameters=[tc.ParameterSpec("a", (), lower=0.0, upper=1.0),
                    tc.ParameterSpec("b", (), lower=-2.0, upper=2.0)],
        **kw,
    )


def test_sysid_resolves_to_arrow_and_fits_as_jax(monkeypatch, capsys):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "0")
    jtc.expr.clear_variables()
    sj = _sysid(jtc)
    st = _sysid(ttc, device="cpu")
    assert sj.solver.kkt_backend_resolved == st.solver.kkt_backend_resolved == "arrow"
    pj, pt = sj.solver.kkt_plan, st.solver.kkt_plan
    np.testing.assert_array_equal(pt.arrow, pj.arrow)
    np.testing.assert_array_equal(pt.band, pj.band)
    st.solver.opts = st.solver.opts.replace(verboseLevel=2)
    st.solver._report_kkt_plan()
    assert f"backend=arrow n_arrow={len(pj.arrow)}" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    N, a_true, b_true = 40, 0.8, 0.5
    u_seq = rng.standard_normal((1, N))
    x_seq = np.zeros((1, N))
    for k in range(N - 1):
        x_seq[0, k + 1] = a_true * x_seq[0, k] + b_true * u_seq[0, k]
    y_seq = x_seq + 1e-3 * rng.standard_normal((1, N))
    solj, estj = sj.fit(u_seq, y_seq, x0=y_seq)
    solt, estt = st.fit(u_seq, y_seq, x0=y_seq)
    assert solj.ok and solt.ok, (solj.describe(), solt.describe())
    assert solt.iters == solj.iters
    for k in ("a", "b"):
        np.testing.assert_allclose(float(estt[k]), float(estj[k]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(estt["a"]), a_true, atol=5e-3)
