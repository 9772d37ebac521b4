"""The l1l2 trajectory estimation (``examples/l1l2estimation``) on the
``'dense'`` branch, the port against the JAX package with
``TENSCALC_AUTO_FLEET=1`` (test_torch_l1l2.py holds the
``'fleet_banded'`` branch):

* 'dense' in float32 at N = 200 holds tests/test_f32_robustness.py:59 on
  both sides; at iteration 2 the gradient exit test sits on its
  threshold, and each side's last bit decides it, so the two paths part
  there and the converged positions are apart by ~1e-2 while J agrees
  to 1e-4.
* build_l2 against build_l1l2's outlier rejection
  (tests/test_examples.py:55, N = 120, float64) on 'dense', the branch
  that converges in float64 (the JAX test's 'auto' resolves to
  'tridiag', which the port has not ported yet).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import l1l2estimation as jl  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import l1l2estimation as tl  # noqa: E402

torch.set_num_threads(1)

BENCH = {"gradTolerance": 0.2, "desiredDualityGap": 5e-3}


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _pos(sol):
    return np.asarray(sol.outputs["position"], float)


def test_f32_dense_matches_jax():
    """tests/test_f32_robustness.py:59 on both sides (N = 200)."""
    sj = jl.build_l1l2(N=200, ns="l3d_", dtype="float32", kkt_backend="dense", **BENCH)
    st = tl.build_l1l2(N=200, ns="l3d_", dtype="float32", kkt_backend="dense", device="cpu",
                       **BENCH)
    params, init, true_pos = tl.bench_inputs(200, "l3d_")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "dense"
    a = sj.solve(params, init=init, mu0=1.0, max_iter=60)
    b = st.solve(params, init=init, mu0=1.0, max_iter=60)
    for sol in (a, b):
        assert sol.ok, sol.describe()
        assert np.abs(_pos(sol) - true_pos).mean() < 0.6
        for leaf in (sol.lam, sol.nu, sol.gap, sol.norminf_grad):
            assert np.isfinite(np.asarray(leaf)).all()
    assert abs(a.iters - b.iters) <= 1, (a.iters, b.iters)
    np.testing.assert_allclose(float(b.outputs["J"]), float(a.outputs["J"]), rtol=1e-4)


def test_l2_vs_l1l2_outlier_rejection():
    """tests/test_examples.py:55 on 'dense' in float64, each solve against
    the JAX package's."""
    n = 120
    _, true_pos, meas, dt1, outliers = tl.make_data(n)
    p2 = {"l2e_measurement": meas, "l2e_dt1": dt1, "l2e_weight2acceleration": 10.0}
    i2 = {"l2e_position": np.zeros(n)}
    s2t = tl.build_l2(n, kkt_backend="dense", device="cpu")
    s2j = jl.build_l2(n, kkt_backend="dense")
    sol2 = s2t.solve(p2, init=i2, mu0=0.1, max_iter=100)
    ref2 = s2j.solve(p2, init=i2, mu0=0.1, max_iter=100)
    assert sol2.ok and (sol2.status, sol2.iters) == (ref2.status, ref2.iters)
    np.testing.assert_allclose(_pos(sol2), _pos(ref2), rtol=0, atol=1e-8)

    s12t = tl.build_l1l2(n, kkt_backend="dense", device="cpu")
    s12j = jl.build_l1l2(n, kkt_backend="dense")
    params, init = tl.l1l2_params(meas, dt1), tl.l1l2_init(n)
    sol12 = s12t.solve(params, init=init, mu0=0.1, max_iter=150)
    ref12 = s12j.solve(params, init=init, mu0=0.1, max_iter=150)
    assert sol12.ok, sol12.describe()
    assert (sol12.status, sol12.iters) == (ref12.status, ref12.iters)
    np.testing.assert_allclose(float(sol12.outputs["J"]), float(ref12.outputs["J"]), rtol=1e-8)
    err2 = np.abs(_pos(sol2) - true_pos).mean()
    err12 = np.abs(_pos(sol12) - true_pos).mean()
    assert err12 < err2  # outliers absorbed by the l1 noise term
    off = np.ones(n, bool)
    off[outliers] = False
    assert np.median(np.abs(sol12.outputs["noise1"][off])) < 0.05
