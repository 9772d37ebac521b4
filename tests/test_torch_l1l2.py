"""The l1l2 trajectory estimation (``examples/l1l2estimation``) on the
port against the JAX package with ``TENSCALC_AUTO_FLEET=1``, each side
naming its branch: ``'fleet_banded'`` in the 'hoisted' band mode (K1/K2's
plain versions here, a spy counts them), and ``'dense'``.

The problem's condensed KKT reaches a condition number near 1e16 (its
paired epigraph constraints go to zero together), so the two packages'
last-bit differences grow along the path:

* float64 on 'fleet_banded' takes the JAX package's path (the same
  statuses and mu at every iteration) with the position apart by
  4e-7 .. 5e-5 from the third iteration on (measured at N = 60), so the
  positions are held to 1e-4 and J to 1e-6 relative (apart by 2e-7),
  over the first 8 iterations.  It does not converge within 60
  iterations on either side: both stop at the iteration limit with a
  large addEye2Hessian (status 0x808, measured at N = 60 and 120), the
  JAX package's own result on this branch.
* float32 with bench.py's l1l2 options converges on both sides:
  iterations within one, position within 2e-3.

The 'dense' branch's cases are in test_torch_l1l2_dense.py.
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
from tenscalc_tpu_torch.kkt import fleet_banded as tfb  # noqa: E402

torch.set_num_threads(1)

N = 60
BENCH = {"gradTolerance": 0.2, "desiredDualityGap": 5e-3}


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


@pytest.fixture
def band_spy(monkeypatch):
    """Counts of K1's and K2's entry points (their plain versions on the
    CPU); K3 (the factor alone) must not run."""
    calls = {"K1": 0, "K2": 0}
    for key, name in (("K1", "fleet_banded_factor_solve_batched"),
                      ("K2", "fleet_banded_solve_batched")):
        def spy(*a, _f=getattr(tfb, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tfb, name, spy)

    def refuse(*a, **k):
        raise AssertionError("K3 is off the l1l2 path")

    monkeypatch.setattr(tfb, "fleet_banded_factor_batched", refuse)
    return calls


def _pair(ns, dtype, n=N, **opts):
    sj = jl.build_l1l2(N=n, ns=ns, dtype=dtype, **opts)
    st = tl.build_l1l2(N=n, ns=ns, dtype=dtype, device="cpu", **opts)
    params, init, true_pos = tl.bench_inputs(n, ns)
    return sj, st, params, init, true_pos


def _pos(sol):
    return np.asarray(sol.outputs["position"], float)


def test_inputs_match_jax():
    for x, y in zip(tl.make_data(N=N, seed=3), jl.make_data(N=N, seed=3)):
        np.testing.assert_array_equal(x, y)
    params, inits, true_pos = tl.fleet_inputs(3, N, "fi_")
    assert params["fi_measurement"].shape == (3, N) and params["fi_dt1"].shape == (3, N - 1)
    assert inits["fi_noise1abs"].shape == (3, N) and true_pos.shape == (3, N)
    np.testing.assert_array_equal(params["fi_dt1"][2], jl.make_data(N=N, seed=2)[3])


def test_f64_fleet_banded_matches_jax(band_spy):
    sj, st, params, init, _ = _pair("l64_", "float64")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode == sj._solve_raw._band_mode == "hoisted"
    assert st.kkt_plan.bandwidth == sj.kkt_plan.bandwidth
    for max_iter in (3, 8):
        a = sj.solve(params, init=init, mu0=1.0, max_iter=max_iter)
        b = st.solve(params, init=init, mu0=1.0, max_iter=max_iter)
        assert (b.status, b.iters, b.mu) == (a.status, a.iters, a.mu), (b.describe(), a.describe())
        np.testing.assert_allclose(_pos(b), _pos(a), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(b.outputs["J"]), float(a.outputs["J"]), rtol=1e-6)
    # one K1 an adaptation trip, K2 for the rest of each direction
    assert band_spy["K1"] >= 2 + 7 and band_spy["K2"] >= band_spy["K1"], band_spy


def test_f32_bench_options_match_jax(band_spy):
    """bench.py's l1l2 row's options (f32, gradTolerance 0.2, gap 5e-3,
    mu0 = 1, max_iter = 60) at N = 60."""
    sj, st, params, init, true_pos = _pair("l32_", "float32", **BENCH)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    a = sj.solve(params, init=init, mu0=tl.BENCH_MU0, max_iter=tl.BENCH_MAX_ITER)
    b = st.solve(params, init=init, mu0=tl.BENCH_MU0, max_iter=tl.BENCH_MAX_ITER)
    assert a.status == b.status == 0, (a.describe(), b.describe())
    assert abs(a.iters - b.iters) <= 1, (a.iters, b.iters)
    np.testing.assert_allclose(_pos(b), _pos(a), rtol=0, atol=2e-3)
    assert np.abs(_pos(b) - true_pos).mean() < 0.6
    assert band_spy["K1"] >= b.iters - 1 and band_spy["K2"] >= band_spy["K1"], band_spy


def test_bench_plan_at_full_size():
    """bench.py's row at N = 200: nU 996, nF 796, the RCM band w = 10 in
    the 'hoisted' band mode (chip_smoke.py's [l1l2])."""
    st = tl.build_l1l2(N=200, ns="lpl_", device="cpu", **tl.BENCH_OPTIONS)
    assert (st.nU, st.nF, st.nG) == (996, 796, 0)
    assert st.kkt_backend_resolved == "fleet_banded"
    assert st.kkt_plan.n == 996 and st.kkt_plan.bandwidth == 10
    assert st._solve_raw.band_mode == "hoisted" and tfb.route(10) == "lane"
