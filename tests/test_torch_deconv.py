"""The deconvolution fleet of chip_smoke.py [deconv] at a small size (a
signal of N = 300 through a 70-tap filter, so H^T H has half-bandwidth
69: the band plan's w = 69 is past the warp routes, and the card's K1/K2
take the block route), B = 2, against the JAX package with
``TENSCALC_AUTO_FLEET=1`` (the ``fleet_banded`` route in the 'hoisted'
band mode, its Pallas kernels in interpret mode), at PERF.md §2's
tolerances: float64 iterations equal and x within 1e-8 (here),
float32 iterations within one and x within 2e-3
(test_torch_deconv_f32.py).  The problem is built by
chip_smoke.build_deconv through each package's public API."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt import fleet_banded as tfb  # noqa: E402

torch.set_num_threads(1)

N, K, B = 300, 70, 2
X_ATOL = {"float64": 1e-8, "float32": 2e-3}


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def check_fleet_against_jax(dtype, monkeypatch):
    calls = {"K1": 0, "K2": 0}
    for key, name in (("K1", "fleet_banded_factor_solve_batched"),
                      ("K2", "fleet_banded_solve_batched")):
        def spy(*a, _f=getattr(tfb, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tfb, name, spy)
    sj = chip_smoke.build_deconv(jtc, N, K, "dcv_", dtype=dtype)
    st = chip_smoke.build_deconv(ttc, N, K, "dcv_", dtype=dtype, device="cpu")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode == sj._solve_raw._band_mode == "hoisted"
    assert st.kkt_plan.n == sj.kkt_plan.n == N
    assert st.kkt_plan.bandwidth == sj.kkt_plan.bandwidth == K - 1
    assert tfb.route(K - 1) == "block"
    h, y, _ = chip_smoke.deconv_inputs(N, K, B)
    params = {"dcv_h": h, "dcv_y": y}
    inits = {"dcv_x": np.full((B, N), 0.5)}
    rj = sj.solve_many(params, inits=inits, mu0=1.0, max_iter=100)
    rt = st.solve_many(params, inits=inits, mu0=1.0, max_iter=100)
    assert (rt.status.numpy() == 0).all() and (np.asarray(rj.status) == 0).all()
    it_t, it_j = rt.iters.numpy(), np.asarray(rj.iters)
    if dtype == "float64":
        np.testing.assert_array_equal(it_t, it_j)
    else:
        assert np.abs(it_t - it_j).max() <= 1, (it_t, it_j)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0, atol=X_ATOL[dtype])
    # the box holds, and K1 factors an adaptation trip, K2 the other solves
    assert rt.u.min() >= 0.0 and rt.u.max() <= 1.0
    assert calls["K1"] >= it_t.max() - 1 and calls["K2"] >= calls["K1"], calls


def test_deconvolution_fleet_matches_jax(monkeypatch):
    check_fleet_against_jax("float64", monkeypatch)
