"""The deconvolution game of chip_smoke.py [deconv-game] at the size of
tests/test_torch_deconv.py (N = 300 through a 70-tap filter; player 1
owns x_1..x_150, player 2 the rest, both minimize 1/2 ||h * x - y||^2
under their own box), one instance, float64.  Its stacked KKT (x and the
2N bound multipliers, nK = 900) has an RCM band of w = 251, past the warp
route, so the card's K9/K10 take the block route; the band is assembled
directly ('hoisted' band mode).  Held against the JAX package's
``tc.equilibrium`` on its ``'dense'`` backend (its fleet banded LU in
interpret mode at w = 251 compiles for minutes, past this file's budget):
status and iterations equal, x within 1e-8; and, the game being a
potential game, its x against the fleet's minimizer
(chip_smoke.build_deconv) within 2e-3 and its objective within 1e-3
relative, as chip_smoke.py holds the card's game against its fleet."""

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
from tenscalc_tpu_torch.kkt import banded_lu as tlu  # noqa: E402

torch.set_num_threads(1)

N, K = 300, 70


@pytest.fixture(autouse=True)
def _fresh_variables():
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def test_deconvolution_game_matches_jax_and_the_minimizer(monkeypatch):
    calls = {"K9": 0, "K10": 0}
    for key, name in (("K9", "fleet_banded_lu_factor_solve_batched"),
                      ("K10", "fleet_banded_lu_solve_batched")):
        def spy(*a, _f=getattr(tlu, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tlu, name, spy)
    game = chip_smoke.build_deconv_game(ttc, N, K, "dgm_", dtype="float64", device="cpu")
    assert game.kkt_backend_resolved == "fleet_banded_lu"
    assert game._solve_raw.band_mode == "hoisted"
    w = game.kkt_plan.bandwidth
    assert game.kkt_plan.n == 3 * N and w > tlu.MAX_W and tlu.route(w) == "block"
    h, y, _ = chip_smoke.deconv_inputs(N, K, 1)
    params = {"dgm_h": h, "dgm_y": y}
    inits = {"dgm_x1": np.full((1, N // 2), 0.5), "dgm_x2": np.full((1, N - N // 2), 0.5)}
    rt = game.solve_many(params, inits=inits, mu0=1.0, max_iter=100)
    jgame = chip_smoke.build_deconv_game(jtc, N, K, "dgm_", dtype="float64",
                                         kkt_backend="dense")
    rj = jgame.solve_many(params, inits=inits, mu0=1.0, max_iter=100)
    assert int(rt.status[0]) == int(np.asarray(rj.status)[0]) == 0
    assert int(rt.iters[0]) == int(np.asarray(rj.iters)[0])
    x = rt.u.numpy()[:, :N]
    np.testing.assert_allclose(x, np.asarray(rj.u)[:, :N], rtol=0, atol=1e-8)
    assert calls["K9"] >= int(rt.iters[0]) - 1 and calls["K10"] >= calls["K9"], calls
    fleet = chip_smoke.build_deconv(ttc, N, K, "dgf_", dtype="float64", device="cpu")
    rf = fleet.solve_many({"dgf_h": h, "dgf_y": y}, inits={"dgf_x": np.full((1, N), 0.5)},
                          mu0=1.0, max_iter=100)
    assert int(rf.status[0]) == 0
    # both stop at the default duality gap, where entries at a bound sit
    # up to ~3e-4 off it on either side: the answers agree to the
    # reference's float32 tolerance, the objectives closer
    np.testing.assert_allclose(x, rf.u.numpy(), rtol=0, atol=2e-3)
    Jg, Jf = float(rt.f[0]), float(rf.f[0])
    assert abs(Jg - Jf) <= 1e-3 * abs(Jf), (Jg, Jf)
