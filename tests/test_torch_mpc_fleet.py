"""examples/mpc_fleet (B DC-motor plants, each with its own pole, gain,
reference phase and initial state, in one solve_many a period) on the
port against the JAX package in float64 with ``TENSCALC_AUTO_FLEET=1``
(both on 'fleet_banded'): B = 4, T = 20, 3 periods.

At T = 20 two of the four instances
take a different second step on the two sides, decided by the last
bits of the first (the port's fleet banded and dense backends and the
JAX package's dense backend agree to 1e-15 on one of them, where the
JAX package's fleet banded backend parts from its own dense one by
3e-2), so each period's controls agree to what the solves' exit
tolerances leave (2.4e-4 measured; held to 1e-3), statuses and
iterations equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_fleet as jmf  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_fleet as tmf  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def test_mpc_fleet_closed_loop():
    B, T, steps = 4, 20, 3
    hist_t = tmf.run_fleet(B=B, T=T, n_steps=steps, device="cpu")
    hist_j = jmf.run_fleet(B=B, T=T, n_steps=steps)
    assert (hist_t["status"] == 0).all() and hist_t["status"].shape == (steps, B)
    np.testing.assert_array_equal(hist_t["status"], hist_j["status"])
    np.testing.assert_array_equal(hist_t["iters_max"], hist_j["iters_max"])
    assert hist_t["x"].shape == (steps, B, 2) and np.abs(hist_t["x"]).max() < 0.45
    np.testing.assert_allclose(hist_t["u"], hist_j["u"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(hist_t["x"], hist_j["x"], rtol=0, atol=1e-4)
    # the first period starts from the same state
    np.testing.assert_array_equal(hist_t["x"][0], hist_j["x"][0])
