"""tests/test_apps.py:420 on the port: over 14 data realizations the
sample std of a-hat agrees with the mean reported Laplace std; the first
two realizations held against the JAX package in float64 with
``TENSCALC_AUTO_FLEET=1`` on 'dense' (the fits' status and iterations
equal, estimates to 1e-8, ``parameter_std`` at the JAX package's
solution to 1e-8 relative).  The helpers are test_torch_apps_sysid.py's."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from test_torch_apps_sysid import _hold_fit, _hold_std, _soft  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def test_sysid_parameter_std_calibrated():
    """tests/test_apps.py:420: over 14 realizations the sample std of
    a-hat agrees with the mean reported Laplace std (the port's fits);
    the first two held against the JAX package's."""
    a_hats, stds = [], []
    for m in range(14):
        ttc.clear_variables()
        sysid, (sol, est) = _soft(ttc, {"device": "cpu"}, np.random.default_rng(100 + m),
                                  name=f"sidc{m}_")
        assert sol.ok, sol.describe()
        std = sysid.parameter_std(sol)
        if m < 2:
            jtc.expr.clear_variables()
            sj, fj = _soft(jtc, {}, np.random.default_rng(100 + m), name=f"sidc{m}_")
            _hold_fit((sol, est), fj)
            _hold_std(sysid, sj, fj[0])
        a_hats.append(float(est["a"]))
        stds.append(float(std["theta"]["a"]))
        assert np.isfinite(std["theta"]["b"]).all() and (std["x"] > 0).all()
    sample_std, mean_reported = np.std(a_hats, ddof=1), np.mean(stds)
    assert 0.5 * mean_reported < sample_std < 2.0 * mean_reported, (sample_std, mean_reported)
