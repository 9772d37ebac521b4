"""The deconvolution fleet of tests/test_torch_deconv.py in float32 (N =
300, a 70-tap filter, w = 69, B = 2) against the JAX package with
``TENSCALC_AUTO_FLEET=1``: iterations within one and x within 2e-3
(PERF.md §2)."""

import torch

from test_torch_deconv import _fresh_variables, check_fleet_against_jax  # noqa: F401

torch.set_num_threads(1)


def test_deconvolution_fleet_matches_jax_f32(monkeypatch):
    check_fleet_against_jax("float32", monkeypatch)
