"""The plain versions of K1-K3 (fleet banded LDL^T) at half-bandwidths
past the warp routes' 63, where the CUDA kernels take the block route (a
CTA an instance), held against the JAX package's entry points, whose
Pallas kernels run in interpret mode on the CPU, at the tolerance of
tests/test_torch_fleet_banded.py (1e-5).  Above w = 63 the backward
sweep sums a row's products in the block route's order (a thread's
terms, then a pairwise tree: ``fleet_banded.backward_sum``).  The JAX
side's cost is its compiles (~20 s an entry point at w = 100), so the
two independent ones run side by side."""

from concurrent.futures import ThreadPoolExecutor


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tenscalc_tpu.kkt import fleet_banded as jfb
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import fleet_banded as tfb
from test_torch_fleet_banded import _band as fb_band

torch.set_num_threads(1)

RTOL = ATOL = 1e-5  # the existing plain-versus-Pallas tests' tolerance
CLAMP = 1e-7
# (n, w, B): the first width of the block route, and one past a hundred
SHAPES = [(80, 64, 1), (110, 100, 1)]


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


@pytest.mark.parametrize("n,w,B", SHAPES)
def test_plain_versions_match_jax_kernels_past_63(n, w, B):
    band, rhs = fb_band(n, w, B, seed=n + w + B, zero_last_pivot=True)
    jb, jr = jnp.asarray(band), jnp.asarray(rhs)
    with ThreadPoolExecutor(2) as pool:
        fs = pool.submit(jfb.fleet_banded_factor_solve_batched, jb, jr, w, clamp=CLAMP)
        f3 = pool.submit(jfb.fleet_banded_factor_batched, jb, w, clamp=CLAMP)
        (jf, jx), jf3 = fs.result(), f3.result()
    jx2 = jfb.fleet_banded_solve_batched(jf, jr, w)
    tband, trhs = torch.from_numpy(band), torch.from_numpy(rhs)
    assert tfb.route(w) == "block"
    tf, tx = tfb.fleet_banded_factor_solve_batched(tband, trhs, w, CLAMP)
    tf3 = tfb.fleet_banded_factor_batched(tband, w, CLAMP)
    tx2 = tfb.fleet_banded_solve_batched(tf, trhs, w)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf3.numpy(), np.asarray(jf3), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx2.numpy(), np.asarray(jx2), rtol=RTOL, atol=ATOL)
    assert (tf[:, n - 1, 0] == CLAMP).all()  # the clamp decided a pivot
