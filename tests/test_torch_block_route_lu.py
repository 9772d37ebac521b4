"""The plain versions of K9-K11 (fleet banded LU) at half-bandwidths past
the warp route's 63, where the CUDA kernels take the block route (a CTA
an instance), held against the JAX package's entry points, whose Pallas
kernels run in interpret mode on the CPU, at the tolerance of
tests/test_torch_banded_lu.py (1e-5).  Above w = 63 the backward sweep
sums a row's products in the block route's order
(``fleet_banded.backward_sum``).  The JAX side's cost is its compiles
(~20 s an entry point at w = 100), so the two independent ones run side
by side."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tenscalc_tpu.kkt import banded_lu as jlu
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import banded_lu as tlu
from test_torch_banded_lu import _fleet

torch.set_num_threads(1)

RTOL = ATOL = 1e-5  # the existing plain-versus-Pallas tests' tolerance
CLAMP = 1e-4  # the adapters' pivot clamp
# (n, w, B): the first width of the block route, and one past a hundred
SHAPES = [(80, 64, 1), (110, 100, 1)]


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


@pytest.mark.parametrize("n,w,B", SHAPES)
def test_plain_versions_match_jax_kernels_past_63(n, w, B):
    _, band, rhs = _fleet(n, w, B, seed=n + w + B, zero_last_pivot=True)
    jb, jr = jnp.asarray(band), jnp.asarray(rhs)
    with ThreadPoolExecutor(2) as pool:
        fs = pool.submit(jlu.fleet_banded_lu_factor_solve_batched, jb, jr, w, clamp=CLAMP)
        f11 = pool.submit(jlu.fleet_banded_lu_factor_batched, jb, w, clamp=CLAMP)
        (jf, jx), jf11 = fs.result(), f11.result()
    jx10 = jlu.fleet_banded_lu_solve_batched(jf, jr, w)
    tb, tr = torch.from_numpy(band), torch.from_numpy(rhs)
    assert tlu.route(w) == "block"
    tf, tx = tlu.fleet_banded_lu_factor_solve_batched(tb, tr, w, CLAMP)
    tf11 = tlu.fleet_banded_lu_factor_batched(tb, w, CLAMP)
    tx10 = tlu.fleet_banded_lu_solve_batched(tf, tr, w)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf11.numpy(), np.asarray(jf11), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx10.numpy(), np.asarray(jx10), rtol=RTOL, atol=ATOL)
    assert (tf[:, n - 1, 0] == CLAMP).all()  # the clamp decided a pivot
