"""Block cyclic reduction (``kkt/cyclic.py``) against the JAX package's on
the same seeded inputs (its oracle is tests/test_cyclic.py): ``cr_solve``
on a batch of 2 at tests/test_cyclic.py's (nb, s) shapes, which pad the
chain to 2^m - 1 blocks but at nb = 3 and 7, and on an indefinite chain
(float64: both instances to 1e-7 of numpy's solve, the first to 1e-12
relative of JAX's), and the ``CyclicFactorization`` adapter.  The
flagship on ``kkt_backend='cyclic'`` is in tests/test_torch_cyclic_ipm.py."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from tenscalc_tpu.kkt.cyclic import CyclicFactorization as JCyclic  # noqa: E402
from tenscalc_tpu.kkt.cyclic import cr_solve as jcr_solve  # noqa: E402
from tenscalc_tpu.kkt.spike import dense_to_blocks as jdense_to_blocks  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt.cyclic import CyclicFactorization, cr_solve  # noqa: E402
from tenscalc_tpu_torch.kkt.spike import dense_to_blocks  # noqa: E402
from tenscalc_tpu_torch.kkt.structure import plan_banded  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _block_tridiag_dense(rng, nb, s, indefinite=False):
    """tests/test_cyclic.py's chain."""
    n = nb * s
    A = np.zeros((n, n))
    for i in range(nb):
        D = rng.standard_normal((s, s))
        A[i * s:(i + 1) * s, i * s:(i + 1) * s] = D + D.T
        if i > 0:
            Bc = rng.standard_normal((s, s))
            A[i * s:(i + 1) * s, (i - 1) * s:i * s] = Bc
            A[(i - 1) * s:i * s, i * s:(i + 1) * s] = Bc.T
    A += 4 * s * np.eye(n)
    if indefinite:
        for i in range(nb):
            sl = slice(i * s + s // 2, (i + 1) * s)
            A[sl, sl] -= 9 * s * np.eye(s - s // 2)
    return A


@pytest.mark.parametrize("nb,s,indefinite", [(3, 4, False), (7, 3, False), (10, 5, False),
                                             (16, 4, False), (33, 2, False), (12, 4, True)])
def test_cr_solve_matches_jax(nb, s, indefinite):
    rng = np.random.default_rng(nb * 10 + s)
    As = np.stack([_block_tridiag_dense(rng, nb, s, indefinite) for _ in range(2)])
    b = rng.standard_normal((2, nb * s))
    A_t, B_t = dense_to_blocks(torch.from_numpy(As), s)
    x = cr_solve(A_t, B_t, torch.from_numpy(b).view(2, nb, s)).reshape(2, -1).numpy()
    for i in range(2):
        np.testing.assert_allclose(x[i], np.linalg.solve(As[i], b[i]), rtol=1e-7, atol=1e-9)
    # the first instance against the JAX package's (each call compiles)
    Aj, Bj = jdense_to_blocks(jnp.asarray(As[0]), s)
    np.testing.assert_array_equal(A_t[0].numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(B_t[0].numpy(), np.asarray(Bj))
    xj = np.asarray(jcr_solve(Aj, Bj, jnp.asarray(b[0]).reshape(nb, s))).reshape(-1)
    np.testing.assert_allclose(x[0], xj, rtol=0, atol=1e-12 * np.abs(xj).max())


def test_cyclic_adapter_matches_jax():
    rng = np.random.default_rng(3)
    nb, s = 14, 4
    As = np.stack([_block_tridiag_dense(rng, nb, s) for _ in range(2)])
    plan = plan_banded(np.abs(As).sum(axis=0) > 0)
    assert plan.worthwhile
    b = rng.standard_normal((2, nb * s))
    fac = CyclicFactorization(torch.from_numpy(As), plan)
    x = fac.solve(torch.from_numpy(b)).numpy()
    assert fac.inertia()[0].shape == (2,)
    for i in range(2):
        np.testing.assert_allclose(x[i], np.linalg.solve(As[i], b[i]), rtol=1e-9)
    xj = np.asarray(JCyclic(jnp.asarray(As[0]), plan).solve(jnp.asarray(b[0])))
    np.testing.assert_allclose(x[0], xj, rtol=0, atol=1e-12 * np.abs(xj).max())
