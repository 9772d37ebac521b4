"""The port's single-instance dense LDL^T (K6 factor, K7 solve, K8
factor+solve) held against the JAX package's ``pallas_ldl`` entry
points in interpret mode on the CPU, on the shapes of
tests/test_pallas_ldl.py.  On the CPU the port's wrappers run the plain
PyTorch versions of the CUDA kernels; chip_smoke.py holds the kernels
against those on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenscalc_tpu.kkt import pallas_ldl as jpl
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import dense_ldl as tdl
from tenscalc_tpu_torch.kkt import pallas_ldl as tpl

torch.set_num_threads(1)

# up to n = 128 the TPU kernel eliminates by the same rank-1 steps as
# the port (one panel) and the two agree to a few float32 roundings; past
# a panel it updates the trailing rows by a GEMM, whose sums round
# otherwise: the factors then agree to float32 accuracy of their scale
RTOL = {64: 1e-5, 200: 1e-4}


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


def _sym(rng, n, indefinite=False):
    """tests/test_pallas_ldl.py:19-24's matrices."""
    A = rng.standard_normal((n, n)).astype(np.float32)
    A = 0.5 * (A + A.T) + n * np.eye(n, dtype=np.float32)
    if indefinite:
        A[n // 2:, n // 2:] -= 3 * n * np.eye(n - n // 2, dtype=np.float32)
    return A


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rtol * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("n", [64, 200])
def test_plain_versions_match_jax_kernels(n):
    rng = np.random.default_rng(n)
    A = _sym(rng, n)
    b = rng.standard_normal(n).astype(np.float32)
    jLt, jd = jpl.pallas_ldl_factor(jnp.asarray(A), interpret=True, clamp=1e-7)
    jx = jpl.pallas_ldl_solve(jLt, jd, jnp.asarray(b), interpret=True)
    jLt8, jd8, jx8 = jpl.pallas_ldl_factor_solve(
        jnp.asarray(A), jnp.asarray(b), interpret=True, clamp=1e-7
    )
    tA, tb = torch.from_numpy(A)[None], torch.from_numpy(b)[None]
    tLt, td = tpl.pallas_ldl_factor_plain(tA, 1e-7)
    tx = tpl.pallas_ldl_solve_plain(tLt, td, tb)
    tLt8, td8, tx8 = tpl.pallas_ldl_factor_solve_plain(tA, tb, 1e-7)
    rtol = RTOL[n]
    for t, j in ((tLt, jLt), (td, jd), (tx, jx), (tLt8, jLt8), (td8, jd8), (tx8, jx8)):
        _close(t[0].numpy(), j, rtol)
    # the port's own solve against the TPU kernel's factor
    _close(tpl.pallas_ldl_solve_plain(
        torch.tensor(np.asarray(jLt))[None], torch.tensor(np.asarray(jd))[None], tb
    )[0].numpy(), jx, rtol)
    # reconstruction, unit diagonal (tests/test_pallas_ldl.py:27-35)
    L = tLt[0].numpy().T
    np.testing.assert_allclose(L @ np.diag(td[0].numpy()) @ L.T, A, atol=5e-3 * n)
    np.testing.assert_array_equal(np.diag(L), 1.0)


def test_indefinite_clamp_and_adapter():
    """An indefinite matrix with clamp 1e-7: inertia against eigvalsh, and
    PallasLDLFactorization (float32 factor, refinement in WW's float64)
    against the JAX adapter."""
    rng = np.random.default_rng(96)
    n = 96
    A = _sym(rng, n, indefinite=True).astype(np.float64)
    b = rng.standard_normal(n)
    w = np.linalg.eigvalsh(A)
    fac = tpl.PallasLDLFactorization(torch.from_numpy(A)[None], clamp=1e-7)
    mp, mn = fac.inertia()
    assert (int(mp[0]), int(mn[0])) == ((w > 0).sum(), (w < 0).sum())
    assert mp.dtype == torch.float64
    jfac = jpl.PallasLDLFactorization(jnp.asarray(A), interpret=True, clamp=1e-7)
    x = fac.solve(torch.from_numpy(b)[None])[0].numpy()
    jx = np.asarray(jfac.solve(jnp.asarray(b)))
    ref = np.linalg.solve(A, b)
    np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(x, jx, rtol=1e-9, atol=1e-12)


def test_batch_is_per_instance():
    """A batch (one instance per CTA on the card) equals its instances
    solved one at a time, and the unbatched signature of the JAX entry
    points is kept."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(np.stack([_sym(rng, 40, indefinite=k == 1) for k in range(3)]))
    b = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    Lt, d, x = tpl.pallas_ldl_factor_solve(A, b, 1e-7)
    for k in range(3):
        Lt1, d1 = tpl.pallas_ldl_factor(A[k], 1e-7)
        assert Lt1.shape == (40, 40) and d1.shape == (40,)
        assert torch.equal(Lt1, Lt[k]) and torch.equal(d1, d[k])
        assert torch.equal(tpl.pallas_ldl_solve(Lt1, d1, b[k]), x[k])


def test_cpu_wrappers_run_plain_versions():
    rng = np.random.default_rng(8)
    A = torch.from_numpy(_sym(rng, 50))[None]
    b = torch.from_numpy(rng.standard_normal((1, 50)).astype(np.float32))
    before = dict(tdl.LAUNCHES)
    Lt, d = tpl.pallas_ldl_factor(A, 1e-7)
    pLt, pd = tpl.pallas_ldl_factor_plain(A, 1e-7)
    assert torch.equal(Lt, pLt) and torch.equal(d, pd)
    assert torch.equal(tpl.pallas_ldl_solve(Lt, d, b), tpl.pallas_ldl_solve_plain(pLt, pd, b))
    tpl.PallasLDLFactorization(A, clamp=1e-7).solve(b)
    assert tdl.LAUNCHES == before


def test_block_threads_and_reduction_tree():
    """The backward sums follow the kernels' tree: per thread over its
    indices, a butterfly in each warp, the warps in order.  Threads per
    block: 32 ceil(n / 32), at most 512."""
    assert [tdl.block_threads(n) for n in (1, 32, 33, 200, 512, 896)] == [
        32, 32, 64, 224, 512, 512]
    rng = np.random.default_rng(9)
    n = 300
    A = torch.from_numpy(_sym(rng, n))[None]
    b = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32))
    Lt, d = tpl.pallas_ldl_factor_plain(A, 0.0)
    x = {T: tdl.solve_rows_plain(Lt, d, b, T) for T in (32, 64, 512)}
    ref = np.linalg.solve(A[0].double().numpy(), b[0].double().numpy())
    for T, xt in x.items():
        np.testing.assert_allclose(xt[0].numpy(), ref, rtol=1e-4, atol=1e-5)
