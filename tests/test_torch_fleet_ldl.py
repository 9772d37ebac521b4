"""The port's fleet dense LDL^T (K4 factor, K5 solve) held against the
JAX package's entry points, which run their Pallas kernels in interpret
mode on the CPU, on the shapes of tests/test_fleet.py.  On the CPU the
port's wrappers run the plain PyTorch versions of the CUDA kernels; the
kernels themselves are held against those plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenscalc_tpu.kkt import fleet as jfl
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import dense_ldl as tdl
from tenscalc_tpu_torch.kkt import fleet as tfl
from tenscalc_tpu_torch.kkt import pallas_ldl as tpl

torch.set_num_threads(1)

# the plain versions perform the TPU kernels' operations in the same
# order in float32; XLA fuses some multiply-adds and orders its sums its
# own way, so results agree to a few float32 roundings of their scale
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


def _spd_batch(rng, B, n):
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    return A + np.swapaxes(A, 1, 2) + 3 * n * np.eye(n, dtype=np.float32)


def _indefinite_batch(rng, B, n):
    """tests/test_fleet.py:47-58's matrices: six positive, n - 6 negative
    eigenvalues."""
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    A = A + np.swapaxes(A, 1, 2)
    return A + np.diag(
        np.concatenate([np.full(6, 10.0), np.full(n - 6, -10.0)])
    ).astype(np.float32)[None]


def _close(a, b, scale=None):
    b = np.asarray(b)
    scale = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=RTOL * max(scale, 1.0))


@pytest.mark.parametrize("B,n,clamp", [(5, 13, 0.0), (6, 24, 0.0), (4, 11, 1e-7),
                                     (3, 40, 0.0)])
def test_plain_versions_match_jax_kernels(B, n, clamp):
    rng = np.random.default_rng(n)
    A = _spd_batch(rng, B, n) if clamp == 0.0 else _indefinite_batch(rng, B, n)
    b = rng.standard_normal((B, n)).astype(np.float32)
    jL, jd = jfl.fleet_ldl_factor_batched(jnp.asarray(A), clamp=clamp)
    jx = jfl.fleet_ldl_solve_batched(jL, jd, jnp.asarray(b))
    tL, td = tfl.fleet_ldl_factor_plain(torch.from_numpy(A), clamp)
    tx = tfl.fleet_ldl_solve_plain(tL, td, torch.from_numpy(b))
    _close(tL.numpy(), jL)
    _close(td.numpy(), jd)
    _close(tx.numpy(), jx)


def test_factor_reconstructs():
    """Row j of the factor holds column j of unit-lower L, the pivot at
    [j, j]: L D L^T reproduces A (tests/test_fleet.py:25-34)."""
    rng = np.random.default_rng(0)
    B, n = 5, 13
    A = _spd_batch(rng, B, n)
    L, d = tfl.fleet_ldl_factor_batched(torch.from_numpy(A))
    L, d = L.numpy(), d.numpy()
    for k in range(B):
        np.testing.assert_array_equal(np.diag(L[k]), d[k])
        Lu = np.tril(L[k].T, -1) + np.eye(n)
        np.testing.assert_allclose(Lu @ np.diag(d[k]) @ Lu.T, A[k], atol=2e-3)


def test_batched_solve_residual():
    rng = np.random.default_rng(1)
    B, n = 6, 24
    A = _spd_batch(rng, B, n)
    b = rng.standard_normal((B, n)).astype(np.float32)
    L, d = tfl.fleet_ldl_factor_batched(torch.from_numpy(A))
    x = tfl.fleet_ldl_solve_batched(L, d, torch.from_numpy(b)).numpy()
    assert np.abs(np.einsum("bij,bj->bi", A, x) - b).max() < 1e-3


def test_inertia_matches_eigs():
    rng = np.random.default_rng(2)
    B, n = 4, 11
    A = _indefinite_batch(rng, B, n)
    _, d = tfl.fleet_ldl_factor_batched(torch.from_numpy(A), clamp=1e-7)
    for k in range(B):
        w = np.linalg.eigvalsh(A[k])
        assert ((w > 0).sum(), (w < 0).sum()) == ((d[k] > 0).sum().item(),
                                                  (d[k] < 0).sum().item())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adapter_matches_jax_under_vmap(dtype):
    """FleetLDLFactorization (equilibration, lazy fused first solve,
    refinement against WW, inertia from d) against JAX's under vmap."""
    rng = np.random.default_rng(3)
    B, n = 4, 16
    W = _indefinite_batch(rng, B, n).astype(dtype)
    rhs = rng.standard_normal((B, n)).astype(dtype)

    def jax_one(Wj, bj):
        fac = jfl.FleetLDLFactorization(Wj, n_refine=1)
        x = fac.solve(bj)
        return (x,) + fac.inertia()

    jx, jmp, jmn = jax.vmap(jax_one)(jnp.asarray(W), jnp.asarray(rhs))
    fac = tfl.FleetLDLFactorization(torch.from_numpy(W), n_refine=1)
    tx = fac.solve(torch.from_numpy(rhs))
    tmp, tmn = fac.inertia()
    assert tx.dtype == torch.from_numpy(W).dtype
    _close(tx.numpy(), jx)
    np.testing.assert_array_equal(tmp.numpy(), np.asarray(jmp))
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    # inertia before any solve factors on its own
    mp3, mn3 = tfl.FleetLDLFactorization(torch.from_numpy(W)).inertia()
    assert torch.equal(mp3, tmp) and torch.equal(mn3, tmn)


def test_single_instance_dispatch():
    """B = 1 takes the single-instance route (K8 then K7: Lt with a unit
    diagonal), B > 1 the fleet kernels (the pivot on the diagonal), and
    each solve reads its own factor's layout."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(_spd_batch(rng, 3, 20))
    b = torch.from_numpy(rng.standard_normal((3, 20)).astype(np.float32))
    L1, d1, x1 = tfl.fleet_ldl_factor_solve(A[:1], b[:1])
    pLt, pd, px = tpl.pallas_ldl_factor_solve_plain(A[:1], b[:1], tdl.CLAMP)
    assert torch.equal(L1, pLt) and torch.equal(d1, pd) and torch.equal(x1, px)
    assert torch.equal(torch.diagonal(L1, dim1=1, dim2=2), torch.ones(1, 20))
    assert torch.equal(tfl.fleet_ldl_solve(L1, d1, b[:1]),
                       tpl.pallas_ldl_solve_plain(pLt, pd, b[:1]))
    L3, d3, x3 = tfl.fleet_ldl_factor_solve(A, b)
    fL, fd = tfl.fleet_ldl_factor_plain(A, tdl.CLAMP)
    assert torch.equal(L3, fL) and torch.equal(d3, fd)
    assert torch.equal(x3, tfl.fleet_ldl_solve_plain(fL, fd, b))
    assert torch.equal(torch.diagonal(L3, dim1=1, dim2=2), d3)
    Lf, df = tfl.fleet_ldl_factor(A[:1])
    assert torch.equal(Lf, pLt) and torch.equal(df, pd)
    # the two routes solve the same system
    np.testing.assert_allclose(x1[0].numpy(), x3[0].numpy(), rtol=1e-5, atol=1e-6)


def test_cpu_wrappers_run_plain_versions():
    """A CPU tensor goes to the plain version and launches nothing."""
    rng = np.random.default_rng(5)
    A = torch.from_numpy(_spd_batch(rng, 3, 13))
    b = torch.from_numpy(rng.standard_normal((3, 13)).astype(np.float32))
    before = dict(tdl.LAUNCHES)
    L, d = tfl.fleet_ldl_factor_batched(A, 1e-7)
    x = tfl.fleet_ldl_solve_batched(L, d, b)
    pL, pd = tfl.fleet_ldl_factor_plain(A, 1e-7)
    assert torch.equal(L, pL) and torch.equal(d, pd)
    assert torch.equal(x, tfl.fleet_ldl_solve_plain(pL, pd, b))
    tfl.FleetLDLFactorization(A).solve(b)
    tfl.FleetLDLFactorization(A[:1]).solve(b[:1])
    assert tdl.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    A = torch.eye(13).expand(2, 13, 13).contiguous()
    with pytest.raises(TypeError):
        tfl.fleet_ldl_factor_batched(A.double())
    with pytest.raises(ValueError):
        tfl.fleet_ldl_factor_batched(A[:, :, :12])
    with pytest.raises(ValueError):
        tfl.fleet_ldl_solve_batched(A, torch.ones(2, 13), torch.ones(2, 12))
    # above K4's cap the JAX package's own fallback, the blocked LDL^T
    L, d = tfl.fleet_ldl_factor_batched(torch.eye(161).expand(2, 161, 161))
    assert torch.equal(L, torch.eye(161).expand(2, 161, 161)) and torch.equal(d, torch.ones(2, 161))
    # K6-K8 take n <= 896, the JAX package's single-instance cap
    with pytest.raises(ValueError, match="896"):
        tpl.pallas_ldl_factor(torch.eye(897))
