"""The banded adapters' equilibration scales, correctly rounded: the fleet
banded LDL^T's s (``kkt/fleet_banded.py``) and the banded LU's row and
column scales r, c (``kkt/banded_lu.py``, from a band and from a dense
matrix) come from one helper, ``kkt.dense.equilibration_scale``, and
equal 1/sqrt(norm) formed in float64 and rounded once to float32, bit
for bit, on inputs where torch's float32 rsqrt is off in the last bit;
so does the fleet dense LDL^T's S (``kkt/fleet.py``), held against the
JAX package's adapter too, whose ``lax.rsqrt`` on the CPU (XLA's) is
correctly rounded on most of those inputs and one unit in the last place
off on the rest."""

import numpy as np
import pytest
import torch

from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import banded_lu as tlu
from tenscalc_tpu_torch.kkt import fleet as tfl
from tenscalc_tpu_torch.kkt import fleet_banded as tfb
from tenscalc_tpu_torch.kkt.band_assemble import BandedOperator
from tenscalc_tpu_torch.kkt.dense import equilibration_scale
from tenscalc_tpu_torch.kkt.structure import BandedPlan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


def reference(norm: np.ndarray) -> np.ndarray:
    """1/sqrt(max(norm, 1e-30)) in float64, rounded once to float32."""
    n32 = np.maximum(norm.astype(np.float32), np.float32(1e-30))
    return (1.0 / np.sqrt(n32.astype(np.float64))).astype(np.float32)


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def rsqrt_is_off(norm: np.ndarray) -> bool:
    """Whether torch's float32 rsqrt misrounds some of these norms."""
    t = torch.from_numpy(np.ascontiguousarray(norm, dtype=np.float32))
    return bool((bits(torch.rsqrt(t)) != bits(reference(norm))).any())


def off_inputs(count: int, seed: int) -> np.ndarray:
    """float32 norms over 2^-40..2^40 where torch's float32 rsqrt differs
    from the correctly rounded scale, and zeros (the 1e-30 floor)."""
    rng = np.random.default_rng(seed)
    x = np.exp2(rng.uniform(-40, 40, 200_000)).astype(np.float32)
    off = bits(torch.rsqrt(torch.from_numpy(x))) != bits(reference(x))
    assert off.mean() > 0.05  # the fault: a last-bit error on many inputs
    return np.concatenate([x[off][:count], np.zeros(3, np.float32)])


def test_helper_rounds_correctly_where_rsqrt_does_not():
    x = off_inputs(5000, seed=0)
    s = equilibration_scale(torch.from_numpy(x))
    assert s.dtype == torch.float32
    assert np.array_equal(bits(s), bits(reference(x)))
    assert not np.array_equal(bits(torch.rsqrt(torch.from_numpy(x[:-3]))),
                              bits(reference(x[:-3])))


def test_fleet_banded_scale_is_correctly_rounded():
    """_sym_equilibration's s from a lower band (row r holds band[r, :]
    and band[r-i, i])."""
    B, n, w = 2, 60, 3
    rng = np.random.default_rng(3)
    band = rng.uniform(-1.0, 1.0, (B, n, w + 1)).astype(np.float32)
    band[:, :, 0] = np.maximum(off_inputs(B * n, seed=4)[: B * n].reshape(B, n), 1.0)
    for i in range(1, w + 1):
        band[:, n - i:, i] = 0.0
    M = np.zeros((B, n, n), np.float32)
    for c in range(n):
        for i in range(w + 1):
            if c + i < n:
                M[:, c + i, c] = M[:, c, c + i] = band[:, c, i]
    s = tfb._sym_equilibration(torch.from_numpy(band), n, w)
    assert rsqrt_is_off(np.abs(M).max(axis=2))
    assert np.array_equal(bits(s), bits(reference(np.abs(M).max(axis=2))))


def test_banded_lu_scales_are_correctly_rounded():
    """The K9/K10 adapters' row and column scales r, c, from a band and
    from a dense matrix."""
    B, n, w = 2, 50, 2
    rng = np.random.default_rng(5)
    A = np.zeros((B, n, n), np.float32)
    for i in range(n):
        lo, hi = max(0, i - w), min(n, i + w + 1)
        A[:, i, lo:hi] = rng.uniform(-1.0, 1.0, (B, hi - lo))
    idx = np.arange(n)
    A[:, idx, idx] = np.maximum(off_inputs(B * n, seed=6)[: B * n].reshape(B, n), 1.0)
    A[:, idx[:-1], idx[1:]] *= 3.0  # row and column norms differ
    assert rsqrt_is_off(np.abs(A).max(axis=2)) and rsqrt_is_off(np.abs(A).max(axis=1))
    rref, cref = reference(np.abs(A).max(axis=2)), reference(np.abs(A).max(axis=1))
    plan = BandedPlan(perm=np.arange(n), iperm=np.arange(n), n=n, bandwidth=w,
                      block=w, n_blocks=-(-n // w), worthwhile=True)
    dense = tlu.FleetBandedLUFactorization(torch.from_numpy(A), plan)
    assert np.array_equal(bits(dense.r), bits(rref))
    assert np.array_equal(bits(dense.c), bits(cref))
    band = np.zeros((B, n, 2 * w + 1), np.float32)
    for c in range(n):
        for i in range(w + 1):
            if c + i < n:
                band[:, c, i] = A[:, c + i, c]
        for q in range(1, w + 1):
            if c + q < n:
                band[:, c, w + q] = A[:, c, c + q]
    op = BandedOperator(torch.from_numpy(band), torch.arange(n), lambda v: v)
    fromband = tlu.FleetBandedLUFromBand(op, plan)
    assert np.array_equal(bits(fromband.r), bits(rref))
    assert np.array_equal(bits(fromband.c), bits(cref))


def test_fleet_dense_scale_is_correctly_rounded_and_the_jax_adapters():
    """The dense fleet adapter's S (kkt/fleet.py) on matrices whose row
    norms torch's float32 rsqrt misrounds: the correctly rounded scale,
    bit for bit, and so the JAX package's FleetLDLFactorization(...).s
    wherever its XLA rsqrt rounds correctly, one unit in the last place
    from it elsewhere."""
    import jax.numpy as jnp

    import tenscalc_tpu.kkt.fleet as jfl

    B, n = 4, 300
    rng = np.random.default_rng(7)
    norms = off_inputs(B * n, seed=8)[: B * n].reshape(B, n)
    W = rng.uniform(-0.5, 0.5, (B, n, n)).astype(np.float32)
    W = (W + W.transpose(0, 2, 1)) * np.minimum(norms[:, :, None], norms[:, None, :])
    W[:, np.arange(n), np.arange(n)] = norms  # each row's largest entry
    want = reference(np.abs(W).max(axis=2))
    assert np.array_equal(np.abs(W).max(axis=2), norms)
    s = tfl.FleetLDLFactorization(torch.from_numpy(W).double()).s.numpy()
    assert np.array_equal(bits(s), bits(want))
    assert rsqrt_is_off(norms)
    js = np.stack([np.asarray(jfl.FleetLDLFactorization(jnp.asarray(W[b], jnp.float64)).s)
                   for b in range(B)])
    jax_right = bits(js) == bits(want)
    assert np.array_equal(bits(s)[jax_right], bits(js)[jax_right])
    assert (np.abs(bits(s) - bits(js)) <= 1).all()
    # most of the rows where torch misrounds, and some where XLA does
    torch_off = bits(torch.rsqrt(torch.from_numpy(norms)).numpy()) != bits(want)
    assert (torch_off & jax_right).sum() > 0.5 * torch_off.sum() and not jax_right.all()
