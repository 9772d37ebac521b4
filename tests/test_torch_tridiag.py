"""The block-tridiagonal LDL^T (``kkt/tridiag.py``) against the JAX
package's on the same seeded inputs (its oracles are tests/test_tridiag.py):
the plan, the factor and solve of a batch of 3 in float64 (1e-12
relative) and in float32 with the block pivot clamp firing (the same
clamped positions, x within 1e-5 relative), the inertia, the
safeguarded refinement decided per instance, and the float32 l1l2 of
tests/test_f32_robustness.py:50, which converges on 'tridiag' as in JAX.
The flagship and the min-max chain on ``kkt_backend='tridiag'`` are in
tests/test_torch_tridiag_ipm.py."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

import tenscalc_tpu as jtc  # noqa: E402
from examples import l1l2estimation as jl12  # noqa: E402
from tenscalc_tpu.kkt.structure import plan_banded as jplan_banded  # noqa: E402
from tenscalc_tpu.kkt.tridiag import tridiag_factorize as jtridiag  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import l1l2estimation as tl12  # noqa: E402
from tenscalc_tpu_torch.kkt.structure import plan_banded  # noqa: E402
from tenscalc_tpu_torch.kkt.tridiag import CLAMP, tridiag_factorize  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _banded(rng, n, bw):
    A = np.zeros((n, n))
    for k in range(-bw, bw + 1):
        A += np.diag(rng.standard_normal(n - abs(k)), k)
    A = 0.5 * (A + A.T)
    return A + (2 * bw + 2) * np.eye(n)


def _batch(seed=0, n=150, bw=8, B=3):
    """B scrambled banded matrices of one pattern, the last rows' block
    negated (indefinite), and the pattern."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(n)
    As = []
    for _ in range(B):
        A = _banded(rng, n, bw)
        A[n - 40:, n - 40:] *= -1.0
        As.append(A[p][:, p])
    As = np.stack(As)
    return As, np.abs(As).sum(axis=0) > 0, rng


def test_plan_matches_jax():
    As, pat, _ = _batch()
    pt, pj = plan_banded(pat), jplan_banded(pat)
    np.testing.assert_array_equal(pt.perm, pj.perm)
    np.testing.assert_array_equal(pt.iperm, pj.iperm)
    assert (pt.block, pt.n_blocks, pt.n, pt.bandwidth, pt.worthwhile) == (
        pj.block, pj.n_blocks, pj.n, pj.bandwidth, pj.worthwhile)
    assert pt.worthwhile and pt.bandwidth <= 20


def test_factor_solve_float64_matches_jax():
    As, pat, rng = _batch(1)
    plan = plan_banded(pat)
    b = rng.standard_normal((3, plan.n))
    Bm = rng.standard_normal((3, plan.n, 2))
    fac = tridiag_factorize(torch.from_numpy(As), plan)
    assert fac.lus.dtype == torch.float64
    x = fac.solve(torch.from_numpy(b)).numpy()
    X = fac.solve(torch.from_numpy(Bm)).numpy()
    for i in range(3):
        fj = jtridiag(jnp.asarray(As[i]), plan)
        xj = np.asarray(fj.solve(jnp.asarray(b[i])))
        np.testing.assert_allclose(x[i], xj, rtol=0, atol=1e-12 * np.abs(xj).max())
        np.testing.assert_allclose(x[i], np.linalg.solve(As[i], b[i]), rtol=1e-10, atol=1e-12)
        Xj = np.asarray(fj.solve(jnp.asarray(Bm[i])))
        np.testing.assert_allclose(X[i], Xj, rtol=0, atol=1e-12 * np.abs(Xj).max())


def test_factor_solve_float32_clamp_matches_jax():
    """Instances 1 and 2 hold an exactly singular pair of rows (the
    [[1, 1], [1, 1]] block, coupled to nothing else) in the first and in
    a middle diagonal block of the permuted order: the float32 block LU
    meets an exact zero pivot there on both sides, which the clamp sets
    to +1e-7; a right-hand side equal on the pair keeps x finite."""
    As, pat, rng = _batch(2, n=80, bw=4)
    plan = plan_banded(pat)
    b = rng.standard_normal((3, plan.n))
    s = plan.block
    for i, blk in ((1, 0), (2, plan.n_blocks // 2)):
        r0, r1 = plan.perm[blk * s], plan.perm[blk * s + 1]
        for r in (r0, r1):
            As[i, r, :] = 0.0
            As[i, :, r] = 0.0
        As[i][np.ix_([r0, r1], [r0, r1])] = 1.0
        b[i, r1] = b[i, r0]
    A32, b32 = As.astype(np.float32), b.astype(np.float32)
    fac = tridiag_factorize(torch.from_numpy(A32), plan)
    assert fac.lus.dtype == torch.float32
    x = fac.solve(torch.from_numpy(b32)).numpy()
    d = torch.diagonal(fac.lus, dim1=-2, dim2=-1).numpy()
    clamped = np.abs(d) == np.float32(CLAMP)
    assert clamped.sum(axis=(1, 2)).tolist() == [0, 1, 1]
    for i in range(3):
        fj = jtridiag(jnp.asarray(A32[i]), plan)
        dj = np.asarray(jnp.diagonal(fj.Ds_lu[0], axis1=-2, axis2=-1))
        np.testing.assert_array_equal(clamped[i], np.abs(dj) == np.float32(CLAMP))
        xj = np.asarray(fj.solve(jnp.asarray(b32[i])))
        assert np.isfinite(x[i]).all()
        np.testing.assert_allclose(x[i], xj, rtol=0, atol=1e-5 * np.abs(xj).max())


def test_inertia_matches_jax():
    As, pat, _ = _batch(3, n=60, bw=4)
    plan = plan_banded(pat)
    mp, mn = tridiag_factorize(torch.from_numpy(As), plan).inertia()
    for i in range(3):
        w = np.linalg.eigvalsh(As[i])
        mpj, mnj = tridiag_factorize_jax_inertia(As[i], plan)
        assert (int(mp[i]), int(mn[i])) == (mpj, mnj) == ((w > 0).sum(), (w < 0).sum())


def tridiag_factorize_jax_inertia(A, plan):
    mp, mn = jtridiag(jnp.asarray(A), plan).inertia()
    return int(mp), int(mn)


def _perturbed(fac, factor):
    """Make a factor's unrefined solve a poor first guess (x (1 + 1e-3))
    and scale its refinement corrections by ``factor`` (per instance)."""
    orig, calls = fac._solve32, [0]

    def solve32(b):
        x = orig(b)
        calls[0] += 1
        return x * (1 + 1e-3) if calls[0] == 1 else x * factor

    fac._solve32 = solve32


def test_refinement_decided_per_instance():
    """Instance 0's correction is the true one (accepted: the residual
    falls), instance 1's is -3 times it (rejected: the residual grows),
    instance 2's the true one again; a decision for the whole fleet would
    give both instances the same fate.  Each matches the JAX package's
    own decision on that instance."""
    As, pat, rng = _batch(4, n=60, bw=4)
    plan = plan_banded(pat)
    b = rng.standard_normal((3, plan.n))
    factors = [1.0, -3.0, 1.0]
    fac = tridiag_factorize(torch.from_numpy(As), plan, n_refine=1)
    _perturbed(fac, torch.tensor(factors, dtype=torch.float64)[:, None])
    x = fac.solve(torch.from_numpy(b)).numpy()
    exact = np.linalg.solve(As, b[..., None])[..., 0]
    err = np.abs(x - exact).max(axis=1) / np.abs(exact).max(axis=1)
    assert err[0] < 1e-10 and err[2] < 1e-10 and 5e-4 < err[1] < 2e-3, err
    for i in range(3):
        fj = jtridiag(jnp.asarray(As[i]), plan, n_refine=1)
        _perturbed(fj, factors[i])
        xj = np.asarray(fj.solve(jnp.asarray(b[i])))
        np.testing.assert_allclose(x[i], xj, rtol=0, atol=1e-12 * np.abs(xj).max())


def _l1l2_f32(l12, ns, **kw):
    N = 200
    _, true_pos, meas, dt1, _ = l12.make_data(N=N)
    s = l12.build_l1l2(N=N, ns=ns, dtype="float32", gradTolerance=0.2,
                       desiredDualityGap=5e-3, **kw)
    params = {ns + "measurement": meas, ns + "dt1": dt1, ns + "weight2acceleration": 10.0,
              ns + "weight1acceleration": 2.0, ns + "weight1noise": 2.0}
    init = {ns + "position": np.zeros(N), ns + "noise1": np.zeros(N),
            ns + "acceleration1": np.zeros(N - 2), ns + "noise1abs": np.ones(N),
            ns + "acceleration1abs": np.ones(N - 2)}
    sol = s.solve(params, init=init, mu0=1.0, max_iter=60)
    err = float(np.abs(np.asarray(sol.outputs["position"]) - true_pos).mean())
    return s, sol, err


def test_l1l2_float32_converges_on_tridiag_as_jax(monkeypatch):
    """tests/test_f32_robustness.py:50: status 0, the mean position error
    under 0.6 (the f64 solve's ~0.476), finite multipliers, on both sides;
    the port's iterations within one of the JAX package's; 'auto' under
    TENSCALC_AUTO_FLEET=0 resolves to 'tridiag' in both."""
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "0")
    jtc.expr.clear_variables()
    sj, solj, errj = _l1l2_f32(jl12, "f32t_")
    st, solt, errt = _l1l2_f32(tl12, "f32t_", device="cpu")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "tridiag"
    assert solj.ok and solt.ok, (solj.describe(), solt.describe())
    assert errt < 0.6 and errj < 0.6
    assert np.isfinite(np.asarray(solt.lam)).all()
    assert abs(solt.iters - solj.iters) <= 1, (solt.iters, solj.iters)
