"""The port's per-iteration band mode ('periter': a banded plan whose
Hessian or equality Jacobian depends on the iterate) against the JAX
package's, with the JAX side on its fleet backends
(``TENSCALC_AUTO_FLEET=1``, Pallas in interpret mode) and the port on
the CPU, where the kernels' plain versions run:

* tests/test_band_mode.py's quartic chain (n = 80, float32);
* the per-iteration ``BandKKT`` of the nonlinear unicycle
  (``examples/mpc_unicycle.py``, T = 10: nK = 109, RCM w = 9) at an
  iterate off the central path: its
  band and product equal the dense condensed KKT of the port and of the
  JAX package;
* a fleet of four unicycles against each solved alone, one K1 a trip
  and no K3 (the inertia reads K1's factor);
* ``fns.sin`` and ``fns.cos``, which the unicycle's dynamics take, with
  their derivatives, on tests/test_fns.py's (2, 3) normal samples.

``test_torch_unicycle.py`` holds one unicycle against the JAX package."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_unicycle as jm  # noqa: E402
from tenscalc_tpu.ops import fns as jfns  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_unicycle as tm  # noqa: E402
from tenscalc_tpu_torch.ipm.solver import BandKKT, dense_kkt  # noqa: E402
from tenscalc_tpu_torch.kkt import fleet_banded as tfb  # noqa: E402
from tenscalc_tpu_torch.ops import fns as tfns  # noqa: E402

torch.set_num_threads(1)

T, NS = 10, "un_"
# float32: the reference's cross-backend tolerance on u
U_ATOL_F32 = 2e-3


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _quartic(mod, **kw):
    """tests/test_band_mode.py's chain-coupled quartic: the Hessian
    depends on x, so nothing of H hoists."""
    n = 80
    x, p = mod.variable("bq_x", (n,)), mod.parameter("bq_p", (n,))
    J = mod.norm2(x - p) + ((x[1:] - x[:-1]) ** 4).sum()
    if mod is ttc:
        kw["device"] = "cpu"
    return mod.optimize(J, [x], constraints=[x >= -2.0, x <= 2.0], parameters=[p],
                        dtype="float32", **kw)


def test_quartic_chain_matches_jax_and_dense():
    sj, st = _quartic(jtc), _quartic(ttc)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode == sj._solve_raw._band_mode == "periter"
    assert tuple(st._hoist) == tuple(sj._hoist) and st._hoist[0] is False
    pv = 0.1 * np.random.default_rng(0).standard_normal(80)
    args = dict(init={"bq_x": np.zeros(80)}, mu0=1.0, max_iter=60)
    sol_j = sj.solve({"bq_p": pv}, **args)
    sol_t = st.solve({"bq_p": pv}, **args)
    ttc.clear_variables()
    sol_d = _quartic(ttc, kkt_backend="dense").solve({"bq_p": pv}, **args)
    assert sol_t.ok and sol_j.ok and sol_d.ok, (sol_t.describe(), sol_j.describe())
    assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
    for other in (np.asarray(sol_j.variables["bq_x"]), sol_d.variables["bq_x"]):
        np.testing.assert_allclose(sol_t.variables["bq_x"], other, rtol=0, atol=1e-3)


def test_periter_band_equals_the_dense_kkt(monkeypatch):
    """The BandKKT of the first iteration, at the initial point of two
    instances with u perturbed off the rollout: its band is the permuted
    band of the dense condensed KKT (the port's ``dense_kkt`` and the JAX
    package's ``_assemble_ww``), and so is JAX's own per-iteration band;
    its product is the dense product."""
    ops = []

    class Capture(tfb.FleetBandedFromBand):
        def __init__(self, op, *a, **k):
            ops.append(op)
            super().__init__(op, *a, **k)

    monkeypatch.setattr(tfb, "FleetBandedFromBand", Capture)
    st = tm.build_solver(T=T, ns=NS, dtype="float32", device="cpu")
    params, inits = tm.fleet_inputs(T, 2, NS, seed=3)
    rng = np.random.default_rng(3)
    inits[NS + "u"] = 0.3 * rng.standard_normal(inits[NS + "u"].shape)
    inits[NS + "x"] = inits[NS + "x"] + 0.05 * rng.standard_normal(inits[NS + "x"].shape)
    r0 = st.solve_many(params, inits=inits, mu0=1e-1, max_iter=0)  # the initial point
    st.solve_many(params, inits=inits, mu0=1e-1, max_iter=1)
    op = ops[0]
    assert isinstance(op, BandKKT) and op.H.dim() == 3 and op.Gu.dim() == 3
    perm = np.asarray(st.kkt_plan.perm)
    nK, w = st.kkt_plan.n, st.kkt_plan.bandwidth
    c, i = np.arange(nK)[:, None], np.arange(w + 1)[None, :]
    inside = c + i < nK
    rows, cols = perm[np.minimum(c + i, nK - 1)], perm[c]

    def band_of(W):
        return np.where(inside, np.asarray(W, np.float64)[rows, cols], 0.0)

    assemble_t = dense_kkt(st._fns, st.nU, st.nF, st.nG, st.opts)
    sj = jm.build_solver(T=T, ns=NS, dtype="float32")
    Pm = jnp.asarray(np.eye(nK, dtype=np.float32)[perm])
    pre = {"Pm": Pm, "bmask_u": jnp.asarray(perm < st.nU, jnp.float32),
           "bmask_g": jnp.asarray(perm >= st.nU, jnp.float32)}
    aU = aE = 1e-9
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, nK)).astype(np.float32))
    mv = op.matvec(x).numpy()
    for b in range(2):
        one = {k: (v[b] if np.ndim(v) == 3 else v) for k, v in params.items()}
        penv = st._param_env(one)
        u, nu, lam = r0.u[b], r0.nu[b], r0.lam[b]
        si, sc = r0.scale_ineq[b], r0.scale_cost[b]
        WWt = assemble_t(u, nu, lam, aU, aE, penv, si, sc).numpy()
        refs = [band_of(WWt)]
        if b == 0:  # the JAX package's dense and per-iteration assemblies
            jenv = {k: jnp.asarray(np.asarray(v), jnp.float32) for k, v in one.items()}
            jargs = (jnp.asarray(u.numpy()), jnp.asarray(nu.numpy()),
                     jnp.asarray(lam.numpy()), jnp.asarray(0.1, jnp.float32),
                     jnp.asarray(aU, jnp.float32), jnp.asarray(aE, jnp.float32), jenv,
                     jnp.asarray(si.numpy()), jnp.asarray(sc.numpy()))
            refs.append(band_of(sj._solve_raw._assemble_ww(*jargs)["WW"]))
            refs.append(np.asarray(
                sj._solve_raw._assemble_ww(*jargs, pre=pre, band=True)["WW"].band))
        band_t = op.band[b].numpy()
        scale = np.abs(band_t).max()
        for ref in refs:
            np.testing.assert_allclose(band_t, ref, rtol=1e-5, atol=1e-6 * scale)
        # the plan's band holds the whole matrix
        assert np.abs(WWt).sum() == pytest.approx(
            np.abs(band_of(WWt)).sum() + np.abs(band_of(WWt)[:, 1:]).sum(), rel=1e-6)
        np.testing.assert_allclose(mv[b], WWt.astype(np.float64) @ x[b].numpy(),
                                   rtol=1e-4, atol=1e-5 * scale)


def test_fleet_matches_single_solves_one_k1_a_trip(monkeypatch):
    calls = {"trips": 0, "K1": 0, "K2": 0, "K3": 0}

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    st = tm.build_solver(T=T, ns=NS, dtype="float32", device="cpu")
    # an adapter a trip; the entry points where the card launches K1-K3
    monkeypatch.setattr(tfb, "_scaled_band", count("trips", tfb._scaled_band))
    for key, name in (("K1", "fleet_banded_factor_solve_batched"),
                      ("K2", "fleet_banded_solve_batched"), ("K3", "fleet_banded_factor_batched")):
        monkeypatch.setattr(tfb, name, count(key, getattr(tfb, name)))
    params, inits = tm.fleet_inputs(T, 4, NS, seed=0)
    res = st.solve_many(params, inits=inits, mu0=1e-1, max_iter=200)
    assert (res.status.numpy() == 0).all(), res.status
    assert calls["trips"] > 0 and calls["K1"] == calls["trips"] and calls["K3"] == 0, calls
    assert calls["K2"] >= calls["K1"], calls
    for b in range(4):
        one = {k: (v[b] if np.ndim(v) == 3 else v) for k, v in params.items()}
        sol = st.solve(one, init={k: v[b] for k, v in inits.items()}, mu0=1e-1, max_iter=200)
        assert sol.status == 0, sol.describe()
        np.testing.assert_allclose(sol.variables[NS + "u"].ravel(), res.u[b, : T - 1].numpy(),
                                   rtol=0, atol=U_ATOL_F32)


@pytest.mark.parametrize("name", ["sin", "cos"])
def test_trig_values_and_derivatives_match_jax(name):
    v = np.random.default_rng(0).standard_normal((2, 3))
    f_t, f_j = getattr(tfns, name), getattr(jfns, name)
    np.testing.assert_allclose(f_t(torch.from_numpy(v)).numpy(), np.asarray(f_j(jnp.asarray(v))),
                               rtol=1e-15, atol=1e-15)
    # on an expression, through the port's forward-mode derivatives
    x = ttc.variable("tg_x", (2, 3))
    e = (f_t(x) * f_t(x)).sum()
    g_t = torch.func.grad(lambda xx: e({"tg_x": xx}))(torch.from_numpy(v))
    g_j = jax.grad(lambda xx: (f_j(xx) * f_j(xx)).sum())(jnp.asarray(v))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12, atol=1e-15)
    H_t = torch.func.jacfwd(torch.func.grad(lambda xx: e({"tg_x": xx})))(torch.from_numpy(v))
    H_j = jax.hessian(lambda xx: (f_j(xx) * f_j(xx)).sum())(jnp.asarray(v))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-12, atol=1e-15)
