"""The port's min-max fleet path against the JAX package's: the horizon
chain of tests/test_game_backends.py (n = 40: saddle KKT nK = 240 with an
RCM band w = 6, HessD m = 120 with w = 1), with the JAX side on its fleet
backends (``TENSCALC_AUTO_FLEET=1``).  The port resolves 'auto' to them
on the CPU too, where the kernels' plain versions run: K1/K2 for the
saddle KKT in band mode 'hoisted', K3 for the banded HessD inertia.
Also the nK < 64 route (the fleet dense LDL^T, the dense LDL^T HessD
inertia) on tests/test_minmax.py's case 5.5."""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt import fleet as tfl  # noqa: E402
from tenscalc_tpu_torch.kkt import fleet_banded as tfb  # noqa: E402

torch.set_num_threads(1)

N, B = 40, 4
NS = "mf_"
CERT_KEYS = ("hoist_H", "hoist_H_sf", "hoist_Gz", "hoist_Fz", "deps_H", "deps_Gz", "deps_Fz")
# float64: both sides factor in float32 and refine once in float64; the
# answers agree far inside this (measured 1e-16)
U_ATOL_F64 = 1e-6
# float32: the reference's own cross-backend tolerance on u
# (tests/test_game_backends.py)
U_ATOL_F32 = 2e-3


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _chain(m, dtype, **kw):
    """tests/test_game_backends.py's chain-coupled saddle problem."""
    u, d, p = m.variable(NS + "u", (N,)), m.variable(NS + "d", (N,)), m.parameter(NS + "p", (N,))
    sq = m.norm2 if m is jtc else (lambda e: (e * e).sum())
    f = sq(u - p) + 2.0 * sq(u[1:] - u[:-1]) + u @ d - sq(d)
    return m.minmax(objective=f, minOptimizationVariables=[u], maxOptimizationVariables=[d],
                    minConstraints=[u >= -2.0, u <= 2.0], maxConstraints=[d >= -2.0, d <= 2.0],
                    parameters=[p], dtype=dtype, **kw)


@pytest.fixture(scope="module", params=["float64", "float32"])
def solvers(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("TENSCALC_AUTO_FLEET", "1")
    jtc.expr.clear_variables()
    ttc.clear_variables()
    sj = _chain(jtc, request.param)
    st = _chain(ttc, request.param, device="cpu")
    yield request.param, sj, st
    mp.undo()


def _inputs():
    rng = np.random.default_rng(0)
    one = {NS + "p": 0.5 * rng.standard_normal(N)}
    fleet = {NS + "p": 0.5 * rng.standard_normal((B, N))}
    inits = {NS + "u": np.zeros((B, N)), NS + "d": np.zeros((B, N))}
    return one, fleet, inits


def test_build_matches_jax(solvers):
    _, sj, st = solvers
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode == sj._solve_raw._band_mode == "hoisted"
    assert st._solve_raw.hessd_banded is sj._solve_raw._hessd_banded is True
    assert (st.kkt_plan.n, st.kkt_plan.bandwidth) == (sj.kkt_plan.n, sj.kkt_plan.bandwidth) == (240, 6)
    np.testing.assert_array_equal(st.kkt_plan.perm, sj.kkt_plan.perm)
    cv = inspect.getclosurevars(sj._solve_raw).nonlocals
    hj = cv["hessd_plan"]
    assert (st.hessd_plan.n, st.hessd_plan.bandwidth) == (hj.n, hj.bandwidth) == (120, 1)
    np.testing.assert_array_equal(st.hessd_plan.perm, hj.perm)
    # the JAX build keeps its certificates as local variables
    assert {k: st.certificates[k] for k in CERT_KEYS} == {k: cv[k] for k in CERT_KEYS}
    # the per-instance parameter enters no hoisted block
    assert st.certificates["deps_H"] == st.certificates["deps_Fz"] == set()


def test_single_and_fleet_match_jax(solvers):
    dtype, sj, st = solvers
    one, fleet, inits = _inputs()
    init1 = {k: v[0] for k, v in inits.items()}
    sol_j = sj.solve(one, init=init1, mu0=1.0)
    sol_t = st.solve(one, init=init1, mu0=1.0)
    res_j = sj.solve_many(fleet, inits=inits, mu0=1.0, max_iter=60)
    res_t = st.solve_many(fleet, inits=inits, mu0=1.0, max_iter=60)
    assert sol_t.status == sol_j.status == 0, sol_t.describe()
    assert (res_t.status.numpy() == 0).all() and (np.asarray(res_j.status) == 0).all()
    it_t, it_j = res_t.iters.numpy(), np.asarray(res_j.iters)
    if dtype == "float64":
        assert sol_t.iters == sol_j.iters
        np.testing.assert_array_equal(it_t, it_j)
        atol = U_ATOL_F64
    else:
        assert abs(sol_t.iters - sol_j.iters) <= 1
        assert (np.abs(it_t - it_j) <= 1).all()
        atol = U_ATOL_F32
    np.testing.assert_allclose(sol_t.variables[NS + "u"], sol_j.variables[NS + "u"], atol=atol)
    np.testing.assert_allclose(res_t.u.numpy()[:, :N], np.asarray(res_j.u)[:, :N], atol=atol)


def test_hessd_inertia_reaches_the_factor(solvers, monkeypatch):
    """Each adaptation trip factors the saddle band once (K1's plain
    version, the first solve), refines once (K2's) and factors the HessD
    band once (K3's), in float32 whatever the solver's type; the saddle
    KKT's inertia comes from its solve's factor."""
    dtype, _, st = solvers
    calls = {"factor": [], "factor_solve": 0, "solve": 0}
    factor, factor_solve, solve = (tfb.fleet_banded_factor_batched,
                                   tfb.fleet_banded_factor_solve_batched,
                                   tfb.fleet_banded_solve_batched)

    def spy_factor(band, w, clamp=0.0):
        calls["factor"].append((tuple(band.shape), band.dtype, w))
        return factor(band, w, clamp)

    def spy_factor_solve(*a, **k):
        calls["factor_solve"] += 1
        return factor_solve(*a, **k)

    def spy_solve(*a, **k):
        calls["solve"] += 1
        return solve(*a, **k)

    monkeypatch.setattr(tfb, "fleet_banded_factor_batched", spy_factor)
    monkeypatch.setattr(tfb, "fleet_banded_factor_solve_batched", spy_factor_solve)
    monkeypatch.setattr(tfb, "fleet_banded_solve_batched", spy_solve)
    _, fleet, inits = _inputs()
    res = st.solve_many(fleet, inits=inits, mu0=1.0, max_iter=60)
    assert (res.status.numpy() == 0).all()
    trips = calls["factor_solve"]
    assert trips >= int(res.iters.max()) - 1
    assert calls["solve"] == trips and len(calls["factor"]) == trips
    assert set(calls["factor"]) == {((B, 120, 2), torch.float32, 1)}


def _case55(m, **kw):
    u, d, x = m.variable("f55_u", ()), m.variable("f55_d", ()), m.variable("f55_x", ())
    return m.minmax(objective=x ** 2 - 2 * (d + 2) ** 2, minOptimizationVariables=[u],
                    maxOptimizationVariables=[d, x], minConstraints=[u >= -2.0, u <= 2.0],
                    maxConstraints=[d >= -1.0, d <= 1.0, x == u + d], **kw)


def _same_elimination(monkeypatch):
    """The port's dense fleet adapter as the JAX package's runs it on the
    CPU: one instance through kkt/dense.py's blocked LDL^T (bitwise with
    the JAX package's ``ldl_factor`` and ``ldl_solve``, clamp 1e-7) in
    place of K8's and K7's plain versions, and the scale through the JAX
    package's own float32 ``lax.rsqrt`` (XLA's CPU rsqrt, which is off
    in the last bit on some rows: 0.9486833 for 1/sqrt(1.1111112) on
    this game's first KKT) in place of the correctly rounded one."""
    import jax
    from jax import lax

    from tenscalc_tpu_torch.kkt import dense as tdense

    def factor_solve(A, b):
        L, d = tdense.ldl_factor(A, clamp=1e-7)
        return L, d, tdense.ldl_solve(L, d, b)

    rsqrt = jax.jit(lambda v: lax.rsqrt(jax.numpy.maximum(v, 1e-30)))
    monkeypatch.setattr(tfl, "fleet_ldl_factor_solve", factor_solve)
    monkeypatch.setattr(tfl, "fleet_ldl_solve", tdense.ldl_solve)
    monkeypatch.setattr(tfl, "fleet_ldl_factor", lambda A: tdense.ldl_factor(A, clamp=1e-7))
    monkeypatch.setattr(tfl, "equilibration_scale",
                        lambda v: torch.from_numpy(np.array(rsqrt(v.numpy()))))


def _record_jax_adapter(monkeypatch, calls):
    """Each JAX fleet adapter's WW and scale, and each of its float32
    solves (the first, fused with the factor, and the refinements'):
    right-hand side, result and the factor's d, in the order the jitted
    solver makes them."""
    import jax

    import tenscalc_tpu.kkt.fleet as jfl

    class Recorded(jfl.FleetLDLFactorization):
        def __init__(self, WW, n_refine=2):
            super().__init__(WW, n_refine)
            jax.debug.callback(
                lambda W, s: calls.append({"WW": np.asarray(W), "s": np.asarray(s),
                                           "solves": []}), WW, self.s)

        def _solve32(self, rhs):
            y = super()._solve32(rhs)
            jax.debug.callback(lambda r, y, d: calls[-1]["solves"].append(
                tuple(np.asarray(a) for a in (r, y, d))), rhs, y, self.d)
            return y

    monkeypatch.setattr(jfl, "fleet_kkt_factorize", lambda WW, n_refine=2: Recorded(WW, n_refine))


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def test_small_game_takes_the_fleet_dense_route(monkeypatch):
    """nK = 8 < 64: the fleet dense LDL^T (one instance: K8's and K7's
    plain versions; float32 factor, clamp 1e-7, one float64 refinement),
    the HessD inertia from the dense LDL^T, on both sides.  On this game
    both end at status 232 (8 | 32 | 64 | 128) after 201 iterations: the
    clamp lifts u's pivot (addU, ~1e-9, with a zero Hessian) to 1e-7, and
    the refined directions never reach the saddle point.  Held: the same
    route, status and iterations, and the port's scale correctly rounded.

    The final iterate is no property of the algorithm: through the 1e7
    that the clamped pivot puts into the factor, a last-bit change moves
    it by up to 1e-3 within two iterations.  On the CPU the JAX package
    factors one instance with its blocked ``ldl_factor`` and the port
    with K8's plain version: given the same KKT matrix, scale and
    right-hand side, their first d already differ by 1.0.  So the
    iterates are held where both sides run the same elimination
    (:func:`_same_elimination`): every scaled KKT matrix of the JAX solve
    gives the same factor and float32 solves in the port as in the JAX
    package's ``ldl_factor`` and ``ldl_solve``, bit for bit; the two
    solves are bitwise equal through two iterations (then a float64
    residual, summed in another order, parts them by one unit in the
    last place, and from the third iteration on they are up to 2.4e-3
    apart); and over the whole solve they end with the same status and
    iterations and final iterates 4.08e-5 apart, held to 5e-5."""
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    jax_calls = []
    _record_jax_adapter(monkeypatch, jax_calls)
    jtc.expr.clear_variables()
    sj = _case55(jtc)
    st = _case55(ttc, device="cpu")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet"
    assert st.kkt_plan is None and st._solve_raw.band_mode is None
    ldl_calls = []
    from tenscalc_tpu_torch.ipm import minmax as tmm

    real = tmm.ldl_factor

    def spy(A, block=64, clamp=0.0):
        ldl_calls.append(tuple(A.shape))
        return real(A, block, clamp)

    monkeypatch.setattr(tmm, "ldl_factor", spy)
    init = {"f55_u": 0.1, "f55_d": 0.1, "f55_x": 0.1}
    sol_j = sj.solve({}, init=init, mu0=1.0, max_iter=200)
    sol_t = st.solve({}, init=init, mu0=1.0, max_iter=200)
    assert sol_t.status == sol_j.status == 232
    assert sol_t.iters == sol_j.iters == 201
    for v in sol_t.variables.values():
        assert np.isfinite(np.asarray(v)).all()
    # the HessD (nD + nGd + nFd = 5) of every trip went to ldl_factor
    assert ldl_calls and set(ldl_calls) == {(1, 5, 5)}
    # the port's scale is correctly rounded on every KKT matrix of the JAX
    # solve; XLA's CPU rsqrt, the JAX package's, is not on some
    assert len(jax_calls) > 200
    misrounded = 0
    for k, call in enumerate(jax_calls):
        WW = torch.from_numpy(call["WW"].copy())[None]
        norm = np.abs(call["WW"].astype(np.float32)).max(axis=-1)
        want = (1.0 / np.sqrt(np.maximum(norm, np.float32(1e-30)).astype(np.float64)))
        own = tfl.FleetLDLFactorization(WW).s[0].numpy()
        assert np.array_equal(_bits(own), _bits(want.astype(np.float32))), k
        misrounded += int((_bits(own) != _bits(call["s"])).any())
    assert misrounded > 0
    # the same elimination: each adapter call's scaled matrix through the
    # port's float32 factor and solves and through the JAX package's
    # ldl_factor and ldl_solve (jitted on their own), bit for bit; the
    # refinements' float64 residuals are formed apart (their
    # matrix-vector products summed in other orders), so each solve takes
    # the JAX solve's own right-hand side
    import jax

    from tenscalc_tpu.kkt import dense as jdense

    jfactor = jax.jit(lambda A: jdense.ldl_factor(A, clamp=1e-7))
    jsolve = jax.jit(jdense.ldl_solve)
    _same_elimination(monkeypatch)
    in_solver = []  # whether the JAX solve's own values are the same bits
    for k, call in enumerate(jax_calls):
        fact = tfl.FleetLDLFactorization(torch.from_numpy(call["WW"].copy())[None])
        assert np.array_equal(_bits(fact.s[0].numpy()), _bits(call["s"])), k
        L, d = jfactor(fact._Ws[0].numpy())
        same = True
        for r, y_run, _ in call["solves"]:
            rhs = torch.from_numpy(r.copy())[None]
            got = fact._solve32(rhs)[0]
            bs = (fact.s * rhs.to(torch.float32))[0].numpy()
            want = fact.s[0] * torch.from_numpy(np.asarray(jsolve(L, d, bs)).copy())
            assert np.array_equal(_bits(got.numpy()), _bits(want.numpy())), k
            same &= np.array_equal(_bits(got.numpy()), _bits(y_run))
        assert np.array_equal(_bits(fact.d[0].numpy()), _bits(np.asarray(d))), k
        in_solver.append(same)
    # the JAX solve compiles its adapter into one program, where XLA may
    # fuse the scaling into the factor and round otherwise (it does from
    # the fourteenth call on): its own values are the same bits through
    # the first 13 calls
    assert all(in_solver[:13])
    # ... and the two solves, bitwise through two iterations
    for it in (1, 2):
        a = sj.solve({}, init=init, mu0=1.0, max_iter=it)
        b = st.solve({}, init=init, mu0=1.0, max_iter=it)
        assert (a.status, a.iters) == (b.status, b.iters)
        for k, v in a.variables.items():
            assert np.array_equal(_bits(np.asarray(b.variables[k])), _bits(np.asarray(v))), k
    # ... and over the whole solve: the same status and iterations, the
    # final iterate within 5e-5 of the JAX package's
    sol_s = st.solve({}, init=init, mu0=1.0, max_iter=200)
    assert (sol_s.status, sol_s.iters) == (sol_j.status, sol_j.iters) == (232, 201)
    for k, v in sol_j.variables.items():
        np.testing.assert_allclose(sol_s.variables[k], v, rtol=0, atol=5e-5, err_msg=k)


def _few_maximizers(m, **kw):
    """The chain with 4 maximizer variables: HessD (m = 12) below the
    banded plan's threshold of 32 rows, so the band-mode solver takes the
    HessD inertia from the dense LDL^T of its hoisted blocks."""
    u, d, p = m.variable("fm_u", (N,)), m.variable("fm_d", (4,)), m.parameter("fm_p", (N,))
    sq = m.norm2 if m is jtc else (lambda e: (e * e).sum())
    f = sq(u - p) + 2.0 * sq(u[1:] - u[:-1]) + u[:4] @ d - sq(d)
    return m.minmax(objective=f, minOptimizationVariables=[u], maxOptimizationVariables=[d],
                    minConstraints=[u >= -2.0, u <= 2.0], maxConstraints=[d >= -2.0, d <= 2.0],
                    parameters=[p], **kw)


def test_band_mode_with_dense_hessd_matches_jax(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    jtc.expr.clear_variables()
    sj, st = _few_maximizers(jtc), _few_maximizers(ttc, device="cpu")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st._solve_raw.band_mode == sj._solve_raw._band_mode == "hoisted"
    assert st._solve_raw.hessd_banded is sj._solve_raw._hessd_banded is False
    rng = np.random.default_rng(0)
    fleet = {"fm_p": 0.5 * rng.standard_normal((3, N))}
    inits = {"fm_u": np.zeros((3, N)), "fm_d": np.zeros((3, 4))}
    res_j = sj.solve_many(fleet, inits=inits)
    res_t = st.solve_many(fleet, inits=inits)
    assert (res_t.status.numpy() == 0).all() and (np.asarray(res_j.status) == 0).all()
    np.testing.assert_array_equal(res_t.iters.numpy(), np.asarray(res_j.iters))
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u), atol=U_ATOL_F64)
