"""The nonlinear MPC-MHE pursuit game (examples/mpcmhe_unicycle: T = 5,
L = 4; nK = 177, RCM w = 22) against the JAX package on the fleet banded
LU (``TENSCALC_AUTO_FLEET=1``, K9/K10 in interpret mode on its side,
their plain versions on the port's): the plan, the backend and the band
mode (None: every Jacobian depends on the iterate, so the KKT is
assembled densely at every iterate), and the closed loop's first game
solve in float64 (iterations equal, uFuture within 1e-8, the objective
within 1e-8 relative).  tests/test_torch_mpcmhe_unicycle_f32.py holds
the float32 solve, tests/test_torch_mpcmhe_unicycle_fleet.py a fleet.

The JAX package probes the KKT pattern with eager operations, each
compiled at its first call (~35 s a dtype on the CPU); the JAX side here
probes through its own ``_assemble_ww`` under ``jax.jit`` instead, with
``_probe_assemble``'s random inputs, and the port's plan is held to the
plan that gives."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpcmhe_unicycle as jmu  # noqa: E402
from tenscalc_tpu.kkt import select as jselect  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpcmhe_unicycle as tmu  # noqa: E402

torch.set_num_threads(1)

T, L = 5, 4
NS = "tu_"
U_ATOL_F64 = 1e-8


def _jit_probe(assemble_trial, nK):
    """The JAX package's structure probe with ``_assemble_ww`` compiled
    once: the same random iterates as ``_probe_assemble``, the same
    pattern and plan."""
    solver = assemble_trial.__self__
    assemble = jax.jit(lambda *a: solver._solve_raw._assemble_ww(*a)["WW"])
    dt = solver.opts.np_dtype
    nUu, nD, nX, nFu, nFd, nGu, nGd, nH = solver._ipm_dims

    def trial(t):
        rng = np.random.default_rng(t)
        penv = {p.name: jnp.asarray(rng.standard_normal(p.shape), dt)
                for p in solver.parameters}
        z = jnp.asarray(rng.standard_normal(nUu + nD + nX), dt)
        lam = jnp.asarray(rng.uniform(0.5, 1.5, nFu + nFd), dt)
        nu = jnp.asarray(rng.standard_normal(nGu + nH + nGd + nH), dt)
        return assemble(z, nu, lam, penv, jnp.ones((nFu,), dt), jnp.ones((nFd,), dt),
                        jnp.ones((), dt), jnp.asarray(1e-3, dt), jnp.asarray(1e-3, dt))

    from tenscalc_tpu.kkt.structure import plan_banded, probe_pattern

    return plan_banded(probe_pattern(trial, nK))


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


@pytest.fixture(scope="module")
def jax_fleet_env():
    mp = pytest.MonkeyPatch()
    mp.setenv("TENSCALC_AUTO_FLEET", "1")
    mp.setattr(jselect, "compute_banded_plan", _jit_probe)
    yield
    mp.undo()


def build_pair(dtype, ns, **opts):
    """(JAX solver, port solver) of the game."""
    jtc.expr.clear_variables()
    sj = jmu.build_solver(T=T, L=L, ns=ns, dtype=dtype, **opts)
    st = tmu.build_solver(T=T, L=L, ns=ns, dtype=dtype, device="cpu", **opts)
    return sj, st


def first_game_solve(sj, max_iter=300):
    """The closed loop's first game solve by the JAX package
    (run_closed_loop over L + 1 steps): its inputs and its solution."""
    seen = []
    solve = sj.solve

    def recording(params, init=None, **kw):
        sol = solve(params, init=init, **kw)
        seen.append((params, init, kw, sol))
        return sol

    sj.solve = recording
    try:
        jmu.run_closed_loop(sj, n_steps=L + 1, seed=0, max_iter=max_iter)
    finally:
        del sj.solve
    assert len(seen) == 1
    return seen[0]


@pytest.fixture(scope="module")
def f64(jax_fleet_env):
    return build_pair("float64", NS + "d_")


def test_plan_backend_and_band_mode_match_jax(f64):
    sj, st = f64
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet_banded_lu"
    assert sj._solve_raw._band_mode is None and st._solve_raw.band_mode is None
    assert st._ipm_dims == sj._ipm_dims
    assert st.kkt_plan.n == sj.kkt_plan.n == 177
    assert st.kkt_plan.bandwidth == sj.kkt_plan.bandwidth == 22
    np.testing.assert_array_equal(st.kkt_plan.perm, sj.kkt_plan.perm)
    assert not any(st.certificates[k] for k in ("hoist_S", "hoist_Gz", "hoist_Fz"))


def test_first_solve_float64_matches_jax(f64):
    sj, st = f64
    params, init, kw, sol_j = first_game_solve(sj)
    sol_t = st.solve(params, init=init, **kw)
    assert sol_j.status == 0 and sol_t.status == 0, sol_t.describe()
    assert sol_t.iters == sol_j.iters
    np.testing.assert_allclose(sol_t.outputs["uFuture"], np.asarray(sol_j.outputs["uFuture"]),
                               rtol=0, atol=U_ATOL_F64)
    np.testing.assert_allclose(sol_t.objective, sol_j.objective, rtol=1e-8)
