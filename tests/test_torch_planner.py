"""The port's build-time planning held against the JAX package's: the
hoist certificate (iteration invariance, scale freedom, parameter-value
dependencies) and the RCM banded plan of the flagship KKT."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_dcmotor as jmpc  # noqa: E402
from tenscalc_tpu import native as jnative  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch import native as tnative  # noqa: E402
from tenscalc_tpu_torch.api import problem_functions  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_dcmotor as tmpc  # noqa: E402
from tenscalc_tpu_torch.ipm.hoist import (  # noqa: E402
    analyze_hoistable,
    output_independent_of,
)

torch.set_num_threads(1)
T = 14


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


@pytest.fixture(scope="module")
def flagship(monkeypatch_module):
    monkeypatch_module.setenv("TENSCALC_AUTO_FLEET", "1")
    sj = jmpc.build_solver(T=T, namespace="tp_", dtype="float32")
    st = tmpc.build_solver(T=T, namespace="tp_", dtype="float32", device="cpu")
    return sj, st


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_hoist_certificate_matches_jax(flagship):
    sj, st = flagship
    assert st._hoist == sj._hoist == (True, True, True)
    assert st._hoist_scale_free is True and sj._hoist_scale_free is True
    assert tuple(st._hoist_param_deps) == tuple(sj._hoist_param_deps)


def test_banded_plan_matches_jax(flagship):
    sj, st = flagship
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet_banded"
    assert sj._solve_raw._band_mode == st._solve_raw.band_mode == "hoisted"
    pj, pt = sj._band_plan, st.kkt_plan
    np.testing.assert_array_equal(pt.perm, pj.perm)
    np.testing.assert_array_equal(pt.iperm, pj.iperm)
    assert (pt.bandwidth, pt.worthwhile, pt.block, pt.n_blocks, pt.n) == (
        pj.bandwidth, pj.worthwhile, pj.block, pj.n_blocks, pj.n
    ) == (4, True, 4, 18, 69)


def test_rcm_binding_matches_jax():
    rng = np.random.default_rng(0)
    n = 90
    a = rng.random((n, n)) < 0.04
    pattern = a | a.T
    perm = tnative.rcm(pattern)
    np.testing.assert_array_equal(perm, jnative.rcm(pattern))
    assert tnative.bandwidth(pattern, perm) == jnative.bandwidth(pattern, perm)


def _chain_quartic(mod, ns, n=80):
    x = mod.variable(ns + "x", (n,))
    p = mod.parameter(ns + "p", (n,))
    J = ((x - p) ** 2).sum() + ((x[1:] - x[:-1]) ** 4).sum()
    return J, x, p


def test_certificate_rejects_nonquadratic_in_both():
    """The chain quartic's Hessian depends on x: neither package hoists
    it, so the port's certificate is not vacuous."""
    J, x, p = _chain_quartic(ttc, "tq_")
    fns, packing, nF, nG = problem_functions(
        J, [x], [x >= -2.0, x <= 2.0], [p], torch.float32
    )
    hoist_t = analyze_hoistable(fns, packing.total, nF, nG, torch.float32,
                                {p.name: p.shape})
    Jj, xj, pj = _chain_quartic(jtc, "jq_")
    sj = jtc.optimize(
        Jj, [xj], constraints=[xj >= -2.0, xj <= 2.0], parameters=[pj],
        dtype="float32", kkt_backend="dense",
    )
    assert hoist_t[0] is False and sj._hoist[0] is False
    # linear bound constraints: the Jacobian is still certified constant
    assert hoist_t[1] is True and sj._hoist[1] is True


def test_certificate_rules():
    """Shape-only factories and x ** 0 carry no value dependency; any
    other use of the tainted input does."""
    u = torch.zeros(5)
    assert output_independent_of(lambda v: torch.ones_like(v) * 3.0, 1, u)
    assert output_independent_of(lambda v: v ** 0, 1, u)
    assert output_independent_of(lambda v: v.new_zeros(2) + 1.0, 1, u)
    assert not output_independent_of(lambda v: v ** 2, 1, u)
    assert not output_independent_of(lambda v: v[1:] * 2.0, 1, u)
    # the second derivative of a quadratic is certified constant
    H = torch.func.jacfwd(torch.func.grad(lambda v: (v ** 2).sum()))
    assert output_independent_of(H, 1, u)
