"""The IPM on ``kkt_backend='tridiag'`` (the block-tridiagonal LDL^T of
``kkt/tridiag.py``) against the JAX package's 'tridiag' on the same
inputs (oracles: tests/test_tridiag.py, tests/test_game_backends.py):
the flagship at T = 14 (float64: iterations equal, u within 1e-8;
float32: iterations within one, u within 2e-3) and the min-max chain of
tests/test_game_backends.py (n = 40, float64: iterations equal, u
within 1e-6)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_dcmotor as jmpc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_dcmotor as tmpc  # noqa: E402

torch.set_num_threads(1)

T = 14
N_CHAIN = 40
# From mu0 = 1e-3 these inputs take short steps whose line-search
# decisions at the boundary follow the last bits: the JAX package's own
# 'dense' and 'tridiag' solves part there (objectives 5e-7 apart), and
# so do the two packages; from mu0 = 1 both packages follow one path.
MU0 = 1.0


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _flagship_inputs(ns):
    params = dict(jmpc.default_params(T, ns))
    params[ns + "ref"] = jmpc.reference_signal(np.arange(T) * 0.1)[None, :]
    params[ns + "xinit"] = np.array([[0.2], [0.2]])
    r = np.random.default_rng(0)
    init = {ns + "x": params[ns + "xinit"] + 0.01 * r.random((2, T)),
            ns + "u": 0.01 * r.random((1, T - 1))}
    return params, init


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flagship_on_tridiag_matches_jax(dtype):
    ns = "ttd_"
    jtc.expr.clear_variables()
    sj = jmpc.build_solver(T=T, namespace=ns, dtype=dtype, kkt_backend="tridiag")
    st = tmpc.build_solver(T=T, namespace=ns, dtype=dtype, kkt_backend="tridiag",
                           device="cpu")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "tridiag"
    np.testing.assert_array_equal(st.kkt_plan.perm, sj.kkt_plan.perm)
    params, init = _flagship_inputs(ns)
    s1 = sj.solve(params, init=init, mu0=MU0, max_iter=100)
    s2 = st.solve(params, init=init, mu0=MU0, max_iter=100)
    assert s1.status == s2.status == 0, (s1.describe(), s2.describe())
    if dtype == "float64":
        assert s2.iters == s1.iters
        np.testing.assert_allclose(s2.variables[ns + "u"], s1.variables[ns + "u"],
                                   rtol=0, atol=1e-8)
    else:
        assert abs(s2.iters - s1.iters) <= 1
        np.testing.assert_allclose(s2.variables[ns + "u"], s1.variables[ns + "u"],
                                   rtol=0, atol=2e-3)


def _chain(m, ns, **kw):
    """tests/test_game_backends.py's chain-coupled saddle problem."""
    n = N_CHAIN
    u, d, p = m.variable(ns + "u", (n,)), m.variable(ns + "d", (n,)), m.parameter(ns + "p", (n,))
    sq = m.norm2 if m is jtc else (lambda e: (e * e).sum())
    f = sq(u - p) + 2.0 * sq(u[1:] - u[:-1]) + u @ d - sq(d)
    return m.minmax(objective=f, minOptimizationVariables=[u], maxOptimizationVariables=[d],
                    minConstraints=[u >= -2.0, u <= 2.0], maxConstraints=[d >= -2.0, d <= 2.0],
                    parameters=[p], **kw)


def test_minmax_chain_on_tridiag_matches_jax():
    ns = "tmt_"
    jtc.expr.clear_variables()
    sj = _chain(jtc, ns, kkt_backend="tridiag")
    st = _chain(ttc, ns, kkt_backend="tridiag", device="cpu")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "tridiag"
    pv = 0.5 * np.random.default_rng(0).standard_normal(N_CHAIN)
    args = dict(parameters={ns + "p": pv},
                init={ns + "u": np.zeros(N_CHAIN), ns + "d": np.zeros(N_CHAIN)}, mu0=1.0)
    s1, s2 = sj.solve(**args), st.solve(**args)
    assert s1.status == s2.status == 0
    assert s2.iters == s1.iters
    np.testing.assert_allclose(s2.variables[ns + "u"], s1.variables[ns + "u"],
                               rtol=0, atol=1e-6)
