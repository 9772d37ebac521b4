"""The game solvers' ``kkt_backend='auto'`` under ``TENSCALC_AUTO_FLEET=0``
against the JAX package's own resolution (tests/test_game_backends.py):
the min-max chain resolves to 'tridiag' and the MPC-MHE game
(T = 6, L = 8) to 'tridiag_lu'.  With the variable '1' or unset nothing
changes (tests/test_torch_auto_fleet_unchanged.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpcmhe_dcmotor as jmm  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpcmhe_dcmotor as tmm  # noqa: E402
from test_torch_auto_cpu_branch import CPU  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "0")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _chain(tc, n=40, **kw):
    """tests/test_game_backends.py's min-max chain."""
    u, d, p = tc.variable("acm_u", (n,)), tc.variable("acm_d", (n,)), tc.parameter("acm_p", (n,))
    sq = (lambda e: (e * e).sum())
    f = sq(u - p) + 2.0 * sq(u[1:] - u[:-1]) + u @ d - sq(d)
    return tc.minmax(objective=f, minOptimizationVariables=[u], maxOptimizationVariables=[d],
                     minConstraints=[u >= -2.0, u <= 2.0], maxConstraints=[d >= -2.0, d <= 2.0],
                     parameters=[p], **kw)


CASES = {
    "minmax_chain": ("tridiag", lambda: _chain(jtc), lambda: _chain(ttc, **CPU)),
    "mpcmhe_game": ("tridiag_lu", lambda: jmm.build_solver(T=6, L=8, ns="acg_"),
                    lambda: tmm.build_solver(T=6, L=8, ns="acg_", **CPU)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_game_resolution_matches_jax(case):
    want, make_jax, make_port = CASES[case]
    sj, st = make_jax(), make_port()
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == want
    np.testing.assert_array_equal(st.kkt_plan.perm, sj.kkt_plan.perm)
    assert (st.kkt_plan.block, st.kkt_plan.n_blocks) == (sj.kkt_plan.block, sj.kkt_plan.n_blocks)
