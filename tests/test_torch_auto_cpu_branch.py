"""``kkt_backend='auto'`` under ``TENSCALC_AUTO_FLEET=0``, the JAX
package's non-fleet branch, against the JAX package's own resolution on
the same problems (tests/test_planner.py, tests/test_auto_backend.py:71-94,
tests/test_game_backends.py): the Sysid of test_planner.py:44 resolves
to 'arrow'; dist2convex, the Lasso and slseq to 'dense'; l1l2 and mls
to 'tridiag' (l1l2 with the planner's report line equal to JAX's); a
problem below 64 KKT rows to 'dense'.  The game solvers' branch is in
tests/test_torch_auto_cpu_branch_games.py, the unchanged fleet branch
in tests/test_torch_auto_fleet_unchanged.py, and the float32 l1l2 of
tests/test_f32_robustness.py:50 on 'tridiag' in
tests/test_torch_tridiag.py."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import dist2convex as jd2c  # noqa: E402
from examples import l1l2estimation as jl12  # noqa: E402
from examples import mls as jmls  # noqa: E402
from examples import slseq as jslseq  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import dist2convex as td2c  # noqa: E402
from tenscalc_tpu_torch.examples import l1l2estimation as tl12  # noqa: E402
from tenscalc_tpu_torch.examples import mls as tmls  # noqa: E402
from tenscalc_tpu_torch.examples import slseq as tslseq  # noqa: E402

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "0")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _sysid(tc, **kw):
    return tc.Sysid(
        f=lambda x, u, a, b: a * x + b * u, g=lambda x, a, b: x,
        n_states=1, n_outputs=1, n_inputs=1, horizon=40,
        parameters=[tc.ParameterSpec("a", (), lower=0.0, upper=1.0),
                    tc.ParameterSpec("b", (), lower=-2.0, upper=2.0)],
        **kw,
    ).solver


def _small(tc, **kw):
    x = tc.variable("acb_x", (6,))
    d = x - 1.0
    return tc.optimize((d * d).sum(), [x], constraints=[x >= -2.0, x <= 2.0], **kw)


CASES = {
    "sysid": ("arrow", lambda: _sysid(jtc), lambda: _sysid(ttc, **CPU)),
    "dist2convex": ("dense", lambda: jd2c.build_solver(N=60, d=9),
                    lambda: td2c.build_solver(N=60, d=9, **CPU)),
    "lasso": ("dense", lambda: jtc.Lasso(n_features=8, n_points=60).solver,
              lambda: ttc.Lasso(n_features=8, n_points=60, **CPU).solver),
    "slseq": ("dense", lambda: jslseq.build_solver(N=200, n=60, m=8),
              lambda: tslseq.build_solver(N=200, n=60, m=8, **CPU)),
    "l1l2": ("tridiag", lambda: jl12.build_l1l2(N=60), lambda: tl12.build_l1l2(N=60, **CPU)),
    "mls": ("tridiag", lambda: jmls.build_solver(N=40, n=24, k=12),
            lambda: tmls.build_solver(N=40, n=24, k=12, **CPU)),
    "small": ("dense", lambda: _small(jtc), lambda: _small(ttc, **CPU)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resolution_matches_jax(case, capsys):
    want, make_jax, make_port = CASES[case]
    sj = make_jax()
    st = make_port()
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == want
    pj, pt = sj.kkt_plan, st.kkt_plan
    assert (pj is None) == (pt is None)
    if want in ("tridiag", "tridiag_lu"):
        np.testing.assert_array_equal(pt.perm, pj.perm)
        assert (pt.block, pt.n_blocks, pt.worthwhile) == (pj.block, pj.n_blocks, True)
    if want == "arrow":
        np.testing.assert_array_equal(pt.arrow, pj.arrow)
    if case == "l1l2":
        # the planner's report line (tests/test_planner.py::test_verbose_plan_report)
        capsys.readouterr()
        for s in (sj, st):
            s.opts = s.opts.replace(verboseLevel=2)
            s._report_kkt_plan()
        lj, lt = capsys.readouterr().out.strip().splitlines()
        assert lt == lj and "backend=tridiag" in lt and "bandwidth=" in lt
