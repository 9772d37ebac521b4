"""``flop_counts`` (M17) against the JAX package's: the same dict on
tests/test_profiling.py's least squares (the dense LU in both packages,
``TENSCALC_AUTO_FLEET=0``) and on mpc_dcmotor at T = 30 on
'fleet_banded', with test_profiling.py's assertions."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_dcmotor as jmpc  # noqa: E402
from tenscalc_tpu.profiling import flop_counts as jflop_counts  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch import profiling as tprof  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_dcmotor as tmpc  # noqa: E402
from test_torch_tooling import CPU, _ls  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def test_flop_counts_equal_jax_least_squares(monkeypatch):
    """test_profiling.py::test_flop_counts_phases."""
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "0")
    js, _, _ = _ls(jtc)
    ts, _, _ = _ls(ttc, **CPU)
    c = tprof.flop_counts(ts)
    assert c == jflop_counts(js)
    nK = ts.nU + ts.nG + (0 if ts.opts.smallerNewtonMatrix else ts.nF)
    assert c["kkt_size"] == nK and c["factorization"] == 2 * nK ** 3 / 3
    assert c["hessian"] == 0.0 and c["ineq_jacobian"] == 0.0
    assert c["total_per_iteration"] > c["factorization"]


def test_flop_counts_equal_jax_mpc_dcmotor():
    """test_profiling.py::test_flop_counts_banded_backend_scales_linearly."""
    kw = dict(T=30, namespace="pfb_", dtype="float32", variant="standard",
              smallerNewtonMatrix=True, kkt_backend="fleet_banded")
    jb, tb = jmpc.build_solver(**kw), tmpc.build_solver(**kw, **CPU)
    assert tb.kkt_backend_resolved == "fleet_banded"
    c = tprof.flop_counts(tb)
    assert c == jflop_counts(jb)
    assert c["factorization"] < 0.02 * (2 * c["kkt_size"] ** 3 / 3)
