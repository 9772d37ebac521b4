"""``kkt_backend='auto'`` with ``TENSCALC_AUTO_FLEET`` '1' or unset: the
fleet backends on every device, as before the variable's '0' branch was
ported (the JAX package's TPU branch): the flagship on 'fleet_banded', a
problem below 64 KKT rows on 'fleet', the min-max chain on
'fleet_banded' and the MPC-MHE game on 'fleet_banded_lu'."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_dcmotor as tmpc  # noqa: E402
from tenscalc_tpu_torch.examples import mpcmhe_dcmotor as tmm  # noqa: E402
from test_torch_auto_cpu_branch import CPU, _small  # noqa: E402
from test_torch_auto_cpu_branch_games import _chain  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


@pytest.mark.parametrize("env", ["1", None])
def test_fleet_branch_unchanged(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("TENSCALC_AUTO_FLEET", raising=False)
    else:
        monkeypatch.setenv("TENSCALC_AUTO_FLEET", env)
    assert tmpc.build_solver(T=14, namespace="acf_", **CPU).kkt_backend_resolved == "fleet_banded"
    assert _small(ttc, **CPU).kkt_backend_resolved == "fleet"
    assert _chain(ttc, **CPU).kkt_backend_resolved == "fleet_banded"
    assert tmm.build_solver(T=6, L=8, ns="acg_", **CPU).kkt_backend_resolved == \
        "fleet_banded_lu"
