"""The flagship at T = 14 on ``kkt_backend='cyclic'`` (block cyclic
reduction, ``kkt/cyclic.py``) in float64 against the JAX package's
'cyclic' (oracle: tests/test_cyclic.py::test_mpc_solver_with_cyclic_backend):
status 0 on both sides, iterations within one, u within 2e-3,
tests/test_cyclic.py's own tolerance for this backend.  The odd/even
elimination order amplifies rounding on the IPM's ill-conditioned
endgame KKTs (the module note of the JAX package's cyclic.py), so a
last-bit difference in a product (the CPU's BLAS with one thread or two
moves the port's own answer by 1e-5) moves the final iterate by up to
1e-4 even in float64, in both packages."""

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
# tests/test_torch_tridiag_ipm.py's start (mu0 = 1, where both packages'
# tridiag solves follow one path)
MU0 = 1.0


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def test_flagship_on_cyclic_matches_jax():
    ns = "tcy_"
    jtc.expr.clear_variables()
    sj = jmpc.build_solver(T=T, namespace=ns, kkt_backend="cyclic")
    st = tmpc.build_solver(T=T, namespace=ns, kkt_backend="cyclic", device="cpu")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "cyclic"
    params = dict(jmpc.default_params(T, ns))
    params[ns + "ref"] = jmpc.reference_signal(np.arange(T) * 0.1)[None, :]
    params[ns + "xinit"] = np.array([[0.2], [0.2]])
    r = np.random.default_rng(0)
    init = {ns + "x": params[ns + "xinit"] + 0.01 * r.random((2, T)),
            ns + "u": 0.01 * r.random((1, T - 1))}
    s1 = sj.solve(params, init=init, mu0=MU0, max_iter=100)
    s2 = st.solve(params, init=init, mu0=MU0, max_iter=100)
    assert s1.status == s2.status == 0
    assert abs(s2.iters - s1.iters) <= 1
    np.testing.assert_allclose(s2.variables[ns + "u"], s1.variables[ns + "u"],
                               rtol=0, atol=2e-3)
