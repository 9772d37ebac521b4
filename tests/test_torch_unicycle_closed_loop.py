"""The nonlinear unicycle's receding-horizon loop (``run_closed_loop`` of
``examples/mpc_unicycle.py`` at T = 10) over three steps on
``kkt_backend='dense'`` in float64 against the JAX package's: every solve
at status 0 in the same iterations, the plant's states and the applied
controls within 1e-8."""

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_unicycle as jm  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_unicycle as tm  # noqa: E402

torch.set_num_threads(1)

T, NS, STEPS = 10, "ucl_", 3
ATOL = 1e-8


def test_closed_loop_matches_jax():
    jtc.expr.clear_variables()
    ttc.clear_variables()
    sj = jm.build_solver(T=T, ns=NS, dtype="float64", kkt_backend="dense")
    st = tm.build_solver(T=T, ns=NS, dtype="float64", kkt_backend="dense", device="cpu")
    hj = jm.run_closed_loop(sj, n_steps=STEPS)
    ht = tm.run_closed_loop(st, n_steps=STEPS)
    assert list(ht["status"]) == [0] * STEPS
    np.testing.assert_array_equal(ht["status"], hj["status"])
    np.testing.assert_array_equal(ht["iters"], hj["iters"])
    for k in ("x", "u", "dist"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=ATOL, err_msg=k)
    ttc.clear_variables()
