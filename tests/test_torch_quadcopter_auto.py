"""The quadcopter (examples/mpc_quadcopter, T = 6, the large Newton
matrix: nK = 90, RCM w = 25) solved on ``'auto'`` by the JAX package
with ``TENSCALC_AUTO_FLEET=1`` and by the port (``fleet_banded``: the
dense KKT to K1/K2's plain versions on the CPU), in float64 here and in
float32 in tests/test_torch_quadcopter_f32.py.

The factor of this KKT has pivots that the clamp decides, and a
last-bit change anywhere moves the IPM's path: the JAX package alone,
from the hover init moved by 1e-6 (six draws, float32), ends in 42–86
iterations or at the iteration limit (two of six), and its iteration
count moves from 44 to 59 when its equilibration's rsqrt (XLA's, not
correctly rounded) is replaced by the correctly rounded one the port
uses.  So the packages are held to the same answer, not the same path:
status 0 on both, and in float64 p within 1e-6, u and the slack within
1e-5 (the stopping tolerances bound the thrust less tightly than the
positions), J within 1e-8 relative; in float32 p, u and the slack within
2e-3 and J within 1e-3 relative.  The iteration counts are printed."""

import numpy as np

from test_torch_quadcopter import T, build_pair, jax_fleet_env, jq  # noqa: F401

NS = "tqa_"


def _same_answer(a, b, p_tol, u_tol, f_tol):
    assert a.status == b.status == 0, (a.status, b.status)
    for k, tol in (("p", p_tol), ("u", u_tol), ("positive2", u_tol)):
        np.testing.assert_allclose(np.asarray(b.variables[NS + k]),
                                   np.asarray(a.variables[NS + k]), rtol=0, atol=tol,
                                   err_msg=k)
    J_a, J_b = float(np.asarray(a.outputs["J"])), float(np.asarray(b.outputs["J"]))
    assert abs(J_a - J_b) <= f_tol * abs(J_a), (J_a, J_b)


def auto_solves_reach_the_same_answer(dtype, tols):
    sj, st = build_pair(dtype, NS)
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet_banded"
    params, init = jq.default_params(NS), jq.hover_init(T, NS)
    a = sj.solve(params, init=init, mu0=0.1, max_iter=300)
    b = st.solve(params, init=init, mu0=0.1, max_iter=300)
    print(f"{dtype} iterations: JAX {a.iters}, port {b.iters}")
    _same_answer(a, b, *tols)


def test_auto_solve_reaches_the_jax_answer_f64(jax_fleet_env):  # noqa: F811
    auto_solves_reach_the_same_answer("float64", (1e-6, 1e-5, 1e-8))
