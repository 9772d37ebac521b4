"""The quadcopter at T = 6 with the large Newton matrix on ``'auto'`` in
float32, the JAX package (``TENSCALC_AUTO_FLEET=1``) against the port:
status 0 on both, p, u and the slack within 2e-3, J within 1e-3
relative; tests/test_torch_quadcopter_auto.py says why the paths (the
iteration counts, printed) are not compared."""

from test_torch_quadcopter import jax_fleet_env  # noqa: F401
from test_torch_quadcopter_auto import auto_solves_reach_the_same_answer


def test_auto_solve_reaches_the_jax_answer_f32(jax_fleet_env):  # noqa: F811
    auto_solves_reach_the_same_answer("float32", (2e-3, 2e-3, 1e-3))
