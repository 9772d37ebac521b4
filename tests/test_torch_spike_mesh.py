"""The mesh paths (``kkt/spike.py``, ``parallel/mesh.py``,
``parallel/batch.py``'s mesh half, ``parallel/scaling.py``) against the
JAX package on the same seeded inputs (its oracles are tests/test_spike.py
and tests/test_parallel.py:83-180).  The port's mesh here is virtual:
eight entries of the CPU, the counterpart of the JAX tests' eight
virtual CPU devices; a mesh of two distinct spellings of the CPU
("cpu" and "cpu:0") drives the gathers between device groups.

Held: the spike solve over 8 chunks against JAX's on its 8-device mesh
(float64, 1e-12 relative) and against numpy; the partition error; a
cached factor reused over several right-hand sides; the IPM on
``kkt_backend='spike'`` (test_ipm_spike_backend_end_to_end's problem,
against JAX: status 0, iterations within one, the objective to 1e-8
relative and u to 1e-6, that test's own tolerances against 'dense': the
float32 factor refined twice leaves the two packages' directions apart
in their last bits, and the endgame's stops follow them); a fleet
split over the mesh equal to the unsplit fleet (iterations equal, u
within 1e-10) and to the JAX package's sharded fleet;
``measure_scaling`` over 1, 2 and 4 devices."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

import tenscalc_tpu as jtc  # noqa: E402
from tenscalc_tpu.kkt.spike import dense_to_blocks as jdense_to_blocks  # noqa: E402
from tenscalc_tpu.kkt.spike import spike_solve as jspike_solve  # noqa: E402
from tenscalc_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from tenscalc_tpu.parallel import solve_batched as jsolve_batched  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt.spike import (  # noqa: E402
    dense_to_blocks,
    spike_apply,
    spike_factor,
    spike_solve,
)
from tenscalc_tpu_torch.parallel import Mesh, make_mesh, virtual_devices  # noqa: E402
from tenscalc_tpu_torch.parallel.scaling import init_distributed, measure_scaling  # noqa: E402

torch.set_num_threads(1)

CPU8 = virtual_devices("cpu", 8)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _block_tridiag_dense(rng, nb, s, saddle=False):
    """tests/test_spike.py's chain (with the KKT-style saddle variant)."""
    n = nb * s
    A = np.zeros((n, n))
    for i in range(nb):
        D = rng.standard_normal((s, s))
        A[i * s:(i + 1) * s, i * s:(i + 1) * s] = D + D.T
        if i > 0:
            Bc = rng.standard_normal((s, s))
            A[i * s:(i + 1) * s, (i - 1) * s:i * s] = Bc
            A[(i - 1) * s:i * s, i * s:(i + 1) * s] = Bc.T
    A += 4 * s * np.eye(n)
    if saddle:
        for i in range(nb):
            sl = slice(i * s + s // 2, (i + 1) * s)
            A[sl, sl] -= 8 * s * np.eye(s - s // 2)
    return A


@pytest.mark.parametrize("nb,s,saddle,against_jax", [
    (16, 4, False, True), (16, 4, True, True), (32, 6, False, False), (64, 3, False, False)])
def test_spike_matches_jax_on_eight_entries(nb, s, saddle, against_jax):
    """Two instances in one batch, each against numpy's solve; the first
    against the JAX package's on its 8-device mesh at the shapes its fast
    tests run (each of its calls compiles for ~20 s)."""
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(nb + s)
    As = np.stack([_block_tridiag_dense(rng, nb, s, saddle) for _ in range(2)])
    b = rng.standard_normal((2, nb * s))
    A_t, B_t = dense_to_blocks(torch.from_numpy(As), s)
    xs = []
    for mesh in (Mesh(CPU8, ("stages",)), Mesh(["cpu", "cpu:0"] * 4, ("stages",))):
        x = spike_solve(A_t, B_t, torch.from_numpy(b).view(2, nb, s), mesh)
        assert x.device.type == "cpu"
        xs.append(x.reshape(2, -1).numpy())
    np.testing.assert_array_equal(xs[0], xs[1])
    for i in range(2):
        np.testing.assert_allclose(xs[0][i], np.linalg.solve(As[i], b[i]), rtol=5e-6, atol=1e-8)
    if against_jax:
        jmesh = JMesh(np.array(jax.devices()), ("stages",))
        Aj, Bj = jdense_to_blocks(jnp.asarray(As[0]), s)
        xj = np.asarray(jspike_solve(Aj, Bj, jnp.asarray(b[0]).reshape(nb, s), jmesh)).reshape(-1)
        np.testing.assert_allclose(xs[0][0], xj, rtol=0, atol=1e-12 * np.abs(xj).max())


def test_spike_rejects_bad_partition():
    mesh = Mesh(CPU8, ("stages",))
    A = torch.zeros(1, 10, 3, 3)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        spike_solve(A, A, torch.zeros(1, 10, 3), mesh)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        spike_solve(torch.zeros(1, 8, 3, 3), torch.zeros(1, 8, 3, 3), torch.zeros(1, 8, 3), mesh)


def test_spike_factor_reused_over_right_hand_sides():
    rng = np.random.default_rng(5)
    nb, s = 16, 4
    A = _block_tridiag_dense(rng, nb, s)
    A_t, B_t = dense_to_blocks(torch.from_numpy(A)[None], s)
    mesh = Mesh(CPU8, ("stages",))
    fac = spike_factor(A_t, B_t, mesh)
    for _ in range(3):
        b = rng.standard_normal(nb * s)
        x = spike_apply(fac, torch.from_numpy(b).view(1, nb, s), mesh).reshape(-1).numpy()
        np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=2e-6, atol=1e-8)


def _spike_problem(m, ns):
    """tests/test_spike.py::test_ipm_spike_backend_end_to_end's MPC-style
    QP (T = 40, n = 2)."""
    T, n = 40, 2
    x = m.variable(ns + "x", (T, n))
    u = m.variable(ns + "u", (T,))
    x0 = m.parameter(ns + "x0", (n,))
    A = np.array([[0.95, 0.1], [0.0, 0.9]])
    Bm = np.array([0.0, 1.0])
    dyn = x[1:] - (x[:-1] @ A.T + u[:-1, None] * Bm)
    sq = m.norm2 if m is jtc else (lambda e: (e * e).sum())
    J = sq(x) + 0.1 * sq(u)
    return J, [x, u], dict(constraints=[dyn == 0, x[0] == x0, u >= -1.0, u <= 1.0],
                           parameters=[x0])


def test_ipm_on_spike_matches_jax():
    ns = "tsp_"
    jtc.expr.clear_variables()
    Jj, vj, cj = _spike_problem(jtc, ns)
    Jt, vt, ct = _spike_problem(ttc, ns)
    jmesh = JMesh(np.array(jax.devices()), ("stages",))
    sj = jtc.optimize(Jj, vj, **cj, kkt_backend="spike", kkt_mesh=jmesh)
    with pytest.raises(ValueError, match="kkt_mesh"):
        ttc.optimize(Jt, vt, **ct, kkt_backend="spike", device="cpu")
    st = ttc.optimize(Jt, vt, **ct, kkt_backend="spike",
                      kkt_mesh=Mesh(CPU8, ("stages",)), device="cpu")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "spike"
    np.testing.assert_array_equal(st.kkt_plan.perm, sj.kkt_plan.perm)
    args = dict(parameters={ns + "x0": np.array([1.0, -0.5])},
                init={ns + "x": np.zeros((40, 2)), ns + "u": np.zeros(40)})
    s1, s2 = sj.solve(**args), st.solve(**args)
    assert s1.status == s2.status == 0
    assert abs(s2.iters - s1.iters) <= 1
    np.testing.assert_allclose(s2.objective, s1.objective, rtol=1e-8)
    np.testing.assert_allclose(s2.variables[ns + "u"], s1.variables[ns + "u"],
                               rtol=0, atol=1e-6)


def _qp(m, n=6, **kw):
    """tests/test_parallel.py's box-constrained QP fleet."""
    Q, c, x = m.variable("bQ", (n, n)), m.variable("bc", (n,)), m.variable("bx", (n,))
    J = 0.5 * m.tprod(x, [-1], Q @ x, [-1]) + m.tprod(c, [-1], x, [-1])
    return m.optimize(objective=J, optimizationVariables=[x],
                      constraints=[x >= -1.0, x <= 1.0], parameters=[Q, c],
                      outputExpressions={"x": x}, **kw)


def _qp_data(n, B, seed):
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((B, n))
    Qs = np.zeros((B, n, n))
    for b in range(B):
        M = rng.standard_normal((n, n))
        Qs[b] = M @ M.T + n * np.eye(n)
    return Qs, cs


def test_sharded_fleet_equals_unsharded_and_jax():
    n, B = 6, 16
    jtc.expr.clear_variables()
    sj = _qp(jtc)
    st = _qp(ttc, device="cpu")
    Qs, cs = _qp_data(n, B, 1)
    params = {"bQ": Qs, "bc": cs}
    inits = {"bx": np.zeros((B, n))}
    plain = st.solve_many(params, inits=inits)
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.shape == {"batch": 8}
    for m in (mesh, make_mesh(4, devices=["cpu", "cpu:0"] * 2)):
        res = st.solve_many(params, inits=inits, mesh=m)
        assert (res.status.numpy() == 0).all()
        np.testing.assert_array_equal(res.iters.numpy(), plain.iters.numpy())
        np.testing.assert_allclose(res.u.numpy(), plain.u.numpy(), rtol=0, atol=1e-10)
    rj = jsolve_batched(sj, params, inits=inits, mesh=jmake_mesh(8))
    np.testing.assert_array_equal(plain.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(plain.u.numpy(), np.asarray(rj.u), rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        st.solve_many({"bQ": Qs[:6], "bc": cs[:6]}, inits={"bx": np.zeros((6, n))},
                      mesh=mesh)


def test_measure_scaling_over_device_counts():
    n = 6
    st = _qp(ttc, device="cpu")

    def make_batch(B):
        Qs, cs = _qp_data(n, B, 2)
        return torch.zeros(B, n, dtype=torch.float64), {"bQ": Qs, "bc": cs}

    rows = measure_scaling(st, make_batch, per_device_batch=2, device_counts=(1, 2, 4, 16),
                           mu0=1.0, max_iter=60, reps=1, devices=CPU8)
    assert [r["devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["converged"] == r["batch"] and r["solves_per_s"] > 0, rows
    assert rows[0]["efficiency"] == 1.0
    init_distributed(num_processes=1)  # one process: nothing to join
