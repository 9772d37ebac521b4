"""The run across processes (M16's last item) against the JAX package's
two-process test (tests/test_distributed.py:21-40): two spawned CPU
processes of two mesh entries each, joined in a gloo process group
(``parallel/distributed_smoke.py``), solve a batch-sharded
``mpc_dcmotor`` fleet (T = 6, B = 8) and a 16-stage ``'spike'`` KKT solve
split over the processes.  Held: 4 global entries seen from each
process, 8 of 8 converged, the spike at status 0 in both, its objective
within 1e-12 between them.

In one process, a gloo group of world size 1 (a ``FileStore`` under
``tmp_path``) drives the same exchange code: a process mesh of four
entries gives, bitwise, what a mesh of this process alone gives, for a
QP fleet (with the profiling history and the allowSave snapshot
gathered too) and for a spike solve."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt.spike import spike_solve  # noqa: E402
from tenscalc_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    exchange,
    make_mesh,
    process_mesh,
    virtual_devices,
)
from tenscalc_tpu_torch.parallel.batch_rounding import ChunkedBmm, RowCheck  # noqa: E402
from tenscalc_tpu_torch.parallel.distributed_smoke import run  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def test_two_processes_fleet_and_spike():
    artifact = run(nproc=2, n_local=2, device="cpu", timeout=240)
    assert artifact["num_processes"] == 2
    assert len(artifact["workers"]) == 2
    for w in artifact["workers"]:
        # 4 global entries visible from each process
        assert w["n_global"] == 4 and w["ranks"] == [0, 0, 1, 1]
        # batch-sharded fleet: every instance converged
        assert w["fleet_converged"] == w["fleet_batch"] == 8
        # the 'spike' solve split across the processes
        assert w["spike_status"] == 0 and w["spike_backend"] == "spike"
    j0 = artifact["workers"][0]["spike_J"]
    j1 = artifact["workers"][1]["spike_J"]
    assert abs(j0 - j1) < 1e-12
    assert artifact["ok"]


@pytest.fixture
def one_process_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_process_mesh_in_one_process(one_process_group):
    mesh = process_mesh(4, "batch", "cpu")
    assert mesh.spans_processes and mesh.ranks == (0, 0, 0, 0)
    assert mesh.groups() == [(torch.device("cpu"), [0, 1, 2, 3])]
    local = make_mesh(4, devices=virtual_devices("cpu", 4))
    assert not local.spans_processes

    # every dtype a result carries survives the exchange
    for t in (torch.tensor([[True, False], [False, True], [True, True]]),
              torch.arange(6, dtype=torch.int32).view(3, 2),
              torch.randn(3, 2, dtype=torch.float64)):
        assert torch.equal(exchange(t, [0, 0, 0], 0), t)
        assert torch.equal(exchange(t, [0, 0], 1), t)
    with pytest.raises(ValueError, match="ranks"):
        Mesh(virtual_devices("cpu", 2), ranks=[0])

    # a fleet, with the history and the snapshot gathered too
    n, B = 4, 8
    Q, c, x = ttc.variable("dpQ", (n, n)), ttc.variable("dpc", (n,)), ttc.variable("dpx", (n,))
    solver = ttc.optimize(objective=0.5 * ttc.tprod(x, [-1], Q @ x, [-1])
                          + ttc.tprod(c, [-1], x, [-1]), optimizationVariables=[x],
                          constraints=[x >= -1.0, x <= 1.0], parameters=[Q, c],
                          device="cpu", profiling=True, allowSave=True)
    rng = np.random.default_rng(0)
    M = rng.standard_normal((B, n, n))
    params = {"dpQ": M @ M.transpose(0, 2, 1) + n * np.eye(n),
              "dpc": rng.standard_normal((B, n))}
    inits = {"dpx": np.zeros((B, n))}
    r_proc = solver.solve_many(params, inits=inits, mesh=mesh)
    r_local = solver.solve_many(params, inits=inits, mesh=local)
    assert (r_local.status == 0).all()
    for a, b in zip(r_proc, r_local):
        if isinstance(a, tuple):
            assert len(a) == len(b) == 6 and all(torch.equal(x, y) for x, y in zip(a, b))
        elif a is None:  # the CG nu-initializer's residual: no equality constraints
            assert b is None
        else:
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert r_proc.history.shape[0] == B and torch.isnan(r_proc.history).any()

    # the spike solve: bitwise what this process's own mesh gives
    nb, s_, Bn = 8, 3, 2
    A = torch.as_tensor(rng.standard_normal((Bn, nb, s_, s_)))
    A = A + A.mT + 4 * s_ * torch.eye(s_, dtype=A.dtype)
    Bsub = torch.as_tensor(rng.standard_normal((Bn, nb, s_, s_)))
    Bsub[:, 0] = 0
    b = torch.as_tensor(rng.standard_normal((Bn, nb, s_)))
    x_proc = spike_solve(A, Bsub, b, process_mesh(4, "stages", "cpu"))
    x_local = spike_solve(A, Bsub, b, Mesh(virtual_devices("cpu", 4), ("stages",)))
    assert torch.equal(x_proc, x_local)


def test_process_owning_no_entry_raises(one_process_group):
    # every entry is rank 1's: rank 0, this process, has nothing to solve
    n, B = 2, 4
    x = ttc.variable("dnx", (n,))
    c = ttc.variable("dnc", (n,))
    solver = ttc.optimize(objective=ttc.tprod(x - c, [-1], x - c, [-1]),
                          optimizationVariables=[x], constraints=[x >= -1.0],
                          parameters=[c], device="cpu")
    foreign = Mesh(virtual_devices("cpu", 2), ("batch",), ranks=[1, 1])
    with pytest.raises(ValueError, match="owns no entry"):
        solver.solve_many({"dnc": np.zeros((B, n))}, inits={"dnx": np.zeros((B, n))},
                          mesh=foreign)
    nb, s_ = 4, 2
    A = torch.eye(s_, dtype=torch.float64).expand(1, nb, s_, s_).clone()
    with pytest.raises(ValueError, match="owns no entry"):
        spike_solve(A, torch.zeros_like(A), torch.ones(1, nb, s_, dtype=torch.float64),
                    Mesh(virtual_devices("cpu", 2), ("stages",), ranks=[1, 1]))


def test_batch_rounding_modes():
    # RowCheck flags an operator whose first rows depend on the others
    # (flip along the batch) and passes row-wise ones; ChunkedBmm splits
    # a batched bmm and, on the CPU, gives its bits
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 3, 3, dtype=torch.float64, generator=g)
    v = torch.randn(8, 3, 1, dtype=torch.float64, generator=g)
    mode = RowCheck(8)
    with mode:
        torch.bmm(x, v)
        torch.flip(x, (0,))
        (2.0 * x).sum(-1)
    parted = {k.split()[0] for k in mode.parted}
    checked = {k.split()[0] for k in mode.checked}
    assert parted == {"aten.flip.default"}
    assert {"aten.bmm.default", "aten.mul.Tensor", "aten.sum.dim_IntList"} <= checked
    with ChunkedBmm(8, 4) as cut:
        y = torch.bmm(x, v)
    assert cut.calls == 1 and torch.equal(y, torch.bmm(x, v))
