"""The run across processes (port of ``tools/distributed_smoke.py``).

    python -m tenscalc_tpu_torch.parallel.distributed_smoke [--device cuda|cpu]
        [--flagship DIR]

Starts two worker processes (:mod:`._distributed_worker`) on this host,
joined in one gloo process group through a rendezvous on a free
localhost port, each adding two entries of its device to a mesh across
the processes (the JAX run's global mesh of four devices; :func:`run`
takes other counts).  They run the JAX worker's
workload (a batch-sharded ``mpc_dcmotor`` fleet, T = 6, B = 8, and the
16-stage ``'spike'`` solve) and, with ``--flagship DIR`` on the card,
the flagship fleet split over the processes.  On one card every
worker's entries are cuda:0, and the group is gloo on host copies, since
NCCL refuses two ranks on one device.  It runs on the card unless
``--device cpu`` asks for the CPU; on the card a worker that finds no
CUDA fails and never falls back to the CPU.  It prints the merged result
as JSON and exits non-zero when a worker failed or a check did not hold.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(nproc: int = 2, n_local: int = 2, device: str = "cuda",
        flagship_dir=None, timeout: float = 600.0) -> dict:
    """Start the workers, wait for them (killing every one at the first
    failure or at ``timeout`` seconds), and return the merged result;
    raises when a worker failed or printed no result."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-u", "-m", "tenscalc_tpu_torch.parallel._distributed_worker"]
    extra = ["--device", device, "--n-local", str(n_local)]
    if flagship_dir is not None:
        extra += ["--flagship", str(flagship_dir)]
    with tempfile.TemporaryDirectory(prefix="tc_dist_") as td:
        logs = [Path(td) / f"worker{i}.log" for i in range(nproc)]
        procs = []
        try:
            for i, log in enumerate(logs):
                with open(log, "w") as fh:
                    procs.append(subprocess.Popen(
                        cmd + [str(i), str(nproc), f"localhost:{port}"] + extra,
                        env=env, stdout=fh, stderr=subprocess.STDOUT, cwd=str(_ROOT)))
            deadline = time.monotonic() + timeout
            while True:
                states = [p.poll() for p in procs]
                if all(s == 0 for s in states):
                    break
                if any(s not in (None, 0) for s in states):
                    break  # one failed: the others would wait on it
                if time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = [(p.returncode, log.read_text()) for p, log in zip(procs, logs)]
    results = []
    for rc, out in outs:
        res = None
        for line in out.splitlines():
            if line.startswith("RESULT:"):
                res = json.loads(line[len("RESULT:"):])
        if rc != 0 or res is None:
            raise RuntimeError(
                "worker failed (rc={}):\n{}".format(rc, "\n\n".join(o[-3000:] for _, o in outs)))
        results.append(res)
    return {
        "num_processes": nproc,
        "devices_per_process": n_local,
        "device": device,
        "collectives": "gloo, host copies",
        "workers": results,
        "ok": all(r["fleet_converged"] == r["fleet_batch"] and r["spike_status"] == 0
                  for r in results),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the run across processes")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--flagship", default=None, metavar="DIR")
    args = ap.parse_args(argv)
    artifact = run(device=args.device, flagship_dir=args.flagship)
    print(json.dumps(artifact))
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
