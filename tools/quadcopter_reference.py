"""The reference's statuses on instances of the port's quadcopter fleet:
the JAX package on the CPU (float32, ``TENSCALC_AUTO_FLEET=1``, the large
Newton matrix, mu0 = 0.1, max_iter = 300) solves the given instances of
``tenscalc_tpu_torch.examples.mpc_quadcopter.fleet_inputs(20, 512,
seed=0)`` as one fleet, to set beside the statuses the card gave them
(chip_smoke.py's [quadcopter] line lists the first instances off status
0).  Its Pallas kernels run in interpret mode: about a minute for 16
instances.

    python tools/quadcopter_reference.py --off 1 2 6 16 17 20 23 27 \\
        --on 0 3 4 5 7 8 9 10

Prints one JSON line: the instances, and the reference's statuses and
iterations."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ["TENSCALC_AUTO_FLEET"] = "1"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from examples import mpc_quadcopter as jq  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_quadcopter as tq  # noqa: E402

T, B = 20, 512


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--off", type=int, nargs="*", default=[],
                    help="instances the card left off status 0")
    ap.add_argument("--on", type=int, nargs="*", default=[],
                    help="instances the card converged")
    args = ap.parse_args()
    idx = np.asarray(args.off + args.on, dtype=int)
    params, inits = tq.fleet_inputs(T, B, "quad_", seed=0)
    sub_p = {k: (v[idx] if np.ndim(v) == 3 and v.shape[0] == B else v)
             for k, v in params.items()}
    sub_i = {k: v[idx] for k, v in inits.items()}
    solver = jq.build_solver(T=T, ns="quad_", dtype="float32", smallerNewtonMatrix=False)
    t0 = time.perf_counter()
    res = solver.solve_many(sub_p, inits=sub_i, mu0=0.1, max_iter=300)
    status, iters = np.asarray(res.status), np.asarray(res.iters)
    print(json.dumps({
        "backend": solver.kkt_backend_resolved, "off": args.off, "on": args.on,
        "status": status.tolist(), "iters": iters.tolist(),
        "converged_off": int((status[: len(args.off)] == 0).sum()),
        "converged_on": int((status[len(args.off):] == 0).sum()),
        "seconds": round(time.perf_counter() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
