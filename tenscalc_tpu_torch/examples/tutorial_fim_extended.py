"""Extended Fisher-information tutorial (the JAX package's
``examples/tutorial_fim_extended.py``, the reference's
tutorialFIMextended.m) on the PyTorch port.

The streaming shape: the FIM is a state variable of a compute object,
updated by a named copy, each update taking a chunk of camera positions
contracted at once (tutorial_fim takes all samples in one batch)."""

from __future__ import annotations

import time

import numpy as np

import tenscalc_tpu_torch as tc


def build(chunk=1024, ns="fime_", device=None):
    theta = tc.variable(ns + "theta", (6,))
    t = tc.variable(ns + "t", (chunk,))
    M = tc.variable(ns + "M", (3, 3))
    p = tc.variable(ns + "p", (chunk, 3))
    invS = tc.variable(ns + "invS", (2, 2))
    FIM = tc.variable(ns + "FIM", (6, 6))   # the state accumulator

    q = tc.tprod(tc.Tones((chunk,)), [1], theta[0:3], [2]) + tc.tprod(t, [1], theta[3:6], [2])
    d = p - q
    mu = (d @ M[0:2].T) / (d @ M[2:3].T)
    g = tc.gradient(mu, theta)              # (chunk, 2, 6)
    FIM_chunk = tc.tprod(g, [-3, -1, 1], invS, [-1, -2], g, [-3, -2, 2])

    obj = tc.compute_object(
        inputs=[theta, t, M, p, invS],
        outputs={"FIM": FIM, "FIM_chunk": FIM_chunk},
        state={FIM: np.zeros((6, 6))},
        updates={"accumulate": {FIM: FIM + FIM_chunk}, "reset": {FIM: tc.Tzeros((6, 6))}},
        device=device,
    )
    return obj, ns


def main(S=100000, chunk=1024, seed=0, verbose=True, device=None):
    obj, ns = build(chunk, device=device)
    rng = np.random.default_rng(seed)
    theta = rng.random(6)
    M = np.eye(3) + rng.random((3, 3))
    R = rng.random((2, 2))
    invS = R.T @ R
    obj.set(ns + "theta", theta)
    obj.set(ns + "M", M)
    obj.set(ns + "invS", invS)
    obj.copy("reset")

    n_chunks = -(-S // chunk)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        obj.set(ns + "t", rng.random(chunk))
        obj.set(ns + "p", 5.0 + rng.random((chunk, 3)))
        obj.copy("accumulate")
    FIM = obj.get("FIM").cpu().numpy()
    elapsed = time.perf_counter() - t0
    if verbose:
        print(f"accumulated FIM over {n_chunks * chunk} samples in {elapsed:.3f} s")
        print(FIM)
    return FIM


if __name__ == "__main__":
    main()
