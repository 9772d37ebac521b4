"""Per-layer neural-network training tutorial (the JAX package's
``examples/tutorial_nn1.py``, the reference's tutorialNN1.m) on the
PyTorch port.

The online-retraining pattern: the weights and per-layer gradient
accumulators are state of a compute object; ``resetGradient`` zeroes the
accumulators, ``updateGradient`` adds the current batch's gradient and
``updateParameters`` applies the accumulated step (the reference's three
declareCopy operations), so the training loop streams data with ``set``,
accumulates and applies at the end of each batch.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def target(u):
    return np.sin(3.0 * u) + 0.5 * u


def build(layers=(1, 20, 10, 10, 1), batch=5, lam=1e-3, ns="nn1_", device=None):
    u = tc.variable(ns + "u", (layers[0], batch))
    y = tc.variable(ns + "y", (layers[-1], batch))
    alpha = tc.variable(ns + "alpha", ())

    Ws, bs, gWs, gbs = [], [], [], []
    x = u
    for i in range(len(layers) - 1):
        W = tc.variable(f"{ns}W{i}", (layers[i + 1], layers[i]))
        b = tc.variable(f"{ns}b{i}", (layers[i + 1], 1))
        gW = tc.variable(f"{ns}gW{i}", (layers[i + 1], layers[i]))
        gb = tc.variable(f"{ns}gb{i}", (layers[i + 1], 1))
        Ws.append(W), bs.append(b), gWs.append(gW), gbs.append(gb)
        z = W @ x + b
        x = tc.relu(z) if i < len(layers) - 2 else z

    Jreg = sum((tc.norm2(W) + tc.norm2(b) for W, b in zip(Ws, bs)), tc.to_expr(0.0))
    Jloss = tc.norm2(x - y)
    J = Jloss + lam * Jreg

    reset, accumulate, apply_step = {}, {}, {}
    for W, b, gW, gb in zip(Ws, bs, gWs, gbs):
        reset[gW] = tc.Tzeros(gW.shape)
        reset[gb] = tc.Tzeros(gb.shape)
        accumulate[gW] = gW + tc.gradient(J, W)
        accumulate[gb] = gb + tc.gradient(J, b)
        apply_step[W] = W - alpha * gW
        apply_step[b] = b - alpha * gb

    rng = np.random.default_rng(0)
    state = {}
    for W, b, gW, gb in zip(Ws, bs, gWs, gbs):
        state[W] = rng.random(W.shape) - 0.5
        state[b] = rng.random(b.shape) - 0.5
        state[gW] = np.zeros(gW.shape)
        state[gb] = np.zeros(gb.shape)

    obj = tc.compute_object(
        inputs=[u, y, alpha],
        outputs={
            "output": x,
            "J": {"J": J, "Jloss": Jloss, "Jreg": Jreg},
            "Wb": {v.name: v for v in Ws + bs},
            "gWb": {v.name: v for v in gWs + gbs},
        },
        state=state,
        updates={"resetGradient": reset, "updateGradient": accumulate,
                 "updateParameters": apply_step},
        device=device,
    )
    return obj, ns, layers


def main(seed=0, n_batches=150, samples_per_batch=4, batch=5, alpha0=None, verbose=True,
         device=None):
    """The SGD loop in the reference's set / accumulate / apply shape."""
    obj, ns, layers = build(batch=batch, device=device)
    rng = np.random.default_rng(seed)
    alpha0 = alpha0 or 2e-2 / samples_per_batch
    obj.set(ns + "alpha", alpha0)
    losses = []
    for b_ix in range(n_batches):
        obj.copy("resetGradient")
        sumJ = 0.0
        for _ in range(samples_per_batch):
            uv = 2.0 * rng.random((layers[0], batch)) - 1.0
            obj.set(ns + "u", uv)
            obj.set(ns + "y", target(uv))
            obj.copy("updateGradient")
            sumJ += float(obj.get("J")["Jloss"])
        obj.copy("updateParameters")
        losses.append(sumJ / samples_per_batch)
        if verbose and (b_ix + 1) % 50 == 0:
            print(f"batch {b_ix + 1}: meanJloss={losses[-1]:.5f}")
    return np.asarray(losses)


if __name__ == "__main__":
    losses = main()
    print(f"first-10 mean {losses[:10].mean():.4f} -> last-10 mean {losses[-10:].mean():.4f}")
