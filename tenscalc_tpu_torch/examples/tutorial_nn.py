"""Neural-network gradient-descent tutorial (the JAX package's
``examples/tutorial_nn.py``, the reference's tutorialNN.m) on the
PyTorch port.

A small MLP (layers 1-30-10-10-1, relu activations) is fitted to a
scalar function by minibatch gradient descent.  The loss and its
symbolic gradient with respect to every weight (``tc.gradient``) are
evaluated by one compute function (``tc.compute``), on the card unless
``device="cpu"``; the update runs on the host in numpy, as the JAX
tutorial's does.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def target(u):
    """The function to approximate."""
    return np.sin(3.0 * u) + 0.5 * u


def build(layers=(1, 30, 10, 10, 1), batch=5, ns="nn_", device=None):
    u = tc.variable(ns + "u", (layers[0], batch))
    y = tc.variable(ns + "y", (layers[-1], batch))
    lam = tc.variable(ns + "lambda", ())

    Ws, bs = [], []
    x = u
    for i in range(len(layers) - 1):
        W = tc.variable(f"{ns}W{i}", (layers[i + 1], layers[i]))
        b = tc.variable(f"{ns}b{i}", (layers[i + 1], 1))
        Ws.append(W)
        bs.append(b)
        z = W @ x + b  # b broadcasts over the batch
        x = tc.relu(z) if i < len(layers) - 2 else z

    Jreg = sum((tc.norm2(W) for W in Ws), tc.to_expr(0.0))
    Jloss = tc.norm2(x - y) / batch
    J = Jloss + lam * Jreg

    outputs = {"J": J, "Jloss": Jloss, "Jreg": Jreg, "out": x}
    for i, (W, b) in enumerate(zip(Ws, bs)):
        outputs[f"gW{i}"] = tc.gradient(J, W)
        outputs[f"gb{i}"] = tc.gradient(J, b)

    fn = tc.compute([u, y, lam] + Ws + bs, outputs, device=device)
    return fn, layers


def main(seed=0, steps=400, batch=5, alpha=2e-2, lam=1e-4, verbose=True, device=None):
    fn, layers = build(batch=batch, device=device)
    rng = np.random.default_rng(seed)
    params = {}
    for i in range(len(layers) - 1):
        # He-style init for the relu stack
        params[f"nn_W{i}"] = rng.normal(0.0, np.sqrt(2.0 / layers[i]),
                                        (layers[i + 1], layers[i]))
        params[f"nn_b{i}"] = np.zeros((layers[i + 1], 1))

    losses = []
    for step in range(steps):
        ub = rng.uniform(-1.0, 1.0, (layers[0], batch))
        yb = target(ub)
        out = fn(nn_u=ub, nn_y=yb, nn_lambda=lam, **params)
        losses.append(float(out["Jloss"]))
        for i in range(len(layers) - 1):
            params[f"nn_W{i}"] = params[f"nn_W{i}"] - alpha * out[f"gW{i}"].cpu().numpy()
            params[f"nn_b{i}"] = params[f"nn_b{i}"] - alpha * out[f"gb{i}"].cpu().numpy()
        if verbose and step % 100 == 0:
            print(f"step {step:4d}  Jloss={losses[-1]:.5f}")

    early = float(np.mean(losses[:20]))
    late = float(np.mean(losses[-20:]))
    if verbose:
        print(f"mean loss first 20 steps: {early:.5f}, last 20: {late:.5f}")
    assert late < 0.3 * early, (early, late)
    return params, losses


if __name__ == "__main__":
    main()
