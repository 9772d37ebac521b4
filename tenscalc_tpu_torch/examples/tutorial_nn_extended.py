"""Extended neural-network training tutorial (the JAX package's
``examples/tutorial_nn_extended.py``, the reference's
tutorialNNextended.m) on the PyTorch port.

On top of tutorial_nn1's state machine (reset / update / apply gradient
copies): the relu liveness counts (``get("alive")``: heaviside(x - eps)
a unit over the batch), the directional derivative of every hidden
activation along the accumulated gradient (``get("dx")``), and the
reference's adaptive step: the largest step that keeps the alive relus
alive, floored at alpha0; a hidden layer with no live unit stops the
run.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc

EPS = 1e-12


def target(u):
    return np.sin(3.0 * u) + 0.5 * u


def build(layers=(1, 20, 10, 10, 1), batch=5, lam=1e-3, ns="nne_", device=None):
    u = tc.variable(ns + "u", (layers[0], batch))
    y = tc.variable(ns + "y", (layers[-1], batch))
    alpha = tc.variable(ns + "alpha", ())

    Ws, bs, gWs, gbs = [], [], [], []
    hidden = []
    x = u
    for i in range(len(layers) - 1):
        W = tc.variable(f"{ns}W{i}", (layers[i + 1], layers[i]))
        b = tc.variable(f"{ns}b{i}", (layers[i + 1], 1))
        gW = tc.variable(f"{ns}gW{i}", (layers[i + 1], layers[i]))
        gb = tc.variable(f"{ns}gb{i}", (layers[i + 1], 1))
        Ws.append(W), bs.append(b), gWs.append(gW), gbs.append(gb)
        z = W @ x + b
        if i < len(layers) - 2:
            x = tc.relu(z)
            hidden.append(x)
        else:
            x = z

    Jreg = sum((tc.norm2(W) for W in Ws), tc.to_expr(0.0))
    Jloss = tc.norm2(x - y)
    J = Jloss + lam * Jreg

    # liveness: each unit's heaviside count over the batch
    whichalive = [tc.heaviside(h - EPS).sum(axis=1) for h in hidden]
    totalalive = [w.sum() for w in whichalive]

    # each hidden activation's derivative along the accumulated gradient:
    # every upstream layer's Jacobian contracted with its accumulator
    dxs = []
    for i, h in enumerate(hidden):
        terms = []
        for j in range(i + 1):
            terms.append(tc.tprod(tc.gradient(h, Ws[j]), [1, 2, -1, -2], gWs[j], [-1, -2]))
            terms.append(tc.tprod(tc.gradient(h, bs[j]), [1, 2, -1, -2], gbs[j], [-1, -2]))
        dx = terms[0]
        for t_ in terms[1:]:
            dx = dx + t_
        dxs.append(dx)  # (n_i, batch)

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
            "alive": {"total": totalalive, "which": whichalive},
            "x": hidden,
            "dx": dxs,
        },
        state=state,
        updates={"resetGradient": reset, "updateGradient": accumulate,
                 "updateParameters": apply_step},
        device=device,
    )
    return obj, ns, layers


def main(seed=0, n_batches=100, samples_per_batch=4, batch=5, alpha0=None, verbose=True,
         device=None):
    obj, ns, layers = build(batch=batch, device=device)
    rng = np.random.default_rng(seed)
    alpha0 = alpha0 or 2e-2 / samples_per_batch
    obj.set(ns + "alpha", alpha0)
    losses, alphas = [], []
    n_hidden = len(layers) - 2
    for b_ix in range(n_batches):
        obj.copy("resetGradient")
        sumJ = 0.0
        minx = [np.full(layers[i + 1], np.inf) for i in range(n_hidden)]
        total = np.zeros(n_hidden)
        for _ in range(samples_per_batch):
            uv = 2.0 * rng.random((layers[0], batch)) - 1.0
            obj.set(ns + "u", uv)
            obj.set(ns + "y", target(uv))
            alive = obj.get("alive")
            total += np.asarray([float(a) for a in alive["total"]])
            for i, xi in enumerate(obj.get("x")):
                xi = xi.cpu().numpy()
                mx = np.where(xi > EPS, xi, np.inf).min(axis=1)
                minx[i] = np.minimum(minx[i], mx)
            obj.copy("updateGradient")
            sumJ += float(obj.get("J")["Jloss"])
        # the end of a batch: the adaptive step keeps alive relus alive
        cands = []
        for i, dx in enumerate(obj.get("dx")):
            dx = dx.cpu().numpy().max(axis=1)  # the worst case over the batch
            ok = np.isfinite(minx[i]) & (dx > 0)
            if ok.any():
                cands.append(np.min(minx[i][ok] / dx[ok]))
        alpha = min(cands) if cands else alpha0
        alpha = max(alpha, alpha0)
        obj.set(ns + "alpha", alpha)
        obj.copy("updateParameters")
        if (total == 0).any():
            raise RuntimeError("network is dead")
        losses.append(sumJ / samples_per_batch)
        alphas.append(alpha)
        if verbose and (b_ix + 1) % 50 == 0:
            print(f"batch {b_ix + 1}: meanJloss={losses[-1]:.5f} alpha={alpha:.2e}")
    return np.asarray(losses), np.asarray(alphas)


if __name__ == "__main__":
    losses, alphas = main()
    print(f"first-10 mean {losses[:10].mean():.4f} -> last-10 mean {losses[-10:].mean():.4f}; "
          f"adaptive alpha range [{alphas.min():.2e}, {alphas.max():.2e}]")
