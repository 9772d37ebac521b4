"""Fisher-information tutorial (the JAX package's
``examples/tutorial_fim.py``, the reference's tutorialFIM.m) on the
PyTorch port.

A camera at position p with projection matrix M observes a target
moving as q(t) = theta[0:3] + theta[3:6] t; the measurement is
mu = (M[0:2] (p - q)) / (M[2] (p - q)), and the Fisher information about
theta over S samples (t, p) is sum_s g_s' invS g_s with
g_s = d mu_s / d theta.  The samples are a leading axis of the
expressions: ``gradient`` of the batched measurement gives the (S, 2, 6)
Jacobian at once and ``tprod`` contracts the batch, in one compute
function on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

import tenscalc_tpu_torch as tc


def build(S, ns="fim_", device=None):
    theta = tc.variable(ns + "theta", (6,))   # initial position, velocity
    t = tc.variable(ns + "t", (S,))           # sample times
    M = tc.variable(ns + "M", (3, 3))         # camera matrix
    p = tc.variable(ns + "p", (S, 3))         # camera positions
    invS = tc.variable(ns + "invS", (2, 2))   # error information matrix

    # q_s = theta[0:3] + theta[3:6] t_s: (S, 3)
    q = tc.tprod(tc.Tones((S,)), [1], theta[0:3], [2]) + tc.tprod(t, [1], theta[3:6], [2])
    d = p - q
    mu = (d @ M[0:2].T) / (d @ M[2:3].T)       # (S, 2)
    g = tc.gradient(mu, theta)                # (S, 2, 6)
    FIM = tc.tprod(g, [-3, -1, 1], invS, [-1, -2], g, [-3, -2, 2])
    return tc.compute([theta, t, M, p, invS], {"FIM": FIM, "mu": mu}, device=device)


def main(S=100000, seed=0, device=None):
    fn = build(S, device=device)
    rng = np.random.default_rng(seed)
    theta = rng.random(6)
    M = np.eye(3) + rng.random((3, 3))
    R = rng.random((2, 2))
    invS = R.T @ R
    t = rng.random(S)
    p = 5.0 + rng.random((S, 3))  # 5 and up keeps p away from q

    out = fn(fim_theta=theta, fim_t=t, fim_M=M, fim_p=p, fim_invS=invS)
    FIM = out["FIM"].cpu().numpy()

    # oracle: each sample's Jacobian by torch.func on the CPU, in float64
    Mt = torch.as_tensor(M)

    def mu_one(th, ti, pi):
        d = pi - (th[:3] + th[3:] * ti)
        return (Mt[:2] @ d) / (Mt[2] @ d)

    gall = torch.func.vmap(torch.func.jacfwd(mu_one), in_dims=(None, 0, 0))(
        torch.as_tensor(theta), torch.as_tensor(t), torch.as_tensor(p)).numpy()
    full = np.einsum("sij,ik,skl->jl", gall, invS, gall)
    err = np.abs(FIM - full).max() / max(np.abs(full).max(), 1.0)
    print(f"S={S}  ||FIM||_max={np.abs(FIM).max():.4f}  rel err={err:.2e}")
    assert err < 1e-4, err
    assert np.allclose(FIM, FIM.T, atol=1e-5 * np.abs(FIM).max())
    return FIM


if __name__ == "__main__":
    main()
