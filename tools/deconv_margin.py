"""Where the deconvolution game's answer and the deconvolution fleet's
part, and why: chip_smoke.py's [deconv-game] check holds the two within
2e-3.  Both float32 fleets (N = 1000, a 96-tap filter, seed 0, mu0 = 1,
max_iter = 100, the options chip_smoke.py gives them) are solved by the
port; then, at the instances where the two answers differ most and at the
game's slowest, the exact minimizer in float64 (scipy's bounded-variable
least squares) and its multipliers, g = A^T (A x* - y) (at x*_j = 0 the
lower bound's multiplier is g_j), are set beside them.  An entry whose
bound is active with a small multiplier g_j sits, in an interior-point
answer, at about mu / g_j, mu the solve's last barrier parameter.

    python tools/deconv_margin.py [--device cuda] [--B 256] [--worst 6] \\
        [--out chiprun_out/deconv_margin.json]

Prints one JSON object (a line per instance looked at, then the fleet's
summary) and writes it to ``--out`` when given."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.optimize import lsq_linear  # noqa: E402

import chip_smoke as cs  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402


def conv_matrix(h: np.ndarray, N: int) -> np.ndarray:
    """The full convolution's (N + K - 1, N) matrix A: A x = h * x."""
    K = len(h)
    A = np.zeros((N + K - 1, N))
    for j in range(N):
        A[j:j + K, j] = h
    return A


def answer(x, xs, g, f_star, A, y, mu, iters):
    """One float32 answer against the exact minimizer x*."""
    x = x.astype(np.float64)
    d = np.abs(x - xs)
    j = int(d.argmax())
    return {"iters": int(iters), "mu": float(mu), "max_abs_dx_to_exact": float(d.max()),
            "at": j, "x": float(x[j]), "x_exact": float(xs[j]), "g_exact": float(g[j]),
            "x_times_g": float(x[j] * g[j]),
            "f_minus_f_exact": float(0.5 * np.sum((A @ x - y) ** 2) - f_star)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--B", type=int, default=cs.DC_B)
    ap.add_argument("--worst", type=int, default=6,
                    help="instances looked at, by the game-fleet difference")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    N, K, B = cs.DC_N, cs.DC_K, args.B
    h, y, _ = cs.deconv_inputs(N, K, B, seed=0)
    fleet = cs.build_deconv(ttc, N, K, "mdc_", dtype="float32", device=args.device)
    game = cs.build_deconv_game(ttc, N, K, "mdg_", dtype="float32", device=args.device)
    half = N // 2
    t0 = time.perf_counter()
    rf = fleet.solve_many({"mdc_h": h, "mdc_y": y}, inits={"mdc_x": np.full((B, N), 0.5)},
                          mu0=1.0, max_iter=cs.DC_MAX_ITER)
    rg = game.solve_many({"mdg_h": h, "mdg_y": y},
                         inits={"mdg_x1": np.full((B, half), 0.5),
                                "mdg_x2": np.full((B, N - half), 0.5)},
                         mu0=1.0, max_iter=cs.DC_MAX_ITER)
    seconds = time.perf_counter() - t0
    xf, xg = rf.u.cpu().numpy(), rg.u[:, :N].cpu().numpy()
    st_f, st_g = rf.status.cpu().numpy(), rg.status.cpu().numpy()
    it_f, it_g = rf.iters.cpu().numpy(), rg.iters.cpu().numpy()
    mu_f, mu_g = rf.mu.cpu().numpy(), rg.mu.cpu().numpy()
    dx = np.abs(xg - xf)
    dxi = dx.max(axis=1)
    look = list(np.argsort(-dxi)[:args.worst])
    slow = int(it_g.argmax())
    if slow not in look:
        look.append(slow)
    A = conv_matrix(h, N)
    rows = []
    for i in look:
        r = lsq_linear(A, y[i], bounds=(0.0, 1.0), method="bvls", tol=1e-14, max_iter=10_000)
        xs = r.x
        g = A.T @ (A @ xs - y[i])
        f_star = 0.5 * np.sum((A @ xs - y[i]) ** 2)
        free = (xs > 0) & (xs < 1)
        at0 = xs == 0
        As = A[:, free]
        j = int(dx[i].argmax())
        rows.append({
            "instance": int(i), "status": [int(st_f[i]), int(st_g[i])],
            "max_abs_dx_game_fleet": float(dxi[i]), "at": j,
            "x_fleet": float(xf[i, j]), "x_game": float(xg[i, j]), "x_exact": float(xs[j]),
            "g_exact": float(g[j]), "bvls_status": int(r.status),
            "free": int(free.sum()), "at_0": int(at0.sum()), "at_1": int((xs == 1).sum()),
            "smallest_multiplier_at_0": float(g[at0].min()) if at0.any() else None,
            "multipliers_at_0_below_1e-5": int((g[at0] < 1e-5).sum()),
            "lambda_min_free": float(np.linalg.eigvalsh(As.T @ As)[0]) if free.any() else None,
            "fleet": answer(xf[i], xs, g, f_star, A, y[i], mu_f[i], it_f[i]),
            "game": answer(xg[i], xs, g, f_star, A, y[i], mu_g[i], it_g[i]),
        })
        print(json.dumps(rows[-1]), flush=True)
    ev = np.linalg.eigvalsh(A.T @ A)
    summary = {
        "device": args.device, "B": B, "solve_seconds": seconds,
        "card": cs.card_line() if args.device == "cuda" else None,
        "status_counts_fleet": {str(k): int(v) for k, v in zip(*np.unique(st_f, return_counts=True))},
        "status_counts_game": {str(k): int(v) for k, v in zip(*np.unique(st_g, return_counts=True))},
        "max_abs_dx": float(dxi.max()), "instance": int(dxi.argmax()),
        "instances_dx_above": {str(t): int((dxi > t).sum()) for t in (5e-4, 1e-3, 1.5e-3)},
        "entries_dx_above_1e-3": int((dx > 1e-3).sum()),
        "iters_fleet_max_mean": [int(it_f.max()), float(it_f.mean())],
        "iters_game_max_mean": [int(it_g.max()), float(it_g.mean())],
        "iters_game_above_50": int((it_g > 50).sum()), "slowest_game_instance": slow,
        "mu_fleet_range": [float(mu_f.min()), float(mu_f.max())],
        "mu_game_range": [float(mu_g.min()), float(mu_g.max())],
        "lambda_min_max_AtA": [float(ev[0]), float(ev[-1])],
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"instances": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
