"""A fleet of four nonlinear MPC-MHE pursuit games (T = 5, L = 4; the
closed loop's first solve with per-instance headings, evader positions,
measurements and warm starts, ``mpcmhe_unicycle.fleet_inputs``) on the
fleet banded LU in float32: every instance at status 0 in the same
iterations as its own single solve, its variables within 1e-5 (the
fleet and a single solve run the same operations; only the batched
products' summation orders differ)."""

import numpy as np
import torch

import tenscalc_tpu_torch as ttc
from tenscalc_tpu_torch.examples import mpcmhe_unicycle as tmu

torch.set_num_threads(1)

T, L, B = 5, 4, 4
NS = "tf_"
ATOL = 1e-5


def test_fleet_matches_single_solves():
    ttc.clear_variables()
    st = tmu.build_solver(T=T, L=L, ns=NS, dtype="float32", device="cpu")
    assert st.kkt_backend_resolved == "fleet_banded_lu" and st._solve_raw.band_mode is None
    params, inits = tmu.fleet_inputs(T, L, B, ns=NS, seed=3)
    assert params[NS + "yPast"].shape == (B, 4, L) and inits[NS + "x1"].shape == (B, 5, T + L)
    res = st.solve_many(params, inits=inits, mu0=0.1, max_iter=300)
    assert (res.status.numpy() == 0).all(), res.status
    assert bool(torch.isfinite(res.u).all())
    for b in range(B):
        one = {k: (v[b] if k in (NS + "uPast", NS + "yPast") else v) for k, v in params.items()}
        sol = st.solve(one, init={k: v[b] for k, v in inits.items()}, mu0=0.1, max_iter=300)
        assert sol.status == 0 and sol.iters == int(res.iters[b]), (sol.iters, res.iters)
        z = np.concatenate([np.ravel(sol.variables[v.name]) for v in st.variables])
        np.testing.assert_allclose(res.u[b].numpy(), z, rtol=0, atol=ATOL)
    ttc.clear_variables()
