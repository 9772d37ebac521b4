"""The equilibrium solver's build-time certificates are not vacuous: a
game whose latent dynamics are nonlinear is refused band mode by both
the port and the JAX package, and the port's solver assembles its KKT at
every iterate instead (the certificates themselves, on MPC-MHE, are held
against JAX in tests/test_torch_equilibrium.py)."""

import inspect
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.ipm.equilibrium import (  # noqa: E402
    _game_functions,
    equilibrium_certificates,
)

torch.set_num_threads(1)

CERT_KEYS = ("hoist_S", "hoist_S_sf", "hoist_Gz", "hoist_Fz",
             "deps_S", "deps_G", "deps_Sl", "deps_Fz")


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _jax_certificates(solver):
    """The JAX build's certificates, read from the closure of its solve
    function (the JAX package keeps them as local variables)."""
    cv = inspect.getclosurevars(solver._solve_raw).nonlocals
    return {k: cv[k] for k in CERT_KEYS}


def _nonlinear_game(tc, ns, T_=3, L_=4):
    """MPC-MHE with nonlinear latent dynamics (Ts * omega**2 in the theta
    row), as keyword arguments of ``equilibrium`` for either package."""
    Ts = tc.variable(ns + "Ts", ())
    x0 = tc.variable(ns + "x0", (2, 1))
    x1 = tc.variable(ns + "x1", (2, L_ + T_))
    uFuture = tc.variable(ns + "uFuture", (1, T_))
    d = tc.variable(ns + "d", (1, L_ + T_))
    yPast = tc.variable(ns + "yPast", (1, L_))
    p = tc.variable(ns + "p", ())
    x = tc.expr.concat([x0, x1], axis=1)
    u = tc.expr.concat([tc.expr.Tzeros((1, L_)), uFuture], axis=1)
    theta, omega = x[0:1, :], x[1:2, :]
    J = (tc.tsIntegral(((x[0:1, L_ + 1:]) ** 2).sum(axis=0), Ts)
         + 0.1 * tc.tsIntegral((uFuture ** 2).sum(axis=0), Ts)
         - 10.0 * tc.tsIntegral((d ** 2).sum(axis=0), Ts)
         - 5.0 * tc.tsIntegral(((x[0:1, :L_] - yPast) ** 2).sum(axis=0), Ts))
    return dict(
        P1objective=J, P2objective=-J,
        P1optimizationVariables=[uFuture],
        P1constraints=[uFuture >= -1.0, uFuture <= 1.0],
        P2optimizationVariables=[x0, d],
        P2constraints=[d >= -1.0, d <= 1.0],
        latentVariables=[x1],
        latentConstraints=[
            theta[:, 1:] == theta[:, :-1] + Ts * omega[:, :-1] ** 2,
            omega[:, 1:] == omega[:, :-1] + Ts * (p * omega[:, :-1] + u + d),
        ],
        parameters=[Ts, p, yPast],
    )


def test_nonlinear_latent_dynamics_is_not_certified():
    """The certificate is not vacuous: a game whose latent dynamics are
    nonlinear gets hoist_S False in both packages, and the port's solver
    builds it outside band mode, its KKT assembled at every iterate."""
    jtc.expr.clear_variables()
    kw_j = _nonlinear_game(jtc, "tn_")
    sj = jtc.equilibrium(**kw_j, dtype="float32", kkt_backend="dense")
    cj = _jax_certificates(sj)
    kw_t = _nonlinear_game(ttc, "tn_")
    fns, dims, _ = _game_functions(
        kw_t["P1objective"], kw_t["P2objective"],
        kw_t["P1optimizationVariables"], kw_t["P2optimizationVariables"],
        kw_t["latentVariables"], kw_t["P1constraints"], kw_t["P2constraints"],
        kw_t["latentConstraints"], kw_t["parameters"], torch.float32,
    )
    opts = ttc.SolverOptions(dtype="float32").resolved("equilibrium")
    ct = equilibrium_certificates(
        fns, dims, opts, {p.name: p.shape for p in kw_t["parameters"]}
    )
    assert cj["hoist_S"] is False and ct["hoist_S"] is False
    assert {k: ct[k] for k in CERT_KEYS} == cj
    assert ct["hoist_Gz"] is False and not ct["band_ok"]
    st = ttc.equilibrium(**kw_t, dtype="float32", device="cpu", kkt_backend="dense")
    assert st._solve_raw.band_mode is None and sj._solve_raw._band_mode is None
    assert st.certificates == ct
