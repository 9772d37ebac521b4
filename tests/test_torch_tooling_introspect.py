"""capture_ww, solve_result(save_iter=), the introspection and the graph
export (M17) against the JAX package on the same inputs, on the CPU:
``capture_ww`` on tests/test_diagnostics.py:193's mis-scaled problem
(it = None localizes the mis-scaled variable as that test does; WW at
it = 2 within 1e-8 of its largest entry of JAX's; float64, both on the
dense LU through ``TENSCALC_AUTO_FLEET=0``), the snapshot at a
``save_iter``, ``sparsity`` (the same patterns as test_introspect.py's
three cases), ``op_tree`` (``max_eqns``), ``spy`` (``nnz=9``) and
``export_computation_graph`` (its two files, nonzero ATen operation
counts)."""

import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.cgexport import export_computation_graph  # noqa: E402
from tenscalc_tpu_torch.ipm.solver import HISTORY_COLUMNS  # noqa: E402

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _misscaled(tc, **kw):
    """tests/test_diagnostics.py:193's problem: a variable on a 1e6-worse scale."""
    n = 4
    good, bad, pvar = (tc.variable("cw_good", (n,)), tc.variable("cw_bad", (n,)),
                       tc.variable("cw_p", (n,)))
    J = tc.norm2(good - pvar) + 1e10 * tc.norm2(bad) + tc.norm2(good - 1e4 * bad)
    return tc.optimize(objective=J, optimizationVariables=[good, bad],
                       constraints=[good >= -2.0, good <= 2.0], parameters=[pvar],
                       allowSave=True, profiling=True, maxIter=40, **kw)


def test_capture_ww_matches_jax(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "0")
    params = {"cw_p": np.array([0.5, -0.25, 1.0, 0.1])}
    js, ts = _misscaled(jtc), _misscaled(ttc, **CPU)
    # it = None: the largest direction error, a rounding residue whose
    # argmax is the packages' own
    cap, jcap = ts.capture_ww(params, mu0=1.0), js.capture_ww(params, mu0=1.0)
    assert cap["it"] >= 1
    nK = ts.nU + ts.nG + (0 if ts.opts.smallerNewtonMatrix else ts.nF)
    assert cap["WW"].shape == (nK, nK)
    rep = cap["report"]["variables"]
    assert rep["cw_bad"]["hess_diag_range"][1] > 1e6 * rep["cw_good"]["hess_diag_range"][1]
    assert any("rescal" in a for a in cap["report"]["advice"])
    assert cap["report"]["advice"] == jcap["report"]["advice"]

    cap2, jcap2 = ts.capture_ww(params, it=2, mu0=1.0), js.capture_ww(params, it=2, mu0=1.0)
    assert cap2["it"] == 2 and cap2["state"]["mu"] > 0
    scale = np.abs(jcap2["WW"]).max()
    assert np.abs(cap2["WW"] - jcap2["WW"]).max() <= 1e-8 * scale
    for k in ("u", "lam"):
        np.testing.assert_allclose(cap2["state"][k], jcap2["state"][k], rtol=1e-8, atol=1e-12)
    for k in ("mu", "addU", "addEq"):
        assert cap2["state"][k] == pytest.approx(jcap2["state"][k], rel=1e-8)
    # solve_result(save_iter=3): the iterate iteration 3 starts from (the
    # result of max_iter = 2, bitwise) with that iteration's adapted
    # regularizations; the JAX package's to 1e-8
    res = ts.solve_result(params, mu0=1.0, save_iter=3)
    u, nu, lam, mu, addU, addEq = res.saved
    prev = ts.solve_result(params, mu0=1.0, max_iter=2)
    assert torch.equal(u, prev.u) and torch.equal(lam, prev.lam) and torch.equal(mu, prev.mu)
    jres = js.solve_result(params, mu0=1.0, save_iter=3)
    np.testing.assert_allclose(u.numpy(), np.asarray(jres.saved[0]), rtol=1e-8, atol=1e-12)
    assert float(addU) == pytest.approx(float(jres.saved[4]), rel=1e-8)
    assert res.history.shape == (40, len(HISTORY_COLUMNS))
    z = ttc.variable("cw_z", (2,))
    with pytest.raises(ValueError, match="allowSave"):
        ttc.optimize(objective=ttc.norm2(z), optimizationVariables=[z], **CPU).capture_ww({})


def _sparsity_cases(tc):
    x, y = tc.variable("spy_x", (4,)), tc.variable("spy_y", (3,))
    e = x * x + tc.Tones((4,)) * tc.norm2(y)
    chain = tc.variable("spy_chain", (5,))
    xi, z = tc.variable("spy_ind_x", (2,)), tc.variable("spy_ind_z", (3,))
    return [(e, x), (e, y), (chain[1:] - 0.9 * chain[:-1], chain), (xi + 1.0, z)]


def test_sparsity_spy_and_op_tree_match_jax():
    for (te, tv), (je, jv) in zip(_sparsity_cases(ttc), _sparsity_cases(jtc)):
        pat = ttc.sparsity(te, tv)
        assert pat.dtype == bool and np.array_equal(pat, jtc.sparsity(je, jv))
    x = ttc.variable("spy_rep_x", (3, 3))
    buf = io.StringIO()
    rep = ttc.spy(ttc.norm2(x @ x), file=buf)
    assert rep == buf.getvalue().rstrip("\n")
    assert "computation graph" in rep and "d vec(expr)/d vec(spy_rep_x)" in rep
    assert "nnz=9" in rep and "aten.mm" in rep
    e = ttc.variable("spy_cap_x", (2,))
    for _ in range(10):
        e = e + 1.0
    assert len(ttc.op_tree(e, max_eqns=3).splitlines()) <= 4
    assert ttc.__version__ == "0.1.0"


def test_export_computation_graph(tmp_path):
    n = 4
    Q, x = ttc.variable("cg_Q", (n, n)), ttc.variable("cg_x", (n,))
    solver = ttc.optimize(objective=ttc.tprod(x, [-1], Q @ x, [-1]), optimizationVariables=[x],
                          constraints=[x >= -1.0, x <= 1.0], parameters=[Q], **CPU)
    meta = export_computation_graph(solver, tmp_path / "qp", include_hlo=True)
    saved = json.loads((tmp_path / "qp.meta.json").read_text())
    assert saved == json.loads(json.dumps(meta))
    assert saved["nU"] == n and saved["nF"] == 2 * n
    assert sum(saved["primitive_counts"].values()) > 0
    assert saved["primitive_counts"].get("mul.Tensor", 0) >= 1
    txt = (tmp_path / "qp.fx.txt").read_text()
    assert "# kkt_assembly" in txt and "# jac_F" in txt
    assert not (tmp_path / "qp.hlo.txt").exists()
