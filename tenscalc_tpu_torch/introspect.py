"""Graph introspection (port of ``tenscalc_tpu/introspect.py``): the
analog of the reference's ``lib/@Tcalculus/spy.m`` (recursive
expression-tree printer) and of MATLAB's ``spy`` sparsity plot that
TensCalc users apply to symbolic Jacobians/Hessians.

An :class:`~tenscalc_tpu_torch.expr.Expr` is a deferred torch closure,
so the "expression tree" is its traced ATen graph (``make_fx``: what
actually runs), and structural sparsity is recovered numerically: the
Jacobian (``torch.func.jacfwd``) is evaluated at a couple of random
points, and entries that are nonzero at any of them are structurally
nonzero (random values reveal structure almost surely; the reference's
sparsity_* rules instantiate "typical values" for the same reason,
lib/@csparse/sparsity_ldl.m:40-62).  The probes are the JAX package's:
numpy draws from ``seed``, in float64 on the CPU.

Public API:

* ``spy(expr)``            — print op tree + per-variable Jacobian spy
* ``spy(expr, var)``       — only d expr / d var
* ``sparsity(expr, var)``  — the boolean structural-Jacobian matrix
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx
from torch.func import jacfwd

from .expr import _VARIABLE_SHAPES, Expr, to_expr

__all__ = ["spy", "sparsity", "op_tree"]


def _random_env(deps, rng):
    return {
        n: torch.as_tensor(rng.standard_normal(_VARIABLE_SHAPES[n]) + 0.5)
        for n in deps
    }


def sparsity(expr: Expr, var, n_probes: int = 2, seed: int = 0) -> np.ndarray:
    """Structural sparsity of ``d vec(expr) / d vec(var)`` as a boolean
    (expr.size, var.size) matrix.  ``var`` may be a Variable or a name."""
    expr = to_expr(expr)
    vname = var if isinstance(var, str) else var.name
    if vname not in expr.deps:
        return np.zeros((expr.size, int(np.prod(_VARIABLE_SHAPES[vname]) or 1)),
                        dtype=bool)
    vshape = _VARIABLE_SHAPES[vname]
    rng = np.random.default_rng(seed)
    pat = None
    for _ in range(n_probes):
        env = _random_env(expr.deps, rng)

        def flat(vflat):
            e = dict(env)
            e[vname] = vflat.reshape(vshape)
            return expr.fn(e).reshape(-1)

        J = jacfwd(flat)(env[vname].reshape(-1))
        # non-finite entries (e.g. a division whose denominator hits zero
        # at the probe point) are genuinely dependent — count as nonzero
        nz = ((J.abs() > 0) | ~torch.isfinite(J)).numpy()
        pat = nz if pat is None else (pat | nz)
    return pat


def _ascii_spy(pat: np.ndarray, max_rows: int = 40, max_cols: int = 80) -> str:
    """Render a boolean matrix as an ASCII spy plot, block-downsampled
    when larger than the character budget ('*' = any nonzero in block)."""
    m, n = pat.shape
    if m == 0 or n == 0:
        return "  (empty)"
    br = -(-m // max_rows)  # ceil
    bc = -(-n // max_cols)
    M = -(-m // br)
    N = -(-n // bc)
    padded = np.zeros((M * br, N * bc), dtype=bool)
    padded[:m, :n] = pat
    blocks = padded.reshape(M, br, N, bc).any(axis=(1, 3))
    lines = ["  " + "".join("*" if b else "." for b in row) for row in blocks]
    if br > 1 or bc > 1:
        lines.append(f"  (each char = {br}x{bc} block)")
    return "\n".join(lines)


def op_tree(expr: Expr, max_eqns: int = 200) -> str:
    """The traced computation graph of ``expr`` as an op listing, one line
    per ATen operation of its ``make_fx`` graph: the operation, its output
    shape <- its tensor inputs' shapes (float32 inputs of the declared
    shapes).  This is the dataflow that runs, which the reference's
    spy.m prints before common-subexpression elimination."""
    expr = to_expr(expr)
    names = sorted(expr.deps)
    args = [torch.zeros(_VARIABLE_SHAPES[n], dtype=torch.float32) for n in names]
    graph = make_fx(lambda *xs: expr.fn(dict(zip(names, xs))))(*args).graph

    def shp(node):
        v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
        if not isinstance(v, torch.Tensor):
            return None
        return "x".join(map(str, v.shape)) if v.dim() else "scalar"

    ops = [nd for nd in graph.nodes if nd.op == "call_function"]
    lines = []
    for nd in ops[:max_eqns]:
        ins = ",".join(s for s in map(shp, pytree.tree_leaves((nd.args, nd.kwargs)))
                       if s is not None)
        lines.append(f"  {nd.target}[{shp(nd) or ''}] <- ({ins})")
    if len(ops) > max_eqns:
        lines.append(f"  ... ({len(ops)} operations total)")
    return "\n".join(lines)


def spy(
    expr: Expr,
    var=None,
    *,
    show_tree: bool = True,
    max_rows: int = 40,
    max_cols: int = 80,
    file=None,
) -> str:
    """Print (and return) an introspection report for ``expr``: the
    traced op graph plus ASCII structural-Jacobian spy plots w.r.t. each
    declared dependency (or only ``var``).  Reference:
    lib/@Tcalculus/spy.m."""
    expr = to_expr(expr)
    out = [repr(expr)]
    if show_tree:
        out.append("computation graph (make_fx ATen graph):")
        out.append(op_tree(expr))
    names = (
        [var if isinstance(var, str) else var.name]
        if var is not None
        else sorted(expr.deps)
    )
    for vname in names:
        pat = sparsity(expr, vname)
        nnz = int(pat.sum())
        tot = pat.size
        dens = nnz / tot if tot else 0.0
        out.append(
            f"d vec(expr)/d vec({vname}): {pat.shape[0]}x{pat.shape[1]}, "
            f"nnz={nnz} ({100.0 * dens:.1f}%)"
        )
        out.append(_ascii_spy(pat, max_rows, max_cols))
    report = "\n".join(out)
    print(report, file=file)
    return report
