"""Loop-invariant derivative hoisting for the IPM (port of
``tenscalc_tpu/ipm/hoist.py``).

A derivative whose value does not depend on the iterate (the Hessian of
a quadratic, the Jacobian of a linear constraint) is computed once per
solve instead of in every iteration.  The decision is a structural
certificate: the derivative function is traced once into an FX graph of
ATen operations, and taint from the iterate arguments is propagated
through every node.  A numeric probe would not be a certificate.

The trace runs under ``torch.func.functionalize`` with views and
mutations removed, so every node is a pure function of its arguments.
Four facts keep the analysis from rejecting every quadratic:

* factory ops whose output depends only on the shape of their tensor
  argument (``ones_like``, ``new_zeros``, ``fill.Scalar``, ...) carry
  no value dependency;
* ``x ** 0`` (``aten.pow.Tensor_Scalar`` with exponent 0) is 1
  whatever ``x`` is, and appears in the second derivative of ``x ** 2``;
* zeros stay zeros: forward-mode AD materializes the tangent of a
  constant (a parameter matrix in ``A @ x``) as a zero tensor, which JAX
  keeps symbolic; a view or copy of a known zero, and a product with
  one (``mul``, ``mv``, ``mm``, ... or a division of one), is zero
  whatever the other operand holds;
* every other node's outputs are tainted when any input is (sound
  over-approximation), so a false "depends" only costs speed: ``sqrt``,
  ``floor``, ``sign``, a ``where`` on a comparison, ``searchsorted``, a
  Cholesky factor are no exception.

A function whose Python control flow reads a tensor's value (a loop
until a residual is small) cannot be traced into one graph: ``make_fx``
refuses to read the value.  Such a function is opaque and certifies
nothing, as the JAX package's analysis treats a ``while_loop``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

# ATen overload packets whose output depends only on the shape, dtype
# and device of their tensor arguments, never on the values.
_SHAPE_ONLY = frozenset(
    {
        "ones_like", "zeros_like", "empty_like", "full_like",
        "new_ones", "new_zeros", "new_empty", "new_full", "new_empty_strided",
        "scalar_tensor", "_efficientzerotensor", "zeros", "ones", "full",
        "empty", "empty_strided", "arange",
    }
)


# ATen overload packets whose output is all zeros.
_ZERO_FACTORIES = frozenset({"zeros", "zeros_like", "new_zeros", "_efficientzerotensor"})
# ... is zero when their first tensor argument is (views, copies, sums).
_ZERO_KEEPING = frozenset(
    {
        "expand", "expand_copy", "view", "view_copy", "_to_copy", "alias",
        "alias_copy", "permute", "permute_copy", "t", "t_copy", "transpose",
        "transpose_copy", "slice", "slice_copy", "select", "select_copy",
        "reshape", "clone", "squeeze", "squeeze_copy", "unsqueeze",
        "unsqueeze_copy", "contiguous", "neg", "sum", "div",
    }
)
# ... is zero when any tensor argument is (products).
_ZERO_ABSORBING = frozenset({"mul", "mv", "mm", "bmm", "matmul", "dot", "outer"})


def _packet_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    if packet is None:
        return ""
    return packet.__name__


def _value_free(node: torch.fx.Node) -> bool:
    """True when the node's value cannot depend on its tensor inputs."""
    name = _packet_name(node.target)
    if name in _SHAPE_ONLY:
        return True
    overload = getattr(node.target, "_overloadname", "")
    if name == "fill" and overload == "Scalar":
        return True
    if name == "pow" and overload == "Tensor_Scalar":
        return float(node.args[1]) == 0.0
    return False


def _is_zero(node: torch.fx.Node, zeros: set) -> bool:
    """True when the node's output is all zeros, given the known zeros."""
    name = _packet_name(node.target)
    if name in _ZERO_FACTORIES:
        return True
    if name in _ZERO_KEEPING:
        return bool(node.args) and node.args[0] in zeros
    if name in _ZERO_ABSORBING:
        return any(n in zeros for n in node.all_input_nodes)
    return False


def _data_dependent(err: Exception) -> bool:
    """Whether ``make_fx`` refused a function for reading a traced
    tensor's value (data-dependent control flow)."""
    return isinstance(err, RuntimeError) and "_local_scalar_dense" in str(err)


def _trace(fn: Callable, flat_args: Sequence[torch.Tensor]) -> torch.fx.Graph:
    gm = make_fx(torch.func.functionalize(fn, remove="mutations_and_views"))(
        *flat_args
    )
    return gm.graph


def _tainted_nodes(graph: torch.fx.Graph, in_taint: Sequence[bool]) -> set:
    """The nodes whose values depend on a tainted placeholder."""
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    tainted = {n for n, t in zip(placeholders, in_taint) if t}
    zeros: set = set()
    for node in graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op == "call_function" and _is_zero(node, zeros):
            zeros.add(node)
            continue
        if node.op == "call_function" and _value_free(node):
            continue
        if any(n in tainted for n in node.all_input_nodes):
            tainted.add(node)
    return tainted


class TaintGraph:
    """One trace of ``fn(*args)`` (tensor arguments) that answers several
    taint queries: which outputs depend on a given set of arguments.
    Tracing is the expensive step, so a build that asks many questions of
    the same derivative traces it once."""

    def __init__(self, fn: Callable, *args: torch.Tensor):
        self.graph = _trace(fn, list(args))
        self.n_args = len(args)
        out = next(n for n in self.graph.nodes if n.op == "output")
        self.outputs = pytree.tree_leaves(out.args[0])

    def output_dtypes(self) -> list:
        """Per output leaf: its dtype as traced (None for a constant)."""
        return [o.meta["val"].dtype if isinstance(o, torch.fx.Node) else None
                for o in self.outputs]

    def tainted_outputs(self, arg_indices) -> list:
        """Per output leaf: does it depend on any of ``arg_indices``?"""
        idx = set(arg_indices)
        tainted = _tainted_nodes(self.graph, [i in idx for i in range(self.n_args)])
        return [isinstance(o, torch.fx.Node) and o in tainted for o in self.outputs]


def _flat_fn(fn: Callable, example_args):
    flat, spec = pytree.tree_flatten(list(example_args))

    def flat_call(*leaves):
        return fn(*pytree.tree_unflatten(list(leaves), spec))

    return flat_call, flat


class DerivativeDtypeError(TypeError):
    """A derivative of the problem comes out in another dtype than the
    problem's: the KKT factor would fail on the mixed types."""


def output_independent_of(fn: Callable, n_tainted: int, *example_args,
                          dtype=None, what: str = "the output") -> bool:
    """True if every output of ``fn(*example_args)`` is independent of
    the first ``n_tainted`` (pytree) arguments.  With ``dtype`` given,
    raises :class:`DerivativeDtypeError` when an output is traced in
    another dtype (``what`` names it)."""
    flat_call, flat = _flat_fn(fn, example_args)
    try:
        graph = TaintGraph(flat_call, *flat)
    except RuntimeError as err:
        if _data_dependent(err):
            return False  # opaque: certifies nothing
        raise
    bad = [t for t in graph.output_dtypes() if dtype is not None and t not in (None, dtype)]
    if bad:
        raise DerivativeDtypeError(
            f"{what} comes out {bad[0]} in a {dtype} problem: an expression "
            "mixes dtypes (a lifted function or a constant of another dtype); "
            "cast it to the problem's dtype"
        )
    k = len(pytree.tree_leaves(list(example_args[:n_tainted])))
    return not any(graph.tainted_outputs(range(k)))


def param_value_deps(fn: Callable, penv_example, *args) -> set:
    """The parameter names (keys of the dict first argument) whose
    VALUES the outputs of ``fn(penv, *args)`` depend on.

    A fleet evaluates a hoisted derivative with the other parameters
    replaced by zeros, so that it carries no batch dimension when its
    true dependencies are shared by the fleet."""
    keys = sorted(penv_example)

    def call(pvals, *rest):
        return fn(dict(zip(keys, pvals)), *rest)

    flat_call, flat = _flat_fn(call, ([penv_example[k] for k in keys],) + args)
    try:
        graph = TaintGraph(flat_call, *flat)
    except RuntimeError as err:
        if _data_dependent(err):
            return set(keys)  # opaque: any parameter may reach the outputs
        raise
    return {key for i, key in enumerate(keys) if any(graph.tainted_outputs([i]))}


def _lagrangian(fns, nF: int, nG: int, penv):
    def lagr(u, nu, lam, s_ineq, s_cost):
        val = s_cost * fns.f(u, penv)
        if nF > 0:
            val = val - lam @ (s_ineq * fns.F(u, penv))
        if nG > 0:
            val = val + nu @ fns.G(u, penv)
        return val

    return lagr


def _dummies(nU: int, nF: int, nG: int, dt, param_shapes):
    penv = {k: torch.zeros(s, dtype=dt) for k, s in param_shapes.items()}
    return (
        penv, torch.zeros(nU, dtype=dt), torch.zeros(nG, dtype=dt),
        torch.ones(nF, dtype=dt), torch.ones(nF, dtype=dt),
        torch.ones((), dtype=dt),
    )


def analyze_scale_free(fns, nU: int, nF: int, nG: int, dt, param_shapes,
                       taint_ineq: bool, taint_cost: bool) -> bool:
    """True if the Lagrangian Hessian d2L/du2 is independent of the
    runtime scaling factors (scale_ineq, scale_cost) IN ADDITION to the
    iterates.  ``taint_ineq`` / ``taint_cost``: whether the respective
    scale actually varies at run time."""
    penv, u, nu, lam, s_ineq, s_cost = _dummies(nU, nF, nG, dt, param_shapes)
    lagr = _lagrangian(fns, nF, nG, penv)
    n_taint = 3 + int(taint_ineq) + int(taint_cost)
    args = [u, nu, lam]
    if taint_ineq:
        args.append(s_ineq)
    if taint_cost:
        args.append(s_cost)

    def Hfun(*a):
        si = a[3] if taint_ineq else s_ineq
        sc = a[3 + int(taint_ineq)] if taint_cost else s_cost
        return torch.func.jacfwd(torch.func.grad(lagr, argnums=0), argnums=0)(
            a[0], a[1], a[2], si, sc
        )

    return output_independent_of(Hfun, n_taint, *args)


def analyze_hoistable(fns, nU: int, nF: int, nG: int, dt, param_shapes):
    """Decide which IPM derivative matrices are iteration-invariant.

    Returns ``(h_const, fu_const, gu_const)`` for the Lagrangian Hessian
    d2L/du2 (w.r.t. u, nu, lam jointly) and the constraint Jacobians
    dF/du, dG/du (w.r.t. u).  Zeros stand in for the parameter values
    (the analysis is shape-only).  Raises :class:`DerivativeDtypeError`
    when one of them comes out in another dtype than ``dt``."""
    penv, u, nu, lam, s_ineq, s_cost = _dummies(nU, nF, nG, dt, param_shapes)
    lagr = _lagrangian(fns, nF, nG, penv)
    jac = torch.func.jacfwd
    h_const = output_independent_of(
        jac(torch.func.grad(lagr, argnums=0), argnums=0),
        3, u, nu, lam, s_ineq, s_cost, dtype=dt, what="the Hessian of the Lagrangian",
    )
    fu_const = nF > 0 and output_independent_of(
        lambda uu: jac(lambda v: fns.F(v, penv))(uu), 1, u,
        dtype=dt, what="the Jacobian of the inequalities",
    )
    gu_const = nG > 0 and output_independent_of(
        lambda uu: jac(lambda v: fns.G(v, penv))(uu), 1, u,
        dtype=dt, what="the Jacobian of the equalities",
    )
    return h_const, bool(fu_const), bool(gu_const)
