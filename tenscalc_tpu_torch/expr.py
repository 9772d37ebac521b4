"""Deferred tensor expressions evaluated with PyTorch (port of
``tenscalc_tpu/expr.py``).

An :class:`Expr` is a pure function from an environment (dict of named
tensors) to a tensor, with a static shape.  Derivatives come from
``torch.func`` applied to the evaluated functions, never from the
expressions themselves, so any operator written in plain tensor ops is
differentiable.

Python numbers take the tensor's dtype the way JAX's weakly typed
scalars do (a float beside a tensor of an arithmetic operator is a 0-dim
tensor of its dtype, made when the expression is built); array constants
are materialized on the environment's device and float dtype when
evaluated.
"""

from __future__ import annotations

import numbers
import operator
from typing import Callable, Dict, FrozenSet, Sequence, Tuple, Union

import numpy as np
import torch

Env = Dict[str, torch.Tensor]


def _normalize_shape(shape) -> Tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _env_like(env: Env) -> Tuple[torch.dtype, torch.device]:
    """Float dtype and device of the environment's tensors (float64 on
    the CPU for an empty environment)."""
    for v in env.values():
        if isinstance(v, torch.Tensor):
            dt = v.dtype if v.is_floating_point() else torch.float64
            return dt, v.device
    return torch.float64, torch.device("cpu")


class Expr:
    """A deferred tensor computation: ``env -> tensor`` with static shape.

    ``deps`` is the set of variable/parameter names the expression reads.
    """

    __slots__ = ("fn", "shape", "deps", "name")
    __array_priority__ = 100  # win ufunc dispatch against numpy arrays

    def __init__(self, fn: Callable[[Env], torch.Tensor],
                 shape: Tuple[int, ...], deps: FrozenSet[str],
                 name: str = ""):
        self.fn = fn
        self.shape = _normalize_shape(shape)
        self.deps = frozenset(deps)
        self.name = name

    def __call__(self, env: Env) -> torch.Tensor:
        return self.fn(env)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of scalar Expr")
        return self.shape[0]

    def __repr__(self) -> str:
        nm = f" {self.name}" if self.name else ""
        return f"Expr{nm}[{','.join(map(str, self.shape))} deps={sorted(self.deps)}]"

    # -- arithmetic ---------------------------------------------------
    def __add__(self, other):
        return binary_op(operator.add, self, other)

    def __radd__(self, other):
        return binary_op(operator.add, other, self)

    def __sub__(self, other):
        return binary_op(operator.sub, self, other)

    def __rsub__(self, other):
        return binary_op(operator.sub, other, self)

    def __mul__(self, other):
        return binary_op(operator.mul, self, other)

    def __rmul__(self, other):
        return binary_op(operator.mul, other, self)

    def __truediv__(self, other):
        return binary_op(operator.truediv, self, other)

    def __rtruediv__(self, other):
        return binary_op(operator.truediv, other, self)

    def __pow__(self, other):
        return binary_op(operator.pow, self, other)

    def __rpow__(self, other):
        return binary_op(operator.pow, other, self)

    def __neg__(self):
        return unary_op(operator.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        return unary_op(torch.abs, self)

    def __matmul__(self, other):
        return binary_op(torch.matmul, self, other)

    def __rmatmul__(self, other):
        return binary_op(torch.matmul, other, self)

    # -- indexing / shaping -------------------------------------------
    def __getitem__(self, idx):
        return unary_op(lambda x: x[idx], self)

    @property
    def at(self):
        """Indexed assignment in JAX's functional idiom:
        ``x.at[I].set(y)``, ``.add(y)``, ``.multiply(y)`` return a new
        expression (the value of ``x`` with entries ``I`` replaced)."""
        return _AtHelper(self)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return unary_op(lambda x: torch.reshape(x, shape), self)

    def ravel(self):
        return unary_op(torch.ravel, self)

    def flatten(self):
        return self.ravel()

    @property
    def T(self):
        return unary_op(
            lambda x: x.transpose(-1, -2) if x.dim() >= 2 else x, self
        )

    def transpose(self, *axes):
        if not axes:
            return self.T
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return unary_op(lambda x: x.permute(axes), self)

    def sum(self, axis=None, keepdims=False):
        if axis is None:
            return unary_op(torch.sum, self)
        return unary_op(
            lambda x: torch.sum(x, dim=axis, keepdim=keepdims), self
        )

    def min(self, axis=None, keepdims=False):
        if axis is None:
            return unary_op(torch.amin, self)
        return unary_op(
            lambda x: torch.amin(x, dim=axis, keepdim=keepdims), self
        )

    def max(self, axis=None, keepdims=False):
        if axis is None:
            return unary_op(torch.amax, self)
        return unary_op(
            lambda x: torch.amax(x, dim=axis, keepdim=keepdims), self
        )

    def trace(self):
        return unary_op(torch.trace, self)

    def diag(self):
        return unary_op(torch.diag, self)

    # -- comparisons create constraints -------------------------------
    def __ge__(self, other) -> "Constraint":
        return Constraint("ineq", binary_op(operator.sub, self, other))

    def __le__(self, other) -> "Constraint":
        return Constraint("ineq", binary_op(operator.sub, other, self))

    def __gt__(self, other) -> "Constraint":
        return self.__ge__(other)

    def __lt__(self, other) -> "Constraint":
        return self.__le__(other)

    def __eq__(self, other) -> "Constraint":  # type: ignore[override]
        return Constraint("eq", binary_op(operator.sub, self, other))

    def __ne__(self, other):  # type: ignore[override]
        raise TypeError("!= is not a valid constraint; use ==, >= or <=")

    def __hash__(self):
        return id(self)


class _AtHelper:
    """``expr.at[idx]`` accessor (see :attr:`Expr.at`)."""

    def __init__(self, expr: Expr):
        self._expr = expr

    def __getitem__(self, idx):
        return _AtIndexed(self._expr, idx)


def _at_update(x: torch.Tensor, idx, v, how: str) -> torch.Tensor:
    y = x.clone()
    if how == "set":
        y[idx] = v
    elif how == "add":
        y[idx] = y[idx] + v
    else:
        y[idx] = y[idx] * v
    return y


class _AtIndexed:
    def __init__(self, expr: Expr, idx):
        self._expr = expr
        self._idx = idx

    def _update(self, value, how: str) -> Expr:
        idx = self._idx
        return binary_op(lambda x, v: _at_update(x, idx, v, how), self._expr, value)

    def set(self, value):
        return self._update(value, "set")

    def add(self, value):
        return self._update(value, "add")

    def multiply(self, value):
        return self._update(value, "multiply")


# Registry of declared variable shapes, used to infer expression shapes.
_VARIABLE_SHAPES: Dict[str, Tuple[int, ...]] = {}


class Variable(Expr):
    """A named leaf that reads its value from the environment; the
    problem builder decides whether it is an optimization variable or a
    parameter."""

    __slots__ = ()

    def __init__(self, name: str, shape=()):
        shape = _normalize_shape(shape)
        super().__init__(lambda env, _n=name: env[_n], shape, {name}, name)
        prev = _VARIABLE_SHAPES.get(name)
        if prev is not None and prev != self.shape:
            raise ValueError(
                f"variable {name!r} re-declared with shape {self.shape}, "
                f"previously {prev}"
            )
        _VARIABLE_SHAPES[name] = self.shape

    def __repr__(self) -> str:
        return f"Variable {self.name}[{','.join(map(str, self.shape))}]"

    def __hash__(self):
        return id(self)


def variable(name: str, shape=()) -> Variable:
    """Create a named tensor variable."""
    return Variable(name, shape)


def parameter(name: str, shape=()) -> Variable:
    """Alias of :func:`variable`; the role is decided by the problem builder."""
    return Variable(name, shape)


Tvariable = variable


def clear_variables() -> None:
    """Forget all declared variable shapes."""
    _VARIABLE_SHAPES.clear()


def constant(value, shape=None) -> Expr:
    """Embed a constant array.  Float constants take the environment's
    float dtype and device when evaluated."""
    arr = np.asarray(value)
    if shape is not None:
        arr = np.broadcast_to(arr, _normalize_shape(shape))
    is_float = arr.dtype.kind == "f"

    def fn(env, _a=arr):
        dt, dev = _env_like(env)
        return torch.as_tensor(_a, dtype=dt if is_float else None, device=dev)

    return Expr(fn, arr.shape, frozenset(), "const")


Tconstant = constant


def Tzeros(shape=()) -> Expr:
    shape = _normalize_shape(shape)

    def fn(env):
        dt, dev = _env_like(env)
        return torch.zeros(shape, dtype=dt, device=dev)

    return Expr(fn, shape, frozenset(), "zeros")


def Tones(shape=()) -> Expr:
    shape = _normalize_shape(shape)

    def fn(env):
        dt, dev = _env_like(env)
        return torch.ones(shape, dtype=dt, device=dev)

    return Expr(fn, shape, frozenset(), "ones")


def Teye(n, m=None) -> Expr:
    m = n if m is None else m

    def fn(env):
        dt, dev = _env_like(env)
        return torch.eye(n, m, dtype=dt, device=dev)

    return Expr(fn, (n, m), frozenset(), "eye")


def to_expr(x) -> Expr:
    """Coerce scalars/arrays to Expr."""
    if isinstance(x, Expr):
        return x
    return constant(x)


def _operand(x):
    """Expr operand, or a Python number kept as it is (weakly typed)."""
    if isinstance(x, Expr):
        return x
    if isinstance(x, numbers.Real) and not isinstance(x, (bool, np.bool_)):
        return float(x) if isinstance(x, (float, np.floating)) else int(x)
    return constant(x)


def _value(x, env):
    return x(env) if isinstance(x, Expr) else x


def _deps(*xs) -> FrozenSet[str]:
    return frozenset().union(*[x.deps for x in xs if isinstance(x, Expr)])


def _shape_of(fn: Callable[[Env], torch.Tensor],
              deps: FrozenSet[str]) -> Tuple[int, ...]:
    """Static output shape, by evaluating ``fn`` on meta tensors (no
    data is allocated or computed)."""
    env = {
        n: torch.empty(_VARIABLE_SHAPES[n], dtype=torch.float32, device="meta")
        for n in deps
    }
    return tuple(torch.as_tensor(fn(env)).shape)


def unary_op(f: Callable, a) -> Expr:
    a = to_expr(a)

    def fn(env, _f=f, _a=a):
        return _f(_a(env))

    return Expr(fn, _shape_of(fn, a.deps), a.deps)


class _WeakFloat(float):
    """A Python float operand of an arithmetic operator, weakly typed as
    in JAX: beside a float32 or float64 tensor it is a 0-dim CPU tensor of
    that dtype, made once here, so evaluating the expression allocates
    nothing and launches nothing for it.  Kept as a number, PyTorch's
    forward-mode AD gives a 0-dim float32 tensor minus, times or over it a
    float64 tangent, and the Hessian comes out float64.  (A Python int
    has no such tangent, so it stays an int.)"""

    def __new__(cls, v: float):
        self = super().__new__(cls, v)
        self.by_dtype = {dt: torch.tensor(float(v), dtype=dt)
                         for dt in (torch.float32, torch.float64)}
        return self


def _weak(x):
    return _WeakFloat(x) if type(x) is float else x


def binary_op(f: Callable, a, b) -> Expr:
    a, b = _weak(_operand(a)), _operand(b)
    # a number exponent stays a number: ``x ** 2`` keeps aten.pow's scalar
    # overload, which ipm/hoist.py reads, and has no such tangent
    if f is not operator.pow:
        b = _weak(b)
    deps = _deps(a, b)

    def fn(env, _f=f, _a=a, _b=b):
        x, y = _value(_a, env), _value(_b, env)
        if isinstance(y, torch.Tensor) and isinstance(x, _WeakFloat):
            x = x.by_dtype.get(y.dtype, x)
        elif isinstance(x, torch.Tensor) and isinstance(y, _WeakFloat):
            y = y.by_dtype.get(x.dtype, y)
        return _f(x, y)

    return Expr(fn, _shape_of(fn, deps), deps)


def nary_op(f: Callable, *args) -> Expr:
    exprs = [to_expr(a) for a in args]
    deps = _deps(*exprs)

    def fn(env, _f=f, _es=tuple(exprs)):
        return _f(*[e(env) for e in _es])

    return Expr(fn, _shape_of(fn, deps), deps)


def lift(f: Callable) -> Callable:
    """Lift a torch function to operate on Expr arguments.

    Python numbers pass through as they are; keyword args must be static.
    """

    def wrapped(*args, **kwargs):
        if not any(isinstance(a, Expr) for a in args):
            return f(*args, **kwargs)
        ops = [_operand(a) for a in args]
        deps = _deps(*ops)

        def fn(env, _f=f, _ops=tuple(ops), _kw=kwargs):
            return _f(*[_value(o, env) for o in _ops], **_kw)

        return Expr(fn, _shape_of(fn, deps), deps)

    wrapped.__name__ = getattr(f, "__name__", "lifted")
    return wrapped


def concat(exprs: Sequence, axis: int = 0) -> Expr:
    return nary_op(
        lambda *xs: torch.cat([torch.atleast_1d(x) for x in xs], dim=axis),
        *exprs,
    )


def vertcat(*exprs) -> Expr:
    return concat(exprs, axis=0)


def horzcat(*exprs) -> Expr:
    return concat(exprs, axis=-1)


def stack(exprs: Sequence, axis: int = 0) -> Expr:
    return nary_op(lambda *xs: torch.stack(xs, dim=axis), *exprs)


def substitute(expr: Expr, old: Union[Variable, Sequence[Variable]], new) -> Expr:
    """Replace variable(s) by expression(s): evaluate ``new`` in the
    outer environment and rebind the entries named by ``old``."""
    if isinstance(old, Variable):
        olds, news = [old], [to_expr(new)]
    else:
        olds = list(old)
        news = [to_expr(n) for n in new]
    if len(olds) != len(news):
        raise ValueError("substitute: mismatched variable/value lists")
    deps = (expr.deps - {o.name for o in olds}) | _deps(*news)

    def fn(env, _e=expr, _olds=tuple(olds), _news=tuple(news)):
        env2 = dict(env)
        for o, n in zip(_olds, _news):
            env2[o.name] = n(env)
        return _e(env2)

    return Expr(fn, expr.shape, deps)


def gradient(f, x: Variable) -> Expr:
    """Partial derivatives of ``f`` with respect to the variable ``x``:
    shape ``f.shape + x.shape``, ``g[i..., j...] = d f[i...] / d x[j...]``.
    Reverse mode (``torch.func.jacrev``) when ``f`` is no larger than
    ``x``, else forward mode, as the JAX package chooses."""
    f = to_expr(f)
    if not isinstance(x, Variable):
        raise TypeError("gradient: second argument must be a Variable")
    deps = f.deps | {x.name}
    mode = torch.func.jacrev if f.size <= x.size else torch.func.jacfwd

    def fn(env, _f=f, _n=x.name, _mode=mode):
        def g(xv):
            env2 = dict(env)
            env2[_n] = xv
            return _f(env2)

        out = _mode(g)(env[_n])
        # a derivative that AD knows to be zero comes as a ZeroTensor,
        # which numpy and in-place operations refuse: materialize it
        return torch.zeros_like(out) if out._is_zerotensor() else out

    return Expr(fn, f.shape + x.shape, deps, "gradient")


def jacobian(f, x: Variable) -> Expr:
    """Alias of :func:`gradient`."""
    return gradient(f, x)


def hessian(f, x: Variable, y: Variable = None) -> Expr:
    """``gradient(gradient(f, x), y or x)``: shape ``f.shape + x.shape +
    y.shape``."""
    return gradient(gradient(f, x), x if y is None else y)


class Constraint:
    """A parsed constraint: ``expr >= 0`` (ineq) or ``expr == 0`` (eq)."""

    __slots__ = ("kind", "expr")

    def __init__(self, kind: str, expr: Expr):
        if kind not in ("ineq", "eq"):
            raise ValueError(f"constraint kind must be 'ineq' or 'eq', not {kind!r}")
        self.kind = kind
        self.expr = expr

    def __repr__(self) -> str:
        op = ">= 0" if self.kind == "ineq" else "== 0"
        return f"Constraint[{','.join(map(str, self.expr.shape))}] {op}"

    def __bool__(self):
        raise TypeError(
            "Constraint is not a boolean; pass it in the `constraints` list"
        )
