"""Functions of TensCalc's operator set (port of ``tenscalc_tpu/ops/fns.py``).

Each function takes plain tensors or
:class:`~tenscalc_tpu_torch.expr.Expr` objects (lifted through deferred
evaluation), and is a plain function of tensors: its derivatives come
from ``torch.func``.  Norms, matrix functions, componentwise functions,
``compose``, the table interpolation, and the factorization expressions
(an unpivoted elimination, a Python loop over the columns).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..expr import Expr, lift, nary_op


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """A number or tensor ``v`` as a tensor of ``ref``'s dtype and device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

@lift
def norm1(x):
    """Sum of absolute values of all entries."""
    return torch.sum(torch.abs(x))


@lift
def norm2(x, S=None):
    """Squared Frobenius norm ``sum(x.^2)`` (TensCalc's norm2 is the
    *square*, not the root), or the quadratic form x' S x when ``S`` is
    given."""
    if S is None:
        return (x * x).sum()
    return torch.vdot(x.reshape(-1), (S @ x).reshape(-1))


@lift
def norminf(x):
    """Max absolute value over all entries."""
    return torch.amax(torch.abs(x))


# ---------------------------------------------------------------------------
# matrix functions
# ---------------------------------------------------------------------------

def _symmetrized(A: torch.Tensor) -> torch.Tensor:
    """(A + A') / 2: the matrix ``jnp.linalg.cholesky`` factors, so that
    the factor's derivative is symmetric in A."""
    return (A + A.mT) / 2


@lift
def logdet(A):
    """log(det(A)) for symmetric positive-definite A, through a Cholesky
    factor (its derivative never forms inv(A))."""
    L = torch.linalg.cholesky(_symmetrized(A))
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))


@lift
def traceinv(A):
    """trace(inv(A))."""
    return torch.trace(torch.linalg.inv(A))


@lift
def det(A):
    return torch.linalg.det(A)


@lift
def inv(A):
    return torch.linalg.inv(A)


@lift
def mldivide(A, b):
    """MATLAB ``A\\b``."""
    return torch.linalg.solve(A, b)


@lift
def trace(A):
    return torch.trace(A)


@lift
def diag(x):
    return torch.diag(x)


# ---------------------------------------------------------------------------
# componentwise functions
# ---------------------------------------------------------------------------

@lift
def relu(x):
    return torch.maximum(x, torch.zeros_like(x))


@lift
def srelu(x):
    """Smooth relu log(1 + exp(x))."""
    return torch.logaddexp(x, torch.zeros_like(x))


@lift
def heaviside(x):
    """1 for x > 0, 1/2 at 0, 0 for x < 0."""
    one, half = torch.ones_like(x), torch.full_like(x, 0.5)
    return torch.where(x > 0, one, torch.where(x < 0, torch.zeros_like(x), half))


@lift
def sqr(x):
    return x * x


@lift
def cube(x):
    return x * x * x


@lift
def sign(x):
    return torch.sign(x)


@lift
def sqrt(x):
    return torch.sqrt(x)


@lift
def exp(x):
    return torch.exp(x)


@lift
def log(x):
    return torch.log(x)


@lift
def sin(x):
    return torch.sin(x)


@lift
def cos(x):
    return torch.cos(x)


@lift
def tan(x):
    return torch.tan(x)


@lift
def atan(x):
    return torch.atan(x)


@lift
def normpdf(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


@lift
def absv(x):
    return torch.abs(x)


@lift
def round(x):  # noqa: A001 - TensCalc's name
    """Rounds half to even, as ``jnp.round``."""
    return torch.round(x)


@lift
def ceil(x):
    return torch.ceil(x)


@lift
def floor(x):
    return torch.floor(x)


@lift
def lngamma(x):
    """log(gamma(x)), with the digamma function as its derivative."""
    return torch.lgamma(x)


@lift
def sheaviside(x):
    """Soft heaviside 1 / (1 + exp(-x))."""
    return torch.sigmoid(x)


@lift
def dsheaviside(x):
    """Derivative of the soft heaviside, 1 / (2 + exp(x) + exp(-x))."""
    s = torch.sigmoid(x)
    return s * (1.0 - s)


def compose(x, fun):
    """Apply a function of one entry to every entry of ``x``
    (``torch.func.vmap``, so ``fun`` is differentiated through).  A
    ``fun`` that maps an entry to a tensor appends its axes at the end:
    ``y[i, j, k, l, m] = fun(x[i, j, k])[l, m]``."""

    def impl(_x):
        out = torch.func.vmap(fun)(torch.reshape(_x, (-1,)))
        return torch.reshape(out, tuple(_x.shape) + tuple(out.shape[1:]))

    return lift(impl)(x)


def _entrywise(f):
    """``f`` of two tensors, either of which may be a number."""
    def impl(x, y):
        ref = x if isinstance(x, torch.Tensor) else y
        return f(_like(x, ref), _like(y, ref))

    return impl


def min2(a, b):
    """Entrywise minimum of two tensors."""
    return lift(_entrywise(torch.minimum))(a, b)


def max2(a, b):
    """Entrywise maximum of two tensors."""
    return lift(_entrywise(torch.maximum))(a, b)


def _indicator(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return t.to(ref.dtype if ref.is_floating_point() else torch.get_default_dtype())


def allv(x, axis=None):
    """1.0 where all entries (along ``axis``) are nonzero; its derivative
    is zero."""
    return lift(lambda _x: _indicator(
        torch.all(_x != 0) if axis is None else torch.all(_x != 0, dim=axis), _x))(x)


def anyv(x, axis=None):
    """1.0 where any entry (along ``axis``) is nonzero."""
    return lift(lambda _x: _indicator(
        torch.any(_x != 0) if axis is None else torch.any(_x != 0, dim=axis), _x))(x)


def norm(x, p=2):
    """The p-norm of vec(x) for p in {1, 2, inf}; unlike :func:`norm2`
    the root.  Not differentiable at x = 0 (NaN gradient there): smooth
    objectives use :func:`norm2`."""
    if p == 1:
        return norm1(x)
    if p == 2:
        return lift(lambda _x: torch.sqrt(torch.sum(_x * _x)))(x)
    if p in (math.inf, "inf"):
        return norminf(x)
    raise ValueError(f"norm: unsupported order {p!r}")


def repmat(x, *reps):
    """Tile a tensor."""
    if len(reps) == 1 and isinstance(reps[0], (tuple, list)):
        reps = tuple(reps[0])
    return lift(lambda _x: torch.tile(_x, tuple(reps)))(x)


def permute(x, order):
    """Permute axes with MATLAB's 1-based ``order`` (0-based accepted)."""
    order = list(order)
    if order and min(order) == 1:
        order = [o - 1 for o in order]
    return lift(lambda _x: _x.permute(*order))(x)


# ---------------------------------------------------------------------------
# fraction to the boundary
# ---------------------------------------------------------------------------

@lift
def clp(x, dx):
    """max { alpha >= 0 : x + alpha dx >= 0 } for x > 0: entries with
    dx >= 0 impose no limit, +inf when none does."""
    neg = dx < 0
    ratio = torch.where(neg, -x / torch.where(neg, dx, -torch.ones_like(dx)),
                        torch.full_like(x, math.inf))
    return torch.amin(ratio) if ratio.dim() > 0 else ratio


# ---------------------------------------------------------------------------
# shaping helpers
# ---------------------------------------------------------------------------

def vec2tensor(x, shape):
    """Reshape into ``shape`` in column-major (MATLAB) order."""
    shape = tuple(int(s) for s in shape)

    def impl(_x):
        flat = _x.permute(*reversed(range(_x.dim()))).reshape(-1)
        return flat.reshape(shape[::-1]).permute(*reversed(range(len(shape))))

    return lift(impl)(x)


@lift
def full(x):
    """Densify: a no-op, tensors are dense."""
    return x


@lift
def pdist2t(x, y):
    """Pairwise squared distances between columns."""
    d = x[:, :, None] - y[:, None, :]
    return torch.sum(d * d, dim=0)


# ---------------------------------------------------------------------------
# tprod: TensCalc's generalized tensor product
# ---------------------------------------------------------------------------

def tprod(*args):
    """Generalized tensor product with signed index lists.

    ``tprod(A, ia, B, ib, ...)``: each ``ia`` has one integer per axis of
    its factor; a positive k maps the axis to output axis k (1-based), a
    negative one is summed over, contracted with the axes of the other
    factors that carry the same negative index.  ``tprod(A, [1, -1], B,
    [-1, 2])`` is A @ B."""
    if len(args) % 2 != 0:
        raise ValueError("tprod expects (tensor, index-list) pairs")
    tensors = list(args[0::2])
    indices = [list(ix) if isinstance(ix, (list, tuple)) else [ix] for ix in args[1::2]]
    letters: dict = {}

    def letter(ix: int) -> str:
        if ix not in letters:
            letters[ix] = chr(ord("a") + len(letters))
        return letters[ix]

    in_specs, out_axes = [], {}
    for ixs in indices:
        spec = ""
        for ix in ixs:
            spec += letter(ix)
            if ix > 0:
                out_axes[ix] = letters[ix]
        in_specs.append(spec)
    if out_axes and sorted(out_axes) != list(range(1, max(out_axes) + 1)):
        raise ValueError(f"tprod: output indices must be 1..k, got {sorted(out_axes)}")
    spec = ",".join(in_specs) + "->" + "".join(out_axes[k] for k in sorted(out_axes))
    if any(isinstance(t, Expr) for t in tensors):
        return nary_op(lambda *xs: torch.einsum(spec, *xs), *tensors)
    return torch.einsum(spec, *tensors)


# ---------------------------------------------------------------------------
# table interpolation
# ---------------------------------------------------------------------------

def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` in the same operations: the segment from
    ``searchsorted`` (right side), the slope's division guarded where a
    segment is shorter than float eps's spacing, ``fp[0]`` / ``fp[-1]``
    outside the table."""
    xp, fp = _like(xp, x), _like(fp, x)
    i = torch.clamp(torch.searchsorted(xp, x.detach(), right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64 if x.dtype == torch.float64
                                    else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _gauss_interp_fn(method, n_query_axes):
    """Gaussian-kernel interpolation over scattered tables: points ``Xi``
    ``[*sx, K]``, values ``Yi`` ``[*sy, K]``, query ``x`` ``sx``, scale
    ``S``; returns ``sy``:
      ugaussian:  F(x) = sum_k Yi_k exp(-||x - Xi_k||^2 / (2 S^2))
      ngaussian:  F(x) / sum_k exp(-||x - Xi_k||^2 / (2 S^2))."""

    def impl(_x, _Xi, _Yi, _S):
        D = _Xi - _x[..., None]
        D2 = torch.sum(D * D, dim=tuple(range(n_query_axes)))
        ED2 = torch.exp(-D2 / (2.0 * _S * _S))
        F = torch.tensordot(_Yi, ED2, dims=([_Yi.dim() - 1], [0]))
        if method == "ngaussian":
            F = F / torch.sum(ED2)
        elif method != "ugaussian":
            raise ValueError(f"unknown interpolation method '{method}'")
        return F

    return impl


def _n_query_axes(x) -> int:
    return len(getattr(x, "shape", np.shape(x)))


def interpolate(x, Xi, Yi, S=None, method="linear"):
    """Table interpolation: ``method='linear'`` the 1-D piecewise-linear
    interpolant over a sorted table (``interpolate(x, Xi, Yi)``, the
    values of ``jnp.interp``); ``'ugaussian'`` / ``'ngaussian'`` the
    Gaussian-kernel interpolants over scattered tables, scale ``S``."""
    if method == "linear":
        return lift(_interp)(x, Xi, Yi)
    return lift(_gauss_interp_fn(method, _n_query_axes(x)))(x, Xi, Yi, S)


def Ginterpolate(x, Xi, Yi, S=None, method="linear"):
    """Gradient of the interpolant with respect to the query point:
    ``[*sy, *sx]`` (for 'linear', entrywise: the active segment's slope,
    0 outside the table)."""
    if method == "linear":
        def impl(_x, _Xi, _Yi):
            return torch.func.jvp(lambda q: _interp(q, _Xi, _Yi), (_x,),
                                  (torch.ones_like(_x),))[1]

        return lift(impl)(x, Xi, Yi)
    base = _gauss_interp_fn(method, _n_query_axes(x))

    def impl(_x, _Xi, _Yi, _S):
        return torch.func.jacfwd(lambda q: base(q, _Xi, _Yi, _S))(_x)

    return lift(impl)(x, Xi, Yi, S)


def Hinterpolate(x, Xi, Yi, S=None, method="linear"):
    """Hessian of the interpolant with respect to the query point:
    ``[*sy, *sx, *sx]`` (zero almost everywhere for 'linear')."""
    if method == "linear":
        def impl(_x, _Xi, _Yi):
            ones = torch.ones_like(_x)

            def slope(q):
                return torch.func.jvp(lambda r: _interp(r, _Xi, _Yi), (q,), (ones,))[1]

            return torch.func.jvp(slope, (_x,), (ones,))[1]

        return lift(impl)(x, Xi, Yi)
    base = _gauss_interp_fn(method, _n_query_axes(x))

    def impl(_x, _Xi, _Yi, _S):
        return torch.func.jacfwd(torch.func.jacfwd(lambda q: base(q, _Xi, _Yi, _S)))(_x)

    return lift(impl)(x, Xi, Yi, S)


# ---------------------------------------------------------------------------
# factorization expressions: ordinary differentiable expressions (the
# Cholesky factor, or an unpivoted elimination as TensCalc's symbolic
# ldl/lu nodes carry it), so they compose inside objectives and
# constraints
# ---------------------------------------------------------------------------

def _lu_unpivoted_combined(A: torch.Tensor) -> torch.Tensor:
    """Unpivoted Doolittle elimination: U on and above the diagonal, the
    unit-lower multipliers strictly below, one column a step."""
    n = A.shape[-1]
    ar = torch.arange(n, device=A.device)
    M = A
    for k in range(n):
        d = M[k, k]
        l = torch.where(ar > k, M[:, k] / d, torch.zeros_like(M[:, k]))
        row = torch.where(ar >= k, M[k, :], torch.zeros_like(M[k, :]))
        M2 = M - torch.outer(l, row)
        M = torch.where((ar[:, None] > k) & (ar[None, :] == k), l[:, None], M2)
    return M


@lift
def chol(A):
    """Lower Cholesky factor of a symmetric positive-definite matrix."""
    return torch.linalg.cholesky(_symmetrized(A))


@lift
def ldl(A):
    """Combined LDL^T factor of a symmetric matrix, no pivoting: the
    unit-lower L strictly below the diagonal, d on it (:func:`ldl_l`,
    :func:`ldl_d`)."""
    return _lu_unpivoted_combined(A)


@lift
def ldl_l(F):
    """Unit-lower L of a combined :func:`ldl` factor."""
    n = F.shape[-1]
    return torch.tril(F, -1) + torch.eye(n, dtype=F.dtype, device=F.device)


@lift
def ldl_d(F):
    """Diagonal d of a combined :func:`ldl` factor."""
    return torch.diagonal(F, dim1=-2, dim2=-1)


@lift
def lu(A):
    """Combined unpivoted LU factor: the unit-lower multipliers strictly
    below the diagonal, U on and above (:func:`lu_l`, :func:`lu_u`,
    :func:`lu_d`)."""
    return _lu_unpivoted_combined(A)


@lift
def lu_l(F):
    """Unit-lower L of a combined :func:`lu` factor."""
    n = F.shape[-1]
    return torch.tril(F, -1) + torch.eye(n, dtype=F.dtype, device=F.device)


@lift
def lu_u(F):
    """Upper U of a combined :func:`lu` factor."""
    return torch.triu(F)


@lift
def lu_d(F):
    """Diagonal of U of a combined :func:`lu` factor."""
    return torch.diagonal(F, dim1=-2, dim2=-1)


@lift
def pptrs(L, b):
    """Solve A x = b given the Cholesky factor L = chol(A)."""
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


@lift
def bitrate(snr):
    """Shannon bitrate log2(1 + snr)."""
    return torch.log2(1.0 + snr)
