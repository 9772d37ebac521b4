"""Functions of TensCalc's operator set (port of ``tenscalc_tpu/ops/fns.py``).

Only ``norm2``, ``tprod``, ``sin`` and ``cos`` are ported; the rest of
the module (the other norms, the elementwise functions, the
factorization expressions, the interpolation functions) is ROADMAP item
M15.  Each function takes plain tensors or
:class:`~tenscalc_tpu_torch.expr.Expr` objects.
"""

from __future__ import annotations

import torch

from ..expr import Expr, lift, nary_op


@lift
def norm2(x, S=None):
    """Squared Frobenius norm ``sum(x.^2)`` (TensCalc's norm2 is the
    *square*, not the root), or the quadratic form x' S x when ``S`` is
    given."""
    if S is None:
        return (x * x).sum()
    return torch.vdot(x.reshape(-1), (S @ x).reshape(-1))


@lift
def sin(x):
    return torch.sin(x)


@lift
def cos(x):
    return torch.cos(x)


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
