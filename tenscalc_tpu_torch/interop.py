"""Carrying solve inputs and results across from numpy.

The analog of a model's weights here is the build-time plan plus the
solve inputs.  The plan is rebuilt from the same expressions; the
inputs (parameters, initial points) are made once with numpy, and the
same arrays go to this package and to the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def params_from_numpy(solver, params: Mapping[str, Any], device, dtype,
                      require_batched: bool = True):
    """Batched parameter environment of a fleet.

    A parameter given in its declared shape is shared by the fleet (its
    hoisted derivatives are computed once); any other must carry a
    leading batch dimension B.  Returns ``(penv, shared, B)``; B is None
    when every parameter is shared and ``require_batched`` is False."""
    penv: Dict[str, torch.Tensor] = {}
    shared = set()
    B = None
    for p in solver.parameters:
        if p.name not in params:
            raise ValueError(f"missing parameter {p.name!r}")
        v = torch.as_tensor(np.asarray(params[p.name]), dtype=dtype, device=device)
        if tuple(v.shape) == p.shape:
            shared.add(p.name)
        elif tuple(v.shape[1:]) != p.shape:
            raise ValueError(
                f"parameter {p.name!r}: expected batched shape (B,)+{p.shape} "
                f"or shared shape {p.shape}, got {tuple(v.shape)}"
            )
        elif B is None:
            B = v.shape[0]
        elif v.shape[0] != B:
            raise ValueError("inconsistent batch sizes")
        penv[p.name] = v
    extra = set(params) - set(penv)
    if extra:
        raise ValueError(f"unknown parameters {sorted(extra)}")
    if B is None and require_batched:
        raise ValueError("at least one batched parameter required")
    return penv, frozenset(shared), B


def inits_from_numpy(solver, inits: Optional[Mapping[str, Any]], B: int,
                     device, dtype) -> torch.Tensor:
    """Packed initial points (B, nU); a variable without an init starts
    at zero."""
    inits = dict(inits or {})
    parts = []
    for v in solver.variables:
        if v.name in inits:
            arr = torch.as_tensor(np.asarray(inits[v.name]), dtype=dtype, device=device)
            if tuple(arr.shape) != (B,) + v.shape:
                raise ValueError(
                    f"init {v.name!r}: expected shape (B,)+{v.shape}, got {tuple(arr.shape)}"
                )
        else:
            arr = torch.zeros((B,) + v.shape, dtype=dtype, device=device)
        parts.append(arr.reshape(B, -1))
    return torch.cat(parts, dim=1)


def fleet_from_numpy(solver, params: Mapping[str, Any],
                     inits: Optional[Mapping[str, Any]], device, dtype):
    """Inputs of a game fleet (the JAX package's
    ``EquilibriumSolver.solve_many``): the shared/batched split of the
    parameters by shape, and the packed initial points over the P1, P2
    and latent variables.  B comes from the first batched parameter, or
    else from the inits.  Returns ``(penv, shared, z0)``, z0 (B, nZ)."""
    penv, shared, B = params_from_numpy(
        solver, params, device, dtype, require_batched=False
    )
    if B is None:
        for v in (inits or {}).values():
            B = np.asarray(v).shape[0]
            break
    if B is None:
        raise ValueError("need at least one batched parameter or init")
    return penv, shared, inits_from_numpy(solver, inits, B, device, dtype)


def map_fields(fn, res):
    """``res`` (a result NamedTuple) with ``fn`` applied to each tensor
    field: a None field (profiling off) stays None, and a tuple field
    (the allowSave snapshot) is mapped entry by entry."""
    def one(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(one(x) for x in v)
        return fn(v)

    return type(res)(*(one(v) for v in res))


def result_to_numpy(res) -> Dict[str, Any]:
    """Every field of an IPMResult as numpy arrays on the host (None and
    the snapshot's tuple kept as such)."""
    return map_fields(lambda v: v.detach().cpu().numpy(), res)._asdict()
