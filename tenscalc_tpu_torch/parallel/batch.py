"""Batched solving of a fleet (port of ``tenscalc_tpu/parallel/batch.py``
without the device meshes, which are ROADMAP item M16).

The fleet is the solver's own batch dimension: every instance runs in
lockstep, and each keeps its own iterates, status and iteration count.
A parameter passed in its declared (unbatched) shape is shared, so any
hoisted derivative that depends only on shared parameters is computed
once for the whole fleet.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from ..interop import inits_from_numpy, params_from_numpy


def solve_batched(solver, parameters: Mapping[str, Any],
                  inits: Optional[Mapping[str, Any]] = None,
                  mu0: float = 1.0, max_iter: Optional[int] = None,
                  addEye2Hessian=(1e-9, 1e-9)):
    """Solve a fleet on the solver's device; returns the batched
    IPMResult (tensors on that device).  ``addEye2Hessian`` holds the
    solver's initial regularizations: (addU, addEq) for a minimization,
    (addU, addD, addEq) for a min-max problem."""
    dt = solver.opts.torch_dtype
    penv, shared, B = params_from_numpy(solver, parameters, solver.device, dt)
    u0 = inits_from_numpy(solver, inits, B, solver.device, dt)
    return solver._solve_raw(u0, penv, shared, mu0, max_iter, *addEye2Hessian)
