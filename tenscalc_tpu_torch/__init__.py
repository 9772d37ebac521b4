"""tenscalc_tpu_torch — the PyTorch/CUDA port of tenscalc_tpu.

A second package beside the JAX one, which stays the reference.  It
imports torch, numpy, scipy and ctypes, never jax or tenscalc_tpu.  Its
kernels are written by hand for Hopper (``csrc/``) and built at first
use; every kernel has a plain PyTorch version beside it, which runs for
tensors on the CPU.  Solvers run on the card unless the caller passes
``device="cpu"``.
"""

from .expr import (
    Constraint,
    Expr,
    Tconstant,
    Tones,
    Tvariable,
    Tzeros,
    Variable,
    clear_variables,
    concat,
    constant,
    lift,
    parameter,
    to_expr,
    variable,
)
from .ops.fns import norm2, tprod
from .ops.tseries import tsIntegral
from .ipm.options import SolverOptions
from .ipm.status import SolverStatus, describe_status
from .api import OptimizeSolver, Solution, equilibrium, minmax, optimize
from .parallel.batch import solve_batched

__all__ = [
    "Constraint", "Expr", "Tconstant", "Tones", "Tvariable", "Tzeros",
    "Variable", "clear_variables", "concat", "constant", "lift",
    "parameter", "to_expr", "variable", "norm2", "tprod", "tsIntegral", "SolverOptions",
    "SolverStatus", "describe_status", "OptimizeSolver", "Solution",
    "optimize", "minmax", "equilibrium", "solve_batched",
]
