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
    Teye,
    Tones,
    Tvariable,
    Tzeros,
    Variable,
    clear_variables,
    concat,
    constant,
    gradient,
    hessian,
    horzcat,
    jacobian,
    lift,
    parameter,
    stack,
    substitute,
    to_expr,
    variable,
    vertcat,
)
from .ops.fns import (
    Ginterpolate,
    Hinterpolate,
    allv,
    anyv,
    bitrate,
    ceil,
    chol,
    clp,
    compose,
    cube,
    dsheaviside,
    floor,
    heaviside,
    interpolate,
    ldl,
    ldl_d,
    ldl_l,
    lngamma,
    logdet,
    lu,
    lu_d,
    lu_l,
    lu_u,
    max2,
    min2,
    norm,
    norm1,
    norm2,
    norminf,
    pdist2t,
    permute,
    pptrs,
    relu,
    repmat,
    round,
    sheaviside,
    sqr,
    srelu,
    tprod,
    traceinv,
    vec2tensor,
)
from .ops.tseries import (
    tsCross,
    tsDerivative,
    tsDerivative2,
    tsDot,
    tsIntegral,
    tsIntegrate,
    tsODE,
    tsQdot,
    tsQdotStar,
    tsRotation,
    tsRotationT,
)
from .ipm.options import SolverOptions
from .ipm.status import SolverStatus, describe_status
from .api import (
    ComputeFunction,
    ComputeObject,
    OptimizeSolver,
    Solution,
    compute,
    compute_object,
    equilibrium,
    minmax,
    optimize,
)
from .parallel.batch import solve_batched
from .apps.mpc import Mpc
from .apps.mpcmhe import Mpcmhe
from .apps.lasso import Lasso
from .apps.nlss import NLSS
from .apps.sysid import Sysid, ParameterSpec
from .introspect import spy, sparsity, op_tree

__version__ = "0.1.0"

__all__ = [
    "Constraint", "Expr", "Tconstant", "Teye", "Tones", "Tvariable", "Tzeros",
    "Variable", "clear_variables", "concat", "constant", "gradient", "hessian",
    "horzcat", "jacobian", "lift", "parameter", "stack", "substitute", "to_expr",
    "variable", "vertcat",
    "norm1", "norm2", "norminf", "logdet", "chol", "ldl", "ldl_l", "ldl_d", "lu",
    "lu_l", "lu_u", "lu_d", "pptrs", "bitrate", "traceinv", "relu", "srelu",
    "heaviside", "sqr", "cube", "clp", "vec2tensor", "tprod", "pdist2t",
    "interpolate", "Ginterpolate", "Hinterpolate",
    # round stays an attribute, out of __all__, so that a star import does
    # not shadow the builtin (all/any are exported as allv/anyv likewise)
    "ceil", "floor", "lngamma", "sheaviside", "dsheaviside", "compose", "min2",
    "max2", "allv", "anyv", "norm", "repmat", "permute",
    "tsDerivative", "tsDerivative2", "tsIntegral", "tsIntegrate", "tsODE",
    "tsCross", "tsDot", "tsQdot", "tsQdotStar", "tsRotation", "tsRotationT",
    "SolverOptions", "SolverStatus", "describe_status", "OptimizeSolver", "Solution",
    "optimize", "minmax", "equilibrium", "solve_batched", "compute", "compute_object",
    "ComputeFunction", "ComputeObject",
    "Mpc", "Mpcmhe", "Lasso", "NLSS", "Sysid", "ParameterSpec",
    "spy", "sparsity", "op_tree",
]
