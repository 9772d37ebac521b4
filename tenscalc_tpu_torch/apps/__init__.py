"""The application layer (port of ``tenscalc_tpu/apps``): MPC, MPC-MHE,
Lasso, nonlinear state-space models, system identification and the
LTI-MPC builders, over the port's ``optimize`` and ``equilibrium``."""

from .mpc import Mpc  # noqa: F401
from .mpcmhe import Mpcmhe  # noqa: F401
from .lasso import Lasso  # noqa: F401
from .nlss import NLSS  # noqa: F401
from .sysid import Sysid  # noqa: F401
