from .batch import make_mesh, solve_batched, solve_sharded  # noqa: F401
from .mesh import Mesh, devices, exchange, process_mesh, virtual_devices  # noqa: F401
