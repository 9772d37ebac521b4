"""Binding of the dense LDL^T kernels K4-K8 (``csrc/dense_ldl.cu``) and
the arithmetic their plain versions share.

The wrappers with the JAX signatures live in :mod:`.fleet` (K4/K5, the
fleet layout: row j of the factor holds L[:, j] with the pivot at
[j, j]) and :mod:`.pallas_ldl` (K6-K8, Lt = L^T with a unit diagonal).
Both layouts keep column c of L in row c, so one substitution serves
both: a forward scatter with row c of the factor, a division by d, and
a backward gather whose sums follow the kernels' reduction tree
(:func:`solve_rows_plain`).

K5, and K7 at n <= 32, run one warp solve (a CTA of one warp an
instance, x in its lanes' registers); :func:`solve_plan` gives its route
and grid: the
factor's columns in registers at n <= 32, the instance's rows staged in
shared memory above.  K7 above n = 32 runs the tiles route's solve, a CTA
an instance by 32-row blocks, whose reduction tree spans
:func:`block_threads`.

K4 runs a CTA of one warp an instance: the warp factor in K4's rounding
order at n <= 32 (the registers route), 32-row blocks of 32-column
panels above it (the blocked route, the finished factor in shared
memory); :func:`fleet_factor_plan` gives its route and grid.

K6 and K8 at n <= 32 run the warp factor (a CTA of one warp an instance,
the matrix's upper triangle in its lanes' registers; K8 hands the factor
to the warp solve in registers); above 32 the tiles route: a launch a
32-column panel of one-warp CTAs, one on the panel's diagonal block and
one a tile of the trailing upper triangle, over a scratch working matrix
(K8 then runs K7's solve).  :func:`factor_plan` gives the route, the
launches and the grid.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from .._build import build_shared_library, find_tool
from .fleet_banded import NVCC_FLAGS, SMEM_MAX, _stream

FLEET_MAX_N = 160    # the JAX fleet kernel's VMEM cap (fleet.py:54-61)
SINGLE_MAX_N = 896   # the JAX single-instance cap (fleet.py:263)
MAX_THREADS = 512    # the solve's CTA cap above n = 32 (K7, K8)
CLAMP = 1e-7         # the pivot clamp of the IPM's dense backends
REG_MAX_N = 32       # the warp solve's registers route and the warp factor:
                     # a lane a column

# Kernel launches, one count per kernel; a launcher adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"fleet_factor": 0, "fleet_solve": 0, "ldl_factor": 0,
            "ldl_solve": 0, "ldl_factor_solve": 0}
# The CUDA kernel launches those calls issued: a tiles-route factor
# (K6, K8 above n = 32) launches once a 32-column panel, and K8 then its
# solve.
CUDA_LAUNCHES = dict.fromkeys(LAUNCHES, 0)

_lib: Optional[ctypes.CDLL] = None
LIB_PATH: Optional[Path] = None  # the built library, once loaded
_READY: set = set()  # devices where the kernels' shared-memory opt-in is set


# the caps above as the CUDA source's compile-time limits
DEFINES = [f"-DTC_FLEET_MAX_N={FLEET_MAX_N}", f"-DTC_MAX_THREADS={MAX_THREADS}",
           f"-DTC_DENSE_SMEM_MAX={SMEM_MAX}"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and result types of the library's C entry points."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc_dense_ldl_fleet_factor.argtypes = [P, P, P, I, I, Fl, P]
    lib.tc_dense_ldl_warp_solve.argtypes = [P, P, P, P, I, I, P]
    lib.tc_dense_ldl_factor.argtypes = [P, P, P, P, I, I, Fl, P]
    lib.tc_dense_ldl_solve.argtypes = [P, P, P, P, I, I, I, P]
    lib.tc_dense_ldl_factor_solve.argtypes = [P, P, P, P, P, P, I, I, I, Fl, P]
    lib.tc_dense_ldl_fleet_factor_smem.argtypes = [I]
    lib.tc_dense_ldl_factor_ctas.argtypes = [I, I]
    lib.tc_dense_ldl_init.argtypes = []
    for fn in (lib.tc_dense_ldl_fleet_factor, lib.tc_dense_ldl_warp_solve,
               lib.tc_dense_ldl_factor, lib.tc_dense_ldl_solve,
               lib.tc_dense_ldl_factor_solve, lib.tc_dense_ldl_fleet_factor_smem,
               lib.tc_dense_ldl_factor_ctas, lib.tc_dense_ldl_init):
        fn.restype = ctypes.c_int
    lib.tc_dense_ldl_error_string.argtypes = [I]
    lib.tc_dense_ldl_error_string.restype = ctypes.c_char_p
    return lib


def _load() -> ctypes.CDLL:
    """Build (at first use) and bind the CUDA library; the caps above are
    its compile-time limits."""
    global _lib, LIB_PATH
    if _lib is None:
        nvcc = find_tool("nvcc", ["/usr/local/cuda/bin"])
        path = LIB_PATH = build_shared_library("dense_ldl.cu", nvcc,
                                               [*NVCC_FLAGS, *DEFINES])
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib


def _lib_on(device: torch.device) -> ctypes.CDLL:
    """The library, with its kernels' shared-memory opt-in set on
    ``device`` (once a device)."""
    lib = _load()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _READY:
        with torch.cuda.device(idx):
            _check_rc(lib, lib.tc_dense_ldl_init(), "dense_ldl init")
        _READY.add(idx)
    return lib


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tc_dense_ldl_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def block_threads(n: int) -> int:
    """Threads of K7's and K8's solve CTA for order n: the reduction tree
    of their backward sums, which the plain versions repeat."""
    return min(MAX_THREADS, 32 * -(-n // 32))


class SolvePlan(NamedTuple):
    route: str  # "registers" (n <= 32) or "staged" (rows in shared memory)
    chunks: int  # entries of x a lane holds: ceil(n / 32)
    grid: int  # CTAs, of one warp each: one an instance
    smem: int  # dynamic shared memory of a CTA, bytes


def solve_plan(n: int, B: int) -> SolvePlan:
    """The warp solve's launch for B instances of order n, the C entry's
    own: the registers route at n <= REG_MAX_N, else the instance's n x n
    floats of shared memory (102,400 bytes at n = 160, so two instances an
    SM).  Raises for shapes the kernel does not take."""
    if not 1 <= n <= FLEET_MAX_N:
        raise ValueError(f"the warp solve takes 1 <= n <= {FLEET_MAX_N}, got n={n}")
    if B < 1:
        raise ValueError(f"the warp solve needs B >= 1, got B={B}")
    route = "registers" if n <= REG_MAX_N else "staged"
    return SolvePlan(route, -(-n // 32), B, 0 if route == "registers" else 4 * n * n)


class FleetFactorPlan(NamedTuple):
    route: str  # "registers" (n <= 32: the warp factor) or "blocked"
    panels: int  # 32-column panels: ceil(n / 32)
    grid: int  # CTAs, of one warp each: one an instance
    smem: int  # dynamic shared memory of a CTA, bytes


def fleet_factor_plan(n: int, B: int) -> FleetFactorPlan:
    """K4's launch for B instances of order n, the C entry's own: the
    registers route at n <= REG_MAX_N, else the blocked route, whose CTA
    holds the finished L and W = d L as packed upper triangles (rows from
    column 4 floor(j / 4) to n rounded up to 4), d and 32 floats of slack
    (27,328 bytes at n = 80, eight CTAs an SM; 105,728 at n = 160).
    Raises for shapes the kernel does not take."""
    if not 1 <= n <= FLEET_MAX_N:
        raise ValueError(f"K4 takes 1 <= n <= {FLEET_MAX_N}, got n={n}")
    if B < 1:
        raise ValueError(f"K4 needs B >= 1, got B={B}")
    panels = -(-n // 32)
    if panels == 1:
        return FleetFactorPlan("registers", 1, B, 0)
    a, b = divmod(n, 4)
    tri = n * 4 * -(-n // 4) - 8 * a * (a - 1) - 4 * a * b
    return FleetFactorPlan("blocked", panels, B, 4 * (2 * tri + n + 32))


class FactorPlan(NamedTuple):
    route: str  # "warp" (n <= 32: the warp factor) or "tiles"
    launches: int  # factor launches: 1 (warp), or one a 32-column panel
    grid: int  # CTAs of one warp in the first launch: an instance (warp), or
               # tile_ctas(panels - 1) an instance (tiles)
    threads: int  # threads of K8's solve CTA: block_threads(n)


def tile_ctas(t: int) -> int:
    """CTAs an instance of a tiles-route launch with ``t`` panels after
    it: the diagonal block's and one a tile (I, K), p < I <= K."""
    return 1 + t * (t + 1) // 2


def factor_plan(n: int, B: int) -> FactorPlan:
    """K6's and K8's launches for B instances of order n, the C entries'
    own: the warp factor at n <= REG_MAX_N, else the tiles route, launch
    p of ceil(n / 32) with tile_ctas(panels - 1 - p) CTAs an instance
    (379 at n = 896's first).  Raises for shapes the kernels do not
    take."""
    if not 1 <= n <= SINGLE_MAX_N:
        raise ValueError(f"K6/K8 take 1 <= n <= {SINGLE_MAX_N}, got n={n}")
    if B < 1:
        raise ValueError(f"K6/K8 need B >= 1, got B={B}")
    if n <= REG_MAX_N:
        return FactorPlan("warp", 1, B, block_threads(n))
    panels = -(-n // 32)
    return FactorPlan("tiles", panels, B * tile_ctas(panels - 1), block_threads(n))


# ---------------------------------------------------------------------------
# launches: contiguous float32 (B, n, n) matrices and (B, n) vectors
# ---------------------------------------------------------------------------

def launch_fleet_factor(A, L, d, clamp: float) -> None:
    """K4: L, d preallocated."""
    lib = _lib_on(A.device)
    B, n = A.shape[0], A.shape[-1]
    fleet_factor_plan(n, B)  # raises for a shape the kernel does not take
    with torch.cuda.device(A.device):
        rc = lib.tc_dense_ldl_fleet_factor(
            A.data_ptr(), L.data_ptr(), d.data_ptr(), n, B, clamp, _stream(A)
        )
    _check_rc(lib, rc, "dense_ldl fleet_factor")
    LAUNCHES["fleet_factor"] += 1
    CUDA_LAUNCHES["fleet_factor"] += 1


def _warp_solve(F, d, b, x, what: str) -> None:
    """The warp solve against a factor F in either layout."""
    lib = _lib_on(b.device)
    B, n = b.shape
    solve_plan(n, B)  # raises for a shape the kernel does not take
    with torch.cuda.device(b.device):
        rc = lib.tc_dense_ldl_warp_solve(
            F.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(), n, B, _stream(b),
        )
    _check_rc(lib, rc, what)


def launch_fleet_solve(L, d, b, x) -> None:
    """K5: x preallocated."""
    _warp_solve(L, d, b, x, "dense_ldl fleet_solve")
    LAUNCHES["fleet_solve"] += 1
    CUDA_LAUNCHES["fleet_solve"] += 1


def launch_factor(A, Lt, d, clamp: float) -> None:
    """K6: Lt, d preallocated."""
    lib = _lib_on(A.device)
    B, n = A.shape[0], A.shape[-1]
    plan = factor_plan(n, B)
    with torch.cuda.device(A.device):
        W = torch.empty_like(A) if plan.route == "tiles" else None
        rc = lib.tc_dense_ldl_factor(
            A.data_ptr(), Lt.data_ptr(), d.data_ptr(),
            None if W is None else W.data_ptr(), n, B, clamp, _stream(A),
        )
    _check_rc(lib, rc, "dense_ldl factor")
    LAUNCHES["ldl_factor"] += 1
    CUDA_LAUNCHES["ldl_factor"] += plan.launches


def launch_solve(Lt, d, b, x) -> None:
    """K7: x preallocated.  At n <= REG_MAX_N the warp solve (the tree of
    block_threads(n) = 32 threads is one warp's), above it the tiles
    route's solve, a CTA of block_threads(n) an instance."""
    B, n = b.shape
    if n <= REG_MAX_N:
        _warp_solve(Lt, d, b, x, "dense_ldl solve")
    else:
        lib = _lib_on(b.device)
        with torch.cuda.device(b.device):
            rc = lib.tc_dense_ldl_solve(
                Lt.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(), n, B,
                block_threads(n), _stream(b),
            )
        _check_rc(lib, rc, "dense_ldl solve")
    LAUNCHES["ldl_solve"] += 1
    CUDA_LAUNCHES["ldl_solve"] += 1


def launch_factor_solve(A, b, Lt, d, x, clamp: float) -> None:
    """K8: Lt, d, x preallocated."""
    lib = _lib_on(A.device)
    B, n = b.shape
    plan = factor_plan(n, B)
    with torch.cuda.device(A.device):
        W = torch.empty_like(A) if plan.route == "tiles" else None
        rc = lib.tc_dense_ldl_factor_solve(
            A.data_ptr(), b.data_ptr(), Lt.data_ptr(), d.data_ptr(), x.data_ptr(),
            None if W is None else W.data_ptr(), n, B, plan.threads, clamp, _stream(A),
        )
    _check_rc(lib, rc, "dense_ldl factor_solve")
    LAUNCHES["ldl_factor_solve"] += 1
    CUDA_LAUNCHES["ldl_factor_solve"] += plan.launches + (plan.route == "tiles")


# ---------------------------------------------------------------------------
# checks and the shared plain arithmetic
# ---------------------------------------------------------------------------

def check_matrix(A: torch.Tensor, max_n: Optional[int] = None) -> None:
    """A (B, n, n) float32 on the CPU or a CUDA device, and n <= ``max_n``
    where the kernels have a cap that the JAX package's kernels share
    (K6-K8: 896)."""
    if A.dim() != 3 or A.shape[1] != A.shape[2] or min(A.shape) < 1:
        raise ValueError(f"matrix must be (B, n, n), got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"matrix must be float32, got {A.dtype}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A.device}")
    if max_n is not None and A.shape[-1] > max_n:
        raise ValueError(
            f"n={A.shape[-1]} is above the kernels' cap n <= {max_n}; "
            "kkt.fleet takes larger matrices to the blocked LDL^T"
        )


def check_vector(A: torch.Tensor, b: torch.Tensor, name: str = "rhs") -> None:
    if tuple(b.shape) != (A.shape[0], A.shape[-1]):
        raise ValueError(
            f"{name} must be (B, n)={(A.shape[0], A.shape[-1])}, got {tuple(b.shape)}"
        )
    if b.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {b.dtype}")
    if b.device != A.device:
        raise ValueError(f"matrix and {name} must be on the same device")


def solve_rows_plain(F: torch.Tensor, d: torch.Tensor, b: torch.Tensor,
                     threads: int) -> torch.Tensor:
    """Plain version of the kernels' substitutions: ``F`` (B, n, n) holds
    column c of the unit-lower L in row c, after the diagonal (which is
    not read).  The backward sums follow the reduction tree of a group of
    ``threads``: sequential per thread over its indices, a butterfly in
    each warp, then the warps' sums in order."""
    B, n = b.shape
    x = b.clone()
    for c in range(n):
        x[:, c + 1:] -= x[:, c: c + 1] * F[:, c, c + 1:]
    x = x / d
    chunks = -(-n // threads)
    idx = torch.arange(n, device=b.device)
    zero = x.new_zeros(())
    for c in range(n - 1, -1, -1):
        p = torch.where(idx > c, F[:, c, :] * x, zero)
        p = Fn.pad(p, (0, chunks * threads - n)).view(B, chunks, threads)
        acc = x.new_zeros(B, threads)
        for m in range(chunks):
            acc = acc + p[:, m]
        v = acc.view(B, threads // 32, 32)
        for h in (16, 8, 4, 2, 1):
            v = v[..., :h] + v[..., h: 2 * h]
        tot = x.new_zeros(B)
        for w in range(threads // 32):
            tot = tot + v[:, w, 0]
        x[:, c] = x[:, c] - tot
    return x
