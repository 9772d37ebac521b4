"""Fleet banded LU: a batch of unpivoted unsymmetric banded
factorizations, and the block-tridiagonal LU (port of
``tenscalc_tpu/kkt/banded_lu.py``).

The two-player equilibrium KKT stacks two Lagrangians' rows, so it is
unsymmetric; for horizon games it is still banded in the stage index.

Storage: a band (B, n, 2w+1) holds each instance's full band, row c =
``[A[c,c], A[c+1..c+w, c], A[c, c+1..c+w]]``.  Factoring turns row c into
``[d_c, l_1..l_w, u_1..u_w]``: the clamped pivot (Cheng-Higham,
``d <- sign(d) * max(|d|, clamp)`` with sign(0) = +), the multipliers
``l_i = A[c+i, c] / d_c`` and the raw U entries.  There is no pivoting;
robustness comes from two-sided equilibration, the clamp, iterative
refinement against the true matrix and the IPM's regularization retry.

Each public entry point keeps the JAX signature and dispatches on the
device of its tensors: a CPU tensor goes to the plain PyTorch version
(``*_plain``, a Python loop over the n rows vectorized over the batch);
a CUDA tensor goes to the hand-written kernel in ``csrc/banded_lu.cu``
(K9 factor+solve, K10 solve, K11 factor), or the call raises.  The plain
versions repeat the kernels' arithmetic step for step, so on the card
the two agree to the last bit.

The kernels read and write the JAX layout itself, instance-contiguous.
:func:`route` picks the route by width, for every w >= 1: up to
``MAX_W`` a warp factors one instance staged in shared memory, and a CTA
holds ``group`` instances; above, the block route: the factor a CTA of
``PANEL_THREADS`` an instance, in panels of :func:`block_panel` steps
whose rows sit in shared memory, and the solve a warp an instance, the
factor's rows streamed through a shared-memory ring of ``SOLVE_RING``
rows (K9 launches the factor, then the solve); past w = 1024 for the
solve (where its register window no longer holds a row's reach) and w =
7253 for the factor (where a panel of 4 rows outgrows shared memory),
each phase runs in device memory, a CTA of ``block_threads(w)`` an
instance.  :func:`launch_plan`
picks the group and, on the warp route, the staging by size: the whole
band and x in shared memory, or, above the block's shared-memory cap, a
ring of ``RING_ROWS`` rows of each, which takes any n.

Rows past n: the JAX entry points pad with identity rows; the kernels
and the plain versions mask instead.  Band entries that reach past row n
are zero in every band the solver builds; the solves treat the unknowns
past row n as zeros.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from .._build import build_shared_library, find_tool
from .band_assemble import extract_band_lower, extract_band_upper, shifted_cols
from .dense import equilibration_scale, hdot
from .fleet_banded import (
    NVCC_FLAGS, _check_width, _clamp_pivot, _device_kind, _stream, backward_sum, block_threads,
    block_tree,
)
from .structure import BandedPlan

MAX_W = 63  # a warp an instance up to here, a CTA an instance above
LANE_ROW_W = 31  # a width a template up to here; above, two rows a lane
# the template widths of csrc/banded_lu.cu: each width to LANE_ROW_W, and
# the capacities above (w a run-time argument up to the next capacity)
WIDE_CAPS = (47, 63)
KERNEL_WIDTHS = (*range(1, LANE_ROW_W + 1), *WIDE_CAPS)
# compile-time parameters of csrc/banded_lu.cu (nvcc defines)
MAX_GROUP = 4  # instances a CTA, a warp each
CHUNK_ROWS = 32  # rows a copy into shared memory moves
RING_ROWS = 128  # rows of the band and of x the ring route keeps
SMEM_MAX = 232_448  # shared memory a block can opt into on Hopper
# a block's share when two share an SM (each also reserves 1 KB)
SMEM_TWO_BLOCKS = SMEM_MAX // 2 - 1024
# the block route (csrc/banded_lu.cu): threads of a factor's CTA, panel
# steps at most, the floats a warp tile may read past a panel's last
# slot (at least a 64 x 16 tile's rows and columns), factor rows in a
# solve warp's ring (in groups of SOLVE_GROUP rows, each group's copies on
# one mbarrier) and solve instances a CTA at most
PANEL_THREADS = 512
PANEL_MAX = 64
PANEL_PAD = 80
SOLVE_RING = 32
SOLVE_GROUP = 8
SOLVE_MAX_GROUP = 4
# a lane's leaves of the block solve's tree (block_tree(w) / 32) that the
# solve kernel (K10, K9's second launch) is instantiated at
BLOCK_LEAVES = (2, 4, 8, 16, 32)
# the block route's kernels: the factor in panels and in device memory,
# the solve at each of BLOCK_LEAVES and in device memory
BLOCK_KERNELS = 3 + len(BLOCK_LEAVES)

# Kernel launches, one count per kernel; a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"lu_factor_solve": 0, "lu_solve": 0, "lu_factor": 0}

_lib: Optional[ctypes.CDLL] = None
LIB_PATH: Optional[Path] = None  # the built library, once loaded
_READY: set = set()  # devices where the kernels' shared-memory opt-in is set


class LaunchPlan(NamedTuple):
    ring: bool  # rows through a ring (True) or all staged (False)
    group: int  # instances a CTA, a warp each
    rows: int  # rows of the band and entries of x an instance keeps
    smem: int  # shared memory of a CTA, bytes


def instance_rows(n: int, w: int, ring: bool) -> int:
    """Rows of the band (and entries of x) one instance keeps in shared
    memory: all n and w of padding, or the ring."""
    return RING_ROWS if ring else n + w


def instance_bytes(n: int, w: int, ring: bool) -> int:
    """Shared memory of one instance: its band rows of 2w+1 floats and as
    many entries of x."""
    return 4 * instance_rows(n, w, ring) * (2 * w + 2)


def panel_upper(w: int) -> int:
    """Where a block-route panel slot's upper columns start: w rounded up
    to a multiple of 4."""
    return (w + 3) & ~3


def panel_stride(w: int) -> int:
    """Floats of a block-route panel slot: its w + 1 lower and w upper
    columns, the stride 1 mod 4 (a step's factors at a 16-byte-aligned
    place of the matrix are 16-byte aligned in shared memory)."""
    s = panel_upper(w) + w + 1
    return s + ((1 - s) & 3)


def panel_bytes(w: int, nb: int) -> int:
    """Shared memory of a block-route factor's panel of nb steps."""
    return 4 * (nb * panel_stride(w) + PANEL_PAD)


def solve_bytes(w: int) -> int:
    """Shared memory of a block-route solve warp: its ring of SOLVE_RING
    row slots (a row's 16-byte chunk holding its column 0, then the
    16-byte-aligned stretch holding w of its columns), its ring of x (a
    power of two of at least max(w, block_tree(w)) + SOLVE_RING + 2
    entries) and, for each sweep, an 8-byte mbarrier a group of
    SOLVE_GROUP rows of the ring."""
    slot = 4 + ((w + 6) & ~3)
    xring = 1 << (max(w, block_tree(w)) + SOLVE_RING + 1).bit_length()
    return 4 * (SOLVE_RING * slot + xring + 4 * (SOLVE_RING // SOLVE_GROUP))


def block_smem(w: int, group: int, nb: int, factor: bool) -> int:
    """Shared memory of a block-route launch of the factor (a panel of nb
    steps; nb = 0 in device memory: none) or of the solve (``group``
    warps' rings; group = 0 in device memory: backward_sum's tree of
    block_tree(w) floats).  The library's ``tc_banded_lu_block_smem``
    gives the same bytes, which :func:`bind` checks."""
    if factor:
        return panel_bytes(w, nb) if nb else 0
    return group * solve_bytes(w) if group else 4 * block_tree(w)


def block_panel(w: int) -> int:
    """Steps a block-route factor panel takes: the most, a multiple of 4
    up to PANEL_MAX, whose rows fit the block's shared-memory cap; 0
    where 4 rows do not (from w = 7253): the factor in device memory."""
    nb = min(PANEL_MAX, (SMEM_MAX // 4 - PANEL_PAD) // panel_stride(w)) & ~3
    return nb if nb >= 4 else 0


def route(w: int) -> str:
    """The route of K9-K11 at half-bandwidth w, for every w >= 1: 'warp'
    (a warp an instance, staged in shared memory; its lane maps change at
    w = 16 and 32) to MAX_W, 'block' (the factor a CTA an instance, the
    solve a warp; see :func:`launch_plan`) above."""
    _check_width(w)
    return "warp" if w <= MAX_W else "block"


def launch_plan(n: int, w: int, B: int, sms: int = 132) -> LaunchPlan:
    """Route and group of a launch.  The band is staged whole while an
    instance fits the block cap, else through the ring, whose size does
    not depend on n.  The group is the fewest instances a CTA that lets B
    instances run in one wave at two CTAs an SM (``sms`` SMs), at most
    MAX_GROUP and no more than two CTAs an SM can hold.  On the block
    route ``rows`` is the factor's panel steps (:func:`block_panel`; 0:
    the factor in device memory), ``group`` the solve's instances a CTA
    (a warp each: as many as put B on the card at two CTAs an SM; 0 past
    w = block_threads(w), 1024: the solve in device memory, where a
    warp's register window no longer holds a row's reach; at (2, 5000,
    1200) it measured 13.7 against the warp's 21.2 ms), and
    ``smem`` the factor CTA's (:func:`block_smem`; K9 and K11); a solve
    CTA (K10, and K9's second launch) takes ``block_smem(w, group, 0,
    False)``."""
    if route(w) == "block":
        nb = block_panel(w)
        group = (0 if w > block_threads(w) else
                 min(SOLVE_MAX_GROUP, -(-B // (2 * sms)), SMEM_MAX // solve_bytes(w)))
        return LaunchPlan(False, group, nb, block_smem(w, group, nb, True))
    ring = instance_bytes(n, w, False) > SMEM_MAX
    per = instance_bytes(n, w, ring)
    group = max(1, min(MAX_GROUP, -(-B // (2 * sms)), SMEM_TWO_BLOCKS // per))
    return LaunchPlan(ring, group, instance_rows(n, w, ring), group * per)


# the compile-time parameters above as the CUDA source's nvcc defines
DEFINES = [f"-DTC_LU_CHUNK_ROWS={CHUNK_ROWS}", f"-DTC_LU_RING_ROWS={RING_ROWS}",
           f"-DTC_LU_MAX_GROUP={MAX_GROUP}", f"-DTC_LU_SMEM_MAX={SMEM_MAX}",
           f"-DTC_LU_PANEL_THREADS={PANEL_THREADS}", f"-DTC_LU_PANEL_PAD={PANEL_PAD}",
           f"-DTC_LU_SOLVE_RING={SOLVE_RING}", f"-DTC_LU_SOLVE_GROUP={SOLVE_GROUP}",
           f"-DTC_LU_SOLVE_MAX_GROUP={SOLVE_MAX_GROUP}"]
# widths at which bind() holds block_smem against the library's: the
# first of the block route, the game's, and each phase's last on its
# shared-memory design and first in device memory
SMEM_CHECK_WIDTHS = (64, 381, 1024, 1025, 7252, 7253)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and result types of the library's C entry points."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc_banded_lu_factor_solve.argtypes = [I, I, I, I, P, P, P, P, I, I, Fl, P]
    lib.tc_banded_lu_solve.argtypes = [I, I, I, I, P, P, P, I, I, P]
    lib.tc_banded_lu_factor.argtypes = [I, I, I, I, P, P, I, I, Fl, P]
    lib.tc_banded_lu_init.argtypes = []
    lib.tc_banded_lu_block_smem.argtypes = [I, I, I, I]
    lib.tc_banded_lu_block_smem.restype = ctypes.c_longlong
    for fn in (lib.tc_banded_lu_factor_solve, lib.tc_banded_lu_solve,
               lib.tc_banded_lu_factor, lib.tc_banded_lu_init,
               lib.tc_banded_lu_max_w):
        fn.restype = ctypes.c_int
    lib.tc_banded_lu_error_string.argtypes = [ctypes.c_int]
    lib.tc_banded_lu_error_string.restype = ctypes.c_char_p
    if lib.tc_banded_lu_max_w() != MAX_W:
        raise RuntimeError(f"{lib._name}: unexpected kernel width range")
    for w in SMEM_CHECK_WIDTHS:
        p = launch_plan(4 * w, w, 1024)
        plans = ((p.group, p.rows, True), (p.group, p.rows, False))
        if any(lib.tc_banded_lu_block_smem(w, g, nb, f) != block_smem(w, g, nb, f)
               for g, nb, f in plans):
            raise RuntimeError(f"{lib._name}: the block route's shared memory at w={w} "
                               "differs from block_smem")
    return lib


def _load() -> ctypes.CDLL:
    """Build (at first use) and bind the CUDA library; the constants above
    are its compile-time parameters."""
    global _lib, LIB_PATH
    if _lib is None:
        nvcc = find_tool("nvcc", ["/usr/local/cuda/bin"])
        # 198 kernels (31 widths and two capacities above, two routes,
        # three entry points): their optimization runs on four threads
        path = LIB_PATH = build_shared_library(
            "banded_lu.cu", nvcc, [*NVCC_FLAGS, "-split-compile=4", *DEFINES])
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib


def _lib_on(device: torch.device) -> ctypes.CDLL:
    """The library, with its kernels' shared-memory opt-in set on
    ``device`` (once a device)."""
    lib = _load()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _READY:
        with torch.cuda.device(idx):
            _check_rc(lib, lib.tc_banded_lu_init(), "banded_lu init")
        _READY.add(idx)
    return lib


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tc_banded_lu_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _plan_on(t: torch.Tensor, n: int, w: int, B: int) -> LaunchPlan:
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return launch_plan(n, w, B, sms)


# ---------------------------------------------------------------------------
# launches: contiguous float32 band (B, n, 2w+1) and vectors (B, n), outputs
# preallocated
# ---------------------------------------------------------------------------

def launch_factor_solve(band, rhs, fband, x, w: int, clamp: float) -> None:
    """K9: factor ``band`` into ``fband`` and solve for ``rhs`` into ``x``."""
    lib = _lib_on(band.device)
    B, n, _ = band.shape
    p = _plan_on(band, n, w, B)
    with torch.cuda.device(band.device):
        rc = lib.tc_banded_lu_factor_solve(
            w, int(p.ring), p.group, p.rows, band.data_ptr(), rhs.data_ptr(),
            fband.data_ptr(), x.data_ptr(), n, B, clamp, _stream(band),
        )
    _check_rc(lib, rc, "banded_lu factor_solve")
    LAUNCHES["lu_factor_solve"] += 1


def launch_solve(fband, rhs, x, w: int) -> None:
    """K10: solve against ``fband`` for ``rhs`` into ``x``."""
    lib = _lib_on(fband.device)
    B, n, _ = fband.shape
    p = _plan_on(fband, n, w, B)
    with torch.cuda.device(fband.device):
        rc = lib.tc_banded_lu_solve(
            w, int(p.ring), p.group, p.rows, fband.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), n, B, _stream(fband),
        )
    _check_rc(lib, rc, "banded_lu solve")
    LAUNCHES["lu_solve"] += 1


def launch_factor(band, fband, w: int, clamp: float) -> None:
    """K11: factor ``band`` into ``fband``."""
    lib = _lib_on(band.device)
    B, n, _ = band.shape
    p = _plan_on(band, n, w, B)
    with torch.cuda.device(band.device):
        rc = lib.tc_banded_lu_factor(
            w, int(p.ring), p.group, p.rows, band.data_ptr(), fband.data_ptr(), n, B,
            clamp, _stream(band),
        )
    _check_rc(lib, rc, "banded_lu factor")
    LAUNCHES["lu_factor"] += 1


def _check_band(band: torch.Tensor, w: int) -> None:
    if band.dim() != 3 or band.shape[2] != 2 * w + 1:
        raise ValueError(
            f"band must be (B, n, 2w+1) with w={w}, got {tuple(band.shape)}"
        )
    if band.dtype != torch.float32:
        raise TypeError(f"band must be float32, got {band.dtype}")
    _check_width(w)


def _check_rhs(band: torch.Tensor, b: torch.Tensor) -> None:
    if tuple(b.shape) != tuple(band.shape[:2]):
        raise ValueError(
            f"rhs must be (B, n)={tuple(band.shape[:2])}, got {tuple(b.shape)}"
        )
    if b.dtype != torch.float32:
        raise TypeError(f"rhs must be float32, got {b.dtype}")
    if b.device != band.device:
        raise ValueError("band and rhs must be on the same device")


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic, one row at a time
# ---------------------------------------------------------------------------

def fleet_banded_lu_factor_plain(band: torch.Tensor, w: int,
                                 clamp: float = 0.0) -> torch.Tensor:
    """Plain version of K11: factored band (B, n, 2w+1).  Each step
    updates every entry of its trailing square once, A[c+i, c+j] minus
    the product l_i u_j rounded first.  The square lies in band rows
    c+1..c+w: row c+m takes l_{m+k} u_m at column k <= w - m (entry
    A[c+m+k, c+m]) and l_m u_{m+q} at column w + q, q = 1..w - m (entry
    A[c+m, c+m+q]); the factors come as windows of l and u padded with
    zeros, and the entries outside the square subtract a zero, which
    leaves every float as it is."""
    B, n, R = band.shape
    work = torch.cat([band, band.new_zeros(B, w, R)], dim=1)
    m = torch.arange(1, w + 1, device=band.device)[:, None]
    below = torch.arange(w + 1, device=band.device)[None, :] <= w - m  # k = 0..w
    above = torch.arange(1, w + 1, device=band.device)[None, :] <= w - m  # q = 1..w
    zero = torch.zeros((), dtype=band.dtype, device=band.device)
    fband = torch.empty_like(band)
    for c in range(n):
        d = _clamp_pivot(work[:, c, 0], clamp)
        l = work[:, c, 1: w + 1] / d[:, None]
        u = work[:, c, w + 1:]
        fband[:, c, 0] = d
        fband[:, c, 1: w + 1] = l
        fband[:, c, w + 1:] = u
        # lw[:, m-1, k] = l_{m+k}, uw[:, m-1, q-1] = u_{m+q}
        lw = Fn.pad(l, (0, w)).unfold(1, w + 1, 1)[:, :w]
        uw = Fn.pad(u, (0, w)).unfold(1, w, 1)[:, 1:]
        rows = work[:, c + 1: c + w + 1]
        rows[:, :, : w + 1] -= torch.where(below, lw * u[:, :, None], zero)
        rows[:, :, w + 1:] -= torch.where(above, l[:, :, None] * uw, zero)
    return fband


def _forward_plain(fband: torch.Tensor, b: torch.Tensor, w: int) -> torch.Tensor:
    """y = L^{-1} b with unit-lower L (rows past n as zero padding)."""
    B, n, _ = fband.shape
    x = torch.cat([b, b.new_zeros(B, w)], dim=1)
    for c in range(n):
        x[:, c + 1: c + w + 1] -= fband[:, c, 1: w + 1] * x[:, c: c + 1]
    x[:, n:] = 0.0
    return x


def _backward_plain(fband: torch.Tensor, x: torch.Tensor, w: int) -> torch.Tensor:
    """U x = y in place on the padded y; returns the first n rows.  Row
    c's products u_q x_{c+q} are summed in the route's order
    (:func:`.fleet_banded.backward_sum`: q = 1..w to w = 63)."""
    n = fband.shape[1]
    for c in range(n - 1, -1, -1):
        prods = fband[:, c, w + 1:] * x[:, c + 1: c + w + 1]
        x[:, c] = (x[:, c] - backward_sum(prods)) / fband[:, c, 0]
    return x[:, :n]


def fleet_banded_lu_solve_plain(fband: torch.Tensor, b: torch.Tensor,
                                w: int) -> torch.Tensor:
    """Plain version of K10: x with (L U) x = b."""
    return _backward_plain(fband, _forward_plain(fband, b, w), w)


def fleet_banded_lu_factor_solve_plain(band: torch.Tensor, b: torch.Tensor,
                                       w: int, clamp: float = 0.0):
    """Plain version of K9: (factored band, x)."""
    fband = fleet_banded_lu_factor_plain(band, w, clamp)
    return fband, fleet_banded_lu_solve_plain(fband, b, w)


# ---------------------------------------------------------------------------
# public entry points (JAX signatures): band (B, n, 2w+1), vectors (B, n)
# ---------------------------------------------------------------------------

def fleet_banded_lu_factor_batched(band: torch.Tensor, w: int,
                                   clamp: float = 0.0) -> torch.Tensor:
    """Banded LU of a batch: band (B, n, 2w+1) float32 -> factored band."""
    _check_band(band, w)
    if _device_kind(band) == "cpu":
        return fleet_banded_lu_factor_plain(band, w, clamp)
    band = band.contiguous()  # the adapter's band already is: no copy
    fband = torch.empty_like(band)
    launch_factor(band, fband, w, clamp)
    return fband


def fleet_banded_lu_factor_solve_batched(band: torch.Tensor, b: torch.Tensor,
                                         w: int, clamp: float = 0.0):
    """Factor + one solve in one launch: -> (factored band, x)."""
    _check_band(band, w)
    _check_rhs(band, b)
    if _device_kind(band) == "cpu":
        return fleet_banded_lu_factor_solve_plain(band, b, w, clamp)
    band, b = band.contiguous(), b.contiguous()
    fband, x = torch.empty_like(band), torch.empty_like(b)
    launch_factor_solve(band, b, fband, x, w, clamp)
    return fband, x


def fleet_banded_lu_solve_batched(fband: torch.Tensor, b: torch.Tensor,
                                  w: int) -> torch.Tensor:
    """Solve (L U) x = b against a factored band (B, n, 2w+1)."""
    _check_band(fband, w)
    _check_rhs(fband, b)
    if _device_kind(fband) == "cpu":
        return fleet_banded_lu_solve_plain(fband, b, w)
    fband, b = fband.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    launch_solve(fband, b, x, w)
    return x


# ---------------------------------------------------------------------------
# the KKT adapters
# ---------------------------------------------------------------------------

def _scale_band(lband, uband, r, c, w: int) -> torch.Tensor:
    """Two-sided scaling R A C of full band storage:
    lband[c, i] = A[c+i, c] -> r[c+i] A c[c]; uband[c, q-1] = A[c, c+q]
    -> r[c] A c[c+q].  Returns the (B, n, 2w+1) scaled band."""
    lb = lband * shifted_cols(r, w, 0) * c[:, :, None]
    ub = uband * r[:, :, None] * shifted_cols(c, w, 1)
    return torch.cat([lb, ub], dim=2)


class _LUAdapterBase:
    """Shared solve path: permute and scale the rhs, factor lazily (the
    first solve runs K9, every later solve K10), unscale, unpermute, and
    refine ``n_refine`` times against the exact matrix."""

    def _setup(self, lband, uband, rn, cn, perm, plan, n_refine, clamp):
        self.plan = plan
        self.n_refine = n_refine
        self.clamp = clamp
        self.w = plan.bandwidth
        self.r = equilibration_scale(rn)
        self.c = equilibration_scale(cn)
        self._band_scaled = _scale_band(lband, uband, self.r, self.c, self.w)
        self.fband = None  # lazy: the first solve fuses factor + solve
        self.perm = perm
        self.iperm = torch.argsort(perm)

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _solve32(self, rhs: torch.Tensor) -> torch.Tensor:
        # M x = b  <=>  (R M C) y = R b with x = C y; indexing by perm
        # gives the values of the JAX package's one-hot products
        bp = self.r * rhs.to(torch.float32)[:, self.perm]
        if self.fband is None:
            self.fband, xp = fleet_banded_lu_factor_solve_batched(
                self._band_scaled, bp, self.w, self.clamp
            )
        else:
            xp = fleet_banded_lu_solve_batched(self.fband, bp, self.w)
        return (self.c * xp)[:, self.iperm]

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        for _ in range(self.n_refine):
            x = x + self._solve32(rhs - self._matvec(x)).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        """The unsymmetric system has no inertia: (0, 0), as the JAX
        adapters return; the equilibrium solver adapts on direction
        error only."""
        z = torch.zeros(self.r.shape[0], dtype=self.r.dtype, device=self.r.device)
        return z, z


class FleetBandedLUFromBand(_LUAdapterBase):
    """KKT-backend adapter over a directly assembled permuted band
    (:class:`tenscalc_tpu_torch.kkt.band_assemble.BandedOperator` with
    (B, n, 2w+1) storage), for a batch.  The two-sided inf-norm
    equilibration is read from band storage; refinement residuals use
    the operator's structured matvec."""

    def __init__(self, op, plan: BandedPlan, n_refine: int = 1,
                 clamp: float = 1e-4):
        self.op = op
        n, w = plan.n, plan.bandwidth
        band = op.band.to(torch.float32)
        lband, uband = band[:, :, : w + 1], band[:, :, w + 1:]
        absl, absu = lband.abs(), uband.abs()
        # row r holds lband[r-i, i] (i = 0..w) and uband[r, q-1];
        # column c holds lband[c, 0..w] and uband[c-q, q-1]
        rn = absl[:, :, 0]
        for i in range(1, w + 1):
            rn = torch.maximum(rn, Fn.pad(absl[:, : n - i, i], (i, 0)))
        rn = torch.maximum(rn, absu.amax(dim=2))
        cn = absl.amax(dim=2)
        for q in range(1, w + 1):
            cn = torch.maximum(cn, Fn.pad(absu[:, : n - q, q - 1], (q, 0)))
        self._setup(lband, uband, rn, cn, op.perm, plan, n_refine, clamp)

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.matvec(x)


class FleetBandedLUFactorization(_LUAdapterBase):
    """KKT-backend adapter over dense matrices WW (B, n, n) in original
    order: permute, extract both triangles' bands, equilibrate with the
    row and column inf-norms, factor, and refine against WW."""

    def __init__(self, WW: torch.Tensor, plan: BandedPlan, n_refine: int = 2,
                 clamp: float = 1e-4):
        self.WW = WW
        w = plan.bandwidth
        perm = torch.as_tensor(plan.perm, device=WW.device)
        Wp = WW.to(torch.float32)[:, perm][:, :, perm]
        absW = Wp.abs()
        self._setup(
            extract_band_lower(Wp, w), extract_band_upper(Wp, w),
            absW.amax(dim=2), absW.amax(dim=1), perm, plan, n_refine, clamp,
        )

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        return hdot(self.WW, x)


# ---------------------------------------------------------------------------
# block-tridiagonal LU (pure PyTorch, no kernel): the JAX package's CPU path
# ---------------------------------------------------------------------------

def _to_blocks_lu(Wp: torch.Tensor, plan: BandedPlan):
    """Diagonal blocks A_i, subdiagonal B_i (block (i, i-1)) and
    superdiagonal C_i (block (i-1, i)) of a batch of permuted matrices
    (B, n, n), padded to whole blocks with identity rows; B_0 = C_0 = 0.
    Each (B, n_blocks, s, s)."""
    from .tridiag import _block_view

    blocks = _block_view(Wp, plan)
    idx = torch.arange(plan.n_blocks, device=Wp.device)
    A = blocks[:, idx, idx]
    Bs, C = torch.zeros_like(A), torch.zeros_like(A)
    Bs[:, 1:] = blocks[:, idx[1:], idx[:-1]]
    C[:, 1:] = blocks[:, idx[:-1], idx[1:]]
    return A, Bs, C


class TridiagLUFactorization:
    """Block-tridiagonal LU of a batch: D_0 = A_0, L_i = B_i D_{i-1}^{-1},
    D_i = A_i - L_i C_i, each D_i by a pivoted LU; solves in the factor's
    dtype and ``n_refine`` refinements against WW (the mixed-precision
    contract of :mod:`tenscalc_tpu_torch.kkt.dense`)."""

    def __init__(self, Ls, Cs, lus, pivs, plan: BandedPlan, WW, n_refine: int = 2):
        self.Ls, self.Cs, self.lus, self.pivs = Ls, Cs, lus, pivs
        self.plan = plan
        self.WW = WW
        self.n_refine = n_refine
        self.perm = torch.as_tensor(plan.perm, device=WW.device)
        self.iperm = torch.as_tensor(plan.iperm, device=WW.device)

    def _solve32(self, b: torch.Tensor) -> torch.Tensor:
        s, nb, n = self.plan.block, self.plan.n_blocks, self.plan.n
        Bn = b.shape[0]
        bp = b[:, self.perm].to(self.Ls.dtype)
        bb = torch.cat([bp, bp.new_zeros(Bn, nb * s - n)], dim=1).view(Bn, nb, s)
        ys = []
        y = bb.new_zeros(Bn, s)
        for i in range(nb):
            y = bb[:, i] - hdot(self.Ls[:, i], y)
            ys.append(y)
        # backward: D_i x_i = y_i - C_{i+1} x_{i+1}
        xs = [None] * nb
        x = bb.new_zeros(Bn, s)
        for i in range(nb - 1, -1, -1):
            rhs = ys[i] if i == nb - 1 else ys[i] - hdot(self.Cs[:, i + 1], x)
            x = torch.linalg.lu_solve(self.lus[:, i], self.pivs[:, i], rhs[..., None])[..., 0]
            xs[i] = x
        return torch.cat(xs, dim=1)[:, :n][:, self.iperm]

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        for _ in range(self.n_refine):
            x = x + self._solve32(rhs - hdot(self.WW, x)).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        """The unsymmetric system has no inertia: (0, 0)."""
        z = self.WW.new_zeros(self.WW.shape[0])
        return z, z


def tridiag_lu_factorize(WW: torch.Tensor, plan: BandedPlan,
                         n_refine: int = 2) -> TridiagLUFactorization:
    """Block-tridiagonal LU of a batch WW (B, n, n) in original order, in
    :func:`.tridiag._factor_dtype` (WW's own, the JAX package's rule off
    the TPU).  A singular
    diagonal block is factored anyway (no error check), so its zero pivot
    turns the solve into infinities and NaN, as LAPACK's getrf/getrs do
    in the JAX package."""
    from .tridiag import _factor_dtype

    perm = torch.as_tensor(plan.perm, device=WW.device)
    A, Bs, C = _to_blocks_lu(WW[:, perm][:, :, perm].to(_factor_dtype(WW)), plan)
    nb = plan.n_blocks
    lu, piv = torch.linalg.lu_factor_ex(A[:, 0])[:2]
    Ls, lus, pivs = [torch.zeros_like(A[:, 0])], [lu], [piv]
    for i in range(1, nb):
        # L_i = B_i D_{i-1}^{-1}  <=>  D_{i-1}^T L_i^T = B_i^T
        L = torch.linalg.lu_solve(lu, piv, Bs[:, i].mT, adjoint=True).mT
        lu, piv = torch.linalg.lu_factor_ex(A[:, i] - torch.matmul(L, C[:, i]))[:2]
        Ls.append(L)
        lus.append(lu)
        pivs.append(piv)
    return TridiagLUFactorization(torch.stack(Ls, 1), C, torch.stack(lus, 1),
                                  torch.stack(pivs, 1), plan, WW, n_refine=n_refine)
