"""Fleet banded LDL^T: a batch of unpivoted banded factorizations (port
of ``tenscalc_tpu/kkt/fleet_banded.py``).

Storage: a band (B, n, w+1) holds the lower band of each symmetric
instance, ``band[b, c, i] = M[c+i, c]``.  Factoring turns row c into
``[d_c, L[c+1, c], ..., L[c+w, c]]``; pivots are clamped (Cheng-Higham):
``d <- sign(d) * max(|d|, clamp)`` with sign(0) = +.

Each public entry point keeps the JAX signature and dispatches on the
device of its tensors: a CPU tensor goes to the plain PyTorch version
(``*_plain``, a Python loop over the n rows vectorized over the batch);
a CUDA tensor goes to the hand-written kernel in ``csrc/fleet_banded.cu``
(K1 factor+solve, K2 solve, K3 factor), or the call raises.  There is no
fallback from one to the other.  The plain versions repeat the kernels'
arithmetic step for step (the same clamp, ``r = row / d``, the same
trailing update order, sequential sums), so on the card the two agree to
the last bit; they are the kernels' oracle, not a yardstick of speed.

The kernels read and write the JAX layout itself, instance-contiguous.
:func:`route` picks the route by width, for every w >= 1: up to
``NARROW_W`` a lane runs one instance's elimination, a CTA is one warp
serving ``group`` instances staged in shared memory; above, up to
``MAX_W``, a warp runs one instance (a lane a row of the window) and a
CTA is that warp (group 1); above ``MAX_W`` the block route (no width
cap: the planner's bands reach n/4): the factor a CTA of
:func:`panel_threads` an instance, in panels of :func:`block_panel`
steps whose rows sit in shared memory, and the solve a warp an instance,
the factor's rows streamed through a shared-memory ring of
``SOLVE_RING`` rows (K1 launches the factor, then the solve); past
w = 1024 for the solve and w = 7252 for the factor each phase runs in
device memory, a CTA of :func:`block_threads` an instance.
:func:`launch_plan` picks the group (the fewest that fill the
card in one wave) and, on the lane and warp routes, the staging by size:
the whole band and x in shared memory, or, above the block's
shared-memory cap, a ring of ``RING_ROWS`` rows of each, which takes any
n.  The backward sweep's row sums follow the route's order
(:func:`backward_sum`), so every route agrees with its plain version to
the last bit.

Rows past n: the JAX entry points pad with identity rows; the kernels
and the plain versions mask instead.  Band entries that reach past row n
(``band[c, i]`` with c + i >= n) are zero in every band the solver
builds; the solves treat them as multiplying zeros.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from .._build import build_shared_library, find_tool
from .dense import equilibration_scale, hdot
from .structure import BandedPlan

NARROW_W = 16  # a lane an instance up to here, a warp an instance above
MAX_W = 63  # a warp an instance up to here, the block route above
BLOCK_MAX_THREADS = 1024  # threads of backward_sum's tree (and of a device-memory CTA) at most
# the template widths of csrc/fleet_banded.cu: each narrow width, and the
# capacities the wide route's kernels are instantiated at (w a run-time
# argument up to the next capacity)
WIDE_CAPS = (23, 31, 47, 63)
KERNEL_WIDTHS = (*range(1, NARROW_W + 1), *WIDE_CAPS)
# compile-time parameters of csrc/fleet_banded.cu (nvcc defines)
MAX_GROUP = 32  # instances a CTA, a lane of its one warp each
CHUNK_ROWS = 64  # rows a copy into shared memory moves
RING_ROWS = 256  # rows of the band and of x the ring route keeps
SMEM_MAX = 232_448  # shared memory a block can opt into on Hopper
# the block route (csrc/fleet_banded.cu): threads of a factor's CTA at
# most, panel steps at most, the floats a warp tile may read past a
# panel's last slot (at least a 64 x 16 tile's rows and columns), factor
# rows in a solve warp's ring (in groups of SOLVE_GROUP rows, each
# group's copies on one mbarrier) and solve instances a CTA at most
PANEL_MAX_THREADS = 512
PANEL_REGS = 128  # registers a factor thread may take under the kernel's launch bound
PANEL_MAX = 48
PANEL_PAD = 80
SOLVE_RING = 32
SOLVE_GROUP = 8
SOLVE_MAX_GROUP = 4
# a lane's leaves of the block solve's tree (block_tree(w) / 32) that the
# solve kernel (K2, K1's second launch) is instantiated at
BLOCK_LEAVES = (2, 4, 8, 16, 32)
# the block route's kernels: the factor in panels and in device memory,
# the solve at each of BLOCK_LEAVES and in device memory
BLOCK_KERNELS = 3 + len(BLOCK_LEAVES)

# CTAs (of one warp) a launch plan puts on an SM side by side, one on each
# of its four schedulers: the lanes of a warp run their chains in
# lockstep, so a step costs one warp's instruction stream and a fifth CTA
# would share a scheduler's issue slots
SM_SLOTS = 4

# Kernel launches, one count per kernel; a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"factor_solve": 0, "solve": 0, "factor": 0}

# -Xptxas -v: each kernel's registers and spills go to the build log
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
LIB_PATH: Optional[Path] = None  # the built library, once loaded
_READY: set = set()  # devices where the kernels' shared-memory opt-in is set


def route(w: int) -> str:
    """The route of K1-K3 at half-bandwidth w, for every w >= 1: 'lane'
    (a lane an instance) to NARROW_W, 'warp' (a warp an instance) to
    MAX_W, 'block' (a CTA an instance) above."""
    _check_width(w)
    return "lane" if w <= NARROW_W else "warp" if w <= MAX_W else "block"


def block_threads(w: int) -> int:
    """Threads of backward_sum's block-route tree, and of a block-route
    CTA in device memory: one an offset 1..w of the window, whole warps,
    at most BLOCK_MAX_THREADS (a thread takes every BLOCK_MAX_THREADS-th
    offset above)."""
    return min(32 * -(-w // 32), BLOCK_MAX_THREADS)


def block_tree(w: int) -> int:
    """Leaves of the block route's reduction tree: block_threads(w)
    rounded up to a power of two (the padding holds zeros)."""
    return 1 << (block_threads(w) - 1).bit_length()


def backward_sum(prods: torch.Tensor) -> torch.Tensor:
    """A backward sweep's sum of a row's w products (B, w) -> (B,), in
    the order of the route that w takes in both families: sequential
    from zero over i = 1..w up to MAX_W; on the block route thread t's
    terms i = t, t + T, ... (T = block_threads(w)) sequential from zero,
    then a pairwise tree over the T partial sums padded with zeros to
    block_tree(w) leaves, each level adding the upper half to the lower.
    No partial sum is ever -0 (each starts at +0), so the zeros of the
    padding change nothing: the kernel skips them."""
    B, w = prods.shape
    if w <= MAX_W:
        acc = prods.new_zeros(B)
        for i in range(w):
            acc = acc + prods[:, i]
        return acc
    T, P = block_threads(w), block_tree(w)
    J = -(-w // T)
    terms = Fn.pad(prods, (0, J * T - w)).view(B, J, T)
    acc = prods.new_zeros(B, T)
    for j in range(J):
        acc = acc + terms[:, j]
    acc = Fn.pad(acc, (0, P - T))
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


class LaunchPlan(NamedTuple):
    """A launch's plan.  On the block route: ``group`` the solve's
    instances a CTA (a warp each; 0: in device memory), ``rows`` the
    factor's panel steps (0: in device memory), ``stride`` the factor
    CTA's threads, ``smem`` the factor CTA's shared memory."""
    ring: bool  # rows through a ring (True) or all staged (False)
    group: int  # instances a CTA, a lane each
    rows: int  # rows of the band and entries of x an instance keeps
    stride: int  # floats of an instance's slice of shared memory
    smem: int  # shared memory of a CTA, bytes


def instance_rows(n: int, w: int, ring: bool) -> int:
    """Rows of the band (and entries of x) one instance keeps in shared
    memory: all n and w + 1 of padding (the window reads up to row
    c + 1 + w), or the ring."""
    return RING_ROWS if ring else n + w + 1


def instance_floats(n: int, w: int, ring: bool) -> int:
    """Floats of one instance's slice of shared memory: its band rows of
    w + 1 floats and as many entries of x, made odd so that the lanes'
    accesses at one offset of their instances fall in different banks."""
    return instance_rows(n, w, ring) * (w + 2) | 1


def instance_bytes(n: int, w: int, ring: bool) -> int:
    return 4 * instance_floats(n, w, ring)


def panel_upper(w: int) -> int:
    """Where a block-route panel slot's products e = d r start: w rounded
    up to a multiple of 4."""
    return (w + 3) & ~3


def panel_stride(w: int) -> int:
    """Floats of a block-route panel slot: d and r_1..r_w, then e_1..e_w
    from panel_upper(w), the stride 1 mod 4 (a step's factors at a
    16-byte-aligned place of the matrix are 16-byte aligned in shared
    memory)."""
    s = panel_upper(w) + w + 1
    return s + ((1 - s) & 3)


def panel_bytes(w: int, nb: int) -> int:
    """Shared memory of a block-route factor's panel of nb steps."""
    return 4 * (nb * panel_stride(w) + PANEL_PAD)


def solve_bytes(w: int) -> int:
    """Shared memory of a block-route solve warp: its ring of SOLVE_RING
    row slots (a row's 16-byte chunk holding its d, then the
    16-byte-aligned stretch holding its r_1..r_w), its ring of x (a power
    of two of at least max(w, block_tree(w)) + SOLVE_RING + 2 entries)
    and, for each sweep, an 8-byte mbarrier a group of SOLVE_GROUP rows of
    the ring."""
    slot = 4 + ((w + 6) & ~3)
    xring = 1 << (max(w, block_tree(w)) + SOLVE_RING + 1).bit_length()
    return 4 * (SOLVE_RING * slot + xring + 4 * (SOLVE_RING // SOLVE_GROUP))


def block_smem(w: int, group: int, nb: int, factor: bool) -> int:
    """Shared memory of a block-route launch of the factor (a panel of nb
    steps; nb = 0 in device memory: none) or of the solve (``group``
    warps' rings; group = 0 in device memory: backward_sum's tree of
    block_tree(w) floats).  The library's ``tc_fleet_banded_block_smem``
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


def trailing_tiles(w: int) -> int:
    """Warp tiles (64 x 16) of a block-route panel's rank-nb update of the
    trailing triangle (its w rows and columns, the lower triangle)."""
    rows = -(-w // 64)
    return sum(rows - q * 16 // 64 for q in range(-(-w // 16)))


def panel_threads(w: int, B: int, sms: int = 132) -> int:
    """Threads of a block-route factor CTA: a warp a tile of the rank-nb
    update (one pass over the trailing triangle), from 4 warps (the
    left-looking panel's w + 1 entries a row then take one or two passes)
    to PANEL_MAX_THREADS, and no more than let the ceil(B / sms) CTAs an
    SM that put B on the card in one wave share its 65536 registers at
    PANEL_REGS a thread.  At the deconvolution fleet's (B = 256, w = 95:
    ten tiles) that is 256 threads, two CTAs an SM; PANEL_MAX_THREADS
    there would take two waves (fleet_banded_ablation.py --plans)."""
    fit = 65536 // (PANEL_REGS * 32 * -(-B // sms))
    return 32 * max(4, min(PANEL_MAX_THREADS // 32, trailing_tiles(w), fit))


def launch_plan(n: int, w: int, B: int, sms: int = 132,
                group: Optional[int] = None) -> LaunchPlan:
    """Route and group of a launch.  The group is the fewest instances a
    CTA that lets B instances run in one wave at SM_SLOTS CTAs an SM
    (``sms`` SMs), at most MAX_GROUP, and 1 above NARROW_W (a warp an
    instance); ``group`` overrides it (a measurement's choice).  The
    group's bands are staged whole while they fit the block cap together,
    else they go through the ring, whose size does not depend on n.  On
    the block route (w > MAX_W; see :class:`LaunchPlan`) the factor takes
    panels of :func:`block_panel` steps on a CTA of :func:`panel_threads`
    (panel 0 from w = 7253, where 4 rows outgrow shared memory: the
    factor in device memory), and the solve a warp an instance, as many
    a CTA as put B on the card at two CTAs an SM (``group`` overrides
    it); group 0 past w = block_threads(w), 1024, where a warp's register
    window no longer holds a row's reach: the solve in device memory."""
    if route(w) == "block":
        nb = block_panel(w)
        most = 0 if w > block_threads(w) else min(SOLVE_MAX_GROUP, SMEM_MAX // solve_bytes(w))
        if group is None:
            group = min(most, -(-B // (2 * sms)))
        elif not (group == 0 or 1 <= group <= most):
            raise ValueError(f"group {group} outside 0..{most} at n={n}, w={w}")
        return LaunchPlan(False, group, nb, panel_threads(w, B, sms),
                          block_smem(w, group, nb, True))
    wide = w > NARROW_W
    want = (1 if wide else max(1, min(MAX_GROUP, -(-B // (sms * SM_SLOTS))))
            if group is None else group)
    ring = want * instance_bytes(n, w, False) > SMEM_MAX
    per = instance_bytes(n, w, ring)
    most = 1 if wide else min(MAX_GROUP, SMEM_MAX // per)
    if group is None:
        group = min(want, most)
    elif not 1 <= group <= most:
        raise ValueError(f"group {group} outside 1..{most} at n={n}, w={w}")
    return LaunchPlan(ring, group, instance_rows(n, w, ring),
                      instance_floats(n, w, ring), group * per)


# the compile-time parameters above as the CUDA source's nvcc defines
DEFINES = [f"-DTC_FB_CHUNK_ROWS={CHUNK_ROWS}", f"-DTC_FB_RING_ROWS={RING_ROWS}",
           f"-DTC_FB_MAX_GROUP={MAX_GROUP}", f"-DTC_FB_SMEM_MAX={SMEM_MAX}",
           f"-DTC_FB_PANEL_THREADS={PANEL_MAX_THREADS}", f"-DTC_FB_PANEL_PAD={PANEL_PAD}",
           f"-DTC_FB_SOLVE_RING={SOLVE_RING}", f"-DTC_FB_SOLVE_GROUP={SOLVE_GROUP}",
           f"-DTC_FB_SOLVE_MAX_GROUP={SOLVE_MAX_GROUP}"]
# widths at which bind() holds block_smem against the library's: the
# first of the block route, the deconvolution fleet's, and each phase's
# last on its shared-memory design and first in device memory
SMEM_CHECK_WIDTHS = (64, 95, 1024, 1025, 7252, 7253)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and result types of the library's C entry points, and the
    block route's shared memory checked against :func:`block_smem`."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc_fleet_banded_factor_solve.argtypes = [I, I, I, I, I, P, P, P, P, I, I, Fl, P]
    lib.tc_fleet_banded_solve.argtypes = [I, I, I, I, I, P, P, P, I, I, P]
    lib.tc_fleet_banded_factor.argtypes = [I, I, I, I, I, P, P, I, I, Fl, P]
    lib.tc_fleet_banded_init.argtypes = []
    lib.tc_fleet_banded_check_reciprocal.argtypes = [P, P]
    lib.tc_fleet_banded_block_smem.argtypes = [I, I, I, I]
    lib.tc_fleet_banded_block_smem.restype = ctypes.c_longlong
    for fn in (lib.tc_fleet_banded_factor_solve, lib.tc_fleet_banded_solve,
               lib.tc_fleet_banded_factor, lib.tc_fleet_banded_init,
               lib.tc_fleet_banded_max_w, lib.tc_fleet_banded_check_reciprocal):
        fn.restype = ctypes.c_int
    lib.tc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tc_cuda_error_string.restype = ctypes.c_char_p
    if lib.tc_fleet_banded_max_w() != MAX_W:
        raise RuntimeError(f"{lib._name}: unexpected kernel width range")
    for w in SMEM_CHECK_WIDTHS:
        p = launch_plan(4 * w, w, 1024)
        plans = ((p.group, p.rows, True), (p.group, p.rows, False))
        if any(lib.tc_fleet_banded_block_smem(w, g, nb, f) != block_smem(w, g, nb, f)
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
        # the wide route's kernels take most of the build: their
        # optimization runs on four threads
        path = LIB_PATH = build_shared_library(
            "fleet_banded.cu", nvcc, [*NVCC_FLAGS, "-split-compile=4", *DEFINES])
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib


def _lib_on(device: torch.device) -> ctypes.CDLL:
    """The library, with its kernels' shared-memory opt-in set on
    ``device`` (once a device)."""
    lib = _load()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _READY:
        with torch.cuda.device(idx):
            _check_rc(lib, lib.tc_fleet_banded_init(), "fleet_banded init")
        _READY.add(idx)
    return lib


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_reciprocal(device: torch.device) -> int:
    """Mismatches between the factor's reciprocal (the hardware's estimate
    and one Newton step) and __frcp_rn at every float of magnitude
    2^-60..2^60 on ``device``: 0 is the premise of its divisions'
    bitwise agreement with the plain versions."""
    lib = _load()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        _check_rc(lib, lib.tc_fleet_banded_check_reciprocal(bad.data_ptr(), _stream(bad)),
                  "fleet_banded reciprocal check")
    return int(bad.item())


# ---------------------------------------------------------------------------
# launches: contiguous float32 band (B, n, w+1) and vectors (B, n) on one
# CUDA device, outputs preallocated
# ---------------------------------------------------------------------------

def _check_width(w: int) -> None:
    """Every half-bandwidth from 1 up: the block route has no cap."""
    if w < 1:
        raise ValueError(f"half-bandwidth w={w} outside 1..")


def _kernel_operands(w: int, bands, vectors):
    """(B, n) of a launch, after checking its operands: the bands (B, n,
    w+1) and the vectors (B, n), contiguous float32 tensors on one CUDA
    device.  Raises on anything else, before any CUDA call."""
    _check_width(w)
    if bands[0].dim() != 3:
        raise ValueError(f"band must be (B, n, w+1), got {tuple(bands[0].shape)}")
    B, n = bands[0].shape[:2]
    ops = [*bands, *vectors]
    for t, shape in zip(ops, [(B, n, w + 1)] * len(bands) + [(B, n)] * len(vectors)):
        if tuple(t.shape) != shape:
            raise ValueError(f"kernel operand must be {shape}, got {tuple(t.shape)}")
    for t in ops:
        if t.dtype != torch.float32:
            raise TypeError(f"kernel operands must be float32, got {t.dtype}")
    for t in ops:
        if not t.is_contiguous():
            raise ValueError(f"kernel operands must be contiguous, got strides {t.stride()}")
    for t in ops:
        if t.device.type != "cuda" or t.device != ops[0].device:
            raise ValueError(f"kernel operands must be on one CUDA device, got {t.device}")
    return B, n


def _plan_on(t: torch.Tensor, n: int, w: int, B: int,
             group: Optional[int]) -> LaunchPlan:
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return launch_plan(n, w, B, sms, group)


def launch_factor_solve(band, rhs, fband, x, w: int, clamp: float,
                        group: Optional[int] = None) -> None:
    """K1: factor ``band`` into ``fband`` and solve for ``rhs`` into ``x``."""
    B, n = _kernel_operands(w, (band, fband), (rhs, x))
    lib = _lib_on(band.device)
    p = _plan_on(band, n, w, B, group)
    with torch.cuda.device(band.device):
        rc = lib.tc_fleet_banded_factor_solve(
            w, int(p.ring), p.group, p.rows, p.stride, band.data_ptr(),
            rhs.data_ptr(), fband.data_ptr(), x.data_ptr(), n, B, clamp,
            _stream(band),
        )
    _check_rc(lib, rc, "fleet_banded factor_solve")
    LAUNCHES["factor_solve"] += 1


def launch_solve(fband, rhs, x, w: int, group: Optional[int] = None) -> None:
    """K2: solve against ``fband`` for ``rhs`` into ``x``."""
    B, n = _kernel_operands(w, (fband,), (rhs, x))
    lib = _lib_on(fband.device)
    p = _plan_on(fband, n, w, B, group)
    with torch.cuda.device(fband.device):
        rc = lib.tc_fleet_banded_solve(
            w, int(p.ring), p.group, p.rows, p.stride, fband.data_ptr(),
            rhs.data_ptr(), x.data_ptr(), n, B, _stream(fband),
        )
    _check_rc(lib, rc, "fleet_banded solve")
    LAUNCHES["solve"] += 1


def launch_factor(band, fband, w: int, clamp: float,
                  group: Optional[int] = None) -> None:
    """K3: factor ``band`` into ``fband``."""
    B, n = _kernel_operands(w, (band, fband), ())
    lib = _lib_on(band.device)
    p = _plan_on(band, n, w, B, group)
    with torch.cuda.device(band.device):
        rc = lib.tc_fleet_banded_factor(
            w, int(p.ring), p.group, p.rows, p.stride, band.data_ptr(),
            fband.data_ptr(), n, B, clamp, _stream(band),
        )
    _check_rc(lib, rc, "fleet_banded factor")
    LAUNCHES["factor"] += 1


def _check_band(band: torch.Tensor, w: int) -> None:
    if band.dim() != 3 or band.shape[2] != w + 1:
        raise ValueError(
            f"band must be (B, n, w+1) with w={w}, got {tuple(band.shape)}"
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


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic, one row at a time
# ---------------------------------------------------------------------------

def _clamp_pivot(d: torch.Tensor, clamp: float) -> torch.Tensor:
    if clamp > 0.0:
        sgn = torch.where(d >= 0.0, 1.0, -1.0).to(d.dtype)
        d = sgn * torch.clamp(d.abs(), min=clamp)
    return d


def fleet_banded_factor_plain(band: torch.Tensor, w: int,
                              clamp: float = 0.0) -> torch.Tensor:
    """Plain version of K3: factored band (B, n, w+1).  Each trailing
    entry M[c+i+k, c+i] (i + k <= w) is updated once a step, minus the
    product (d r_i) r_{i+k} rounded first, r_{i+k} from a window of r
    padded with zeros; the rest subtract a zero, which leaves every
    float as it is."""
    B, n, R = band.shape
    work = torch.cat([band, band.new_zeros(B, w, R)], dim=1)
    fband = torch.empty_like(band)
    i = torch.arange(1, w + 1, device=band.device)[:, None]
    mask = i + torch.arange(w, device=band.device)[None, :] <= w
    zero = torch.zeros((), dtype=band.dtype, device=band.device)
    for c in range(n):
        d = _clamp_pivot(work[:, c, 0], clamp)
        r = work[:, c, 1:] / d[:, None]
        fband[:, c, 0] = d
        fband[:, c, 1:] = r
        di = d[:, None] * r  # d r_i at i - 1
        rr = Fn.pad(r, (0, w)).unfold(1, w, 1)[:, :w]  # rr[:, i-1, k] = r_{i+k}
        work[:, c + 1: c + R, :w] -= torch.where(mask, di[:, :, None] * rr, zero)
    return fband


def fleet_banded_solve_plain(fband: torch.Tensor, b: torch.Tensor,
                             w: int) -> torch.Tensor:
    """Plain version of K2: x with (L diag(d) L^T) x = b; the backward
    sweep's sum over i = 1..w in the route's order (:func:`backward_sum`)."""
    B, n, R = fband.shape
    x = torch.cat([b, b.new_zeros(B, w)], dim=1)
    for c in range(n):
        y = x[:, c].clone()
        x[:, c + 1: c + R] -= fband[:, c, 1:] * y[:, None]
        x[:, c] = y / fband[:, c, 0]
    x[:, n:] = 0.0
    for c in range(n - 1, -1, -1):
        prods = fband[:, c, 1:] * x[:, c + 1: c + R]
        x[:, c] = x[:, c] - backward_sum(prods)
    return x[:, :n].contiguous()


def fleet_banded_factor_solve_plain(band: torch.Tensor, b: torch.Tensor,
                                    w: int, clamp: float = 0.0):
    """Plain version of K1: (factored band, x)."""
    fband = fleet_banded_factor_plain(band, w, clamp)
    return fband, fleet_banded_solve_plain(fband, b, w)


# ---------------------------------------------------------------------------
# public entry points (JAX signatures): band (B, n, w+1), vectors (B, n)
# ---------------------------------------------------------------------------

def fleet_banded_factor_batched(band: torch.Tensor, w: int,
                                clamp: float = 0.0) -> torch.Tensor:
    """Banded LDL of a batch: band (B, n, w+1) float32 -> factored band."""
    _check_band(band, w)
    if _device_kind(band) == "cpu":
        return fleet_banded_factor_plain(band, w, clamp)
    band = band.contiguous()  # the adapter's band already is: no copy
    fband = torch.empty_like(band)
    launch_factor(band, fband, w, clamp)
    return fband


def fleet_banded_factor_solve_batched(band: torch.Tensor, b: torch.Tensor,
                                      w: int, clamp: float = 0.0):
    """Factor + one solve in one launch: -> (factored band, x)."""
    _check_band(band, w)
    _check_rhs(band, b)
    if _device_kind(band) == "cpu":
        return fleet_banded_factor_solve_plain(band, b, w, clamp)
    band, b = band.contiguous(), b.contiguous()
    fband, x = torch.empty_like(band), torch.empty_like(b)
    launch_factor_solve(band, b, fband, x, w, clamp)
    return fband, x


def fleet_banded_solve_batched(fband: torch.Tensor, b: torch.Tensor,
                               w: int) -> torch.Tensor:
    """Solve (L diag(d) L^T) x = b against a factored band (B, n, w+1)."""
    _check_band(fband, w)
    _check_rhs(fband, b)
    if _device_kind(fband) == "cpu":
        return fleet_banded_solve_plain(fband, b, w)
    fband, b = fband.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    launch_solve(fband, b, x, w)
    return x


# ---------------------------------------------------------------------------
# the KKT adapter
# ---------------------------------------------------------------------------

def _sym_equilibration(band: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """Symmetric row-inf-norm equilibration scale s = 1/sqrt(max_j |W_rj|)
    from lower-band storage (row r holds band[r, :] and band[r-i, i]).
    band (B, n, w+1) -> s (B, n), correctly rounded
    (:func:`.dense.equilibration_scale`)."""
    absb = band.abs()
    rn = absb.amax(dim=2)
    for i in range(1, w + 1):
        rn = torch.maximum(rn, Fn.pad(absb[:, :, i], (i, 0))[:, :n])
    return equilibration_scale(rn)


def _scaled_band(band: torch.Tensor, n: int, w: int):
    """(s, s_c s_{c+i} band): the symmetric equilibration of a float32
    band (B, n, w+1) and the band it scales."""
    s = _sym_equilibration(band, n, w)
    s_pad = Fn.pad(s, (0, w))
    s_shift = torch.stack([s_pad[:, i: i + n] for i in range(w + 1)], dim=2)
    return s, band * s[:, :, None] * s_shift


class _FleetBandedAdapter:
    """The KKT-backend contract over a permuted lower band (B, n, w+1):
    the band equilibrated symmetrically, factored lazily (the first solve
    runs K1, every later solve K2), each solve refined ``n_refine`` times
    against the matrix's own product ``matvec``, a matrix right-hand side
    (B, n, k) solved a column at a time, and ``inertia()`` read from the
    factor's d (K3 only when no solve came first).  Permuting by index
    gives the values of the JAX package's one-hot products."""

    def __init__(self, band, perm, matvec, plan: BandedPlan, n_refine: int,
                 clamp: float, dtype: torch.dtype):
        self.plan = plan
        self.n_refine = n_refine
        self.clamp = clamp
        self.w = plan.bandwidth
        self.s, self._band_scaled = _scaled_band(band.to(torch.float32), plan.n, self.w)
        self.fband = None  # lazy: the first solve fuses factor + solve
        self.perm = perm
        self.iperm = torch.argsort(perm)
        self._matvec = matvec
        self._dtype = dtype

    def _solve32(self, rhs: torch.Tensor) -> torch.Tensor:
        bp = self.s * rhs.to(torch.float32)[:, self.perm]
        if self.fband is None:
            self.fband, xp = fleet_banded_factor_solve_batched(
                self._band_scaled, bp, self.w, self.clamp
            )
        else:
            xp = fleet_banded_solve_batched(self.fband, bp, self.w)
        return (self.s * xp)[:, self.iperm]

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if rhs.dim() == 3:
            return torch.stack([self.solve(rhs[:, :, k]) for k in range(rhs.shape[2])],
                               dim=2)
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        for _ in range(self.n_refine):
            x = x + self._solve32(rhs - self._matvec(x)).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        if self.fband is None:
            self.fband = fleet_banded_factor_batched(
                self._band_scaled, self.w, self.clamp
            )
        d = self.fband[:, :, 0]
        rt = self._dtype
        return (d > tol).sum(dim=1).to(rt), (d < -tol).sum(dim=1).to(rt)


class FleetBandedFromBand(_FleetBandedAdapter):
    """KKT-backend adapter over a directly assembled permuted band
    (:class:`tenscalc_tpu_torch.ipm.solver.BandKKT` or a game's
    ``BandedOperator``), for a batch: the dense matrix is never formed,
    and refinement uses the operator's structured matvec."""

    def __init__(self, op, plan: BandedPlan, n_refine: int = 1,
                 clamp: float = 1e-7):
        self.op = op
        super().__init__(op.band, op.perm, op.matvec, plan, n_refine, clamp,
                         op.band.dtype)


def band_of_dense(WW: torch.Tensor, plan: BandedPlan) -> torch.Tensor:
    """The lower band (B, n, w+1) of P WW P' for a dense batch (B, n, n),
    band[:, c, i] = WW[:, perm[c+i], perm[c]] read by index (zero past
    the last row)."""
    n, w, dev = plan.n, plan.bandwidth, WW.device
    perm = torch.as_tensor(plan.perm, dtype=torch.int64, device=dev)
    c = torch.arange(n, device=dev)[:, None]
    ci = c + torch.arange(w + 1, device=dev)[None, :]
    idx = perm[torch.clamp(ci, max=n - 1)] * n + perm[c]
    return torch.where(ci < n, WW.flatten(-2)[:, idx], 0.0)


class FleetBandedFactorization(_FleetBandedAdapter):
    """KKT-backend adapter over a dense batch WW (B, n, n) whose
    permuted pattern lies in the plan's band: the band taken by index
    (never the permuted matrix), the same pipeline as
    :class:`FleetBandedFromBand`, refined against WW itself."""

    def __init__(self, WW: torch.Tensor, plan: BandedPlan, n_refine: int = 2,
                 clamp: float = 1e-7):
        self.WW = WW
        perm = torch.as_tensor(plan.perm, dtype=torch.int64, device=WW.device)
        super().__init__(band_of_dense(WW, plan), perm, lambda x: hdot(WW, x), plan,
                         n_refine, clamp, WW.dtype)


def fleet_banded_kkt_factorize(WW: torch.Tensor, plan: BandedPlan, n_refine: int = 2,
                               clamp: float = 1e-7) -> FleetBandedFactorization:
    return FleetBandedFactorization(WW, plan, n_refine=n_refine, clamp=clamp)
