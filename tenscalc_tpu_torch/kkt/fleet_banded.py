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

Rows past n: the JAX entry points pad with identity rows; the kernels
and the plain versions mask instead.  Band entries that reach past row n
(``band[c, i]`` with c + i >= n) are zero in every band the solver
builds; the solves treat them as multiplying zeros.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as Fn

from .._build import build_shared_library, find_tool
from .structure import BandedPlan

MAX_W = 16  # widths the kernels are instantiated for (csrc/fleet_banded.cu)

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


def _load() -> ctypes.CDLL:
    """Build (at first use) and bind the CUDA library."""
    global _lib, LIB_PATH
    if _lib is None:
        nvcc = find_tool("nvcc", ["/usr/local/cuda/bin"])
        path = LIB_PATH = build_shared_library("fleet_banded.cu", nvcc, NVCC_FLAGS)
        lib = ctypes.CDLL(str(path))
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tc_fleet_banded_factor_solve.argtypes = [I, P, P, P, P, I, I, Fl, P]
        lib.tc_fleet_banded_solve.argtypes = [I, P, P, P, I, I, P]
        lib.tc_fleet_banded_factor.argtypes = [I, P, P, I, I, Fl, P]
        for fn in (lib.tc_fleet_banded_factor_solve, lib.tc_fleet_banded_solve,
                   lib.tc_fleet_banded_factor):
            fn.restype = ctypes.c_int
        lib.tc_fleet_banded_max_w.restype = ctypes.c_int
        lib.tc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tc_cuda_error_string.restype = ctypes.c_char_p
        if lib.tc_fleet_banded_max_w() != MAX_W:
            raise RuntimeError(f"{path}: unexpected kernel width range")
        _lib = lib
    return _lib


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# launches on kernel layout: band (n, w+1, B), vectors (n, B), batch fastest
# ---------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_factor_solve(bt, rt, fbt, xt, w: int, clamp: float) -> None:
    """K1 on kernel-layout tensors (outputs ``fbt``, ``xt`` preallocated)."""
    lib = _load()
    n, _, B = bt.shape
    with torch.cuda.device(bt.device):
        rc = lib.tc_fleet_banded_factor_solve(
            w, bt.data_ptr(), rt.data_ptr(), fbt.data_ptr(), xt.data_ptr(),
            n, B, clamp, _stream(bt),
        )
    _check_rc(lib, rc, "fleet_banded factor_solve")
    LAUNCHES["factor_solve"] += 1


def launch_solve(fbt, rt, xt, w: int) -> None:
    """K2 on kernel-layout tensors."""
    lib = _load()
    n, _, B = fbt.shape
    with torch.cuda.device(fbt.device):
        rc = lib.tc_fleet_banded_solve(
            w, fbt.data_ptr(), rt.data_ptr(), xt.data_ptr(), n, B,
            _stream(fbt),
        )
    _check_rc(lib, rc, "fleet_banded solve")
    LAUNCHES["solve"] += 1


def launch_factor(bt, fbt, w: int, clamp: float) -> None:
    """K3 on kernel-layout tensors."""
    lib = _load()
    n, _, B = bt.shape
    with torch.cuda.device(bt.device):
        rc = lib.tc_fleet_banded_factor(
            w, bt.data_ptr(), fbt.data_ptr(), n, B, clamp, _stream(bt),
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
    if not 1 <= w <= MAX_W:
        raise ValueError(f"half-bandwidth w={w} outside 1..{MAX_W}")


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
    """Plain version of K3: factored band (B, n, w+1)."""
    B, n, R = band.shape
    work = torch.cat([band, band.new_zeros(B, w, R)], dim=1)
    fband = torch.empty_like(band)
    for c in range(n):
        d = _clamp_pivot(work[:, c, 0], clamp)
        r = work[:, c, 1:] / d[:, None]
        fband[:, c, 0] = d
        fband[:, c, 1:] = r
        for i in range(1, R):
            di = d * r[:, i - 1]
            work[:, c + i, : R - i] -= di[:, None] * r[:, i - 1:]
    return fband


def fleet_banded_solve_plain(fband: torch.Tensor, b: torch.Tensor,
                             w: int) -> torch.Tensor:
    """Plain version of K2: x with (L diag(d) L^T) x = b."""
    B, n, R = fband.shape
    x = torch.cat([b, b.new_zeros(B, w)], dim=1)
    for c in range(n):
        y = x[:, c].clone()
        x[:, c + 1: c + R] -= fband[:, c, 1:] * y[:, None]
        x[:, c] = y / fband[:, c, 0]
    x[:, n:] = 0.0
    for c in range(n - 1, -1, -1):
        acc = torch.zeros_like(x[:, c])
        for i in range(1, R):
            acc = acc + fband[:, c, i] * x[:, c + i]
        x[:, c] = x[:, c] - acc
    return x[:, :n]


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
    bt = band.permute(1, 2, 0).contiguous()
    fbt = torch.empty_like(bt)
    launch_factor(bt, fbt, w, clamp)
    return fbt.permute(2, 0, 1)


def fleet_banded_factor_solve_batched(band: torch.Tensor, b: torch.Tensor,
                                      w: int, clamp: float = 0.0):
    """Factor + one solve in one launch: -> (factored band, x)."""
    _check_band(band, w)
    _check_rhs(band, b)
    if _device_kind(band) == "cpu":
        return fleet_banded_factor_solve_plain(band, b, w, clamp)
    bt = band.permute(1, 2, 0).contiguous()
    rt = b.t().contiguous()
    fbt = torch.empty_like(bt)
    xt = torch.empty_like(rt)
    launch_factor_solve(bt, rt, fbt, xt, w, clamp)
    return fbt.permute(2, 0, 1), xt.t()


def fleet_banded_solve_batched(fband: torch.Tensor, b: torch.Tensor,
                               w: int) -> torch.Tensor:
    """Solve (L diag(d) L^T) x = b against a factored band (B, n, w+1).

    A factored band returned by the kernels is a view of kernel-layout
    storage, so re-laying it out here copies nothing."""
    _check_band(fband, w)
    _check_rhs(fband, b)
    if _device_kind(fband) == "cpu":
        return fleet_banded_solve_plain(fband, b, w)
    fbt = fband.permute(1, 2, 0).contiguous()
    rt = b.t().contiguous()
    xt = torch.empty_like(rt)
    launch_solve(fbt, rt, xt, w)
    return xt.t()


# ---------------------------------------------------------------------------
# the KKT adapter
# ---------------------------------------------------------------------------

def _sym_equilibration(band: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """Symmetric row-inf-norm equilibration scale s = rsqrt(max_j |W_rj|)
    from lower-band storage (row r holds band[r, :] and band[r-i, i]).
    band (B, n, w+1) -> s (B, n)."""
    absb = band.abs()
    rn = absb.amax(dim=2)
    for i in range(1, w + 1):
        rn = torch.maximum(rn, Fn.pad(absb[:, :, i], (i, 0))[:, :n])
    return torch.rsqrt(torch.clamp(rn, min=1e-30))


class FleetBandedFromBand:
    """KKT-backend adapter over a directly assembled permuted band
    (:class:`tenscalc_tpu_torch.ipm.solver.BandKKT`), for a batch.

    The band is equilibrated symmetrically, factored lazily (the first
    solve runs K1, every later solve K2), and each solve is refined
    ``n_refine`` times against the exact structured matvec.  Permuting
    by index gives the values of the JAX package's one-hot products."""

    def __init__(self, op, plan: BandedPlan, n_refine: int = 1,
                 clamp: float = 1e-7):
        self.op = op
        self.plan = plan
        self.n_refine = n_refine
        self.clamp = clamp
        n, w = plan.n, plan.bandwidth
        self.w = w
        band = op.band.to(torch.float32)
        s = _sym_equilibration(band, n, w)
        self.s = s
        s_pad = Fn.pad(s, (0, w))
        s_shift = torch.stack([s_pad[:, i: i + n] for i in range(w + 1)], dim=2)
        self._band_scaled = band * s[:, :, None] * s_shift
        self.fband = None  # lazy: the first solve fuses factor + solve
        self.perm = op.perm
        self.iperm = torch.argsort(op.perm)

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
        dt = rhs.dtype
        x = self._solve32(rhs).to(dt)
        for _ in range(self.n_refine):
            x = x + self._solve32(rhs - self.op.matvec(x)).to(dt)
        return x

    def inertia(self, tol: float = 0.0):
        if self.fband is None:
            self.fband = fleet_banded_factor_batched(
                self._band_scaled, self.w, self.clamp
            )
        rt = self.op.band.dtype
        d = self.fband[:, :, 0]
        return (d > tol).sum(dim=1).to(rt), (d < -tol).sum(dim=1).to(rt)
