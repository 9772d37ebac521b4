"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases:
  1. setup: the card, a parallel build of the port's native sources;
  2. kernels: K1 (factor+solve), K2 (solve) and K3 (factor) against their
     plain PyTorch versions on the card, bitwise, with each shape's launch
     plan, at the main paths' shapes (the flagship's B=1024, n=149, w=4;
     the min-max saddle KKT's B=1024, n=480, w=6 and HessD's B=1024,
     n=240, w=1; the unicycle fleet's B=512, n=439, w=9; warm, with L2 cold,
     and through the entry point; K2 beside its library call,
     torch.linalg.ldl_solve with no interchanges on K1's factor expanded
     to dense, and K3 beside torch.linalg.lu_factor_ex with no
     interchanges on the band expanded to dense), ragged fleets (B=1000: n=69, w=9; B=1001: n=37, w=1; both
     with instances of magnitudes far outside the usual), w=16, and bands
     above the shared-memory cap (B=64: n=12000, w=4; n=3520, w=16: the
     ring route), timed with CUDA events; at the flagship shape and
     (1000, 69, 9) at 1 to 32 instances a CTA; and the factor's reciprocal
     against __frcp_rn at every float of magnitude 2^-60..2^60; K1 also
     beside torch.linalg.lu_factor_ex then lu_solve on the band expanded
     to dense (the flagship's and the saddle KKT's);
  3. the slice: the flagship fleet (examples/mpc_dcmotor, T=30, B=1024,
     float32) through solve_many, with the kernel launch counts read
     around it, then one single solve;
  4. cross-check: eight of the fleet's instances solved again by the port
     on the CPU (plain versions of the kernels);
  5. a profile of one fleet solve (device busy share, top kernels);
  6. kernels of slice 2: K9 (LU factor+solve), K10 (LU solve) and K11 (LU
     factor) against their plain versions, at the MPC-MHE fleet's shapes
     (B=1024, n=290, w=10; warm, with L2 cold, and through the entry
     point; K10 beside torch.linalg.lu_solve, K11 beside
     torch.linalg.lu_factor_ex and K9 beside the two, all with no
     interchanges), ragged
     ones (B=1000: n=146, w=10; n=69, w=3 and w=1), w=12, and bands
     above the shared-memory cap (B=64: n=3000, w=12; n=16000, w=1: the
     ring route); phase 15 adds its shapes;
  7. slice 2: the MPC-MHE equilibrium fleet (examples/mpcmhe_dcmotor,
     T=12, L=16, B=1024, float32) through solve_many, with the launch
     counts read around it, then one single solve;
  8. its cross-check: 64 instances solved again on the CPU, and the card's
     answers held to the exit tests there;
  9. a profile of one MPC-MHE fleet solve;
 10. kernels of slice 3: K4/K5 (fleet dense LDL^T) at (B, n) = (1024, 32),
     (1000, 13), (1024, 80) and (256, 160), and K6/K7/K8 (single-instance
     LDL^T) at n = 32, 45, 150, 200, 450, 840, 896 with B = 1 and at
     (64, 32) and (8, 450), against their plain versions (bitwise, K4, K6
     and K8 also at extreme magnitudes), timed with CUDA events (also by
     device time at every shape, with the route taken: K4's registers or
     blocked route, the warp solve and the warp factor below n = 33, the
     tiles route above with its launches and CTAs); K5 and K7 also beside
     their library call, torch.linalg.ldl_solve with no interchanges, K4
     and K6 at the sls shapes and K6 at (1, 200) and (1, 896) beside
     torch.linalg.lu_factor_ex with no interchanges, and K8 at every
     shape beside that then torch.linalg.lu_solve;
 11. slice 3, the dense KKT path (examples/sls, constrained least squares,
     N=400, float32): one solve cold and warm (K8, K7) against the CPU; a
     fleet of 1024 with per-instance A and b (K4, K5) and its cross-check
     on eight instances on the CPU; the unbanded width n=80 as a fleet;
     kkt_backend='pallas' (K6, K7), one solve and a fleet of 64; a profile
     of the sls fleet solve;
 12. the min-max slice: bench.py's robust-control saddle fleet (n=80,
     B=1024, float32, built inline) through solve_many, with the launch
     counts read around it (K1, K2 on the saddle KKT, K3 on the HessD
     inertia; no other kernel), then one single solve; its cross-check,
     eight instances solved again on the CPU; a profile of one fleet
     solve;
 13. the slice of problems without inequalities (float32, 'auto', one
     instance each): bench.py's flops curve (examples/flops, N = 30 ...
     4000: K8/K7 up to 896 KKT rows, the blocked LDL^T above, with no
     kernel), each size's build time, warm solve and one-iteration solve,
     and the launches read around the warm solve; N = 300 again on
     kkt_backend='dense' and 'ldl' (no kernel); N = 100 and 1000 again on
     the CPU; bench.py's two mls rows (N = 100, n = 8); the reference's
     slseq (N = 10000, n = 800, m = 40: K8 at n = 840) against its float64
     KKT oracle and against the CPU; profiles of the N = 300 and the slseq
     solves.  [dense-kernels] also holds K8/K7 at these paths' shapes
     (1, 45), (1, 150), (1, 450) and (1, 840) and times the blocked LDL^T
     at (1, 1500);
 14. the per-iteration band mode: bench.py's nonlinear unicycle fleet
     (examples/mpc_unicycle, B=512, T=40, float32, 'auto', mu0 = 0.1,
     max_iter = 200: nK = 439, RCM w = 9, the band assembled from H and
     Gu at every iterate) through solve_many, with its build time and
     plan, every instance at status 0, the iterations, the launch counts
     read around it (K1, K2 and no K3: the inertia reads K1's factor) and
     the warm solve's wall time; four instances again on the CPU (status
     equal, u within 2e-3, objective within 1e-3); a profile of one fleet
     solve's first 20 iterations ([profile7]: device time, idle share, host and device ms a
     lockstep iteration).  [kernels] also holds K1-K3 at its band
     (512, 439, 10) and times them beside their bounds and the library
     calls on the band expanded to dense;
 15. the nonlinear MPC-MHE pursuit game (examples/mpcmhe_unicycle, B=512,
     T=20, L=10, float32, 'auto', mu0 = 0.1, max_iter = 300: nK = 585, RCM
     w = 22, no Jacobian iteration-invariant, so the KKT is assembled
     densely at every iterate, band mode None) through solve_many, with
     its build time and plan, every instance at status 0, the iterations,
     the launch counts read around it (K9 and K10 alone) and the warm
     solve's wall time; four instances again on the CPU (the card's
     answers pass the exit tests there, status equal, iterations within
     one, uFuture within 2e-3 and J within 1e-3 where the CPU's own
     solves from the init and from it moved by 1e-6 agree); a profile of
     one fleet solve ([profile8]).  [lu-kernels] also holds K9-K11 at its
     band (512, 585, 22) and times them beside their bounds and the
     library calls on the band expanded to dense, and holds them at
     w = 13, 15, 16 and 31 (B = 1000) and on the ring route at w = 13,
     16, 22 and 31;
 16. the block route (w > 63), [block-kernels]: K1-K3 and K9-K11 at
     (B, n, w) = (256, 1000, 95), (64, 1200, 127), (16, 2000, 255),
     (2, 4000, 999) and (2, 4100, 1024), and K9-K11 at the game's band
     (256, 3000, 381) and (1, 7000, 1800), bitwise against their plain
     versions (and with both phases forced into device memory), timed
     beside their bounds, the no-FMA floor of the factors, the plain
     versions and the library calls on the band expanded to dense, with
     each family's panel width, factor threads and each launch's shared
     memory logged; [deconv]: a fleet of 256 box-bounded
     deconvolutions through a 96-tap filter (N = 1000, nK = 1000, RCM
     w = 95, the 'hoisted' band) through K1/K2 on the block route, eight
     instances again on the CPU in a spawned process beside the later
     phases ([deconv-cross-check]: status equal, iterations within one,
     x within 2e-3, J within 1e-3), a profile ([profile10]) and from it
     K1's and K2's shares of the device time;
     [deconv-game]: the same problem as a two-player game (nK = 3000,
     RCM w = 381) through K9/K10 on the block route, held to [deconv]'s
     minimizer (x within 2e-3, J within 1e-3; the instance and entry
     where they part most printed with each solve's final mu), a profile
     of its first iterations ([profile11]); [api]: sensitivity() of a flagship
     instance in float64 on the card against the CPU's (1e-8 relative),
     solve_result() against solve(); [tutorials]: the seven tutorials
     at their defaults on the card against the port on the CPU (within
     1e-8 relative), the CPU side in a spawned process;
 17. the apps and the rest of the examples: [l1l2] bench.py's l1l2 row
     (examples/l1l2estimation, N = 200, f32, gradTolerance 0.2,
     desiredDualityGap 5e-3, mu0 = 1, max_iter = 60: nK = 996, RCM
     w = 10, the 'hoisted' band, K1/K2 on the lane route, no K3) with its
     plan, status, iterations, launches a lockstep iteration, the warm
     solve's wall time (median of 10) and the mean position error, and
     the same solve on the CPU (status equal, iterations within one,
     position within 2e-3); [l1l2-fleet] 1024 estimations, instance i
     from make_data(seed=i), in one solve_many (the band (1024, 996, 11)),
     all at status 0, with solves/s, a profile ([profile12]: host and
     device ms a lockstep iteration, idle share, K1's and K2's shares),
     and eight instances on the CPU (status equal, iterations within one,
     position 1e-2, J 1e-3 relative); [l1l2-kernels] K1/K2 at that band,
     bitwise, timed beside their bounds, plain versions and the library
     calls on the band expanded to dense, and K1 on each band the fleet's
     solve gave it; [lasso] one Lasso fit at 200
     features x 2000 points in f32 (nK = 401: K8/K7 on the tiles route),
     the support recovered, and the CPU's fit (W and c within 2e-3);
     [apps] the Mpc app's closed loop (tests/test_apps.py:52),
     examples/mpc_lti's, examples/mpc_fleet at B = 64, T = 20, 20
     periods, the Mpcmhe app at T = 12, L = 16 and tests/test_apps.py:323's
     Sysid with its forecast and parameter_std (torch.func.hessian in
     float64 on the card), each with its backend and launches, all held
     against the port on the CPU in one spawned process (mpc_fleet's
     first period within 2e-3, its loop within 1e-2).  [mls] builds
     bench.py's two mls rows through examples/mls.py at k = 1;
 18. the structured KKT backends and the mesh paths (plain PyTorch:
     batched LU factors and solves; each phase logs statuses, iterations,
     solves/s, host and device ms and CUDA launches a lockstep iteration,
     and checks that its adapters' tensors are on the card): [tridiag] the
     flagship fleet (T = 30, B = 1024, f32) on kkt_backend='tridiag',
     held against the card's fleet_banded flagship (u within 2e-3 where
     both converge); [minmax-tridiag] bench.py's min-max fleet on
     'tridiag'; [auto-cpu-branch] under TENSCALC_AUTO_FLEET=0, bench.py's
     l1l2 row resolved to 'tridiag' (status 0, mean position error under
     0.6, its warm latency) and tests/test_planner.py:44's Sysid to
     'arrow' (a within 5e-3); [cyclic] the flagship fleet in float64 on
     'cyclic'; [spike] the flagship fleet on 'spike' over a virtual mesh
     of 4 x cuda:0; each with eight instances (the l1l2 solve) again on
     the CPU in a spawned process (status equal; f32: iterations within
     one, u within 2e-3; f64: iterations equal and u within 1e-6 where
     both converge); [mesh] the flagship fleet on 'auto' (K1/K2) through
     solve_many(mesh=...) on make_mesh() and on 4 x cuda:0, each held
     against the unsharded fleet (statuses equal, iterations within one,
     u within 2e-3; the bitwise-equal count logged), and measure_scaling
     at 1, 2 and 4 entries of cuda:0 with 256 instances an entry (its
     solves/s no target: one card);
 19. the tooling and the run across processes: [profiling] the flagship
     fleet (T = 30, B = 1024, f32) with profiling=True and allowSave=True,
     bitwise [slice]'s fleet, its history on the card (every instance's
     rows finite up to its iters - 1), K1/K2 as profiling.kernel_times
     reads them (1.00 and 2.00 a lockstep iteration) and flop_counts;
     [capture-ww] tests/test_diagnostics.py:193's mis-scaled problem on
     the card (one instance: K8/K7; capture_ww localizes it, with the CPU
     port's iterate and advice, WW at it = 2 within 1e-8 of the CPU's); [distributed] two
     processes of two mesh entries of cuda:0 each, in one gloo group
     (parallel/distributed_smoke.py): the JAX run's T = 6 fleet (B = 8,
     K4/K5) and 16-stage 'spike' solve, then the flagship fleet split over
     the processes, bitwise each process's instances solved as one fleet
     of 512 in the parent and the unsplit fleet of 1024 solved with its
     batched gemv (aten.bmm) in calls of 512 rows (the one operator whose
     rows round by the batch's size: parallel/batch_rounding.py), and
     against the unsplit fleet of 1024 as it is: status 0, iterations
     within one, the objective within 1e-4 and u within 2e-2 (as
     [tridiag]'s), the count above 2e-3 and the bitwise-equal count
     logged; solves/s; the workers load the libraries built at setup and
     build none.

Every cross-check's CPU side (phases 4, 8, 11, 12, 14, 15, the
quadcopter's, [deconv]'s, [tutorials]', phase 17's and phase 18's) runs in
a spawned process of its own (start_cpu_side) beside the card's later phases, and is held
once the card's phases are done.

It prints a JSON line of the kernels, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}.  It exits non-zero,
without that line, when CUDA is missing or any check fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FLEET_B, FLEET_T = 1024, 30
# the instances each cross-check solves again on the CPU
FLEET_CHECKS = np.arange(0, FLEET_B, FLEET_B // 8)
# same operations in the same order without contraction into fused
# multiply-adds: the kernels are expected to match the plain versions
# to the last bit; the check allows a few roundings of the result scale
KERNEL_RTOL = 1e-5
# the card's spin before a call timed for its device time alone: ~0.3 ms
# at the H100's clocks, more than the host needs to enqueue any kernel
# call timed so
SPIN_CYCLES = 500_000
# the reference's batched-vs-single float32 tolerance on u
U_ATOL = 2e-3
# float32 objective of two solves inside the same convergence ball
F_RTOL = 1e-3
# the sls objective on card and CPU (float32, the same stopping point)
J_RTOL = 1e-4
SOURCE = "tenscalc_tpu_torch/csrc/fleet_banded.cu"
REPLACES = {
    "factor_solve": "tenscalc_tpu/kkt/fleet_banded.py:198",
    "solve": "tenscalc_tpu/kkt/fleet_banded.py:138",
    "factor": "tenscalc_tpu/kkt/fleet_banded.py:75",
}
NAMES = {"factor_solve": "K1 fleet_banded_factor_solve",
         "solve": "K2 fleet_banded_solve", "factor": "K3 fleet_banded_factor"}
MMHE_B, MMHE_T, MMHE_L = 1024, 12, 16
MMHE_CHECKS = np.arange(0, MMHE_B, MMHE_B // 64)
LU_SHAPE = (MMHE_B, 290, 10)  # the MPC-MHE fleet's stacked KKT band
LU_SOURCE = "tenscalc_tpu_torch/csrc/banded_lu.cu"
LU_REPLACES = {
    "lu_factor_solve": "tenscalc_tpu/kkt/banded_lu.py:309",
    "lu_solve": "tenscalc_tpu/kkt/banded_lu.py:252",
    "lu_factor": "tenscalc_tpu/kkt/banded_lu.py:175",
}
LU_NAMES = {"lu_factor_solve": "K9 fleet_banded_lu_factor_solve",
            "lu_solve": "K10 fleet_banded_lu_solve",
            "lu_factor": "K11 fleet_banded_lu_factor"}
DENSE_SOURCE = "tenscalc_tpu_torch/csrc/dense_ldl.cu"
DENSE_REPLACES = {
    "fleet_factor": "tenscalc_tpu/kkt/fleet.py:68",
    "fleet_solve": "tenscalc_tpu/kkt/fleet.py:116",
    "ldl_factor": "tenscalc_tpu/kkt/pallas_ldl.py:42",
    "ldl_solve": "tenscalc_tpu/kkt/pallas_ldl.py:108",
    "ldl_factor_solve": "tenscalc_tpu/kkt/pallas_ldl.py:140",
}
DENSE_NAMES = {"fleet_factor": "K4 fleet_ldl_factor_batched",
               "fleet_solve": "K5 fleet_ldl_solve_batched",
               "ldl_factor": "K6 pallas_ldl_factor",
               "ldl_solve": "K7 pallas_ldl_solve",
               "ldl_factor_solve": "K8 pallas_ldl_factor_solve"}
# (B, n): the sls fleet, a ragged fleet, the unbanded width, the fleet
# cap; the single-instance route at sls, mid and cap widths, and batched
SLS_B, SLS_N, WIDE_N = 1024, 32, 80
SLS_CHECKS = np.arange(0, SLS_B, SLS_B // 8)
FLEET_SHAPES = [(SLS_B, SLS_N), (1000, 13), (SLS_B, WIDE_N), (256, 160)]
SINGLE_SHAPES = [(1, SLS_N), (1, 45), (1, 150), (1, 200), (1, 450), (1, 840), (1, 896),
                 (64, SLS_N), (8, 450)]
# K6's library call is also timed at these single-route shapes
K6_LIBRARY_SHAPES = [(1, 200), (1, 896)]
# one instance's KKT on the paths without inequalities: flops at N = 30,
# 100 and 300 (1.5 N rows) and slseq (n + m = 840); the blocked LDL^T's
# order on the flops curve at N = 1000
FLOPS_SHAPES = [(1, 45), (1, 150), (1, 450), (1, 840)]
FALLBACK_N = 1500
FLOPS_SIZES = (30, 60, 100, 200, 300, 1000, 2000, 4000)
SLSEQ = (10000, 800, 40)
# slseq's x against its float64 oracle: 11x the port's float32 CPU error
SLSEQ_ATOL = 1e-4
# the min-max fleet (bench.py:809-865): n = 80 minimizer and maximizer
# variables, their bounds; saddle KKT (nK = 480, RCM w = 6), HessD
# (m = 240, w = 1)
MM_B, MM_N = 1024, 80
MM_CHECKS = np.arange(0, MM_B, MM_B // 8)
MM_SADDLE, MM_HESSD = (MM_B, 480, 6), (MM_B, 240, 1)
# the nonlinear unicycle fleet (bench.py:669-741): B = 512, T = 40; its
# condensed KKT (nU = 239, nG = 200: nK = 439, RCM w = 9) assembled into
# the band at every iterate ('periter')
UNI_B, UNI_T = 512, 40
UNI_BAND = (UNI_B, 439, 9)
# the nonlinear MPC-MHE pursuit fleet (examples/mpcmhe_unicycle at the
# example's own T = 20, L = 10): its stacked KKT (nK = 585, RCM w = 22)
# assembled densely at every iterate into K9/K10
PUR_B, PUR_T, PUR_L = 512, 20, 10
PURSUIT_BAND = (PUR_B, 585, 22)
# the quadcopter fleet (examples/mpc_quadcopter at T = 20 with the large
# Newton matrix): its KKT (14 T + 6 = 286 rows, RCM w = 30) assembled
# densely at every iterate into K1/K2 on the wide route
QUAD_B, QUAD_T = 512, 20
QUAD_BAND = (QUAD_B, 286, 30)
# [profile9] traces the fleet's first iterations (the whole solve's
# lockstep iterations look alike, and the trace of ~300 takes a minute)
PROFILE9_ITERS = 10
# [profile7] traces the unicycle fleet's first iterations (every instance
# is still iterating there; the whole solve's trace took ~45 s)
PROFILE7_ITERS = 20
# instances of the unicycle's, the pursuit's and the quadcopter's CPU
# cross-checks (eight before the deconvolution phases joined the run,
# whose time limit they share)
NONCONVEX_CHECKS = 4
UNI_CHECKS = np.arange(0, UNI_B, UNI_B // NONCONVEX_CHECKS)
PUR_CHECKS = np.arange(0, PUR_B, PUR_B // NONCONVEX_CHECKS)
# K1-K3's wide route (a warp an instance) at the quadcopter's fleet and n
# and at each capacity's edges, staged; the same widths on the ring; K9-K11
# at two rows a lane, staged and on the ring
FB_WIDE_WIDTHS = (17, 24, 30, 31, 32, 48, 63)
FB_WIDE_SHAPES = ([(QUAD_B, 286, w) for w in FB_WIDE_WIDTHS]
                  + [(16, 232_448 // (4 * (w + 2)) - w + 99, w) for w in FB_WIDE_WIDTHS])
LU_WIDE_WIDTHS = (32, 48, 63)
LU_WIDE_SHAPES = ([(512, 286, w) for w in LU_WIDE_WIDTHS]
                  + [(16, 1200, w) for w in LU_WIDE_WIDTHS])


# the deconvolution fleet and its game: a signal of N = 1000 samples
# through a 96-tap FIR filter (H^T H: half-bandwidth 95), B = 256, float32;
# the game's stacked KKT (nK = 3 N) has RCM w = 381
DC_N, DC_K, DC_B = 1000, 96, 256
GAME_BAND = (DC_B, 3 * DC_N, 381)
# the block route (a CTA an instance factoring in panels, a warp an
# instance solving): the deconvolution fleet's band (B = 256, n = 1000,
# w = 95), wider bands, the planner's n/4 limit and w = 1024 (the widest
# warp solve: its window's last entry in the x ring, NL = 32); K9-K11
# also at the game's band and at w = 1800 (the solve in device memory,
# the factor in panels of 16)
BLOCK_SHAPES = [(256, 1000, 95), (64, 1200, 127), (16, 2000, 255), (2, 4000, 999)]
WIDE_BLOCK_SHAPE = (2, 4100, 1024)
LU_WIDE_BLOCK_SHAPES = [WIDE_BLOCK_SHAPE, (1, 7000, 1800)]
BLOCK_CASES = ([(fam, shape) for shape in BLOCK_SHAPES for fam in ("fb", "lu")]
               + [("fb", WIDE_BLOCK_SHAPE)]
               + [("lu", shape) for shape in (GAME_BAND, *LU_WIDE_BLOCK_SHAPES)])
# both families' phases in device memory are also forced, through the C
# entries, at the cases up to this many updates (B n w^2)
INPLACE_CHECK_UPDATES = 1e10
DC_MAX_ITER = 100
# [profile11] traces the game's first iterations (a lockstep iteration of
# the game takes ~0.8 s)
PROFILE11_ITERS = 5
# the flagship instance whose sensitivity [api] takes in float64
API_T = 30
# the tutorials at the JAX package's defaults (tutorial_fim's S = 100000,
# tutorial_nn's 400 steps), held to the port on the CPU as the CPU tests
# hold the port to the JAX package
TUTORIAL_RTOL = 1e-8
TUTORIALS = ("lq", "lq_extended", "fim", "fim_extended", "nn", "nn1", "nn_extended")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


_CARD: list = []  # card_line's reading


def card_line(fresh: bool = False) -> str:
    """The card's name and power limit as nvidia-smi gives them: read at
    the first call, and again when ``fresh`` (the phases' logs reuse the
    first reading, so a slow nvidia-smi on a busy host costs one wait)."""
    if fresh or not _CARD:
        _CARD[:] = [subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=120,
        ).stdout.strip()]
    return _CARD[0]


def timed_call(fn, before=None, spin: bool = False) -> float:
    """One call of ``fn`` timed with CUDA events (ms), after ``before``
    when given.  By default the events bracket the host's enqueue of the
    call too, so its launch overhead is inside (the ``ms`` of every
    kernel since the first).  ``spin=True`` first spins the card for
    ~0.3 ms, so the start event fires after the host has enqueued the
    call: the time is the device's alone (``device_ms``)."""
    if before is not None:
        before()
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def cuda_ms(fn, reps: int, spin: bool = False) -> float:
    """Median of ``reps`` single-call times, CUDA events, after a warm-up."""
    fn()
    return statistics.median(timed_call(fn, spin=spin) for _ in range(reps))


def test_band(B: int, n: int, w: int, seed: int):
    """Symmetric-indefinite bands with rows dominated by diagonals of
    either sign, zeros past the last row; and a right-hand side."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    band = torch.randn(B, n, w + 1, generator=g)
    sign = torch.where(torch.rand(B, n, generator=g) < 0.5, -1.0, 1.0)
    band[:, :, 0] = sign * (2 * w + 1 + torch.rand(B, n, generator=g))
    for i in range(1, w + 1):
        band[:, n - i:, i] = 0.0
    return band.cuda(), torch.randn(B, n, generator=g).cuda()


def bound(kind: str, B: int, n: int, w: int):
    """Least time (ms) for the work: bytes each input read once and each
    output written once, and the float32 operations these shapes need."""
    R = w + 1
    factor_ops = 2 * w + w * (w + 1)          # divisions, d*r_i, updates
    solve_ops = 2 * (2 * w + 1)               # forward and backward rows
    if kind == "factor_solve":
        nbytes, ops = 4 * (2 * B * n * R + 2 * B * n), factor_ops + solve_ops
    elif kind == "solve":
        nbytes, ops = 4 * (B * n * R + 2 * B * n), solve_ops
    else:
        nbytes, ops = 4 * 2 * B * n * R, factor_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * n * ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_counts(*mods) -> None:
    for m in mods:
        for counts in (m.LAUNCHES, getattr(m, "CUDA_LAUNCHES", {})):
            for k in counts:
                counts[k] = 0


def test_lu_band(B: int, n: int, w: int, seed: int):
    """Unsymmetric bands (B, n, 2w+1) with rows dominated by diagonals of
    either sign, zeros past the last row; and a right-hand side."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    band = torch.randn(B, n, 2 * w + 1, generator=g)
    sign = torch.where(torch.rand(B, n, generator=g) < 0.5, -1.0, 1.0)
    band[:, :, 0] = sign * (2 * w + 1 + torch.rand(B, n, generator=g))
    for i in range(1, w + 1):
        band[:, n - i:, i] = 0.0
        band[:, n - i:, w + i] = 0.0
    return band.cuda(), torch.randn(B, n, generator=g).cuda()


def lu_bound(kind: str, B: int, n: int, w: int):
    """Least time (ms) for the work of K9/K10/K11: bytes each input read
    once and each output written once, and the float32 operations."""
    R = 2 * w + 1
    factor_ops = w + 2 * w * w + 2            # l = row / d, w^2 updates, clamp
    solve_ops = 4 * w + 2                     # forward and backward rows
    if kind == "lu_factor_solve":
        nbytes, ops = 4 * (2 * B * n * R + 2 * B * n), factor_ops + solve_ops
    elif kind == "lu_solve":
        nbytes, ops = 4 * (B * n * R + 2 * B * n), solve_ops
    else:
        nbytes, ops = 4 * 2 * B * n * R, factor_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * n * ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def test_sym(B: int, n: int, seed: int):
    """Symmetric-indefinite matrices (B, n, n) whose diagonals of either
    sign dominate their rows; and a right-hand side."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    A = torch.randn(B, n, n, generator=g)
    A = 0.5 * (A + A.transpose(1, 2))
    sign = torch.where(torch.rand(B, n, generator=g) < 0.5, -1.0, 1.0)
    idx = torch.arange(n)
    A[:, idx, idx] = sign * (n + torch.rand(B, n, generator=g))
    return A.cuda(), torch.randn(B, n, generator=g).cuda()


def dense_bound(kind: str, B: int, n: int):
    """Least time (ms) for the work of K4-K8: bytes each input read once
    and each output written once (a symmetric matrix or a factor is its
    triangle), and the float32 operations of the elimination and of the
    two sweeps.  A step whose trailing block has order m divides m
    entries by the pivot and updates the block's upper triangle, a
    product and a difference an element: m(m + 1) + m, about n^3/3 in
    all."""
    tri = n * (n + 1) // 2
    factor_ops = sum(m * (m + 1) + m for m in range(n))
    solve_ops = 2 * n * (n - 1) + n
    if kind in ("fleet_factor", "ldl_factor"):
        nbytes, ops = 4 * B * 2 * tri, factor_ops
    elif kind in ("fleet_solve", "ldl_solve"):
        nbytes, ops = 4 * B * (tri - n + 3 * n), solve_ops
    else:
        nbytes, ops = 4 * B * (2 * tri + 2 * n), factor_ops + solve_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dense_ptxas_report(log: Path, chunks: int) -> str:
    """Registers a thread of each kernel of csrc/dense_ldl.cu (K4 at
    ``chunks`` = 1..5 panels; the tiles route's factor and solve, K6, K7
    and K8 above n = 32; the warp factor of K6 and K8; the warp solve at
    ``chunks`` = 1..5 entries of x a lane),
    from the ptxas report
    (-Xptxas -v) in the build log ``log``; fails on a spill."""
    import re

    regs, spills, name = {}, {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '.*?\d+((?:fleet|ldl|warp|tile)_\w*?kernel)"
                      r"(?:ILi(\d+)E)?E", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills[name] = spills.get(name, 0) + int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    want = {"tile_factor_kernel", "tile_solve_kernel<7>", "tile_solve_kernel<8>",
            "ldl_warp_factor_kernel", "ldl_warp_factor_solve_kernel"}
    for c in range(1, chunks + 1):
        want |= {f"warp_solve_kernel<{c}>", f"fleet_factor_kernel<{c}>"}
    check(set(regs) == want, f"dense_ldl.cu: ptxas reported {sorted(regs)}")
    check(not any(spills.values()), f"dense_ldl.cu: register spills: {spills}")
    return ", ".join(f"{k} {r}" for k, r in sorted(regs.items()))


def phase_dense_kernels(dl, fl, pl):
    """K4-K8 against their plain versions at the fleet and single-route
    shapes (K4, K6 and K8 to the last bit); returns per-kernel records
    (times at the sls shapes)."""
    recs = {k: {"max_abs_err": 0.0} for k in DENSE_REPLACES}
    clamp = dl.CLAMP

    shape_ms, shape_dev = {}, {}

    def record(k, B, n, err, scale, kern, reps, plain_ms, main, lib_ms=None, route=""):
        """Holds the error, and times the launch ``kern`` (also its device
        time alone)."""
        check(np.isfinite(err) and err <= KERNEL_RTOL * scale,
              f"{k} at B={B} n={n}: max abs err {err}")
        recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], err)
        bms, by = dense_bound(k, B, n)
        ms = cuda_ms(kern, reps)
        dev_ms = cuda_ms(kern, reps, spin=True)
        shape_ms[k], shape_dev[k] = ms, dev_ms
        dev = f" (device {dev_ms:.4f} ms)"
        lib = "" if lib_ms is None else f"  library {lib_ms:.4f} ms"
        log(f"[dense-kernels] {DENSE_NAMES[k]} B={B} n={n}{route}: max_abs_err "
            f"{err:.3e}  kernel {ms:.4f} ms{dev}  plain {plain_ms:.3f} ms{lib}  "
            f"bound {bms:.3e} ms ({by})")
        if main:
            recs[k].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, library_ms=lib_ms)

    def warp_route(B, n):
        plan = dl.solve_plan(n, B)
        return (f" [warp solve, {plan.route} route, {plan.grid} CTAs of one warp, "
                f"{plan.smem} B of shared memory a CTA]")

    def fleet_factor_route(B, n):
        plan = dl.fleet_factor_plan(n, B)
        return (f" [{plan.route} route, {plan.panels} panel(s), {plan.grid} CTAs of one "
                f"warp, {plan.smem} B of shared memory a CTA]")

    def factor_route(B, n, solve=False):
        plan = dl.factor_plan(n, B)
        if plan.route == "warp":
            return f" [warp factor, {plan.grid} CTAs of one warp]"
        tail = f"; the solve {B} CTA(s) of {plan.threads} threads" if solve else ""
        return (f" [tiles route, {plan.launches} launches of one-warp CTAs, "
                f"{plan.grid} in the first{tail}]")

    def solve_route(B, n):
        if n <= dl.REG_MAX_N:
            return warp_route(B, n)
        return (f" [tiles route's solve, {B} CTA(s) of {dl.block_threads(n)} threads, "
                f"{2 * -(-n // 32)} block steps]")

    def library_factor(A, F, d, what):
        """torch.linalg.lu_factor_ex with no interchanges: on a symmetric A
        with no clamp firing, U's diagonal is d and the unit-lower L below
        it is the factor's (F holds L's column c in row c).  Held to the
        kernel at the kernels' tolerance; returns its time (ms)."""
        B, n, _ = A.shape
        LU = torch.linalg.lu_factor_ex(A, pivot=False).LU
        torch.cuda.synchronize()
        low = torch.ones(n, n, dtype=torch.bool, device=A.device).tril(-1)
        el = max((LU - F.mT).abs()[:, low].max().item(),
                 (LU.diagonal(dim1=-2, dim2=-1) - d).abs().max().item())
        scale = max(F.abs().max().item(), d.abs().max().item(), 1.0)
        check(bool((d.abs() > clamp).all()), f"{what}: no clamp fired")
        check(np.isfinite(el) and el <= KERNEL_RTOL * scale,
              f"lu_factor_ex against {what} at B={B} n={n}: max abs diff {el}")
        t = cuda_ms(lambda: torch.linalg.lu_factor_ex(A, pivot=False), 10)
        log(f"[dense-kernels] library torch.linalg.lu_factor_ex(pivot=False) against "
            f"{what} at B={B} n={n}: {t:.4f} ms, max abs diff from the kernel {el:.3e}")
        return t

    def library_solve(LD, b, x, scale, what):
        """torch.linalg.ldl_solve against a factor in LAPACK's packed
        lower form (L below the diagonal, d on it) with no interchanges
        (pivots 1..n): the same function as K5/K7.  Its x is held to the
        kernel's at the kernels' tolerance; returns its time (ms)."""
        B, n = b.shape
        piv = torch.arange(1, n + 1, dtype=torch.int32, device=b.device).repeat(B, 1)
        rhs = b[..., None]
        xl = torch.linalg.ldl_solve(LD, piv, rhs)[..., 0]
        torch.cuda.synchronize()
        el = (xl - x).abs().max().item()
        check(np.isfinite(el) and el <= KERNEL_RTOL * scale,
              f"ldl_solve against {what} at B={B} n={n}: max abs diff {el}")

        def solve():
            return torch.linalg.ldl_solve(LD, piv, rhs)

        # warm from the check above: ten single calls, or three where one
        # takes over 50 ms (the fleets' batched solves take 0.2-2.3 s a
        # call, which ten calls each would spend of the run's time limit)
        times = [timed_call(solve)]
        reps = 10 if n <= 200 and times[0] < 50 else 3
        return statistics.median(times + [timed_call(solve) for _ in range(reps - 1)])

    for B, n in FLEET_SHAPES:
        A, b = test_sym(B, n, seed=n)
        L, d = fl.fleet_ldl_factor_batched(A, clamp)
        x = fl.fleet_ldl_solve_batched(L, d, b)
        pL, pd = fl.fleet_ldl_factor_plain(A, clamp)
        px = fl.fleet_ldl_solve_plain(pL, pd, b)
        torch.cuda.synchronize()
        check(same_bits(L, pL) and same_bits(d, pd),
              f"K4 at B={B} n={n}: not bitwise equal to the plain version")
        e4 = max((L - pL).abs().max().item(), (d - pd).abs().max().item())
        e5 = (x - fl.fleet_ldl_solve_plain(L, d, b)).abs().max().item()
        scale = max(pL.abs().max().item(), px.abs().max().item(), 1.0)
        # K4's row j holds L[:, j] and the pivot at [j, j]: its transpose
        # is the packed lower form
        l5 = library_solve(L.mT, b, x, scale, "K5")
        reps, preps = (50, 5) if n <= 80 else (20, 2)
        xo = torch.empty_like(b)
        p4 = cuda_ms(lambda: fl.fleet_ldl_factor_plain(A, clamp), preps)
        p5 = cuda_ms(lambda: fl.fleet_ldl_solve_plain(pL, pd, b), preps)
        main = (B, n) == (SLS_B, SLS_N)
        l4 = library_factor(A, L, d, "K4") if main else None
        record("fleet_factor", B, n, e4, scale,
               lambda: dl.launch_fleet_factor(A, L, d, clamp), reps, p4, main, l4,
               fleet_factor_route(B, n))
        record("fleet_solve", B, n, e5, scale,
               lambda: dl.launch_fleet_solve(L, d, b, xo), reps, p5, main, l5,
               warp_route(B, n))
    for B, n in SINGLE_SHAPES:
        A, b = test_sym(B, n, seed=n + B)
        Lt, d = pl.pallas_ldl_factor(A, clamp)
        x = pl.pallas_ldl_solve(Lt, d, b)
        Lt8, d8, x8 = pl.pallas_ldl_factor_solve(A, b, clamp)
        pLt, pd = pl.pallas_ldl_factor_plain(A, clamp)
        px = pl.pallas_ldl_solve_plain(pLt, pd, b)
        torch.cuda.synchronize()
        for name, got, want in (("K6 Lt", Lt, pLt), ("K6 d", d, pd), ("K8 Lt", Lt8, pLt),
                                ("K8 d", d8, pd), ("K8 x", x8, px)):
            check(torch.equal(got, want), f"{name} at B={B} n={n}: not bitwise "
                  "equal to the plain version")
        e6 = max((Lt - pLt).abs().max().item(), (d - pd).abs().max().item())
        e7 = (x - pl.pallas_ldl_solve_plain(Lt, d, b)).abs().max().item()
        e8 = max((Lt8 - pLt).abs().max().item(), (d8 - pd).abs().max().item(),
                 (x8 - px).abs().max().item())
        scale = max(pLt.abs().max().item(), px.abs().max().item(), 1.0)
        LD = Lt.mT.clone()  # Lt's unit diagonal replaced by d, outside the time
        LD.diagonal(dim1=-2, dim2=-1).copy_(d)
        l7 = library_solve(LD, b, x, scale, "K7")
        reps, preps = (50, 5) if n <= 200 else (10, 1)
        xo = torch.empty_like(b)
        p6 = cuda_ms(lambda: pl.pallas_ldl_factor_plain(A, clamp), preps)
        p7 = cuda_ms(lambda: pl.pallas_ldl_solve_plain(pLt, pd, b), preps)
        p8 = cuda_ms(lambda: pl.pallas_ldl_factor_solve_plain(A, b, clamp), preps)
        main = (B, n) == (1, SLS_N)
        l6 = (library_factor(A, Lt, d, "K6")
              if main or (B, n) in K6_LIBRARY_SHAPES else None)
        l8, el = library_pair(A, b, x8, scale, 10 if n <= 200 else 3)
        log(f"[dense-kernels] library torch.linalg.lu_factor_ex(pivot=False) then "
            f"lu_solve (two calls) against K8 at B={B} n={n}: {l8:.4f} ms, max abs diff "
            f"{el:.3e}")
        record("ldl_factor", B, n, e6, scale,
               lambda: dl.launch_factor(A, Lt, d, clamp), reps, p6, main, l6,
               factor_route(B, n))
        record("ldl_solve", B, n, e7, scale,
               lambda: dl.launch_solve(Lt, d, b, xo), reps, p7, main, l7, solve_route(B, n))
        record("ldl_factor_solve", B, n, e8, scale,
               lambda: dl.launch_factor_solve(A, b, Lt8, d8, xo, clamp), reps, p8, main, l8,
               route=factor_route(B, n, solve=True))
        if (B, n) in FLOPS_SHAPES:
            # the shapes of the paths without inequalities, beside the record
            for k, lib in (("ldl_solve", l7), ("ldl_factor_solve", l8)):
                bms, by = dense_bound(k, B, n)
                recs[k].setdefault("main_shapes", []).append(
                    {"n": n, "ms": shape_ms[k], "device_ms": shape_dev[k],
                     "plain_ms": {"ldl_solve": p7, "ldl_factor_solve": p8}[k],
                     "bound_ms": bms, "bound_by": by, "library_ms": lib})
    # K6 and K8 at extreme magnitudes (instances scaled beyond 2^+-60,
    # pivots clamped, a quotient that overflows), to the same bits (NaN
    # where the plain version has NaN)
    A, b = test_sym(64, SLS_N, seed=7)
    A[1::4] *= 1e21
    A[2::4] *= 1e-25
    A[3::4, 1, 2] = 1e38
    Lt, d = pl.pallas_ldl_factor(A, clamp)
    Lt8, d8, x8 = pl.pallas_ldl_factor_solve(A, b, clamp)
    pLt, pd, px = pl.pallas_ldl_factor_solve_plain(A, b, clamp)
    for name, got, want in (("K6 Lt", Lt, pLt), ("K6 d", d, pd), ("K8 Lt", Lt8, pLt),
                            ("K8 d", d8, pd), ("K8 x", x8, px)):
        check(same_bits(got, want), f"{name} at extreme magnitudes: not bitwise equal "
              "to the plain version")
    check(bool(px.isnan().any()) and bool(pd[2::4].abs().eq(clamp).all()),
          "the extreme data overflow and clamp")
    log(f"[dense-kernels] K6/K8 B=64 n={SLS_N} at magnitudes beyond 2^+-60: bitwise "
        "equal to the plain versions")
    # K4 the same, on both routes
    for n in (SLS_N, WIDE_N):
        A, _ = test_sym(64, n, seed=n + 7)
        A[1::4] *= 1e21
        A[2::4] *= 1e-25
        A[3::4, 1, 2] = 1e38
        L, d = fl.fleet_ldl_factor_batched(A, clamp)
        pL, pd = fl.fleet_ldl_factor_plain(A, clamp)
        check(same_bits(L, pL) and same_bits(d, pd),
              f"K4 at n={n}, extreme magnitudes: not bitwise equal to the plain version")
        check(not bool(pL.isfinite().all()) and bool(pd[2::4].abs().eq(clamp).all()),
              "the extreme data overflow and clamp")
        log(f"[dense-kernels] K4 B=64 n={n}{fleet_factor_route(64, n)} at magnitudes "
            "beyond 2^+-60: bitwise equal to the plain version")
    phase_fallback(dl, fl)
    return recs


def phase_fallback(dl, fl):
    """One instance above K6-K8's cap of 896 (the flops curve at N = 1000):
    the JAX package's size rule takes it to the blocked LDL^T of
    kkt/dense.py, plain PyTorch on the card, with no kernel of ours;
    timed beside K8's bound and the lu_factor_ex + lu_solve pair."""
    n = FALLBACK_N
    A, b = test_sym(1, n, seed=n)
    reset_counts(dl)
    L, d, x = fl.fleet_ldl_factor_solve(A, b)
    torch.cuda.synchronize()
    check(not any(dl.LAUNCHES.values()), f"no K4-K8 above n = 896: {dl.LAUNCHES}")
    check(bool(torch.equal(L.diagonal(dim1=-2, dim2=-1), torch.ones_like(d))),
          "the fallback's factor is a unit-lower L")
    xd = torch.linalg.solve(A.double(), b.double()[..., None])[..., 0]
    err = ((x.double() - xd).abs().max() / xd.abs().max()).item()
    check(err <= 1e-5, f"the blocked LDL^T's x within 1e-5 of a float64 solve ({err:.3e})")
    t_fs = cuda_ms(lambda: fl.fleet_ldl_factor_solve(A, b), 3)
    t_s = cuda_ms(lambda: fl.fleet_ldl_solve(L, d, b), 10)
    piv = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")[None]

    def pair():
        LU = torch.linalg.lu_factor_ex(A, pivot=False).LU
        return torch.linalg.lu_solve(LU, piv, b[..., None])

    t_lib = cuda_ms(pair, 3)
    bms, by = dense_bound("ldl_factor_solve", 1, n)
    log(f"[dense-kernels] the blocked LDL^T above K8's cap, B=1 n={n} (no kernel launch): "
        f"factor+solve {t_fs:.4f} ms, solve {t_s:.4f} ms, x within {err:.3e} of float64; "
        f"bound {bms:.4f} ms ({by}); library lu_factor_ex(pivot=False) + lu_solve "
        f"(two calls) {t_lib:.4f} ms")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, signed zeros included, with NaN where the other
    has NaN (payloads aside)."""
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def ptxas_report(mod, w, routes=("",)) -> str:
    """Registers a thread of a kernel library's three kernels at width
    ``w`` (on the wide routes, the capacity ``w`` is instantiated at) on
    each route (the kernels' second template argument: ``routes`` =
    ("staged", "ring")), or with ``w`` None of its block-route kernels
    (the library's BLOCK_KERNELS), from the ptxas report (-Xptxas -v) in
    its build log; fails on a spill in any kernel."""
    import re

    from tenscalc_tpu_torch._build import build_log

    regs, spills, name = {}, {}, None
    for line in build_log(mod.LIB_PATH).read_text().splitlines():
        m = re.search(r"Compiling entry function '.*?\d((?:lu_)?(?:factor_solve|solve|factor)"
                      r"(?:_wide|_block|_inplace)?_kernel)(?:ILi(\d+)E(?:Lb([01])E)?)?", line)
        if "Compiling entry function" in line:
            if m and re.search("_block_|_inplace_", m.group(1)):  # the block route's
                name = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else ""), None, "")
            else:
                name = ((m.group(1), int(m.group(2)), routes[int(m.group(3) or 0)])
                        if m and m.group(2) else (m.group(1), None, "") if m else None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills[name] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    src = Path(mod.LIB_PATH).name
    n_block = sum(kw is None for _, kw, _ in regs)
    check(len(regs) - n_block == 3 * len(mod.KERNEL_WIDTHS) * len(routes)
          and n_block == mod.BLOCK_KERNELS,
          f"{src}: ptxas reported {len(regs)} kernels, {n_block} on the block route")
    check(not any(spills.values()), f"{src}: register spills: {spills}")
    return ", ".join(f"{k}{' ' + rt if rt else ''} {r}"
                     for (k, kw, rt), r in sorted(regs.items()) if kw == w)


def cuda_ms_cold(fn, reps: int = 20) -> float:
    """Median of ``reps`` single-call device times, CUDA events, each
    after a 256 MB write that evicts the 50 MB L2 (not timed)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    t = statistics.median(timed_call(fn, flush.zero_, spin=True) for _ in range(reps))
    del flush
    return t


def lu_dense(f):
    """K9's factored band (B, n, 2w+1) expanded to LAPACK's packed LU: the
    multipliers below the diagonal, d and U on and above it."""
    B, n, R = f.shape
    w = (R - 1) // 2
    LU = f.new_zeros(B, n, n)
    c = torch.arange(n, device=f.device)
    LU[:, c, c] = f[:, :, 0]
    for i in range(1, w + 1):
        LU[:, c[i:], c[:-i]] = f[:, : n - i, i]
        LU[:, c[:-i], c[i:]] = f[:, : n - i, w + i]
    return LU


def ldl_dense(f):
    """K1's factored band (B, n, w+1) expanded to LAPACK's packed lower
    LDL^T form: L below the diagonal, d on it."""
    B, n, R = f.shape
    LD = f.new_zeros(B, n, n)
    c = torch.arange(n, device=f.device)
    LD[:, c, c] = f[:, :, 0]
    for i in range(1, R):
        LD[:, c[i:], c[:-i]] = f[:, : n - i, i]
    return LD


def ldl_as_lu(f):
    """K1's factored band (B, n, w+1) as LAPACK's packed LU of the same
    matrix: L below the diagonal, U = diag(d) L^T on and above it."""
    LD = ldl_dense(f)
    L = LD.tril(-1)
    eye = torch.eye(f.shape[1], device=f.device, dtype=f.dtype)
    return L + f[:, :, 0, None] * (L + eye).mT


def library_check(fn, x, scale, what, reps):
    """Holds one PyTorch call's x to a kernel's at the kernels' tolerance
    and returns its time (ms, CUDA events, ``reps`` single calls after
    that call, which warms it up)."""
    xl = fn()
    torch.cuda.synchronize()
    el = (xl - x).abs().max().item()
    check(np.isfinite(el) and el <= KERNEL_RTOL * scale,
          f"{what}: max abs diff from the kernel {el}")
    return statistics.median(timed_call(fn) for _ in range(reps)), el


def library_pair(A, b, x, scale, reps):
    """The dense solve of A x = b in two PyTorch calls,
    torch.linalg.lu_factor_ex with no interchanges then
    torch.linalg.lu_solve (pivots 1..n), A built before the timed calls:
    its x held to a kernel's ``x`` at the kernels' tolerance; returns its
    time (ms, CUDA events, ``reps`` single calls) and the difference."""
    B, n = b.shape
    piv = torch.arange(1, n + 1, dtype=torch.int32, device=b.device).repeat(B, 1)

    def pair():
        LU = torch.linalg.lu_factor_ex(A, pivot=False).LU
        return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]

    return library_check(pair, x, scale, f"lu_factor_ex + lu_solve at B={B} n={n}", reps)


def library_lu_factor(A, want, scale, what, lower=False, reps=5):
    """torch.linalg.lu_factor_ex(A, pivot=False) on a band expanded to its
    dense matrix A (built before the timed calls): its LU held to a
    kernel's factor in LAPACK's packed form ``want`` at the kernels'
    tolerance (``lower``: L and the diagonal only, the part an LDL^T
    factor shares with it); returns its time (ms, CUDA events, ``reps``
    single calls) and the difference."""
    LU = torch.linalg.lu_factor_ex(A, pivot=False).LU
    if lower:
        LU = LU.tril()
    torch.cuda.synchronize()
    el = (LU - want).abs().max().item()
    check(np.isfinite(el) and el <= KERNEL_RTOL * scale,
          f"{what}: max abs diff from the kernel {el}")
    del LU
    return cuda_ms(lambda: torch.linalg.lu_factor_ex(A, pivot=False), reps), el


# (B, n, w): the MPC-MHE fleet and the pursuit fleet; ragged batches (B
# not a multiple of the group) at the T = 6 game's width, a narrow band
# and the widths past w = 12 (13 and 15 on the two-lanes-a-row map of the
# factor, 16 and 31 on the one-lane map); w = 12; and bands above the
# shared-memory cap (the ring route) at w = 1, 12, 13, 16, 22 and 31, one
# with n a whole number of chunks
LU_SHAPES = [LU_SHAPE, PURSUIT_BAND, (1000, 146, 10), (1000, 69, 3), (1000, 69, 1),
             (1000, 100, 13), (1000, 100, 15), (1000, 100, 16), (1000, 77, 31),
             (1024, 290, 12), (64, 3000, 12), (64, 16000, 1), (64, 2100, 13),
             (64, 1700, 16), (64, 1300, 22), (64, 900, 31)]
# the main paths' shapes, timed in full (device time alone, L2 cold, the
# entry point, the library calls); the kernels line's record is the
# MPC-MHE fleet's, the pursuit fleet's is in its main_shapes
LU_MAIN_SHAPES = (LU_SHAPE, PURSUIT_BAND)


def phase_lu_kernels(lu):
    """K9-K11 against their plain versions; returns per-kernel records."""
    recs = {k: {"max_abs_err": 0.0} for k in LU_REPLACES}
    clamp = 1e-4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, n, w in LU_SHAPES:
        main = (B, n, w) in LU_MAIN_SHAPES
        plan = lu.launch_plan(n, w, B, sms)
        band, rhs = test_lu_band(B, n, w, seed=n + w)
        f9, x9 = lu.fleet_banded_lu_factor_solve_batched(band, rhs, w, clamp)
        x10 = lu.fleet_banded_lu_solve_batched(f9, rhs, w)
        f11 = lu.fleet_banded_lu_factor_batched(band, w, clamp)
        pf, px = lu.fleet_banded_lu_factor_solve_plain(band, rhs, w, clamp)
        px10 = lu.fleet_banded_lu_solve_plain(pf, rhs, w)
        torch.cuda.synchronize()
        errs = {
            "lu_factor_solve": max((f9 - pf).abs().max().item(),
                                   (x9 - px).abs().max().item()),
            "lu_solve": (x10 - px10).abs().max().item(),
            "lu_factor": (f11 - pf).abs().max().item(),
        }
        scale = max(pf.abs().max().item(), px.abs().max().item(), 1.0)
        for k, e in errs.items():
            check(np.isfinite(e) and e <= KERNEL_RTOL * scale,
                  f"{k} at B={B} n={n} w={w}: max abs err {e}")
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], e)
        log(f"[lu-kernels] B={B} n={n} w={w}: route "
            f"{'ring' if plan.ring else 'staged'}, {plan.group} instances "
            f"(a warp each) a CTA, {-(-B // plan.group)} CTAs, "
            f"{plan.smem} bytes of shared memory a CTA")
        fb, xo = torch.empty_like(band), torch.empty_like(rhs)
        reps = 50 if main or n <= 290 else 5
        preps = (20 if n <= 290 else 3) if main else (3 if n <= 290 else 0)
        if plan.ring:
            check(n > lu.RING_ROWS, f"a ring band longer than the ring at B={B} n={n} w={w}")
        runs = {
            "lu_factor_solve": (
                lambda: lu.launch_factor_solve(band, rhs, fb, xo, w, clamp),
                lambda: lu.fleet_banded_lu_factor_solve_plain(band, rhs, w, clamp),
                lambda: lu.fleet_banded_lu_factor_solve_batched(band, rhs, w, clamp)),
            "lu_solve": (
                lambda: lu.launch_solve(f9, rhs, xo, w),
                lambda: lu.fleet_banded_lu_solve_plain(pf, rhs, w),
                lambda: lu.fleet_banded_lu_solve_batched(f9, rhs, w)),
            "lu_factor": (
                lambda: lu.launch_factor(band, fb, w, clamp),
                lambda: lu.fleet_banded_lu_factor_plain(band, w, clamp),
                lambda: lu.fleet_banded_lu_factor_batched(band, w, clamp)),
        }
        libs = {}
        if main:
            # K10's library call: lu_solve with no interchanges (pivots
            # 1..n) on K9's factor expanded to dense (not timed)
            LU = lu_dense(f9)
            piv = torch.arange(1, n + 1, dtype=torch.int32, device="cuda").repeat(B, 1)
            libs["lu_solve"], el = library_check(
                lambda: torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0],
                x10, scale, f"lu_solve against K10 at B={B} n={n} w={w}", 5)
            log(f"[lu-kernels] library torch.linalg.lu_solve (pivots 1..n) on K9's "
                f"factor as dense LU: {libs['lu_solve']:.4f} ms, max abs diff from K10 "
                f"{el:.3e}")
            # K11's library call: lu_factor_ex with no interchanges on the
            # band expanded to its dense matrix (not timed); no clamp fires
            # on these data, so its LU is K11's factor
            check(bool((f11[..., 0].abs() > clamp).all()), "no clamp fired in K11")
            LU = lu_dense(f11)
            Ad = lu_dense(band)
            libs["lu_factor"], el = library_lu_factor(
                Ad, LU, scale, f"lu_factor_ex against K11 at B={B} n={n} w={w}")
            log(f"[lu-kernels] library torch.linalg.lu_factor_ex(pivot=False) on the band "
                f"as a dense matrix: {libs['lu_factor']:.4f} ms, max abs diff from K11 "
                f"{el:.3e}")
            # K9's function as a dense pair on the same matrix
            libs["lu_factor_solve"], el = library_pair(Ad, rhs, x9, scale, 3)
            log(f"[lu-kernels] library torch.linalg.lu_factor_ex(pivot=False) then "
                f"lu_solve (two calls) on the band as a dense matrix: "
                f"{libs['lu_factor_solve']:.4f} ms, max abs diff from K9 {el:.3e}")
            del LU, Ad
        for k, (kern, plain, entry) in runs.items():
            ms = cuda_ms(kern, reps)
            plain_ms = cuda_ms(plain, preps) if preps else None
            bms, by = lu_bound(k, B, n, w)
            extra, dev_ms = "", None
            if main:
                dev_ms = cuda_ms(kern, reps, spin=True)
                cold = cuda_ms_cold(kern)
                entry_ms = cuda_ms(entry, reps)
                extra = (f" (device {dev_ms:.4f} ms; with L2 cold {cold:.4f} ms)  "
                         f"entry point {entry_ms:.4f} ms")
            lib = f"  library {libs[k]:.4f} ms" if k in libs else ""
            plain_s = f"{plain_ms:.3f} ms" if plain_ms is not None else "not timed"
            log(f"[lu-kernels] {LU_NAMES[k]} B={B} n={n} w={w}: max_abs_err "
                f"{errs[k]:.3e}  kernel {ms:.4f} ms{extra}  plain {plain_s}{lib}  "
                f"bound {bms:.5f} ms ({by})")
            if (B, n, w) == LU_SHAPE:
                recs[k].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                               bound_by=by, library_ms=libs.get(k))
            elif main:
                recs[k].setdefault("main_shapes", []).append(
                    {"B": B, "n": n, "w": w, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": libs.get(k), "max_abs_err": errs[k]})
        del band, rhs, f9, x9, x10, f11, pf, px, px10, fb, xo
    return recs


# (B, n, w): the flagship fleet's band; the min-max saddle and HessD
# bands; the nonlinear unicycle fleet's; a fleet at w = 9 and one whose
# last CTA holds one instance (B = 1001 at w = 1); the widest band; and
# bands above the shared-memory cap (the ring route), one with n a whole
# number of chunks
FB_SHAPE = (FLEET_B, 149, 4)
FB_SHAPES = [FB_SHAPE, MM_SADDLE, MM_HESSD, UNI_BAND, (1000, 69, 9), (1001, 37, 1),
             (FLEET_B, 149, 16), (64, 12000, 4), (64, 3520, 16)]
# the main paths' shapes, timed in full (device time alone, L2 cold, the
# entry point, the library call); the shape each kernel's record (the
# kernels line) comes from: K1/K2 the flagship's, K3 the min-max HessD
# inertia's, its only main-path caller
FB_MAIN_SHAPES = (FB_SHAPE, MM_SADDLE, MM_HESSD, UNI_BAND)
FB_RECORDED = {"factor_solve": FB_SHAPE, "solve": FB_SHAPE, "factor": MM_HESSD}
# fleets whose instances reach far outside the usual magnitudes, at a
# width that divides through the pivot's reciprocal and one that does not
FB_RANGE_SHAPES = [(1001, 37, 1), (1000, 69, 9)]
# instances a CTA (a lane each, one warp a CTA) timed at these shapes:
# 1 is a warp an instance, one lane's chain and 31 lanes of copies
FB_SWEEP_SHAPES = [FB_SHAPE, (1000, 69, 9)]
FB_GROUPS = (1, 2, 4, 8, 16, 32)


def phase_kernels(fb):
    """K1-K3 against their plain versions (bitwise); returns per-kernel
    records (times at the shapes of FB_RECORDED)."""
    recs = {k: {"max_abs_err": 0.0} for k in REPLACES}
    clamp = 1e-7
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad = fb.check_reciprocal(torch.device("cuda"))
    check(bad == 0, f"the factor's reciprocal differs from __frcp_rn at {bad} floats")
    log("[kernels] the factor's reciprocal equals __frcp_rn at all 2,013,265,922 "
        "floats of magnitude 2^-60..2^60")
    for B, n, w in FB_SHAPES:
        main = (B, n, w) in FB_MAIN_SHAPES
        plan = fb.launch_plan(n, w, B, sms)
        band, rhs = test_band(B, n, w, seed=n + w)
        if (B, n, w) in FB_RANGE_SHAPES:
            # magnitudes outside 2^-60..2^60, where a step divides by
            # __fdiv_rn instead of through the pivot's reciprocal
            band[1::4] *= 1e21
            band[2::4] *= 1e-25
            band[3::4, ::5, 1] = 1e-30
            rhs[::5] *= 1e-30
        f1, x1 = fb.fleet_banded_factor_solve_batched(band, rhs, w, clamp)
        x2 = fb.fleet_banded_solve_batched(f1, rhs, w)
        f3 = fb.fleet_banded_factor_batched(band, w, clamp)
        pf, px = fb.fleet_banded_factor_solve_plain(band, rhs, w, clamp)
        px2 = fb.fleet_banded_solve_plain(pf, rhs, w)
        torch.cuda.synchronize()
        errs = {
            "factor_solve": max((f1 - pf).abs().max().item(),
                                (x1 - px).abs().max().item()),
            "solve": (x2 - px2).abs().max().item(),
            "factor": (f3 - pf).abs().max().item(),
        }
        scale = max(pf.abs().max().item(), px.abs().max().item(), 1.0)
        for k, e in errs.items():
            # the kernels repeat the plain versions' roundings: bitwise
            check(e == 0.0, f"{k} at B={B} n={n} w={w}: max abs err {e}")
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], e)
        log(f"[kernels] B={B} n={n} w={w}: route {'ring' if plan.ring else 'staged'}, "
            f"{plan.group} instances (a lane each) a CTA of one warp, "
            f"{-(-B // plan.group)} CTAs, {plan.smem} bytes of shared memory a CTA")
        fbo, xo = torch.empty_like(band), torch.empty_like(rhs)
        reps = 50 if n <= 480 else 5
        preps = (20 if n <= 149 else 3) if main else (3 if n <= 149 else 0)
        # kernel launch, plain version, entry point; the band (3 MB at the
        # flagship shape) stays in L2 as it does after assembly
        runs = {
            "factor_solve": (
                lambda: fb.launch_factor_solve(band, rhs, fbo, xo, w, clamp),
                lambda: fb.fleet_banded_factor_solve_plain(band, rhs, w, clamp),
                lambda: fb.fleet_banded_factor_solve_batched(band, rhs, w, clamp)),
            "solve": (
                lambda: fb.launch_solve(f1, rhs, xo, w),
                lambda: fb.fleet_banded_solve_plain(pf, rhs, w),
                lambda: fb.fleet_banded_solve_batched(f1, rhs, w)),
            "factor": (
                lambda: fb.launch_factor(band, fbo, w, clamp),
                lambda: fb.fleet_banded_factor_plain(band, w, clamp),
                lambda: fb.fleet_banded_factor_batched(band, w, clamp)),
        }
        libs = {}
        if main and (B, n, w) != UNI_BAND:
            # K2's library call: ldl_solve with no interchanges (pivots
            # 1..n) on K1's factor expanded to dense (not timed); 3.6-5.1 s
            # a call at the unicycle's band on an H100, so not repeated there
            LD = ldl_dense(f1)
            piv = torch.arange(1, n + 1, dtype=torch.int32, device="cuda").repeat(B, 1)
            libs["solve"], el = library_check(
                lambda: torch.linalg.ldl_solve(LD, piv, rhs[..., None])[..., 0],
                x2, scale, f"ldl_solve against K2 at B={B} n={n} w={w}", 3 if n <= 149 else 1)
            log(f"[kernels] library torch.linalg.ldl_solve (pivots 1..n) on K1's "
                f"factor as dense LDL^T: {libs['solve']:.4f} ms, max abs diff from K2 "
                f"{el:.3e}")
        if main:
            # K3's library call: lu_factor_ex with no interchanges on the
            # band expanded to its dense symmetric matrix (not timed); no
            # clamp fires on these data, so L below U's diagonal and d on it
            # are K3's factor
            check(bool((f3[..., 0].abs() > clamp).all()), "no clamp fired in K3")
            LD = ldl_dense(f3)
            Ad = ldl_dense(band)
            Ad = Ad + Ad.tril(-1).mT
            libs["factor"], el = library_lu_factor(
                Ad, LD, scale, f"lu_factor_ex against K3 at B={B} n={n} w={w}", lower=True)
            log(f"[kernels] library torch.linalg.lu_factor_ex(pivot=False) on the band "
                f"as a dense symmetric matrix: {libs['factor']:.4f} ms, max abs diff from "
                f"K3 {el:.3e}")
            if (B, n, w) != MM_HESSD:
                # K1's function as a dense pair on the same matrix
                libs["factor_solve"], el = library_pair(Ad, rhs, x1, scale, 3)
                log(f"[kernels] library torch.linalg.lu_factor_ex(pivot=False) then "
                    f"lu_solve (two calls) on the band as a dense symmetric matrix: "
                    f"{libs['factor_solve']:.4f} ms, max abs diff from K1 {el:.3e}")
            del LD, Ad
        for k, (kern, plain, entry) in runs.items():
            ms = cuda_ms(kern, reps)
            plain_ms = cuda_ms(plain, preps) if preps else None
            bms, by = bound(k, B, n, w)
            extra, dev_ms = "", None
            if main:
                dev_ms = cuda_ms(kern, reps, spin=True)
                cold = cuda_ms_cold(kern)
                entry_ms = cuda_ms(entry, reps)
                extra = (f" (device {dev_ms:.4f} ms; with L2 cold {cold:.4f} ms)  "
                         f"entry point {entry_ms:.4f} ms")
            lib = f"  library {libs[k]:.4f} ms" if k in libs else ""
            plain_s = f"{plain_ms:.3f} ms" if plain_ms is not None else "not timed"
            log(f"[kernels] {NAMES[k]} B={B} n={n} w={w}: max_abs_err "
                f"{errs[k]:.3e}  kernel {ms:.4f} ms{extra}  plain {plain_s}{lib}  "
                f"bound {bms:.5f} ms ({by})")
            if FB_RECORDED[k] == (B, n, w):
                recs[k].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                               bound_by=by, library_ms=libs.get(k))
        if (B, n, w) in FB_SWEEP_SHAPES:
            phase_kernels_groups(fb, B, n, w, band, rhs, f1, pf, px, px2, clamp)
        del band, rhs, f1, x1, x2, f3, pf, px, px2, fbo, xo
    return recs


def wide_row(label, names, k, B, n, w, err, kern, bms, by, lib_ms, plain_ms=None):
    """One kernel's line at a wide shape: device time alone and with the
    host's launch overhead, bound, library pair, plain version."""
    dev = cuda_ms(kern, 20, spin=True)
    ms = cuda_ms(kern, 20)
    plain_s = f"{plain_ms:.3f} ms" if plain_ms is not None else "not timed"
    log(f"[{label}] {names[k]} B={B} n={n} w={w}: max_abs_err {err:.3e}  kernel "
        f"{ms:.4f} ms (device {dev:.4f} ms)  plain {plain_s}  library {lib_ms:.4f} ms  "
        f"bound {bms:.5f} ms ({by})")
    return {"B": B, "n": n, "w": w, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, "max_abs_err": err}


def phase_wide_kernels(fb, recs):
    """K1-K3 on the wide route (w = 17..63, a warp an instance) at
    FB_WIDE_SHAPES: bitwise against the plain versions, timed beside their
    bounds and library calls on the band expanded to dense (K1: the
    lu_factor_ex + lu_solve pair; K2: lu_solve on K1's factor as an LU;
    K3: lu_factor_ex); the quadcopter's shape goes into the records'
    main_shapes."""
    clamp = 1e-7
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, n, w in FB_WIDE_SHAPES:
        plan = fb.launch_plan(n, w, B, sms)
        check(plan.group == 1 and plan.ring == (B == 16),
              f"wide plan at B={B} n={n} w={w}: {plan}")
        band, rhs = test_band(B, n, w, seed=n + w)
        f1, x1 = fb.fleet_banded_factor_solve_batched(band, rhs, w, clamp)
        x2 = fb.fleet_banded_solve_batched(f1, rhs, w)
        f3 = fb.fleet_banded_factor_batched(band, w, clamp)
        pf, px = fb.fleet_banded_factor_solve_plain(band, rhs, w, clamp)
        px2 = fb.fleet_banded_solve_plain(pf, rhs, w)
        torch.cuda.synchronize()
        check(same_bits(f1, pf) and same_bits(x1, px) and same_bits(x2, px2)
              and same_bits(f3, pf), f"K1-K3 at B={B} n={n} w={w}: not bitwise")
        errs = {"factor_solve": max((f1 - pf).abs().max().item(), (x1 - px).abs().max().item()),
                "solve": (x2 - px2).abs().max().item(), "factor": (f3 - pf).abs().max().item()}
        for k, e in errs.items():
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], e)
        log(f"[kernels] B={B} n={n} w={w}: wide route "
            f"{'ring' if plan.ring else 'staged'}, a CTA of one warp an instance, {B} CTAs, "
            f"{plan.smem} bytes of shared memory a CTA; bitwise equal to the plain versions")
        scale = max(pf.abs().max().item(), px.abs().max().item(), 1.0)
        lreps = 1 if plan.ring else 3
        check(bool((f3[..., 0].abs() > clamp).all()), "no clamp fired in K3")
        Ad = ldl_dense(band)
        Ad = Ad + Ad.tril(-1).mT
        piv = torch.arange(1, n + 1, dtype=torch.int32, device="cuda").repeat(B, 1)
        LU = ldl_as_lu(f1)
        libs = {
            "factor_solve": library_pair(Ad, rhs, x1, scale, lreps)[0],
            "solve": library_check(
                lambda: torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0], x2, scale,
                f"lu_solve against K2 at B={B} n={n} w={w}", lreps)[0],
            "factor": library_lu_factor(Ad, ldl_dense(f3), scale,
                                        f"lu_factor_ex against K3 at B={B} n={n} w={w}",
                                        lower=True, reps=lreps)[0],
        }
        del Ad, LU
        fbo, xo = torch.empty_like(band), torch.empty_like(rhs)
        runs = {
            "factor_solve": (lambda: fb.launch_factor_solve(band, rhs, fbo, xo, w, clamp),
                             lambda: fb.fleet_banded_factor_solve_plain(band, rhs, w, clamp)),
            "solve": (lambda: fb.launch_solve(f1, rhs, xo, w),
                      lambda: fb.fleet_banded_solve_plain(pf, rhs, w)),
            "factor": (lambda: fb.launch_factor(band, fbo, w, clamp),
                       lambda: fb.fleet_banded_factor_plain(band, w, clamp)),
        }
        for k, (kern, plain) in runs.items():
            main = (B, n, w) == QUAD_BAND
            plain_ms = cuda_ms(plain, 1) if main else None
            bms, by = bound(k, B, n, w)
            row = wide_row("kernels", NAMES, k, B, n, w, errs[k], kern, bms, by, libs[k],
                           plain_ms)
            if main:
                recs[k].setdefault("main_shapes", []).append(row)
        del band, rhs, f1, x1, x2, f3, pf, px, px2, fbo, xo


def phase_wide_lu_kernels(lu, recs):
    """K9-K11 at two rows a lane (w = 32..63) at LU_WIDE_SHAPES: bitwise
    against the plain versions, timed beside their bounds and library
    calls on the band expanded to dense (K9: the lu_factor_ex + lu_solve
    pair; K10: lu_solve on K9's factor; K11: lu_factor_ex)."""
    clamp = 1e-4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, n, w in LU_WIDE_SHAPES:
        plan = lu.launch_plan(n, w, B, sms)
        check(plan.ring == (n > 1000), f"LU plan at B={B} n={n} w={w}: {plan}")
        band, rhs = test_lu_band(B, n, w, seed=n + w)
        f9, x9 = lu.fleet_banded_lu_factor_solve_batched(band, rhs, w, clamp)
        x10 = lu.fleet_banded_lu_solve_batched(f9, rhs, w)
        f11 = lu.fleet_banded_lu_factor_batched(band, w, clamp)
        pf, px = lu.fleet_banded_lu_factor_solve_plain(band, rhs, w, clamp)
        px10 = lu.fleet_banded_lu_solve_plain(pf, rhs, w)
        torch.cuda.synchronize()
        check(same_bits(f9, pf) and same_bits(x9, px) and same_bits(x10, px10)
              and same_bits(f11, pf), f"K9-K11 at B={B} n={n} w={w}: not bitwise")
        errs = {"lu_factor_solve": max((f9 - pf).abs().max().item(),
                                       (x9 - px).abs().max().item()),
                "lu_solve": (x10 - px10).abs().max().item(),
                "lu_factor": (f11 - pf).abs().max().item()}
        for k, e in errs.items():
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], e)
        log(f"[lu-kernels] B={B} n={n} w={w}: two rows a lane, route "
            f"{'ring' if plan.ring else 'staged'}, {plan.group} instances (a warp each) a "
            f"CTA, {plan.smem} bytes of shared memory a CTA; bitwise equal to the plain "
            "versions")
        scale = max(pf.abs().max().item(), px.abs().max().item(), 1.0)
        lreps = 1 if plan.ring else 3
        check(bool((f11[..., 0].abs() > clamp).all()), "no clamp fired in K11")
        Ad = lu_dense(band)
        piv = torch.arange(1, n + 1, dtype=torch.int32, device="cuda").repeat(B, 1)
        LU = lu_dense(f9)
        libs = {
            "lu_factor_solve": library_pair(Ad, rhs, x9, scale, lreps)[0],
            "lu_solve": library_check(
                lambda: torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0], x10, scale,
                f"lu_solve against K10 at B={B} n={n} w={w}", lreps)[0],
            "lu_factor": library_lu_factor(Ad, lu_dense(f11), scale,
                                           f"lu_factor_ex against K11 at B={B} n={n} w={w}",
                                           reps=lreps)[0],
        }
        del Ad, LU
        fo, xo = torch.empty_like(band), torch.empty_like(rhs)
        runs = {"lu_factor_solve": lambda: lu.launch_factor_solve(band, rhs, fo, xo, w, clamp),
                "lu_solve": lambda: lu.launch_solve(f9, rhs, xo, w),
                "lu_factor": lambda: lu.launch_factor(band, fo, w, clamp)}
        for k, kern in runs.items():
            bms, by = lu_bound(k, B, n, w)
            wide_row("lu-kernels", LU_NAMES, k, B, n, w, errs[k], kern, bms, by, libs[k])
        del band, rhs, f9, x9, x10, f11, pf, px, px10, fo, xo


def block_launches(fam, mod, w, B, plan) -> str:
    """K1-K3's (fam 'fb') or K9-K11's ('lu') launches on the block route:
    the factor's panel width nb, its threads and each kernel's CTAs and
    shared memory (either phase in device memory where the plan says 0)."""
    names = ("K3, K1", "K2, K1") if fam == "fb" else ("K11, K9", "K10, K9")
    threads = plan.stride if fam == "fb" else mod.PANEL_THREADS
    ssmem = mod.block_smem(w, plan.group, plan.rows, False)
    factor = (f"a CTA of {threads} threads an instance, panels of nb = {plan.rows} steps"
              if plan.rows else
              f"in device memory (a CTA of {mod.block_threads(w)} threads an instance)")
    solve = (f"{plan.group} instance(s) (a warp each) a CTA, {-(-B // plan.group)} CTAs"
             if plan.group else
             f"in device memory (a CTA of {mod.block_threads(w)} threads an instance), {B} CTAs")
    return (f"the factor ({names[0]}'s first launch) {factor}, {B} CTAs, {plan.smem} bytes of "
            f"shared memory a CTA; the solve ({names[1]}'s second launch) {solve}, "
            f"{ssmem} bytes a CTA")


def inplace_check(fam, mod, band, rhs, w, clamp, pf, px, px2) -> None:
    """K1-K3 (fam 'fb') or K9-K11 ('lu') with both block-route phases in
    device memory (panel 0 and group 0, which the plan takes only past
    w = 7252 and w = 1024), forced through the C entries at a narrower
    band: bitwise against the plain versions.  These launches are checks:
    no wrapper counts them."""
    lib = mod._lib_on(band.device)
    B, n, _ = band.shape
    f, x, x2, f3 = (torch.full_like(t, float("nan")) for t in (band, rhs, rhs, band))
    s = mod._stream(band)
    if fam == "fb":
        a = (w, 0, 0, 0, 0)
        rcs = (lib.tc_fleet_banded_factor_solve(*a, band.data_ptr(), rhs.data_ptr(),
                                                f.data_ptr(), x.data_ptr(), n, B, clamp, s),
               lib.tc_fleet_banded_solve(*a, pf.data_ptr(), rhs.data_ptr(), x2.data_ptr(),
                                         n, B, s),
               lib.tc_fleet_banded_factor(*a, band.data_ptr(), f3.data_ptr(), n, B, clamp, s))
    else:
        a = (w, 0, 0, 0)
        rcs = (lib.tc_banded_lu_factor_solve(*a, band.data_ptr(), rhs.data_ptr(),
                                             f.data_ptr(), x.data_ptr(), n, B, clamp, s),
               lib.tc_banded_lu_solve(*a, pf.data_ptr(), rhs.data_ptr(), x2.data_ptr(),
                                      n, B, s),
               lib.tc_banded_lu_factor(*a, band.data_ptr(), f3.data_ptr(), n, B, clamp, s))
    torch.cuda.synchronize()
    what = "K1-K3" if fam == "fb" else "K9-K11"
    check(rcs == (0, 0, 0) and same_bits(f, pf) and same_bits(x, px) and same_bits(x2, px2)
          and same_bits(f3, pf), f"{what} in device memory at B={B} n={n} w={w}: rc {rcs}, "
          "not bitwise")
    log(f"[block-kernels] B={B} n={n} w={w} {what} with both phases in device memory "
        "(forced): bitwise equal to the plain versions")


def phase_block_kernels(fb, lu):
    """K1-K3 and K9-K11 on the block route (w > 63: a CTA an instance) at
    BLOCK_CASES: bitwise against the plain versions, timed (device time
    alone and with the host's launch overhead) beside their bounds, the
    plain versions and the library calls on the band expanded to dense
    (K1/K9: lu_factor_ex(pivot=False) + lu_solve; K2/K10: lu_solve on the
    kernel's factor; K3/K11: lu_factor_ex).  Returns each kernel's rows
    (the game's band's marked with its path)."""
    rows = {k: [] for k in (*REPLACES, *LU_REPLACES)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mod, src in ((fb, SOURCE), (lu, LU_SOURCE)):
        log(f"[block-kernels] ptxas, {src}: no spills; registers a thread: "
            f"{ptxas_report(mod, None, ('staged', 'ring'))}")
    for fam, (B, n, w) in BLOCK_CASES:
        mod, clamp = (fb, 1e-7) if fam == "fb" else (lu, 1e-4)
        check(mod.route(w) == "block", f"{fam} route at w={w}: {mod.route(w)}")
        plan = mod.launch_plan(n, w, B, sms)
        if fam == "fb":
            band, rhs = test_band(B, n, w, seed=n + w)
            fs, so, fa = (fb.fleet_banded_factor_solve_batched, fb.fleet_banded_solve_batched,
                          fb.fleet_banded_factor_batched)
            pfs, pso, pfa = (fb.fleet_banded_factor_solve_plain, fb.fleet_banded_solve_plain,
                             fb.fleet_banded_factor_plain)
            names, keys, bnd = NAMES, tuple(REPLACES), bound
        else:
            band, rhs = test_lu_band(B, n, w, seed=n + w)
            fs, so, fa = (lu.fleet_banded_lu_factor_solve_batched,
                          lu.fleet_banded_lu_solve_batched, lu.fleet_banded_lu_factor_batched)
            pfs, pso, pfa = (lu.fleet_banded_lu_factor_solve_plain,
                             lu.fleet_banded_lu_solve_plain, lu.fleet_banded_lu_factor_plain)
            names, keys, bnd = LU_NAMES, tuple(LU_REPLACES), lu_bound
        f1, x1 = fs(band, rhs, w, clamp)
        x2 = so(f1, rhs, w)
        f3 = fa(band, w, clamp)
        t0 = time.perf_counter()
        pf, px = pfs(band, rhs, w, clamp)
        torch.cuda.synchronize()
        plain_fs = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        px2 = pso(pf, rhs, w)
        torch.cuda.synchronize()
        plain_so = 1e3 * (time.perf_counter() - t0)
        check(same_bits(f1, pf) and same_bits(x1, px) and same_bits(x2, px2)
              and same_bits(f3, pf), f"{names[keys[0]]} family at B={B} n={n} w={w}: "
              "not bitwise on the block route")
        errs = {keys[0]: max((f1 - pf).abs().max().item(), (x1 - px).abs().max().item()),
                keys[1]: (x2 - px2).abs().max().item(), keys[2]: (f3 - pf).abs().max().item()}
        check(all(e == 0.0 for e in errs.values()), f"block route errors {errs}")
        check(bool((f3[..., 0].abs() > clamp).all()), "no clamp fired in the factor")
        launches = block_launches(fam, mod, w, B, plan)
        if B * n * w * w <= INPLACE_CHECK_UPDATES:
            inplace_check(fam, mod, band, rhs, w, clamp, pf, px, px2)
        log(f"[block-kernels] B={B} n={n} w={w} {'K1-K3' if fam == 'fb' else 'K9-K11'}: "
            f"block route, {launches}; bitwise equal to the plain versions (max abs err 0.0)")
        scale = max(pf.abs().max().item(), px.abs().max().item(), 1.0)
        if fam == "fb":
            Ad = ldl_dense(band)
            Ad = Ad + Ad.tril(-1).mT
            LU, want3 = ldl_as_lu(f1), ldl_dense(f3)
        else:
            # K11's factor is K9's, bit for bit (held above)
            Ad, LU = lu_dense(band), lu_dense(f1)
            want3 = LU
        piv = torch.arange(1, n + 1, dtype=torch.int32, device="cuda").repeat(B, 1)
        lreps = 3 if B * n * n <= 400_000_000 else 1
        libs = {
            keys[0]: library_pair(Ad, rhs, x1, scale, lreps)[0],
            keys[1]: library_check(
                lambda: torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0], x2, scale,
                f"lu_solve against {names[keys[1]]} at B={B} n={n} w={w}", lreps)[0],
            keys[2]: library_lu_factor(Ad, want3, scale,
                                       f"lu_factor_ex against {names[keys[2]]} at "
                                       f"B={B} n={n} w={w}", lower=fam == "fb",
                                       reps=lreps)[0],
        }
        del Ad, LU, want3
        fo, xo = torch.empty_like(band), torch.empty_like(rhs)
        launch = {keys[0]: lambda: mod.launch_factor_solve(band, rhs, fo, xo, w, clamp),
                  keys[1]: lambda: mod.launch_solve(f1, rhs, xo, w),
                  keys[2]: lambda: mod.launch_factor(band, fo, w, clamp)}
        plain_ms = {keys[0]: plain_fs, keys[1]: plain_so, keys[2]: None}
        kreps = 5 if n * w * w <= 3e7 else 2
        for k, kern in launch.items():
            bms, by = bnd(k, B, n, w)
            dev = cuda_ms(kern, kreps, spin=True)
            ms = cuda_ms(kern, kreps)
            plain_s = (f"{plain_ms[k]:.1f} ms (one call, host clock)"
                       if plain_ms[k] is not None else "not timed")
            floor = ""
            if k != keys[1]:
                # the factor's floor under the kernels' contract: each of its
                # updates (the LU's sum over steps of min(w, n-1-c)^2; the
                # LDL's lower triangle, min(w, n-1-c)(min(w, n-1-c) + 1) / 2)
                # a product rounded, then a subtraction, two FP32
                # instructions (no FMA)
                m = [min(w, n - 1 - c) for c in range(n)]
                upd = B * sum(v * v if fam == "lu" else v * (v + 1) // 2 for v in m)
                floor = f", {4 * upd / FP32_FLOPS * 1e3:.3f} ms without FMA"
            log(f"[block-kernels] {names[k]} B={B} n={n} w={w}: max_abs_err {errs[k]:.1e}  "
                f"kernel {ms:.4f} ms (device {dev:.4f} ms)  plain {plain_s}  library "
                f"{libs[k]:.4f} ms  bound {bms:.5f} ms ({by}{floor}), {dev / bms:.1f}x")
            rows[k].append({"B": B, "n": n, "w": w, "ms": ms, "device_ms": dev,
                            "plain_ms": plain_ms[k], "bound_ms": bms, "bound_by": by,
                            "library_ms": libs[k], "max_abs_err": errs[k],
                            **({"path": "deconv_game"} if (B, n, w) == GAME_BAND else {})})
        del band, rhs, f1, x1, x2, f3, pf, px, px2, fo, xo
        torch.cuda.empty_cache()
    return rows


def tutorial_outputs(name: str, device: str) -> list:
    """The arrays a tutorial's ``main`` returns at its defaults, flat, on
    ``device`` ('cuda' or 'cpu')."""
    import importlib

    mod = importlib.import_module(f"tenscalc_tpu_torch.examples.tutorial_{name}")
    kw = {"verbose": False} if name not in ("lq", "fim") else {}
    with contextlib.redirect_stdout(io.StringIO()):
        out = mod.main(device=device, **kw)
    if isinstance(out, dict):
        return [np.asarray(out[k]) for k in sorted(out)]
    if isinstance(out, tuple) and isinstance(out[0], dict):  # tutorial_nn
        return [np.asarray(out[1])] + [np.asarray(out[0][k]) for k in sorted(out[0])]
    if isinstance(out, tuple):
        return [np.asarray(o) for o in out]
    return [np.asarray(out)]


def cpu_side(fn, args):
    """A CPU side's process: ``fn(*args)`` on one thread, below the card's
    phases in priority (they are host-bound); returns its result and
    seconds."""
    os.nice(10)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


CPU_POOLS: list = []  # every CPU side's pool, ended when the run ends


def start_cpu_side(fn, *args):
    """``fn(*args)``, the CPU side of a cross-check (the port on the CPU:
    the plain versions of the kernels), in a spawned process of its own
    beside the card's later phases; returns what collect_cpu_side takes."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    CPU_POOLS.append(pool)
    return pool, pool.apply_async(cpu_side, (fn, args))


def collect_cpu_side(side):
    """A CPU side's (result, seconds), its process ended."""
    pool, job = side
    try:
        return job.get(timeout=1000)
    finally:
        pool.close()
        pool.join()


def numpy_result(res, idx=None):
    """A fleet's result (its instances ``idx``, or all) as numpy arrays on
    the host, field by field."""
    from tenscalc_tpu_torch.interop import map_fields

    if idx is not None:
        res = map_fields(lambda v: v[torch.as_tensor(idx, device=v.device)], res)
    return SimpleNamespace(**map_fields(lambda v: v.cpu().numpy(), res)._asdict())


def torch_result(res):
    """numpy_result's fields as CPU tensors again."""
    return SimpleNamespace(**{
        k: (v if v is None else tuple(map(torch.as_tensor, v)) if isinstance(v, tuple)
            else torch.as_tensor(v))
        for k, v in vars(res).items()})


def deconv_cpu(params, inits):
    """[deconv-cross-check]'s CPU side: those instances of the fleet."""
    import tenscalc_tpu_torch as ttc

    cpu = build_deconv(ttc, DC_N, DC_K, "bdc_", dtype="float32", device="cpu")
    return numpy_result(cpu.solve_many(params, inits=inits, mu0=1.0, max_iter=DC_MAX_ITER))


def tutorials_cpu():
    """[tutorials]' CPU side: the seven tutorials at their defaults, each
    timed."""
    import tenscalc_tpu_torch as ttc

    res = {}
    for name in TUTORIALS:
        ttc.clear_variables()
        t0 = time.perf_counter()
        res[name] = (tutorial_outputs(name, "cpu"), time.perf_counter() - t0)
    return res


def phase_deconv(ttc, fb, others):
    """The deconvolution fleet (B = 256, N = 1000, a 96-tap filter, f32,
    'auto', mu0 = 1, max_iter = 100) on the card: the 'hoisted' band mode
    through K1/K2 on the block route (w = 95), no K3 and no other kernel."""
    ns = "bdc_"
    t0 = time.perf_counter()
    solver = build_deconv(ttc, DC_N, DC_K, ns, dtype="float32")
    build = time.perf_counter() - t0
    plan = solver.kkt_plan
    check(solver.device.type == "cuda", "the default device is the card")
    check(solver.kkt_backend_resolved == "fleet_banded"
          and solver._solve_raw.band_mode == "hoisted"
          and (plan.n, plan.bandwidth) == (DC_N, DC_K - 1) and fb.route(plan.bandwidth) == "block",
          f"fleet banded, hoisted band (1000, w=95) on the block route: "
          f"{solver.kkt_backend_resolved} {solver._solve_raw.band_mode} {plan.n} {plan.bandwidth}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[deconv] solver built in {build:.1f} s: nU {solver.nU} nF {solver.nF}; nK {plan.n}, "
        f"RCM w {plan.bandwidth} ({plan.n_blocks} blocks); band mode "
        f"{solver._solve_raw.band_mode}; K1/K2 route {fb.route(plan.bandwidth)}: "
        f"{block_launches('fb', fb, plan.bandwidth, DC_B, fb.launch_plan(plan.n, plan.bandwidth, DC_B, sms))}")
    h, y, xtrue = deconv_inputs(DC_N, DC_K, DC_B, seed=0)
    params = {ns + "h": h, ns + "y": y}
    inits = {ns + "x": np.full((DC_B, DC_N), 0.5)}

    def run(max_iter=DC_MAX_ITER):
        res = solver.solve_many(params, inits=inits, mu0=1.0, max_iter=max_iter)
        torch.cuda.synchronize()
        return res

    run(max_iter=2)  # warm-up (first-call allocations)
    reset_counts(fb, *others)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K4-K11 on the deconvolution path: {[m.LAUNCHES for m in others]}")
    check(tuple(res.u.shape) == (DC_B, DC_N) and bool(torch.isfinite(res.u).all()),
          "finite x of the expected shape")
    check(bool((res.u >= 0).all() and (res.u <= 1).all()), "x inside its box")
    check(launches["factor_solve"] > 0 and launches["solve"] > 0 and launches["factor"] == 0,
          f"K1 and K2 on the deconvolution path, no K3: {launches}")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    err = np.abs(res.u.cpu().numpy() - xtrue)
    log(f"[deconv] fleet B={DC_B} N={DC_N} K={DC_K} f32: status counts "
        f"{dict(zip(*np.unique(status, return_counts=True)))}; iters max {iters.max()} mean "
        f"{iters.mean():.2f}; warm solve wall {wall:.4f} s, {DC_B / wall:.1f} solves/s, host "
        f"{1e3 * wall / lockstep:.1f} ms a lockstep iteration ({card_line()}); launches "
        f"{launches}; per lockstep iteration K1 {launches['factor_solve'] / lockstep:.2f} K2 "
        f"{launches['solve'] / lockstep:.2f}; |x - spike train| mean {err.mean():.4f} max "
        f"{err.max():.4f}")
    return solver, params, inits, res, launches, wall, lockstep


def deconv_cross_check_inputs(params, inits, res):
    """Eight instances for the CPU cross-check: those off status 0 first
    (up to four), then every 32nd."""
    off = np.flatnonzero(res.status.cpu().numpy() != 0)[:4]
    idx = np.unique(np.concatenate([off, np.arange(0, DC_B, DC_B // 8)]))[:8]
    sub_p = {k: (v[idx] if np.ndim(v) == 2 else v) for k, v in params.items()}
    return idx, sub_p, {k: v[idx] for k, v in inits.items()}


def finish_deconv_cross_check(idx, out, res):
    """The card's instances against the port on the CPU: status equal,
    iterations within one, x within U_ATOL, the objective within F_RTOL."""
    r, seconds = out
    st, it = res.status.cpu().numpy()[idx], res.iters.cpu().numpy()[idx]
    x, f = res.u.cpu().numpy()[idx], res.f.cpu().numpy()[idx]
    dx = np.abs(x - r.u).max(axis=1)
    df = np.abs(f - r.f) / np.abs(r.f)
    check(np.array_equal(st, r.status), f"deconv status card {st} cpu {r.status}")
    check(bool((np.abs(it - r.iters) <= 1).all()),
          f"deconv iterations card {it} cpu {r.iters}")
    check(bool((dx <= U_ATOL).all() and (df <= F_RTOL).all()),
          f"deconv x within {U_ATOL} ({dx.max():.3e}), J within {F_RTOL} ({df.max():.3e})")
    log(f"[deconv-cross-check] instances {idx.tolist()} on the CPU in {seconds:.1f} s beside "
        f"the other phases: status card {st.tolist()} cpu {r.status.tolist()}; iterations "
        f"card {it.tolist()} cpu {r.iters.tolist()}; max |dx| {dx.max():.3e}, J max rel "
        f"diff {df.max():.3e}")


def phase_deconv_game(ttc, lu, others, fleet_res):
    """The deconvolution as a two-player game (each player owns 500 of the
    1000 samples, both minimize the same objective) on the card, B = 256,
    f32: the stacked KKT's band through K9/K10 on the block route.  A
    potential game: its x is held within U_ATOL of [deconv]'s minimizer
    where both are at status 0, its objective within F_RTOL."""
    ns = "bdg_"
    t0 = time.perf_counter()
    solver = build_deconv_game(ttc, DC_N, DC_K, ns, dtype="float32")
    build = time.perf_counter() - t0
    plan = solver.kkt_plan
    w = plan.bandwidth
    check(solver.kkt_backend_resolved == "fleet_banded_lu"
          and solver._solve_raw.band_mode == "hoisted" and (plan.n, w) == GAME_BAND[1:]
          and w > lu.MAX_W and lu.route(w) == "block",
          f"the game on the fleet banded LU, hoisted band past w=63: "
          f"{solver.kkt_backend_resolved} {solver._solve_raw.band_mode} {plan.n} {w}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[deconv-game] solver built in {build:.1f} s: nK {plan.n}, RCM w {w} "
        f"({plan.n_blocks} blocks); band mode {solver._solve_raw.band_mode}; K9/K10 route "
        f"{lu.route(w)}: {block_launches('lu', lu, w, DC_B, lu.launch_plan(plan.n, w, DC_B, sms))}")
    h, y, _ = deconv_inputs(DC_N, DC_K, DC_B, seed=0)
    params = {ns + "h": h, ns + "y": y}
    half = DC_N // 2
    inits = {ns + "x1": np.full((DC_B, half), 0.5), ns + "x2": np.full((DC_B, DC_N - half), 0.5)}

    def run(max_iter=DC_MAX_ITER):
        res = solver.solve_many(params, inits=inits, mu0=1.0, max_iter=max_iter)
        torch.cuda.synchronize()
        return res

    run(max_iter=2)
    reset_counts(lu, *others)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(lu.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K1-K8 on the game's path: {[m.LAUNCHES for m in others]}")
    check(launches["lu_factor_solve"] > 0 and launches["lu_solve"] > 0
          and launches["lu_factor"] == 0, f"K9 and K10 on the game's path: {launches}")
    x = res.u[:, :DC_N]
    check(bool(torch.isfinite(x).all()), "finite x")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    both = (status == 0) & (fleet_res.status.cpu().numpy() == 0)
    dx = (x - fleet_res.u).abs().max(dim=1).values.cpu().numpy()
    df = (np.abs(res.f.cpu().numpy() - fleet_res.f.cpu().numpy())
          / np.abs(fleet_res.f.cpu().numpy()))
    check(both.any() and bool((dx[both] <= U_ATOL).all() and (df[both] <= F_RTOL).all()),
          f"the game's x within {U_ATOL} of the fleet's ({dx[both].max(initial=0):.3e}), J "
          f"within {F_RTOL} ({df[both].max(initial=0):.3e})")
    # where the two part most: an entry at its bound, whose small
    # multiplier g leaves each interior-point answer near mu / g
    i = int(np.where(both, dx, -1.0).argmax())
    j = int((x[i] - fleet_res.u[i]).abs().argmax())
    lockstep = int(iters.max()) - 1
    log(f"[deconv-game] fleet B={DC_B} f32: status counts "
        f"{dict(zip(*np.unique(status, return_counts=True)))}; iters max {iters.max()} mean "
        f"{iters.mean():.2f}; warm solve wall {wall:.4f} s, {DC_B / wall:.1f} solves/s, host "
        f"{1e3 * wall / lockstep:.1f} ms a lockstep iteration; launches {launches}; per "
        f"lockstep iteration K9 {launches['lu_factor_solve'] / lockstep:.2f} K10 "
        f"{launches['lu_solve'] / lockstep:.2f}; against [deconv] on the {int(both.sum())} "
        f"instances at status 0 in both: max |dx| {dx[both].max():.3e}, J max rel diff "
        f"{df[both].max():.3e}; the max at instance {i} entry {j}: x game "
        f"{float(x[i, j]):.4e} fleet {float(fleet_res.u[i, j]):.4e}, final mu game "
        f"{float(res.mu[i]):.3e} fleet {float(fleet_res.mu[i]):.3e}; game iterations "
        f"{int(iters[i])}, the slowest instance {int(iters.argmax())}")
    return solver, params, inits, launches, wall, lockstep


def phase_api(mpc):
    """sensitivity() on one flagship instance (T = 30) in float64 on the
    card, against the same solution's sensitivity on the CPU (1e-8
    relative to each block's largest entry); solve_result()'s fields
    against solve()'s."""
    ns = "bapi_"
    card = mpc.build_solver(T=API_T, namespace=ns, dtype="float64")
    cpu = mpc.build_solver(T=API_T, namespace=ns, dtype="float64", device="cpu")
    params, inits = mpc.fleet_inputs(API_T, 1, ns, seed=0)
    params = {k: (v[0] if k in (ns + "ref", ns + "xinit") else v) for k, v in params.items()}
    init = {k: v[0] for k, v in inits.items()}
    sol = card.solve(params, init=init, mu0=1e-3, max_iter=100)
    check(sol.ok, f"the flagship instance in float64: {sol.describe()}")
    raw = card.solve_result(params, init=init, mu0=1e-3, max_iter=100)
    check(raw.u.device.type == "cuda" and raw.u.dim() == 1, "solve_result: the card's tensors")
    check(int(raw.status) == sol.status and int(raw.iters) == sol.iters,
          f"solve_result status/iterations {int(raw.status)}/{int(raw.iters)} against solve's "
          f"{sol.status}/{sol.iters}")
    du = float((raw.u.cpu() - torch.as_tensor(card.packing.pack(
        {k: torch.as_tensor(v) for k, v in sol.variables.items()}))).abs().max())
    check(du <= 1e-12 and abs(float(raw.f) - sol.objective) <= 1e-12 * abs(sol.objective),
          f"solve_result's u and objective equal solve's (|du| {du})")
    t0 = time.perf_counter()
    sens = card.sensitivity(sol, params)
    t_card = time.perf_counter() - t0
    ref = cpu.sensitivity(sol, params)
    worst, n_blocks = 0.0, 0
    for v, blocks in ref.items():
        for p, r in blocks.items():
            scale = max(np.abs(r).max(), 1e-300)
            worst = max(worst, np.abs(sens[v][p] - r).max() / scale)
            n_blocks += 1
    check(worst <= 1e-8, f"sensitivity on the card against the CPU: {worst:.3e} relative")
    log(f"[api] flagship T={API_T} float64: status 0, {sol.iters} iterations; solve_result "
        f"equal to solve (|du| {du:.1e}); sensitivity of {len(ref)} variables to "
        f"{len(params)} parameters ({n_blocks} blocks) on the card in {t_card:.2f} s, max "
        f"difference from the CPU's {worst:.3e} relative")


def phase_tutorials(ttc):
    """The seven tutorials at their defaults on the card, each timed."""
    outs = {}
    for name in TUTORIALS:
        ttc.clear_variables()
        t0 = time.perf_counter()
        outs[name] = tutorial_outputs(name, "cuda")
        torch.cuda.synchronize()
        outs[name] = (outs[name], time.perf_counter() - t0)
    return outs


def finish_tutorials(card, out):
    """The card's tutorials against the port's on the CPU, every output
    within TUTORIAL_RTOL relative to its largest entry."""
    cpu, seconds = out
    parts = []
    for name in TUTORIALS:
        (c, tc_), (r, tr) = card[name], cpu[name]
        check(len(c) == len(r), f"tutorial_{name}: {len(c)} outputs against {len(r)}")
        err = max(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) for a, b in zip(c, r))
        check(err <= TUTORIAL_RTOL, f"tutorial_{name}: card against CPU {err:.3e} relative")
        parts.append(f"{name} {tc_:.2f} s (CPU {tr:.2f} s, max rel diff {err:.1e})")
    log(f"[tutorials] at their defaults on the card, against the port on the CPU (run in "
        f"{seconds:.1f} s beside the other phases): " + "; ".join(parts))


def phase_kernels_groups(fb, B, n, w, band, rhs, f1, pf, px, px2, clamp):
    """K1-K3 at each group of FB_GROUPS: bitwise against the plain
    versions, and their device times alone."""
    fbo, xo = torch.empty_like(band), torch.empty_like(rhs)
    parts = []
    for G in FB_GROUPS:
        kerns = (lambda: fb.launch_factor_solve(band, rhs, fbo, xo, w, clamp, group=G),
                 lambda: fb.launch_solve(f1, rhs, xo, w, group=G),
                 lambda: fb.launch_factor(band, fbo, w, clamp, group=G))
        kerns[0]()
        torch.cuda.synchronize()
        e1 = max((fbo - pf).abs().max().item(), (xo - px).abs().max().item())
        kerns[1]()
        torch.cuda.synchronize()
        e2 = (xo - px2).abs().max().item()
        kerns[2]()
        torch.cuda.synchronize()
        e3 = (fbo - pf).abs().max().item()
        check(e1 == e2 == e3 == 0.0, f"K1-K3 at group {G}, B={B} n={n} w={w}: "
              f"max abs err {e1}, {e2}, {e3}")
        t = [cuda_ms(kern, 20, spin=True) for kern in kerns]
        parts.append(f"G={G} ({-(-B // G)} CTAs) {t[0]:.4f}/{t[1]:.4f}/{t[2]:.4f}")
    log(f"[kernels] device ms K1/K2/K3 by instances a CTA at B={B} n={n} w={w} "
        f"(exact at each): " + "; ".join(parts))


class _BandOnly:
    """A KKT operator reduced to what the adapter's inertia reads."""

    def __init__(self, band, perm):
        self.band = band
        self.perm = perm

    def matvec(self, x):
        raise NotImplementedError("an inertia query solves nothing")


def phase_slice(mpc, fb, lu):
    ns = "fleet_"
    solver = mpc.build_solver(T=FLEET_T, namespace=ns, dtype="float32")
    check(solver.device.type == "cuda", "the default device is the card")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is off")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is 'highest'")
    check((solver.nU, solver.nG, solver.nF) == (89, 60, 174), "flagship sizes")
    check(solver.kkt_backend_resolved == "fleet_banded"
          and solver._solve_raw.band_mode == "hoisted"
          and solver.kkt_plan.bandwidth == 4, "fleet banded, hoisted band, w=4")
    params, inits = mpc.fleet_inputs(FLEET_T, FLEET_B, ns, seed=0)

    def run():
        res = solver.solve_many(params, inits=inits, mu0=1e-3, max_iter=100)
        torch.cuda.synchronize()
        return res

    run()  # warm-up (first-call allocations)
    reset_counts(fb, lu)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    check(not any(lu.LAUNCHES.values()), f"no LU kernel on the flagship path: {lu.LAUNCHES}")
    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (FLEET_B, solver.nU), "u shape")
    check(bool(torch.isfinite(res.u).all()), "finite u")
    check(int((status == 0).sum()) == FLEET_B,
          f"all {FLEET_B} instances at status 0 (got {np.bincount(status)})")
    check(launches["factor_solve"] > 0 and launches["solve"] > 0,
          f"K1 and K2 ran on the main path: {launches}")
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    # the same answers as every earlier slice's kernels gave
    check(int(iters.max()) == 11 and round(float(iters.mean()), 2) == 7.66,
          f"iterations max 11, mean 7.66 (got {iters.max()}, {iters.mean():.4f})")
    check(launches["factor_solve"] == lockstep and launches["solve"] == 2 * lockstep,
          f"K1 1.00 and K2 2.00 a lockstep iteration: {launches}")
    log(f"[slice] fleet B={FLEET_B} T={FLEET_T} f32: status 0 for all; iters "
        f"max {iters.max()} mean {iters.mean():.2f}; wall {wall:.4f} s; "
        f"{FLEET_B / wall:.1f} solves/s; launches {launches}; per lockstep "
        f"iteration K1 {launches['factor_solve'] / lockstep:.2f} "
        f"K2 {launches['solve'] / lockstep:.2f} K3 {launches['factor'] / lockstep:.2f}")

    # K3 is off the fleet's path: it runs on a path of its own, the
    # adapter's inertia asked before any solve (the D-sign count of a
    # fresh factorization), driven with every count at 0; its count there
    # is kept apart from the main path's
    band, _ = test_band(FLEET_B, solver.nU + solver.nG, 4, seed=3)
    op = _BandOnly(band, torch.as_tensor(solver.kkt_plan.perm, device="cuda"))
    reset_counts(fb, lu)
    mp, mn = fb.FleetBandedFromBand(op, solver.kkt_plan).inertia()
    torch.cuda.synchronize()
    check(fb.LAUNCHES == {"factor_solve": 0, "solve": 0, "factor": 1},
          f"the inertia query ran K3 alone: {fb.LAUNCHES}")
    entry_launches = {"factor": fb.LAUNCHES["factor"]}
    check(bool(((mp + mn) == op.band.shape[1]).all()), "inertia counts every pivot")
    log(f"[slice] inertia path on a flagship-shaped band: K3 launches "
        f"{entry_launches['factor']} (the fleet path: {launches['factor']})")

    one = {k: (v[0] if k in (ns + "ref", ns + "xinit") else v)
           for k, v in params.items()}
    sol = solver.solve(one, init={k: v[0] for k, v in inits.items()},
                       mu0=1e-3, max_iter=100)
    check(sol.status == 0, f"single solve status {sol.describe()}")
    log(f"[slice] single solve: status 0, {sol.iters} iters, {sol.time:.4f} s")
    return solver, params, inits, res, launches, entry_launches, wall


def flagship_cpu(params, inits):
    """[cross-check]'s CPU side: FLEET_CHECKS of the flagship fleet."""
    from tenscalc_tpu_torch.examples import mpc_dcmotor as mpc

    ns = "fleet_"
    cpu = mpc.build_solver(T=FLEET_T, namespace=ns, dtype="float32", device="cpu")
    return numpy_result(cpu.solve_many(
        {k: (v[FLEET_CHECKS] if k in (ns + "ref", ns + "xinit") else v)
         for k, v in params.items()},
        inits={k: v[FLEET_CHECKS] for k, v in inits.items()}, mu0=1e-3, max_iter=100))


def phase_cross_check(out, res):
    """Eight of the flagship fleet's instances against the port on the
    CPU: status equal, u within U_ATOL."""
    r, _ = out
    idx = FLEET_CHECKS
    st_gpu = res.status.cpu().numpy()[idx]
    du = np.abs(r.u - res.u.cpu().numpy()[idx]).max()
    check((r.status == st_gpu).all(), "status equal on card and CPU")
    check(du <= U_ATOL, f"u within {U_ATOL} (max diff {du:.3e})")
    log(f"[cross-check] 8 instances on the CPU: status equal, max |du| "
        f"{du:.3e}, iters card {res.iters.cpu().numpy()[idx].tolist()} "
        f"cpu {r.iters.tolist()}")


def device_profile(fn, host_ops: bool = False):
    """One call of ``fn`` under the profiler (with the host's operators
    if ``host_ops``; profiling.kernel_events, no warm-up): (wall s,
    device kernel s, kernel launches, device us by kernel name)."""
    from tenscalc_tpu_torch.profiling import kernel_events

    got = kernel_events(fn, n=1, warmup=False, host_ops=host_ops)
    check(got is not None, "the profiler saw device kernels")
    wall, ev = got
    dev_us = {k: us for k, (us, _) in ev.items()}
    return wall, sum(dev_us.values()) / 1e6, sum(c for _, c in ev.values()), dev_us


def phase_profile(label: str, run_fleet, watch=(), host_ops: bool = True):
    """One solve (a fleet's or one instance's) under the profiler: the device's busy and idle
    shares, the top ten kernels, and the kernels whose names ``watch``'s
    patterns find, with their share of the device time.  ``host_ops=False``
    traces the device alone (a long solve's host operators take minutes
    to collect).  Returns the profiled wall time and the device kernel
    time (s), and the watched kernels' shares of that time, in the
    order of ``watch``."""
    import re

    wall, busy, _, dev_us = device_profile(run_fleet, host_ops)
    log(f"[{label}] a solve under the profiler: wall {wall:.4f} s, device "
        f"kernel time {busy:.4f} s, device idle share {1 - busy / wall:.3f}")
    for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[{label}]   {v / 1e3:9.3f} ms  {k[:90]}")
    shares = []
    for name, pattern in watch:
        us = sum(v for k, v in dev_us.items() if re.search(pattern, k))
        check(us > 0, f"the profiler saw {name}")
        shares.append(us / 1e6 / busy)
        log(f"[{label}] {name}: {us / 1e3:.3f} ms, {shares[-1]:.4f} of the "
            f"device kernel time")
    return wall, busy, shares


def phase_mpcmhe(mm, fb, lu):
    """Slice 2: the MPC-MHE equilibrium fleet on the card."""
    ns = "mmhe_"
    t0 = time.perf_counter()
    solver = mm.build_solver(T=MMHE_T, L=MMHE_L, ns=ns, dtype="float32")
    log(f"[slice2] solver built in {time.perf_counter() - t0:.1f} s")
    check(solver.device.type == "cuda", "the default device is the card")
    check(solver._ipm_dims == (12, 30, 56, 24, 56, 0, 0, 56), "MPC-MHE sizes")
    check(solver.kkt_backend_resolved == "fleet_banded_lu"
          and solver._solve_raw.band_mode == "hoisted"
          and solver.kkt_plan.n == 290 and solver.kkt_plan.bandwidth == 10,
          "fleet banded LU, hoisted band, n=290, w=10")
    params = mm.fleet_inputs(MMHE_T, MMHE_L, MMHE_B, ns, seed=0)

    def run():
        res = solver.solve_many(params, mu0=1e-3, max_iter=100)
        torch.cuda.synchronize()
        return res

    run()  # warm-up (first-call allocations)
    reset_counts(fb, lu)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(lu.LAUNCHES)
    check(not any(fb.LAUNCHES.values()), f"no LDL kernel on the game path: {fb.LAUNCHES}")
    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (MMHE_B, 98), "z shape")
    check(bool(torch.isfinite(res.u).all()), "finite z")
    check(int((status == 0).sum()) == MMHE_B,
          f"all {MMHE_B} instances at status 0 (got {np.bincount(status)})")
    check(launches["lu_factor_solve"] > 0 and launches["lu_solve"] > 0,
          f"K9 and K10 ran on the main path: {launches}")
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    log(f"[slice2] MPC-MHE fleet B={MMHE_B} T={MMHE_T} L={MMHE_L} f32: status 0 "
        f"for all; iters max {iters.max()} mean {iters.mean():.2f}; wall "
        f"{wall:.4f} s; {MMHE_B / wall:.1f} solves/s; launches {launches}; per "
        f"lockstep iteration K9 {launches['lu_factor_solve'] / lockstep:.2f} "
        f"K10 {launches['lu_solve'] / lockstep:.2f} "
        f"K11 {launches['lu_factor'] / lockstep:.2f}")

    # K11 is off the IPM path; its entry point (the JAX package's factor
    # wrapper) is driven on its own, on a band of the fleet's shape, with
    # every count at 0; its count there is kept apart from the main path's
    band, _ = test_lu_band(*LU_SHAPE, seed=5)
    reset_counts(fb, lu)
    fband = lu.fleet_banded_lu_factor_batched(band, LU_SHAPE[2], 1e-4)
    torch.cuda.synchronize()
    check(lu.LAUNCHES == {"lu_factor_solve": 0, "lu_solve": 0, "lu_factor": 1},
          f"the factor entry point ran K11 alone: {lu.LAUNCHES}")
    check(bool(torch.isfinite(fband).all()), "finite K11 factor")
    entry_launches = {"lu_factor": lu.LAUNCHES["lu_factor"]}
    log(f"[slice2] factor entry point on an MPC-MHE-shaped band: K11 launches "
        f"{entry_launches['lu_factor']} (the fleet path: {launches['lu_factor']})")

    one = {k: (v[0] if k in (ns + "uPast", ns + "yPast", ns + "ref") else v)
           for k, v in params.items()}
    sol = solver.solve(one, mu0=1e-3, max_iter=100)
    check(sol.status == 0, f"single solve status {sol.describe()}")
    log(f"[slice2] single solve: status 0, {sol.iters} iters, {sol.time:.4f} s")
    return solver, params, res, launches, entry_launches


def mpcmhe_cpu(params, card):
    """[cross-check2]'s CPU side: MMHE_CHECKS of the MPC-MHE fleet solved
    again, and the exit tests' metrics of the card's answers ``card``."""
    from tenscalc_tpu_torch.examples import mpcmhe_dcmotor as mm

    ns = "mmhe_"
    per = (ns + "uPast", ns + "yPast", ns + "ref")
    cpu = mm.build_solver(T=MMHE_T, L=MMHE_L, ns=ns, dtype="float32", device="cpu")
    sub_p = {k: (v[MMHE_CHECKS] if k in per else v) for k, v in params.items()}
    r = cpu.solve_many(sub_p, mu0=1e-3, max_iter=100)
    m = cpu.exit_metrics(sub_p, torch_result(card))
    return numpy_result(r), {k: v.numpy() for k, v in m.items()}


def phase_mpcmhe_cross_check(out, card, opts):
    """64 of the card's MPC-MHE instances solved again on the CPU.

    Status 0 stands for the exit tests (stationarity, equality and gap
    within their tolerances), and that is what is held: both sides at
    status 0 within one iteration of each other, and the card's answers
    ``card`` (numpy_result's), evaluated again on the CPU from their final
    (z, nu, lam), pass the exit tests (``opts``: the solver's).  uFuture
    is printed, not held: float32 solves of this game that pass the gap
    test one update apart differ by a few 1e-3 in uFuture, as much as an
    answer one update short of passing it."""
    (r, m), _ = out
    idx = MMHE_CHECKS
    st_gpu, st_cpu = card.status, r.status
    it_gpu, it_cpu = card.iters, r.iters
    du = np.abs(r.u[:, :MMHE_T] - card.u[:, :MMHE_T]).max(axis=1)
    f_gpu, f_cpu = card.f, r.f
    rel_df = np.abs(f_gpu - f_cpu) / np.abs(f_cpu)
    same = it_gpu == it_cpu
    check((st_gpu == 0).all() and (st_cpu == 0).all(), "status 0 on card and CPU")
    check((np.abs(it_gpu - it_cpu) <= 1).all(), "iterations within one")
    check(bool(np.isfinite(m["g"]).all() and (m["g"] <= opts.gradTolerance).all()),
          f"card answers stationary on the CPU (max g {m['g'].max():.3e})")
    check(bool((m["eq"] <= opts.equalTolerance).all()),
          f"card answers feasible on the CPU (max |G| {m['eq'].max():.3e})")
    check(bool((m["min_F"] > 0).all() and (m["min_lam"] > 0).all()),
          "card answers strictly interior on the CPU")
    # gap = lam . F is a sum of nF positive float32 products, each
    # evaluation within (nF + 2) * 2^-24 of the exact value relative to it
    nF = card.lam.shape[1]
    gap_tol = opts.desiredDualityGap * (1 + 2 * (nF + 2) * 2.0**-24)
    check(bool((m["gap"] <= gap_tol).all()),
          f"card answers within the gap on the CPU (max {m['gap'].max():.6e})")
    check(bool((rel_df <= F_RTOL).all()), f"objective within {F_RTOL} relative")
    log(f"[cross-check2] {len(idx)} MPC-MHE instances on the CPU: status 0 on both; "
        f"iterations equal on {int(same.sum())}, one apart on {int((~same).sum())}; "
        f"the card's answers on the CPU: max g {m['g'].max():.3e} (tol "
        f"{opts.gradTolerance}), max |G| {m['eq'].max():.3e}, max gap "
        f"{m['gap'].max():.6e} (tol {opts.desiredDualityGap}); objective max rel "
        f"diff {rel_df.max():.3e}; max |duFuture| {du[same].max(initial=0):.3e} "
        f"at equal iterations, {du[~same].max(initial=0):.3e} one apart")


def sls_params(ns: str, data) -> dict:
    return {ns + "A": data["A"], ns + "b": data["b"]}


def per_iteration(launches: dict, iters: int, cuda: dict) -> str:
    """Launches per lockstep iteration (the last trip only runs the exit
    tests): each wrapper's calls, and in brackets the CUDA kernel launches
    they issued (``cuda``; a tiles-route factor launches once a panel)."""
    return " ".join(f"{DENSE_NAMES[k].split()[0]} {v / (iters - 1):.2f} "
                    f"({cuda[k] / (iters - 1):.2f} CUDA launches)"
                    for k, v in launches.items() if v)


def phase_sls_single(sls, dl, others):
    """The bench.py protocol through optimize(): a cold solve from
    default_data()["x0"], then a warm one from its optimum (mu0 = 1,
    max_iter = 30); the route of one solve is K8 then K7."""
    ns = "sls1_"
    solver = sls.build_constrained(ns=ns, dtype="float32")
    check(solver.device.type == "cuda", "the default device is the card")
    check((solver.nU, solver.nF, solver.nG) == (32, 64, 0), "sls sizes")
    check(solver.kkt_backend_resolved == "fleet" and solver._solve_raw.band_mode is None
          and solver._hoist == (True, True, False),
          "auto resolves to the fleet dense backend, dense branch, H and Fu hoisted")
    data = sls.default_data()
    params = sls_params(ns, data)
    solver.solve(params, init={ns + "x": data["x0"]}, mu0=1.0, max_iter=30)  # warm-up
    reset_counts(dl, *others)
    cold = solver.solve(params, init={ns + "x": data["x0"]}, mu0=1.0, max_iter=30)
    n_cold, c_cold = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
    reset_counts(dl, *others)
    warm = solver.solve(params, init={ns + "x": cold.variables[ns + "x"]}, mu0=1.0,
                        max_iter=30)
    n_warm, c_warm = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          "no banded kernel on the sls path")
    for name, sol, n, c in (("cold", cold, n_cold, c_cold), ("warm", warm, n_warm, c_warm)):
        check(sol.status == 0, f"{name} solve status {sol.describe()}")
        check(n["ldl_factor_solve"] > 0 and n["ldl_solve"] > 0
              and n["fleet_factor"] == n["fleet_solve"] == n["ldl_factor"] == 0,
              f"{name} solve through K8 and K7 alone: {n}")
        check(np.isfinite(sol.variables[ns + "x"]).all(), f"{name} x finite")
        log(f"[sls-single] {name}: status 0, {sol.iters} iterations, {sol.time:.4f} s, "
            f"J {float(sol.outputs['J']):.8f}; launches {n}; per iteration "
            f"{per_iteration(n, sol.iters, c)}")
    cpu = sls.build_constrained(ns=ns, dtype="float32", device="cpu")
    ref = cpu.solve(params, init={ns + "x": data["x0"]}, mu0=1.0, max_iter=30)
    dx = np.abs(ref.variables[ns + "x"] - cold.variables[ns + "x"]).max()
    dJ = abs(float(ref.outputs["J"]) - float(cold.outputs["J"])) / abs(float(ref.outputs["J"]))
    check(ref.status == 0 and abs(ref.iters - cold.iters) <= 1, "CPU cold solve agrees")
    check(dx <= U_ATOL and dJ <= J_RTOL, f"cold x within {U_ATOL} ({dx:.3e}), "
          f"J within {J_RTOL} ({dJ:.3e}) of the CPU solve")
    log(f"[sls-single] the CPU's cold solve: {ref.iters} iterations, max |dx| {dx:.3e}, "
        f"J rel diff {dJ:.3e}")
    return {k: n_cold[k] + n_warm[k] for k in n_cold}


def solve_sls_fleet(solver, ns, data, max_iter=60):
    res = solver.solve_many(sls_params(ns, data), inits={ns + "x": data["x0"]},
                            mu0=1.0, max_iter=max_iter)
    torch.cuda.synchronize()
    return res


def phase_sls_fleet(label, sls, dl, others, ns, B, n, seed, **opts):
    """A fleet of B sls instances with their own A and b; every instance
    at status 0.  Returns (solver, data, result, launches)."""
    solver = sls.build_constrained(n=n, ns=ns, dtype="float32", **opts)
    data = sls.fleet_inputs(B, n=n, seed=seed)
    solve_sls_fleet(solver, ns, data)  # warm-up (first-call allocations)
    reset_counts(dl, *others)
    t0 = time.perf_counter()
    res = solve_sls_fleet(solver, ns, data)
    wall = time.perf_counter() - t0
    launches, cuda = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          "no banded kernel on the sls path")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (B, n) and bool(torch.isfinite(res.u).all()), "finite x")
    check(int((status == 0).sum()) == B,
          f"all {B} instances at status 0 (got {np.bincount(status)})")
    log(f"[{label}] B={B} n={n} backend {solver.kkt_backend_resolved}: status 0 for "
        f"all; iterations max {iters.max()} mean {iters.mean():.2f}; wall {wall:.4f} s; "
        f"{B / wall:.1f} solves/s; launches {launches}; per lockstep iteration "
        f"{per_iteration(launches, int(iters.max()), cuda)}")
    return solver, data, res, launches


def sls_cpu(sub):
    """[sls-fleet-cross-check]'s CPU side: SLS_CHECKS of the sls fleet
    (``sub``: their data)."""
    from tenscalc_tpu_torch.examples import sls

    ns = "slsf_"
    cpu = sls.build_constrained(ns=ns, dtype="float32", device="cpu")
    return numpy_result(cpu.solve_many(sls_params(ns, sub), inits={ns + "x": sub["x0"]},
                                       mu0=1.0, max_iter=60))


def phase_sls_cross_check(out, res):
    """Eight of the sls fleet's instances against the port on the CPU
    (plain versions of K4/K5)."""
    r, _ = out
    card = numpy_result(res, SLS_CHECKS)
    st_c, st_g = r.status, card.status
    it_c, it_g = r.iters, card.iters
    dx = np.abs(r.u - card.u).max()
    dJ = (np.abs(r.f - card.f) / np.abs(r.f)).max()
    check((st_c == 0).all() and (st_g == 0).all(), "status 0 on card and CPU")
    check((np.abs(it_c - it_g) <= 1).all(), "iterations within one")
    check(dJ <= J_RTOL, f"J within {J_RTOL} relative (max {dJ:.3e})")
    check(dx <= U_ATOL, f"x within {U_ATOL} (max {dx:.3e})")
    log(f"[sls-fleet-cross-check] 8 instances on the CPU: status 0 on both; iterations "
        f"card {it_g.tolist()} cpu {it_c.tolist()}; max |dx| {dx:.3e}; J max rel diff "
        f"{dJ:.3e}")


def phase_sls_pallas(sls, dl, others):
    """kkt_backend='pallas': one solve and a fleet of 64, K6 at every
    factorization and K7 at every solve."""
    ns = "slsp_"
    solver = sls.build_constrained(ns=ns, dtype="float32", kkt_backend="pallas")
    check(solver.kkt_backend_resolved == "pallas", "pallas backend")
    data = sls.default_data()
    params = sls_params(ns, data)
    solver.solve(params, init={ns + "x": data["x0"]}, mu0=1.0, max_iter=30)  # warm-up
    reset_counts(dl, *others)
    sol = solver.solve(params, init={ns + "x": data["x0"]}, mu0=1.0, max_iter=30)
    n_one, c_one = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
    check(sol.status == 0, f"pallas single solve status {sol.describe()}")
    check(n_one["ldl_factor"] > 0 and n_one["ldl_solve"] > 0
          and n_one["fleet_factor"] == n_one["fleet_solve"] == n_one["ldl_factor_solve"] == 0,
          f"the pallas solve through K6 and K7 alone: {n_one}")
    log(f"[sls-pallas] single: status 0, {sol.iters} iterations, {sol.time:.4f} s; "
        f"launches {n_one}; per iteration {per_iteration(n_one, sol.iters, c_one)}")
    fleet = sls.fleet_inputs(64, seed=2)
    reset_counts(dl, *others)
    res = solve_sls_fleet(solver, ns, fleet)
    n_fleet, c_fleet = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(int((status == 0).sum()) == 64, f"all 64 at status 0 ({np.bincount(status)})")
    check(n_fleet["ldl_factor"] > 0 and n_fleet["ldl_solve"] > 0
          and n_fleet["ldl_factor_solve"] == n_fleet["fleet_factor"] == 0,
          f"the pallas fleet through K6 and K7 alone: {n_fleet}")
    log(f"[sls-pallas] fleet B=64: status 0 for all; iterations max {iters.max()} mean "
        f"{iters.mean():.2f}; launches {n_fleet}; per lockstep iteration "
        f"{per_iteration(n_fleet, int(iters.max()), c_fleet)}")
    return {k: n_one[k] + n_fleet[k] for k in n_one}


def build_minmax(ttc, ns: str, device=None, **options):
    """bench.py:809-865's saddle problem: a horizon-chain minimizer with a
    bilinear coupling to a strongly concave maximizer, both bounded;
    ``options`` go to minmax() (``kkt_backend``)."""
    u = ttc.variable(ns + "u", (MM_N,))
    d = ttc.variable(ns + "d", (MM_N,))
    p = ttc.parameter(ns + "p", (MM_N,))

    def sq(e):  # the reference's norm2: the sum of squares
        return (e * e).sum()

    f = sq(u - p) + 2.0 * sq(u[1:] - u[:-1]) + u @ d - sq(d)
    return ttc.minmax(
        objective=f, minOptimizationVariables=[u], maxOptimizationVariables=[d],
        minConstraints=[u >= -2.0, u <= 2.0], maxConstraints=[d >= -2.0, d <= 2.0],
        parameters=[p], dtype="float32", device=device, **options,
    )


def deconv_residual(tc, x, h, y, N: int, K: int):
    """h * x - y for a full convolution, sum_k h_k x_{j-k} for
    j = 0..N+K-2: x zero-padded by K - 1 on both sides and gathered into
    its (K, N + K - 1) matrix of shifts by one index, then h times it.
    The gather keeps the Hessian's pattern the band of H^T H
    (half-bandwidth K - 1) and the solver's hoisting certificates
    structural: no derivative reads x."""
    xp = tc.expr.vertcat(tc.Tzeros((K - 1,)), x, tc.Tzeros((K - 1,)))
    shifts = (K - 1 - np.arange(K))[:, None] + np.arange(N + K - 1)[None, :]
    return h @ xp[shifts] - y


def build_deconv(tc, N: int, K: int, ns: str, **options):
    """Non-negative, box-bounded deconvolution through a known K-tap FIR
    filter h: minimize 1/2 ||h * x - y||^2 s.t. 0 <= x <= 1, x in R^N,
    h (K,) and y (N + K - 1,) parameters, the tc.optimize defaults
    (condensed Newton matrix).  ``tc`` is the port (or, in the tests,
    the JAX package); ``options`` go to its ``optimize``."""
    h = tc.parameter(ns + "h", (K,))
    y = tc.parameter(ns + "y", (N + K - 1,))
    x = tc.variable(ns + "x", (N,))
    J = 0.5 * tc.norm2(deconv_residual(tc, x, h, y, N, K))
    return tc.optimize(objective=J, optimizationVariables=[x], constraints=[x >= 0, x <= 1],
                       parameters=[h, y], outputExpressions={"J": J, "x": x}, **options)


def build_deconv_game(tc, N: int, K: int, ns: str, **options):
    """The deconvolution as a two-player game: player 1 owns x_1..x_{N/2},
    player 2 the rest, both minimize the same 1/2 ||h * x - y||^2 under
    their own box.  A potential game: its equilibrium is
    :func:`build_deconv`'s minimizer."""
    h = tc.parameter(ns + "h", (K,))
    y = tc.parameter(ns + "y", (N + K - 1,))
    x1 = tc.variable(ns + "x1", (N // 2,))
    x2 = tc.variable(ns + "x2", (N - N // 2,))
    x = tc.expr.vertcat(x1, x2)
    J = 0.5 * tc.norm2(deconv_residual(tc, x, h, y, N, K))
    return tc.equilibrium(
        P1objective=J, P2objective=J, P1optimizationVariables=[x1],
        P2optimizationVariables=[x2], P1constraints=[x1 >= 0, x1 <= 1],
        P2constraints=[x2 >= 0, x2 <= 1], parameters=[h, y],
        outputExpressions={"J": J, "x": x}, **options)


def deconv_inputs(N: int, K: int, B: int, seed: int = 0):
    """A fleet's data: the filter h_k = exp(-k/20) normalized to sum 1
    (shared; H^T H has condition ~1e3), and per instance a sparse spike
    train x (3% of the samples, amplitudes 0.3..1) convolved with h plus
    N(0, 0.01^2) noise: y (B, N + K - 1); and x (B, N) itself."""
    rng = np.random.default_rng(seed)
    h = np.exp(-np.arange(K) / 20.0)
    h /= h.sum()
    x = np.where(rng.random((B, N)) < 0.03, rng.uniform(0.3, 1.0, (B, N)), 0.0)
    y = np.stack([np.convolve(xi, h) for xi in x]) + 0.01 * rng.standard_normal((B, N + K - 1))
    return h, y, x


def minmax_inputs(ns: str, B: int):
    """bench.py's inputs: p = 0.5 N(0, 1) from default_rng(0), zero inits."""
    rng = np.random.default_rng(0)
    return ({ns + "p": 0.5 * rng.standard_normal((B, MM_N))},
            {ns + "u": np.zeros((B, MM_N)), ns + "d": np.zeros((B, MM_N))})


def phase_minmax(ttc, fb, others):
    """The min-max fleet on the card: K1/K2 on the saddle KKT, K3 on the
    banded HessD inertia, no other kernel."""
    ns = "bmm_"
    t0 = time.perf_counter()
    solver = build_minmax(ttc, ns)
    log(f"[minmax] solver built in {time.perf_counter() - t0:.1f} s")
    check(solver.device.type == "cuda", "the default device is the card")
    check(solver._ipm_dims == (MM_N, MM_N, 2 * MM_N, 2 * MM_N, 0, 0), "min-max sizes")
    check(solver.kkt_backend_resolved == "fleet_banded"
          and solver._solve_raw.band_mode == "hoisted" and solver._solve_raw.hessd_banded
          and (solver.kkt_plan.n, solver.kkt_plan.bandwidth) == MM_SADDLE[1:]
          and (solver.hessd_plan.n, solver.hessd_plan.bandwidth) == MM_HESSD[1:],
          "fleet banded, hoisted band (480, w=6), banded HessD (240, w=1)")
    params, inits = minmax_inputs(ns, MM_B)

    def run():
        res = solver.solve_many(params, inits=inits, mu0=1.0, max_iter=60)
        torch.cuda.synchronize()
        return res

    run()  # warm-up (first-call allocations)
    reset_counts(fb, *others)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K4-K11 on the min-max path: {[m.LAUNCHES for m in others]}")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (MM_B, 2 * MM_N) and bool(torch.isfinite(res.u).all()),
          "finite z of the expected shape")
    check(int((status == 0).sum()) == MM_B,
          f"all {MM_B} instances at status 0 (got {np.bincount(status)})")
    check(launches["factor_solve"] > 0 and launches["solve"] > 0 and launches["factor"] > 0,
          f"K1, K2 and K3 ran on the min-max path: {launches}")
    check(launches["factor_solve"] == launches["solve"] == launches["factor"],
          f"one K1, one K2 and one K3 an adaptation trip: {launches}")
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    log(f"[minmax] fleet B={MM_B} n={MM_N} f32: status 0 for all; iters max {iters.max()} "
        f"mean {iters.mean():.2f}; wall {wall:.4f} s; {MM_B / wall:.1f} solves/s; launches "
        f"{launches}; per lockstep iteration K1 {launches['factor_solve'] / lockstep:.2f} "
        f"K2 {launches['solve'] / lockstep:.2f} K3 {launches['factor'] / lockstep:.2f}")

    one = {ns + "p": params[ns + "p"][0]}
    sol = solver.solve(one, init={k: v[0] for k, v in inits.items()}, mu0=1.0, max_iter=60)
    check(sol.status == 0, f"single solve status {sol.describe()}")
    du = np.abs(sol.variables[ns + "u"] - res.u[0, :MM_N].cpu().numpy()).max()
    check(du <= U_ATOL, f"the single solve is the fleet's instance 0 within {U_ATOL} ({du:.3e})")
    log(f"[minmax] single solve: status 0, {sol.iters} iters (the fleet's instance 0: "
        f"{iters[0]}), {sol.time:.4f} s, max |du| from instance 0 {du:.3e}")
    return solver, params, inits, res, launches


def minmax_cpu(params, inits):
    """[minmax-cross-check]'s CPU side: MM_CHECKS of the min-max fleet."""
    import tenscalc_tpu_torch as ttc

    cpu = build_minmax(ttc, "bmm_", device="cpu")
    return numpy_result(cpu.solve_many({k: v[MM_CHECKS] for k, v in params.items()},
                                       inits={k: v[MM_CHECKS] for k, v in inits.items()},
                                       mu0=1.0, max_iter=60))


def phase_minmax_cross_check(out, res):
    """Eight of the min-max fleet's instances against the port on the CPU
    (plain versions of K1-K3)."""
    r, _ = out
    card = numpy_result(res, MM_CHECKS)
    st_c, st_g = r.status, card.status
    it_c, it_g = r.iters, card.iters
    du = np.abs(r.u[:, :MM_N] - card.u[:, :MM_N]).max()
    df = (np.abs(r.f - card.f) / np.abs(r.f)).max()
    check((st_c == st_g).all(), "status equal on card and CPU")
    check((np.abs(it_c - it_g) <= 1).all(), "iterations within one")
    check(du <= U_ATOL, f"u within {U_ATOL} (max {du:.3e})")
    check(df <= F_RTOL, f"objective within {F_RTOL} relative (max {df:.3e})")
    log(f"[minmax-cross-check] 8 instances on the CPU: status equal; iterations card "
        f"{it_g.tolist()} cpu {it_c.tolist()}; max |du| {du:.3e}; objective max rel diff "
        f"{df:.3e}")


def phase_unicycle(tm, fb, others):
    """The nonlinear unicycle fleet (bench.py:669-741: B = 512, T = 40,
    float32, 'auto', mu0 = 0.1, max_iter = 200) on the card: the
    per-iteration band mode through K1/K2, the inertia read from K1's
    factor (no K3), no other kernel."""
    ns = "buni_"
    t0 = time.perf_counter()
    solver = tm.build_solver(T=UNI_T, ns=ns, dtype="float32")
    build = time.perf_counter() - t0
    plan = solver.kkt_plan
    check(solver.device.type == "cuda", "the default device is the card")
    check((solver.nU, solver.nG, solver.nF) == (239, 200, 78), "unicycle sizes")
    check(solver.kkt_backend_resolved == "fleet_banded"
          and solver._solve_raw.band_mode == "periter"
          and (plan.n, plan.bandwidth) == UNI_BAND[1:]
          and tuple(solver._hoist) == (False, True, False),
          "fleet banded, per-iteration band (439, w=9), hoist flags (H, Fu, Gu) = "
          "(False, True, False)")
    log(f"[unicycle] solver built in {build:.1f} s: nU {solver.nU} nG {solver.nG} "
        f"nF {solver.nF}; nK {plan.n}, RCM w {plan.bandwidth}; hoist (H, Fu, Gu) "
        f"{tuple(solver._hoist)}; band mode {solver._solve_raw.band_mode}; backend "
        f"{solver.kkt_backend_resolved}; K1-K3 launch plan "
        f"{fb.launch_plan(plan.n, plan.bandwidth, UNI_B, torch.cuda.get_device_properties(0).multi_processor_count)}")
    params, inits = tm.fleet_inputs(UNI_T, UNI_B, ns, seed=0)

    def run(max_iter=200):
        res = solver.solve_many(params, inits=inits, mu0=1e-1, max_iter=max_iter)
        torch.cuda.synchronize()
        return res

    run(max_iter=2)  # warm-up (first-call allocations)
    reset_counts(fb, *others)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K4-K11 on the unicycle path: {[m.LAUNCHES for m in others]}")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (UNI_B, solver.nU) and bool(torch.isfinite(res.u).all()),
          "finite u of the expected shape")
    n_ok = int((status == 0).sum())
    check(n_ok == UNI_B, f"all {UNI_B} instances at status 0 (got {np.bincount(status)})")
    check(launches["factor_solve"] > 0 and launches["solve"] > 0,
          f"K1 and K2 ran on the unicycle path: {launches}")
    check(launches["factor"] == 0, f"the inertia reads K1's factor, no K3: {launches}")
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    k1 = launches["factor_solve"]
    log(f"[unicycle] fleet B={UNI_B} T={UNI_T} f32: status 0 for {n_ok} of {UNI_B}; iters "
        f"max {iters.max()} mean {iters.mean():.2f}; warm solve wall {wall:.4f} s, "
        f"{UNI_B / wall:.1f} solves/s, host {1e3 * wall / lockstep:.1f} ms a lockstep "
        f"iteration ({card_line()}); launches {launches}; per lockstep iteration "
        f"K1 {k1 / lockstep:.2f} K2 {launches['solve'] / lockstep:.2f} "
        f"K3 {launches['factor'] / lockstep:.2f}; adaptation trips beyond one a lockstep "
        f"iteration: {k1 - lockstep}")
    return solver, params, inits, res, launches, wall, lockstep


# the unicycle's init moved by this much: a float32 solve on the CPU that
# then lands elsewhere (beyond U_ATOL) started on a rounding's edge
# between two local minima
UNI_NUDGE = 1e-6


def minimize_exit_metrics(solver, params, res):
    """The exit tests' metrics of a minimization fleet's result ``res``,
    evaluated again on ``solver``'s device from its final (u, nu, lam) and
    scales: stationarity of the scaled Lagrangian ``g``, equality ``eq``,
    ``gap`` = lam . s F, ``min_F`` (of s F) and ``min_lam``."""
    from torch.func import grad, vmap

    from tenscalc_tpu_torch.interop import params_from_numpy

    fns, dev, dt = solver._fns, solver.device, solver.opts.torch_dtype
    penv, shared, _ = params_from_numpy(solver, params, dev, dt)
    pdims = {k: (None if k in shared else 0) for k in penv}
    u, nu, lam, si, sc = (t.to(dev, dt) for t in (res.u, res.nu, res.lam, res.scale_ineq,
                                                    res.scale_cost))

    def lagr(uu, nn, ll, pe, s_i, s_c):
        return s_c * fns.f(uu, pe) - ll @ (s_i * fns.F(uu, pe)) + nn @ fns.G(uu, pe)

    g = vmap(grad(lagr), in_dims=(0, 0, 0, pdims, 0, 0))(u, nu, lam, penv, si, sc)
    Fs = si * vmap(fns.F, in_dims=(0, pdims))(u, penv)
    G = vmap(fns.G, in_dims=(0, pdims))(u, penv)
    return {"g": g.abs().amax(1), "eq": G.abs().amax(1), "gap": (lam * Fs).sum(1),
            "min_F": Fs.amin(1), "min_lam": lam.amin(1)}


def nonconvex_cpu(example, build_kw, idx, params, inits, card, max_iter):
    """The CPU side of the unicycle's and the pursuit's cross-checks: the
    port on the CPU (float32, the kernels' plain versions) solves
    instances ``idx`` from their inits and from the inits moved by
    UNI_NUDGE, in one fleet (an instance's iterates do not depend on the
    others in its fleet), and evaluates the exit tests' metrics of the
    card's answers ``card`` (numpy_result's).  Returns both results, the
    metrics and the solver's tolerances."""
    import importlib

    tm = importlib.import_module(f"tenscalc_tpu_torch.examples.{example}")
    cpu = tm.build_solver(**build_kw, dtype="float32", device="cpu")
    sub_p = {k: (v[idx] if np.ndim(v) == 3 else v) for k, v in params.items()}
    sub_i = {k: v[idx] for k, v in inits.items()}
    nudge = np.random.default_rng(1)
    sub_n = {k: v + UNI_NUDGE * nudge.standard_normal(v.shape) for k, v in sub_i.items()}
    both = cpu.solve_many(
        {k: (np.concatenate([v, v]) if np.ndim(v) == 3 else v) for k, v in sub_p.items()},
        inits={k: np.concatenate([sub_i[k], sub_n[k]]) for k in sub_i},
        mu0=1e-1, max_iter=max_iter)
    card = torch_result(card)
    m = (cpu.exit_metrics(sub_p, card) if hasattr(cpu, "exit_metrics")
         else minimize_exit_metrics(cpu, sub_p, card))
    o = cpu.opts
    return (numpy_result(both, np.arange(len(idx))),
            numpy_result(both, np.arange(len(idx), 2 * len(idx))),
            {k: v.numpy() for k, v in m.items()},
            SimpleNamespace(gradTolerance=o.gradTolerance, equalTolerance=o.equalTolerance,
                            desiredDualityGap=o.desiredDualityGap))


def phase_unicycle_cross_check(out, card):
    """NONCONVEX_CHECKS of the unicycle fleet's instances (``card``:
    numpy_result's) against the port on the CPU (float32, plain versions
    of K1/K2).

    The problem is nonconvex (the pursuer may turn either way) and some
    instances start on a rounding's edge between two local minima: the
    CPU alone, from an init moved by UNI_NUDGE, lands up to 4.0 away in u
    (the bounds are +-2).  So what is held of every instance is status 0
    on both sides and the card's answer passing the exit tests evaluated
    again on the CPU (stationarity, equality, gap, interior); an instance
    whose two CPU solves agree within U_ATOL is also held to u within
    U_ATOL and the objective within F_RTOL of the card; the others are
    printed."""
    (r, rn, m, opts), _ = out
    idx = UNI_CHECKS
    st_c, st_g = r.status, card.status
    it_c, it_g = r.iters, card.iters
    nu = UNI_T - 1  # u leads the packed primal vector
    u_c, u_n, u_g = r.u[:, :nu], rn.u[:, :nu], card.u[:, :nu]
    du = np.abs(u_c - u_g).max(axis=1)
    stable = np.abs(u_c - u_n).max(axis=1) <= U_ATOL
    f_c, f_g = r.f, card.f
    df = np.abs(f_c - f_g) / np.abs(f_c)
    check((st_c == 0).all() and (st_g == 0).all() and (rn.status == 0).all(),
          f"status 0 on card and CPU ({st_g}, {st_c}, nudged {rn.status})")
    check(bool(np.isfinite(m["g"]).all() and (m["g"] <= opts.gradTolerance).all()),
          f"card answers stationary on the CPU (max g {m['g'].max():.3e})")
    check(bool((m["eq"] <= opts.equalTolerance).all()),
          f"card answers feasible on the CPU (max |G| {m['eq'].max():.3e})")
    check(bool((m["min_F"] >= -1e-6).all() and (m["min_lam"] > 0).all()),
          "card answers inside the bounds with positive multipliers on the CPU")
    # gap = lam . sF is a sum of nF positive float32 products, each
    # evaluation within (nF + 2) * 2^-24 of the exact value relative to it
    nF = card.lam.shape[1]
    gap_tol = opts.desiredDualityGap * (1 + 2 * (nF + 2) * 2.0**-24)
    check(bool((m["gap"] <= gap_tol).all()),
          f"card answers within the gap on the CPU (max {m['gap'].max():.6e})")
    check(bool((du[stable] <= U_ATOL).all()),
          f"u within {U_ATOL} where the CPU's own solves agree ({du[stable]})")
    check(bool((df[stable] <= F_RTOL).all()),
          f"objective within {F_RTOL} relative where the CPU's own solves agree "
          f"({df[stable]})")
    log(f"[unicycle-cross-check] {len(idx)} instances on the CPU: status 0 on both; "
        f"iterations card "
        f"{it_g.tolist()} cpu {it_c.tolist()} (init moved by {UNI_NUDGE}: "
        f"{rn.iters.tolist()}); the card's answers on the CPU: max g "
        f"{m['g'].max():.3e} (tol {opts.gradTolerance}), max |G| {m['eq'].max():.3e}, max gap "
        f"{m['gap'].max():.6e} (tol {opts.desiredDualityGap}); the CPU's two solves agree on "
        f"{int(stable.sum())} of {len(idx)}: there max |du| {du[stable].max(initial=0):.3e}, "
        f"objective "
        f"max rel diff {df[stable].max(initial=0):.3e}; on the others max |du| "
        f"{du[~stable].max(initial=0):.3e} (the nudged CPU solve "
        f"{np.abs(u_c - u_n).max(axis=1)[~stable].round(4).tolist()}), objectives card "
        f"{f_g[~stable].round(5).tolist()} cpu {f_c[~stable].round(5).tolist()}")


def phase_pursuit(tm, lu, others):
    """The nonlinear MPC-MHE pursuit fleet (examples/mpcmhe_unicycle,
    B = 512, T = 20, L = 10, float32, 'auto', mu0 = 0.1, max_iter = 300)
    on the card: its KKT (nK = 585, RCM w = 22) assembled densely at every
    iterate (band mode None) and factored by K9/K10 alone."""
    ns = "pur_"
    t0 = time.perf_counter()
    solver = tm.build_solver(T=PUR_T, L=PUR_L, ns=ns, dtype="float32")
    build = time.perf_counter() - t0
    plan = solver.kkt_plan
    check(solver.device.type == "cuda", "the default device is the card")
    check(solver.kkt_backend_resolved == "fleet_banded_lu"
          and solver._solve_raw.band_mode is None
          and (plan.n, plan.bandwidth) == PURSUIT_BAND[1:],
          "fleet banded LU, no band mode, n=585, w=22")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[pursuit] solver built in {build:.1f} s: dims {solver._ipm_dims}; nK {plan.n}, RCM "
        f"w {plan.bandwidth}; band mode {solver._solve_raw.band_mode}; backend "
        f"{solver.kkt_backend_resolved}; certificates hoist_S "
        f"{solver.certificates['hoist_S']} hoist_Gz {solver.certificates['hoist_Gz']} "
        f"hoist_Fz {solver.certificates['hoist_Fz']}; K9/K10 launch plan "
        f"{lu.launch_plan(plan.n, plan.bandwidth, PUR_B, sms)}")
    params, inits = tm.fleet_inputs(PUR_T, PUR_L, PUR_B, ns, seed=0)

    def run(max_iter=300):
        res = solver.solve_many(params, inits=inits, mu0=1e-1, max_iter=max_iter)
        torch.cuda.synchronize()
        return res

    run(max_iter=2)  # warm-up (first-call allocations)
    reset_counts(lu, *others)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(lu.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K1-K8 on the pursuit path: {[m.LAUNCHES for m in others]}")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (PUR_B, sum(solver._ipm_dims[:3]))
          and bool(torch.isfinite(res.u).all()), "finite z of the expected shape")
    n_ok = int((status == 0).sum())
    check(n_ok == PUR_B, f"all {PUR_B} instances at status 0 (got {np.bincount(status)})")
    check(launches["lu_factor_solve"] > 0 and launches["lu_solve"] > 0
          and launches["lu_factor"] == 0, f"K9 and K10 alone on the pursuit path: {launches}")
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    k9 = launches["lu_factor_solve"]
    log(f"[pursuit] fleet B={PUR_B} T={PUR_T} L={PUR_L} f32: status 0 for {n_ok} of {PUR_B}; "
        f"iters max {iters.max()} mean {iters.mean():.2f}; warm solve wall {wall:.4f} s, "
        f"{PUR_B / wall:.1f} solves/s, host {1e3 * wall / lockstep:.1f} ms a lockstep "
        f"iteration ({card_line()}); launches {launches}; per lockstep iteration K9 "
        f"{k9 / lockstep:.2f} K10 {launches['lu_solve'] / lockstep:.2f} K11 "
        f"{launches['lu_factor'] / lockstep:.2f}; K10 a direction {launches['lu_solve'] / k9:.2f}; "
        f"adaptation trips beyond one a lockstep iteration: {k9 - lockstep}")
    return solver, params, inits, res, launches, wall, lockstep


def phase_pursuit_cross_check(out, card):
    """NONCONVEX_CHECKS of the pursuit fleet's instances (``card``:
    numpy_result's) against the port on the CPU (float32, plain versions
    of K9/K10).

    The card's answers must pass the exit tests evaluated again on the CPU
    (stationarity, equality, gap, interior), at the same status and within
    one iteration; the game is nonconvex, so uFuture (within U_ATOL) and
    the objective J (within F_RTOL relative) are held where the CPU's own
    solves from the init and from the init moved by UNI_NUDGE agree
    (the unicycle's rule); the others are printed."""
    (r, rn, m, opts), _ = out
    idx = PUR_CHECKS
    st_c, st_g = r.status, card.status
    it_c, it_g = r.iters, card.iters
    u_c, u_n, u_g = (x[:, :PUR_T] for x in (r.u, rn.u, card.u))
    du = np.abs(u_c - u_g).max(axis=1)
    stable = np.abs(u_c - u_n).max(axis=1) <= U_ATOL
    f_c, f_g = r.f, card.f
    df = np.abs(f_c - f_g) / np.abs(f_c)
    check((st_g == st_c).all() and (st_g == 0).all(),
          f"status 0 on card and CPU ({st_g}, {st_c})")
    check((np.abs(it_g - it_c) <= 1).all(), f"iterations within one ({it_g}, {it_c})")
    check(bool(np.isfinite(m["g"]).all() and (m["g"] <= opts.gradTolerance).all()),
          f"card answers stationary on the CPU (max g {m['g'].max():.3e})")
    check(bool((m["eq"] <= opts.equalTolerance).all()),
          f"card answers feasible on the CPU (max |G| {m['eq'].max():.3e})")
    check(bool((m["min_F"] > 0).all() and (m["min_lam"] > 0).all()),
          "card answers strictly interior on the CPU")
    # gap = lam . F is a sum of nF positive float32 products, each
    # evaluation within (nF + 2) * 2^-24 of the exact value relative to it
    nF = card.lam.shape[1]
    gap_tol = opts.desiredDualityGap * (1 + 2 * (nF + 2) * 2.0**-24)
    check(bool((m["gap"] <= gap_tol).all()),
          f"card answers within the gap on the CPU (max {m['gap'].max():.6e})")
    check(bool((du[stable] <= U_ATOL).all()),
          f"uFuture within {U_ATOL} where the CPU's own solves agree ({du[stable]})")
    check(bool((df[stable] <= F_RTOL).all()),
          f"J within {F_RTOL} relative where the CPU's own solves agree ({df[stable]})")
    log(f"[pursuit-cross-check] {len(idx)} instances on the CPU: status 0 on both; "
        f"iterations card "
        f"{it_g.tolist()} cpu {it_c.tolist()} (init moved by {UNI_NUDGE}: "
        f"{rn.iters.tolist()}); the card's answers on the CPU: max g "
        f"{m['g'].max():.3e} (tol {opts.gradTolerance}), max |G| {m['eq'].max():.3e}, max gap "
        f"{m['gap'].max():.6e} (tol {opts.desiredDualityGap}); the CPU's two solves agree on "
        f"{int(stable.sum())} of {len(idx)}: there max |duFuture| "
        f"{du[stable].max(initial=0):.3e}, J "
        f"max rel diff {df[stable].max(initial=0):.3e}; on the others max |duFuture| "
        f"{du[~stable].max(initial=0):.3e}, J card {f_g[~stable].round(5).tolist()} cpu "
        f"{f_c[~stable].round(5).tolist()}")


def phase_quadcopter(tq, fb, others):
    """The quadcopter fleet (examples/mpc_quadcopter at T = 20 with the
    large Newton matrix, B = 512, float32, 'auto', mu0 = 0.1, max_iter =
    300, each instance its own target) on the card: its KKT (nK = 286,
    RCM w = 30) assembled densely at every iterate (band mode None) and
    factored by K1/K2 on the wide route.  The reference converges on this
    configuration only for some instances and iterations vary with the
    rounding, so the converged share is reported, not required."""
    ns = "bquad_"
    t0 = time.perf_counter()
    solver = tq.build_solver(T=QUAD_T, ns=ns, dtype="float32", smallerNewtonMatrix=False)
    build = time.perf_counter() - t0
    plan = solver.kkt_plan
    check(solver.device.type == "cuda", "the default device is the card")
    check(solver.kkt_backend_resolved == "fleet_banded"
          and solver._solve_raw.band_mode is None
          and (plan.n, plan.bandwidth) == QUAD_BAND[1:],
          f"fleet banded, no band mode, n={QUAD_BAND[1]}, w={QUAD_BAND[2]}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[quadcopter] solver built in {build:.1f} s: nU {solver.nU} nG {solver.nG} nF "
        f"{solver.nF}; nK {plan.n}, RCM w {plan.bandwidth}; band mode "
        f"{solver._solve_raw.band_mode}; backend {solver.kkt_backend_resolved}; hoist (H, Fu, "
        f"Gu) {tuple(solver._hoist)}; K1/K2 launch plan "
        f"{fb.launch_plan(plan.n, plan.bandwidth, QUAD_B, sms)}")
    params, inits = tq.fleet_inputs(QUAD_T, QUAD_B, ns, seed=0)

    def run(max_iter=300):
        res = solver.solve_many(params, inits=inits, mu0=1e-1, max_iter=max_iter)
        torch.cuda.synchronize()
        return res

    run(max_iter=2)  # warm-up (first-call allocations)
    reset_counts(fb, *others)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K4-K11 on the quadcopter path: {[m.LAUNCHES for m in others]}")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (QUAD_B, solver.nU) and bool(torch.isfinite(res.u).all()),
          "finite u of the expected shape")
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    check(launches["factor_solve"] >= lockstep > 0 and launches["solve"] > 0,
          f"K1 and K2 at least once a lockstep iteration: {launches}")
    n_ok = int((status == 0).sum())
    ok = status == 0
    k1 = launches["factor_solve"]
    log(f"[quadcopter] fleet B={QUAD_B} T={QUAD_T} f32: status 0 for {n_ok} of {QUAD_B} "
        f"(converged share {n_ok / QUAD_B:.4f}; statuses {dict(zip(*np.unique(status, return_counts=True)))}); "
        f"iters max {iters.max()} mean {iters.mean():.2f} (converged: max "
        f"{iters[ok].max(initial=0)} mean {iters[ok].mean() if ok.any() else 0:.2f}); warm "
        f"solve wall {wall:.4f} s, {QUAD_B / wall:.1f} solves/s, host {1e3 * wall / lockstep:.1f} "
        f"ms a lockstep iteration ({card_line()}); launches {launches}; per lockstep "
        f"iteration K1 {k1 / lockstep:.2f} K2 {launches['solve'] / lockstep:.2f} K3 "
        f"{launches['factor'] / lockstep:.2f}; adaptation trips beyond one a lockstep "
        f"iteration: {k1 - lockstep}")
    log(f"[quadcopter] the first 32 instances off status 0: "
        f"{np.flatnonzero(~ok)[:32].tolist()}")
    return solver, params, inits, res, launches, wall, lockstep


def quadcopter_cpu(sub_p, inits, card):
    """The quadcopter cross-check's CPU side: the port on the CPU
    (float32, plain versions of K1/K2) solves the instances from each of
    ``inits`` in one fleet, and evaluates the exit tests' metrics of the
    card's answers ``card`` (numpy_result's).  Returns numpy arrays and
    the tolerances."""
    from tenscalc_tpu_torch.examples import mpc_quadcopter as tq

    torch.set_num_threads(2)
    cpu = tq.build_solver(T=QUAD_T, ns="bquad_", dtype="float32", device="cpu",
                          smallerNewtonMatrix=False)
    k = len(inits)
    t0 = time.perf_counter()
    r = cpu.solve_many(
        {n: (np.concatenate([v] * k) if np.ndim(v) == 3 else v) for n, v in sub_p.items()},
        inits={n: np.concatenate([i[n] for i in inits]) for n in inits[0]},
        mu0=1e-1, max_iter=300)
    seconds = time.perf_counter() - t0
    m = minimize_exit_metrics(cpu, sub_p, torch_result(card))
    o = cpu.opts
    return {"status": r.status.numpy().reshape(k, -1), "iters": r.iters.numpy().reshape(k, -1),
            "u": r.u.numpy().reshape(k, -1, cpu.nU), "f": r.f.numpy().reshape(k, -1),
            "seconds": seconds, "nF": cpu.nF, "tol": (o.gradTolerance, o.equalTolerance,
                                                      o.desiredDualityGap),
            **{"m_" + n: v.numpy() for n, v in m.items()}}


def start_quadcopter_cross_check(params, inits, res):
    """Start the CPU side of the quadcopter cross-check on NONCONVEX_CHECKS
    of the fleet's instances (evenly spaced), from their inits and from two draws
    of them moved by UNI_NUDGE; returns what
    finish_quadcopter_cross_check needs."""
    idx = np.arange(0, QUAD_B, QUAD_B // NONCONVEX_CHECKS)
    sub_p = {k: (v[idx] if np.ndim(v) == 3 else v) for k, v in params.items()}
    sub_i = {k: v[idx] for k, v in inits.items()}
    nudge = np.random.default_rng(1)
    moved = [{k: v + UNI_NUDGE * nudge.standard_normal(v.shape) for k, v in sub_i.items()}
             for _ in range(2)]
    card = numpy_result(res, idx)
    return start_cpu_side(quadcopter_cpu, sub_p, [sub_i, *moved], card), card


def finish_quadcopter_cross_check(side, card):
    """The quadcopter cross-check, the CPU side collected.

    The problem is nonconvex (the thrust magnitude's square root) and its
    KKT's factor has pivots that the clamp decides, so a last-bit change
    can move an instance's path, even to the iteration limit: the JAX
    package alone, from one init moved by 1e-6, ends in 42-86 iterations
    or at the limit (T = 6, float32).  So every converged card answer is
    held to the exit tests evaluated again on the CPU; and where the CPU's
    three solves (the init and two draws moved by UNI_NUDGE) agree (the
    same status, iterations within one, p and u within U_ATOL), the card
    is held to their status, iterations within one, p and u within
    U_ATOL and J within F_RTOL relative; the others are printed."""
    out, _ = collect_cpu_side(side)
    st, it, u, f = out["status"], out["iters"], out["u"], out["f"]
    st_g, it_g, f_g = card.status, card.iters, card.f
    pu = 6 * QUAD_T  # p then u lead the packed primal vector (3 T each)
    x = u[:, :, :pu]
    x_g = card.u[:, :pu]
    stable = ((st == st[0]).all(0) & (np.abs(it - it[0]) <= 1).all(0)
              & (np.abs(x - x[0]).max(axis=2) <= U_ATOL).all(0))
    dx = np.abs(x[0] - x_g).max(axis=1)
    df = np.abs(f[0] - f_g) / np.abs(f[0])
    g_tol, eq_tol, gap = out["tol"]
    conv = st_g == 0
    m = {k[2:]: v for k, v in out.items() if k.startswith("m_")}
    check(bool(np.isfinite(m["g"][conv]).all() and (m["g"][conv] <= g_tol).all()),
          f"converged card answers stationary on the CPU (g {m['g'][conv]})")
    check(bool((m["eq"][conv] <= eq_tol).all()),
          f"converged card answers feasible on the CPU (|G| {m['eq'][conv]})")
    check(bool((m["min_F"][conv] >= -1e-6).all() and (m["min_lam"][conv] > 0).all()),
          "converged card answers inside the bounds with positive multipliers on the CPU")
    gap_tol = gap * (1 + 2 * (out["nF"] + 2) * 2.0**-24)
    check(bool((m["gap"][conv] <= gap_tol).all()),
          f"converged card answers within the gap on the CPU ({m['gap'][conv]})")
    check((st_g == st[0])[stable].all(),
          f"the same status where the CPU's solves agree ({st_g}, {st[0]}, {stable})")
    check((np.abs(it_g - it[0]) <= 1)[stable].all(),
          f"iterations within one where the CPU's solves agree ({it_g}, {it[0]})")
    check(bool((dx[stable] <= U_ATOL).all()),
          f"p and u within {U_ATOL} where the CPU's solves agree ({dx[stable]})")
    check(bool((df[stable] <= F_RTOL).all()),
          f"J within {F_RTOL} relative where the CPU's solves agree ({df[stable]})")
    log(f"[quadcopter-cross-check] {len(st_g)} instances (every {QUAD_B // len(st_g)}th) on "
        f"the CPU in {out['seconds']:.1f} s "
        f"beside the other phases: status card {st_g.tolist()} cpu {st.tolist()} (the init, "
        f"then moved by {UNI_NUDGE} twice); iterations card {it_g.tolist()} cpu {it.tolist()}; "
        f"status equal on {int((st_g == st[0]).sum())} of {len(st_g)}; the CPU's three solves "
        f"agree on {int(stable.sum())} of {len(st_g)}: there max |d(p, u)| "
        f"{dx[stable].max(initial=0):.3e}, J max "
        f"rel diff {df[stable].max(initial=0):.3e}; the {int(conv.sum())} converged card "
        f"answers on the CPU: max g {m['g'][conv].max(initial=0):.3e} (tol {g_tol}), max |G| "
        f"{m['eq'][conv].max(initial=0):.3e}, max gap {m['gap'][conv].max(initial=0):.6e} (tol "
        f"{gap}); elsewhere max |d(p, u)| {dx[~stable].max(initial=0):.3e}, J card "
        f"{f_g[~stable].round(5).tolist()} cpu {f[0][~stable].round(5).tolist()}")

def flops_launch_check(rows, n_launch, others, where):
    """K8 and K7 alone up to 896 KKT rows, no kernel above."""
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"{where}: no banded kernel")
    if rows <= 896:
        check(n_launch["ldl_factor_solve"] > 0 and n_launch["ldl_solve"] > 0
              and n_launch["fleet_factor"] == n_launch["fleet_solve"]
              == n_launch["ldl_factor"] == 0, f"{where}: through K8 and K7 alone: {n_launch}")
    else:
        check(not any(n_launch.values()), f"{where}: no K4-K8 above 896 rows: {n_launch}")


def phase_flops(flops, dl, others):
    """bench.py's flops curve (bench.py:472-556) through optimize() in
    float32 under 'auto': u0 = 0, mu0 = 1, max_iter = 60; per size the
    build time, a warm solve with the launches read around it, and a
    max_iter = 1 solve.  Returns the launches summed over the sizes and
    the N = 300 solver."""
    total = {k: 0 for k in dl.LAUNCHES}
    keep = None
    for N in FLOPS_SIZES:
        t0 = time.perf_counter()
        solver, ns = flops.build_solver(N, ns=f"bfl{N}_", dtype="float32")
        build = time.perf_counter() - t0
        check((solver.nU, solver.nF, solver.nG) == (N, 0, N // 2), f"flops N={N} sizes")
        check(solver.kkt_backend_resolved == "fleet" and solver.kkt_plan is None,
              f"flops N={N}: auto resolves to the fleet dense backend")
        params, init = flops.default_data(N, ns)
        solver.solve(params, init=init, mu0=1.0, max_iter=60)  # warm-up
        reset_counts(dl, *others)
        sol = solver.solve(params, init=init, mu0=1.0, max_iter=60)
        n, c = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
        check(sol.status == 0, f"flops N={N}: {sol.describe()}")
        check(np.isfinite(sol.variables[ns + "x"]).all(), f"flops N={N}: finite x")
        flops_launch_check(3 * N // 2, n, others, f"flops N={N}")
        one = solver.solve(params, init=init, mu0=1.0, max_iter=1)
        check(one.status & 8 and one.iters == 2, f"flops N={N} max_iter=1: status {one.status}")
        for k in total:
            total[k] += n[k]
        route = ("K8/K7" if 3 * N // 2 <= 896 else "blocked LDL^T, no kernel")
        log(f"[flops] N={N} (KKT {3 * N // 2} rows, {route}): build {build:.2f} s; status 0, "
            f"{sol.iters} iterations; warm solve {sol.time:.4f} s; max_iter=1 solve "
            f"{one.time:.4f} s; J {float(sol.outputs['J']):.6f}; launches {n}; per iteration "
            f"{per_iteration(n, sol.iters, c) or 'none'}")
        if N == 300:
            keep = (solver, params, init)
        del solver
    return total, keep


def phase_flops_backends(flops, dl, others):
    """flops N = 300 on kkt_backend='dense' (pivoted LU) and 'ldl' (the
    blocked LDL^T): plain PyTorch, no kernel of ours."""
    N = 300
    for backend in ("dense", "ldl"):
        solver, ns = flops.build_solver(N, ns=f"bfd{backend}_", dtype="float32",
                                        kkt_backend=backend)
        check(solver.kkt_backend_resolved == backend, f"{backend} backend")
        params, init = flops.default_data(N, ns)
        solver.solve(params, init=init, mu0=1.0, max_iter=60)  # warm-up
        reset_counts(dl, *others)
        sol = solver.solve(params, init=init, mu0=1.0, max_iter=60)
        check(sol.status == 0, f"flops N={N} on '{backend}': {sol.describe()}")
        check(not any(v for m in (dl, *others) for v in m.LAUNCHES.values()),
              f"no K1-K11 on '{backend}'")
        log(f"[flops-backends] N={N} kkt_backend='{backend}': status 0, {sol.iters} "
            f"iterations, warm solve {sol.time:.4f} s, no kernel launch")


def phase_flops_cross_check(flops):
    """N = 100 and 1000 solved again by the port on the CPU."""
    for N in (100, 1000):
        card, ns = flops.build_solver(N, ns=f"bfl{N}_", dtype="float32")
        cpu, _ = flops.build_solver(N, ns=f"bfl{N}_", dtype="float32", device="cpu")
        params, init = flops.default_data(N, ns)
        a = card.solve(params, init=init, mu0=1.0, max_iter=60)
        r = cpu.solve(params, init=init, mu0=1.0, max_iter=60)
        dx = np.abs(a.variables[ns + "x"] - r.variables[ns + "x"]).max()
        dJ = abs(float(a.outputs["J"]) - float(r.outputs["J"])) / abs(float(r.outputs["J"]))
        check(a.status == r.status and abs(a.iters - r.iters) <= 1,
              f"flops N={N}: card status {a.status} ({a.iters} it), CPU {r.status} ({r.iters})")
        check(dx <= U_ATOL and dJ <= J_RTOL,
              f"flops N={N}: x within {U_ATOL} ({dx:.3e}), J within {J_RTOL} ({dJ:.3e})")
        log(f"[flops-cross-check] N={N} on the CPU: status {r.status} on both, iterations "
            f"card {a.iters} cpu {r.iters}, max |dx| {dx:.3e}, J rel diff {dJ:.3e}")


def phase_mls(mls, dl, others):
    """bench.py's bench_mls rows (N = 100, n = 8; x0 = 0.02 rand, mu0 = 1,
    max_iter = 20): min ||A x - b||^2 / N without and with 0 <= x <= 0.05,
    built by examples/mls.py at k = 1 (bench.py builds them with sls's
    vector builders: the same problems, the same iterations, 2 and 7)."""
    total = {k: 0 for k in dl.LAUNCHES}
    for row, constrained, ns, want in (("unconstrained", False, "bmlu_", 2),
                                       ("constrained", True, "bmlc_", 7)):
        solver = mls.build_solver(N=100, n=8, k=1, constrained=constrained, ns=ns,
                                  dtype="float32")
        params, init = mls.bench_inputs(ns=ns)
        solver.solve(params, init=init, mu0=1.0, max_iter=20)  # warm-up
        reset_counts(dl, *others)
        sol = solver.solve(params, init=init, mu0=1.0, max_iter=20)
        n_l, c_l = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
        check(sol.status == 0 and sol.iters == want,
              f"mls {row}: {sol.describe()}, {sol.iters} iterations (want {want})")
        check(n_l["ldl_factor_solve"] > 0 and not any(v for m in others
                                                    for v in m.LAUNCHES.values()),
              f"mls {row} through K8: {n_l}")
        for k in total:
            total[k] += n_l[k]
        log(f"[mls] {row} (examples/mls.py at k = 1; nF={solver.nF}, KKT "
            f"{solver.nU + solver.nG} rows): status 0, {sol.iters} iterations, "
            f"{sol.time:.4f} s; launches {n_l}; per iteration "
            f"{per_iteration(n_l, sol.iters, c_l)}")
    return total


def phase_slseq(slseq, dl, others):
    """The reference's slseq (N = 10000, n = 800, m = 40, float32 'auto'):
    K8 at n = 840, held to the float64 KKT oracle and to the port on the
    CPU.  Returns the launches, the solver and its inputs."""
    N, n, m = SLSEQ
    t0 = time.perf_counter()
    solver = slseq.build_solver(N, n, m, dtype="float32")
    build = time.perf_counter() - t0
    check(solver.nU + solver.nG == 840 and solver.nF == 0
          and solver.kkt_backend_resolved == "fleet", "slseq: 840 KKT rows on the fleet backend")
    A, b, C, d = slseq.default_data(N, n, m)
    params = {"slq_A": A, "slq_b": b, "slq_C": C, "slq_d": d}
    init = {"slq_x": 0.01 * np.random.default_rng(1).random(n)}
    solver.solve(params, init=init, mu0=1.0, max_iter=60)  # warm-up
    reset_counts(dl, *others)
    sol = solver.solve(params, init=init, mu0=1.0, max_iter=60)
    n_l, c_l = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
    check(sol.status == 0, f"slseq: {sol.describe()}")
    flops_launch_check(n + m, n_l, others, "slseq")
    x = sol.outputs["x"]
    xref = slseq.kkt_oracle(A, b, C, d)
    ex = np.abs(x - xref).max()
    eq = np.abs(C @ x - d).max()
    # the port on the CPU in float32 lands 8.7e-6 from the oracle (|x| up
    # to 0.049), its equality residual 1.1e-7
    check(ex <= SLSEQ_ATOL and eq <= 1e-4,
          f"slseq: x within {SLSEQ_ATOL} of the float64 oracle ({ex:.3e}), |Cx - d| {eq:.3e}")
    cpu = slseq.build_solver(N, n, m, dtype="float32", device="cpu")
    r = cpu.solve(params, init=init, mu0=1.0, max_iter=60)
    dx = np.abs(r.outputs["x"] - x).max()
    dJ = abs(float(r.outputs["J"]) - float(sol.outputs["J"])) / abs(float(r.outputs["J"]))
    check(r.status == 0 and abs(r.iters - sol.iters) <= 1 and dx <= U_ATOL and dJ <= J_RTOL,
          f"slseq on the CPU: status {r.status}, {r.iters} it, |dx| {dx:.3e}, dJ {dJ:.3e}")
    log(f"[slseq] N={N} n={n} m={m}: build {build:.2f} s; status 0, {sol.iters} iterations, "
        f"warm solve {sol.time:.4f} s; launches {n_l}; per iteration "
        f"{per_iteration(n_l, sol.iters, c_l)}; max |x - oracle| {ex:.3e}, |Cx - d| {eq:.3e}; "
        f"the CPU: {r.iters} iterations, max |dx| {dx:.3e}, J rel diff {dJ:.3e}")
    return n_l, solver, params, init


# ---------------------------------------------------------------------------
# slice 19: the apps and the rest of the examples
# ---------------------------------------------------------------------------

# bench.py's l1l2 row (examples/l1l2estimation, N = 200, f32): nU = 996,
# nF = 796, the condensed KKT's RCM band w = 10, K1/K2 on the lane route;
# its fleet (the scenario sweep of PERF.md §1): B estimations, instance i
# from make_data(N, seed=i)
L12_N, L12_B, L12_W = 200, 1024, 10
L12_CHECKS = np.arange(0, L12_B, L12_B // 8)
L12_BAND = (L12_B, 996, L12_W)
L12_POS_ATOL = 2e-3  # the reference's float32 cross-backend tolerance
# the fleet's cross-check: with bench.py's gradTolerance of 0.2 an f32
# solve stops anywhere in a tolerance ball whose positions span more
# than 2e-3 on this ill-conditioned problem: an instance's card and CPU
# positions part by 6.5e-3 at J equal to 5.2e-7 relative (measured on
# one H100), so the fleet's positions are held to 1e-2 and J to F_RTOL
L12_FLEET_POS_ATOL = 1e-2
L12_ERR_BOUND = 0.6  # tests/test_f32_robustness.py's bound on |position - truth|
# [lasso]: one fit at 200 features x 2000 points in f32 (nK = 401: K8/K7
# on the tiles route); this fit's f32 gradient floor is 2.1e-4 .. 2.7e-4
# (the port on the CPU), above the default gradTolerance of 1e-4
LASSO_F, LASSO_P, LASSO_GRAD_TOL = 200, 2000, 1e-3
# [apps]: the Mpc app's closed loop (tests/test_apps.py:52), mpc_lti's,
# run_fleet(B, T, n_steps), the Mpcmhe app at the DC-motor MPC-MHE size
# and tests/test_apps.py:323's Sysid, each in float64 against the port on
# the CPU; closed-loop states and controls within APP_ATOL (a control
# pinned at its bound follows the last bits of the final barrier
# parameter: 3.2e-6 between the port and the JAX package on the CPU);
# mpc_fleet's first period's controls within U_ATOL (a per-instance plant
# can take a different second step on the last bits of the first: 2.4e-4
# between the two packages on the CPU), its whole loop within
# APP_FLEET_ATOL: each period's solves stop inside their exit tolerances,
# on the card and the CPU up to 8.7e-3 apart in u, and the loop carries
# each period's difference into the next state (measured on one H100)
APP_FLEET = (64, 20, 20)
APP_FLEET_ATOL = 1e-2
MMAPP_T, MMAPP_L = 12, 16
APP_ATOL = 1e-5
SYSID_RTOL = 1e-8


def phase_l1l2(l12, fb, others):
    """bench.py's l1l2 row (bench.py:405-469) on the card through
    optimize(): N = 200, f32, gradTolerance 0.2, desiredDualityGap 5e-3,
    mu0 = 1, max_iter = 60, from bench.py's inits; its plan, status,
    iterations, K1/K2 launches a lockstep iteration (no K3, no other
    kernel), the warm solve's wall time (median of 10) and the mean
    position error against the true trajectory."""
    ns = "bl12_"
    t0 = time.perf_counter()
    solver = l12.build_l1l2(N=L12_N, ns=ns, **l12.BENCH_OPTIONS)
    build = time.perf_counter() - t0
    plan = solver.kkt_plan
    check(solver.device.type == "cuda", "the default device is the card")
    check((solver.nU, solver.nF, solver.nG) == (996, 796, 0),
          f"l1l2 sizes {(solver.nU, solver.nF, solver.nG)}")
    check(solver.kkt_backend_resolved == "fleet_banded"
          and solver._solve_raw.band_mode == "hoisted"
          and (plan.n, plan.bandwidth) == (996, L12_W) and fb.route(L12_W) == "lane",
          f"fleet banded, hoisted band (996, w={L12_W}) on the lane route: "
          f"{solver.kkt_backend_resolved} {solver._solve_raw.band_mode} {plan.n} "
          f"{plan.bandwidth}")
    params, init, true_pos = l12.bench_inputs(L12_N, ns)

    def solve():
        return solver.solve(params, init=init, mu0=l12.BENCH_MU0, max_iter=l12.BENCH_MAX_ITER)

    solve()  # warm-up (first-call allocations)
    reset_counts(fb, *others)
    sol = solve()
    launches = dict(fb.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K4-K11 on the l1l2 path: {[m.LAUNCHES for m in others]}")
    check(sol.status == 0, f"l1l2: {sol.describe()}")
    check(launches["factor_solve"] > 0 and launches["solve"] > 0 and launches["factor"] == 0,
          f"K1 and K2 on the l1l2 path, no K3: {launches}")
    pos = np.asarray(sol.outputs["position"], float)
    check(pos.shape == (L12_N,) and np.isfinite(pos).all(), "finite positions")
    err = float(np.abs(pos - true_pos).mean())
    check(err < L12_ERR_BOUND, f"mean position error {err:.4f} below {L12_ERR_BOUND}")
    walls = [solve().time for _ in range(10)]
    lockstep = sol.iters - 1
    log(f"[l1l2] N={L12_N} f32: built in {build:.1f} s; nU {solver.nU} nF {solver.nF}; nK "
        f"{plan.n}, RCM w {plan.bandwidth}; band mode {solver._solve_raw.band_mode}; K1/K2 "
        f"route {fb.route(plan.bandwidth)}; status 0, {sol.iters} iterations; warm solve "
        f"{statistics.median(walls):.4f} s (median of 10; {min(walls):.4f}..{max(walls):.4f}; "
        f"{card_line()}); launches {launches}; per lockstep iteration K1 "
        f"{launches['factor_solve'] / lockstep:.2f} K2 {launches['solve'] / lockstep:.2f}; mean "
        f"|position - truth| {err:.4f}")
    return solver, params, init, sol, launches


def l1l2_cpu(params, init):
    """[l1l2-cross-check]'s CPU side: the single solve."""
    from tenscalc_tpu_torch.examples import l1l2estimation as l12

    cpu = l12.build_l1l2(N=L12_N, ns="bl12_", device="cpu", **l12.BENCH_OPTIONS)
    sol = cpu.solve(params, init=init, mu0=l12.BENCH_MU0, max_iter=l12.BENCH_MAX_ITER)
    return sol.status, sol.iters, np.asarray(sol.outputs["position"], float)


def finish_l1l2_cross_check(out, sol):
    """The card's single solve against the port on the CPU: status equal,
    iterations within one, position within L12_POS_ATOL."""
    (status, iters, pos), seconds = out
    dp = float(np.abs(np.asarray(sol.outputs["position"], float) - pos).max())
    check(status == sol.status and abs(iters - sol.iters) <= 1,
          f"l1l2 card status {sol.status} ({sol.iters} it), CPU {status} ({iters} it)")
    check(dp <= L12_POS_ATOL, f"l1l2 position within {L12_POS_ATOL} ({dp:.3e})")
    log(f"[l1l2-cross-check] the CPU's solve in {seconds:.1f} s: status {status}, iterations "
        f"card {sol.iters} cpu {iters}, max |d position| {dp:.3e}")


def phase_l1l2_fleet(solver, l12, fb, others):
    """1024 l1l2 estimations in one solve_many, instance i from
    make_data(N, seed=i): the band (1024, 996, 11) through K1/K2, every
    instance at status 0; iterations, solves/s, launches a lockstep
    iteration."""
    ns = "bl12_"
    params, inits, true_pos = l12.fleet_inputs(L12_B, L12_N, ns)

    def run(max_iter=l12.BENCH_MAX_ITER):
        res = solver.solve_many(params, inits=inits, mu0=l12.BENCH_MU0, max_iter=max_iter)
        torch.cuda.synchronize()
        return res

    run(max_iter=2)  # warm-up (first-call allocations at this B)
    reset_counts(fb, *others)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          f"no K4-K11 on the l1l2 fleet's path: {[m.LAUNCHES for m in others]}")
    check(launches["factor_solve"] > 0 and launches["solve"] > 0 and launches["factor"] == 0,
          f"K1 and K2 on the l1l2 fleet's path, no K3: {launches}")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(tuple(res.u.shape) == (L12_B, solver.nU) and bool(torch.isfinite(res.u).all()),
          "finite u of the expected shape")
    check(int((status == 0).sum()) == L12_B,
          f"all {L12_B} instances at status 0 (got {np.bincount(status)})")
    pos = res.u[:, solver.packing.slice_of(ns + "position")].cpu().numpy()
    err = np.abs(pos - true_pos).mean(axis=1)
    lockstep = int(iters.max()) - 1  # the last trip only runs the exit tests
    # the bands K1 factored in that solve, for [l1l2-kernels] (a solve
    # again, its launches after the counts were read)
    bands, entry = [], fb.fleet_banded_factor_solve_batched

    def keep(band, b, w, clamp=0.0):
        bands.append((band.clone(), b.clone(), clamp))
        return entry(band, b, w, clamp)

    fb.fleet_banded_factor_solve_batched = keep
    try:
        run()
    finally:
        fb.fleet_banded_factor_solve_batched = entry
    log(f"[l1l2-fleet] B={L12_B} N={L12_N} f32, band {L12_BAND[0]}x{L12_BAND[1]}x"
        f"{L12_BAND[2] + 1}: status 0 for all; iterations max {iters.max()} mean "
        f"{iters.mean():.2f}; wall {wall:.4f} s, {L12_B / wall:.1f} solves/s, host "
        f"{1e3 * wall / lockstep:.1f} ms a lockstep iteration ({card_line()}); launches "
        f"{launches}; per lockstep iteration K1 {launches['factor_solve'] / lockstep:.2f} K2 "
        f"{launches['solve'] / lockstep:.2f}; mean |position - truth| a fleet mean "
        f"{err.mean():.4f}, max {err.max():.4f}")
    return params, inits, res, launches, wall, lockstep, bands


def l1l2_fleet_cpu(params, inits):
    """[l1l2-fleet-cross-check]'s CPU side: those instances of the fleet."""
    from tenscalc_tpu_torch.examples import l1l2estimation as l12

    cpu = l12.build_l1l2(N=L12_N, ns="bl12_", device="cpu", **l12.BENCH_OPTIONS)
    return numpy_result(cpu.solve_many(params, inits=inits, mu0=l12.BENCH_MU0,
                                       max_iter=l12.BENCH_MAX_ITER))


def l1l2_fleet_cross_check_inputs(params, inits):
    sub_p = {k: (v[L12_CHECKS] if np.ndim(v) >= 1 else v) for k, v in params.items()}
    return sub_p, {k: v[L12_CHECKS] for k, v in inits.items()}


def finish_l1l2_fleet_cross_check(out, res, sl):
    """Eight of the fleet's instances against the port on the CPU: status
    equal, iterations within one, position (``sl`` of u) within
    L12_FLEET_POS_ATOL, J (the objective) within F_RTOL relative."""
    r, seconds = out
    idx = L12_CHECKS
    st, it = res.status.cpu().numpy()[idx], res.iters.cpu().numpy()[idx]
    dp = np.abs(res.u.cpu().numpy()[idx][:, sl] - r.u[:, sl]).max(axis=1)
    f = res.f.cpu().numpy()[idx]
    df = np.abs(f - r.f) / np.abs(r.f)
    log(f"[l1l2-fleet-cross-check] instances {idx.tolist()} on the CPU in {seconds:.1f} s: "
        f"status card {st.tolist()} cpu {r.status.tolist()}; iterations card {it.tolist()} "
        f"cpu {r.iters.tolist()}; max |d position| an instance "
        f"{np.array2string(dp, precision=3)}; J rel diff an instance "
        f"{np.array2string(df, precision=2)}")
    check(np.array_equal(st, r.status), f"l1l2 fleet status card {st} cpu {r.status}")
    check(bool((np.abs(it - r.iters) <= 1).all()),
          f"l1l2 fleet iterations card {it} cpu {r.iters}")
    check(bool((dp <= L12_FLEET_POS_ATOL).all() and (df <= F_RTOL).all()),
          f"l1l2 fleet position within {L12_FLEET_POS_ATOL} ({dp.max():.3e}), J within "
          f"{F_RTOL} ({df.max():.3e})")


def phase_l1l2_kernels(fb, recs, bands):
    """K1 and K2 at the l1l2 fleet's band (1024, 996, 10) on the lane
    route: bitwise against their plain versions, timed beside their
    bounds, the plain versions and the library calls on the band
    expanded to dense (K1: lu_factor_ex(pivot=False) then lu_solve; K2:
    lu_solve on K1's factor as an LU); the rows go into the records'
    main_shapes.  Then K1 on each band the fleet's solve gave it
    (``bands``: its equilibrated, permuted KKT bands, one a lockstep
    iteration): bitwise against the plain version on the first and the
    last, its device time on each."""
    B, n, w = L12_BAND
    clamp = 1e-7
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fb.launch_plan(n, w, B, sms)
    band, rhs = test_band(B, n, w, seed=n + w)
    f1, x1 = fb.fleet_banded_factor_solve_batched(band, rhs, w, clamp)
    x2 = fb.fleet_banded_solve_batched(f1, rhs, w)
    pf, px = fb.fleet_banded_factor_solve_plain(band, rhs, w, clamp)
    px2 = fb.fleet_banded_solve_plain(pf, rhs, w)
    torch.cuda.synchronize()
    check(same_bits(f1, pf) and same_bits(x1, px) and same_bits(x2, px2),
          f"K1/K2 at B={B} n={n} w={w}: not bitwise")
    log(f"[l1l2-kernels] B={B} n={n} w={w}: route {fb.route(w)} "
        f"{'ring' if plan.ring else 'staged'}, {plan.group} instances (a lane each) a CTA of "
        f"one warp, {-(-B // plan.group)} CTAs, {plan.smem} bytes of shared memory a CTA; "
        f"bitwise equal to the plain versions")
    scale = max(pf.abs().max().item(), px.abs().max().item(), 1.0)
    Ad = ldl_dense(band)
    Ad = Ad + Ad.tril(-1).mT
    piv = torch.arange(1, n + 1, dtype=torch.int32, device="cuda").repeat(B, 1)
    libs = {"factor_solve": library_pair(Ad, rhs, x1, scale, 3)[0]}
    del Ad
    LU = ldl_as_lu(f1)
    libs["solve"] = library_check(
        lambda: torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0], x2, scale,
        f"lu_solve against K2 at B={B} n={n} w={w}", 3)[0]
    del LU
    fbo, xo = torch.empty_like(band), torch.empty_like(rhs)
    runs = {
        "factor_solve": (lambda: fb.launch_factor_solve(band, rhs, fbo, xo, w, clamp),
                         lambda: fb.fleet_banded_factor_solve_plain(band, rhs, w, clamp)),
        "solve": (lambda: fb.launch_solve(f1, rhs, xo, w),
                  lambda: fb.fleet_banded_solve_plain(pf, rhs, w)),
    }
    errs = {"factor_solve": max((f1 - pf).abs().max().item(), (x1 - px).abs().max().item()),
            "solve": (x2 - px2).abs().max().item()}
    for k, (kern, plain) in runs.items():
        bms, by = bound(k, B, n, w)
        row = wide_row("l1l2-kernels", NAMES, k, B, n, w, errs[k], kern, bms, by, libs[k],
                       cuda_ms(plain, 1))
        row["path"] = "l1l2-fleet"
        recs[k].setdefault("main_shapes", []).append(row)
        recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], errs[k])
    del band, rhs, f1, x1, x2, pf, px, px2, fbo, xo
    times = []
    for i, (band, rhs, cl) in enumerate(bands):
        fbo, xo = torch.empty_like(band), torch.empty_like(rhs)
        if i in (0, len(bands) - 1):
            fb.launch_factor_solve(band, rhs, fbo, xo, w, cl)
            pf, px = fb.fleet_banded_factor_solve_plain(band, rhs, w, cl)
            check(same_bits(fbo, pf) and same_bits(xo, px),
                  f"K1 on the fleet's band of lockstep iteration {i + 1}: not bitwise")
        times.append(cuda_ms(lambda: fb.launch_factor_solve(band, rhs, fbo, xo, w, cl), 10,
                             spin=True))
    def spread(t):  # entries below the normal range, and the nonzero range
        a = t.abs()
        nz = a[a > 0]
        return (int(((a > 0) & (a < 2.0 ** -126)).sum()),
                f"{float(nz.min()):.1e}..{float(nz.max()):.1e}")

    last = bands[-1]
    fl, _ = fb.fleet_banded_factor_solve_plain(last[0], last[1], w, last[2])
    # the random band with the last band's zeros: a quotient with a zero
    # numerator leaves __fdiv_rn's fast path
    zband, zrhs = test_band(B, n, w, seed=n + w)
    zband = torch.where(last[0] == 0, 0.0, zband)
    fbo, xo = torch.empty_like(zband), torch.empty_like(zrhs)
    t_zero = cuda_ms(lambda: fb.launch_factor_solve(zband, zrhs, fbo, xo, w, 1e-7), 10,
                     spin=True)
    log(f"[l1l2-kernels] K1 on the {len(bands)} bands of the fleet's solve (bitwise on the "
        f"first and the last), device ms a lockstep iteration: "
        f"{', '.join(f'{t:.4f}' for t in times)}; the last band's subnormal entries and "
        f"nonzero magnitudes {spread(last[0])}, its factor's {spread(fl)}; its zero share "
        f"{float((last[0] == 0).float().mean()):.4f} (of the factor "
        f"{float((fl == 0).float().mean()):.4f}); K1 on the random band with those zeros "
        f"{t_zero:.4f} ms")


def lasso_data():
    """[lasso]'s data: 10 of 200 weights nonzero (1..2 in magnitude, either
    sign), Gaussian features, y = X w + 1 + N(0, 0.01^2), numpy seed 0;
    returns (X, y, w, support)."""
    rng = np.random.default_rng(0)
    w = np.zeros(LASSO_F)
    support = rng.choice(LASSO_F, 10, replace=False)
    w[support] = rng.uniform(1.0, 2.0, 10) * rng.choice([-1.0, 1.0], 10)
    X = rng.standard_normal((LASSO_P, LASSO_F))
    return X, X @ w + 1.0 + 0.01 * rng.standard_normal(LASSO_P), w, support


def phase_lasso(ttc, dl, others):
    """One Lasso.fit (apps/lasso.py) at 200 features x 2000 points in f32,
    l1weight 1: the fleet dense LDL^T at nK = 401, K8 and K7 on the tiles
    route, no other kernel; status 0 and the support recovered as
    tests/test_apps.py:109 checks it."""
    lasso = ttc.Lasso(LASSO_F, LASSO_P, name="blas", dtype="float32",
                      gradTolerance=LASSO_GRAD_TOL)
    s = lasso.solver
    nK = s.nU + s.nG
    check(s.device.type == "cuda" and s.kkt_backend_resolved == "fleet" and nK == 401
          and dl.factor_plan(nK, 1).route == "tiles",
          f"the Lasso on the card's fleet dense backend at nK = 401 (tiles route): "
          f"{s.kkt_backend_resolved} {nK}")
    X, y, w, support = lasso_data()
    lasso.fit(X, y, l1weight=1.0)  # warm-up
    reset_counts(dl, *others)
    sol = lasso.fit(X, y, l1weight=1.0)
    n_l, c_l = dict(dl.LAUNCHES), dict(dl.CUDA_LAUNCHES)
    check(not any(v for m in others for v in m.LAUNCHES.values()),
          "no banded kernel on the Lasso's path")
    check(sol.status == 0, f"lasso: {sol.describe()}")
    check(n_l["ldl_factor_solve"] > 0 and n_l["ldl_solve"] > 0
          and n_l["fleet_factor"] == n_l["fleet_solve"] == n_l["ldl_factor"] == 0,
          f"the Lasso through K8 and K7 alone: {n_l}")
    W, c = np.asarray(sol.outputs["W"], float), float(sol.outputs["c"])
    off = np.ones(LASSO_F, bool)
    off[support] = False
    dw = float(np.abs(W[support] - w[support]).max())
    check(dw < 0.2 and float(np.abs(W[off]).max()) < 0.1 and abs(c - 1.0) < 0.2,
          f"the support recovered: |dW| {dw:.3e} on it, {np.abs(W[off]).max():.3e} off it, "
          f"c {c:.4f}")
    log(f"[lasso] {LASSO_F} features x {LASSO_P} points f32 (gradTolerance "
        f"{LASSO_GRAD_TOL}): nK {nK}, backend {s.kkt_backend_resolved}, route "
        f"{dl.factor_plan(nK, 1).route}; status 0, {sol.iters} iterations, {sol.time:.4f} s; "
        f"max |W - w| on the support {dw:.3e}, off it {np.abs(W[off]).max():.3e}, c {c:.6f}; "
        f"launches {n_l}; per iteration {per_iteration(n_l, sol.iters, c_l)}")
    return sol, n_l


def lasso_cpu():
    """[lasso-cross-check]'s CPU side: the same fit."""
    import tenscalc_tpu_torch as ttc

    X, y, _, _ = lasso_data()
    sol = ttc.Lasso(LASSO_F, LASSO_P, name="blas", dtype="float32",
                    gradTolerance=LASSO_GRAD_TOL, device="cpu").fit(X, y, l1weight=1.0)
    return sol.status, sol.iters, np.asarray(sol.outputs["W"], float), float(sol.outputs["c"])


def finish_lasso_cross_check(out, sol):
    (status, iters, W, c), seconds = out
    dw = float(np.abs(np.asarray(sol.outputs["W"], float) - W).max())
    dc = abs(float(sol.outputs["c"]) - c)
    check(status == sol.status and abs(iters - sol.iters) <= 1,
          f"lasso card status {sol.status} ({sol.iters} it), CPU {status} ({iters} it)")
    check(dw <= U_ATOL and dc <= U_ATOL, f"lasso W within {U_ATOL} ({dw:.3e}), c ({dc:.3e})")
    log(f"[lasso-cross-check] the CPU's fit in {seconds:.1f} s: status {status}, iterations "
        f"card {sol.iters} cpu {iters}, max |dW| {dw:.3e}, |dc| {dc:.3e}")


def build_app_mpc(ttc, **options):
    """tests/test_apps.py's DC-motor Mpc (T = 15, forward-Euler dynamics,
    |u| <= 1, |x| <= 0.45); its state derivative works on Exprs and on
    numpy."""
    T, ns = 15, "bapm_"
    x = ttc.variable(ns + "x", (2, T))
    u = ttc.variable(ns + "u", (1, T))
    ref = ttc.variable(ns + "ref", (1, T))
    p = ttc.variable(ns + "p", ())
    k = ttc.variable(ns + "k", ())

    def f(xs, us, ref_, p_, k_):
        x2 = xs[1:2, :]
        if isinstance(xs, ttc.Expr) or isinstance(us, ttc.Expr):
            return ttc.concat([x2, p_ * x2 + k_ * us], axis=0)
        return np.concatenate([x2, np.asarray(p_) * x2 + np.asarray(k_) * us], axis=0)

    Ts = 0.1
    J = (ttc.tsIntegral(((x[0:1, :] - ref) ** 2).sum(axis=0), Ts)
         + (1 / 50.0) * ttc.tsIntegral((u ** 2).sum(axis=0), Ts))
    return ttc.Mpc(objective=J, control_variable=u, state_variable=x, state_derivative=f,
                   sample_time=Ts, parameters=[ref, p, k],
                   constraints=[u >= -1.0, u <= 1.0, x >= -0.45, x <= 0.45],
                   output_expressions={"J": J}, **options)


def app_mpc_loop(mpc, steps=15):
    """tests/test_apps.py:52's closed loop: 15 steps, the plant by RK23."""
    T, Ts, ns = mpc.T, mpc.sample_time_value, "bapm_"
    mpc.set_parameter(ns + "p", -2.0)
    mpc.set_parameter(ns + "k", 1.0)
    mpc.set_initial_state(0.0, [0.2, 0.1])
    u_warm = 0.01 * np.random.default_rng(0).random((1, T))
    t = 0.0
    for _ in range(steps):
        mpc.set_parameter(ns + "ref",
                          -0.3 * np.sign(np.sin(0.5 * (t + np.arange(T) * Ts)))[None, :])
        state = mpc.set_solver_warm_start(u_warm)
        mpc.set_solver_state_start(np.clip(state[:, 1:], -0.42, 0.42))
        sol = mpc.solve(mu0=1e-3, max_iter=100)
        if sol.status != 0:
            break
        t, u_warm, _ = mpc.apply_controls(sol)
    return mpc.get_history()


def build_app_mpcmhe(ttc, **options):
    """The DC motor's MPC-MHE game through the Mpcmhe app at the
    MPC-MHE cell's size (T = 12, L = 16; examples/mpcmhe_dcmotor's plant,
    weights and bounds, lambda_n = 20 as bench.py's fleet): trapezoidal
    dynamics dx = [x2; p x2 + k (u + d)], y = x1."""
    T, L, ns = MMAPP_T, MMAPP_L, "bmha_"
    Ts, p, k = 0.05, -2.0, 1.0
    x = ttc.variable(ns + "x", (2, L + T + 1))
    y = ttc.variable(ns + "yPast", (1, L + 1))
    up = ttc.variable(ns + "uPast", (1, L))
    uf = ttc.variable(ns + "uFuture", (1, T))
    d = ttc.variable(ns + "d", (1, L + T))
    ref = ttc.variable(ns + "ref", (1, T))

    def f(xs, us, ds, *_):
        if isinstance(xs, ttc.Expr):
            return ttc.concat([xs[1:2, :], p * xs[1:2, :] + k * (us + ds)], axis=0)
        return np.concatenate([xs[1:2, :], p * xs[1:2, :] + k * (us + ds)], axis=0)

    J = (ttc.tsIntegral(((x[0:1, L + 1:] - ref) ** 2).sum(axis=0), Ts)
         + (1 / 50.0) * ttc.tsIntegral((uf ** 2).sum(axis=0), Ts)
         - 50.0 * ttc.tsIntegral((d ** 2).sum(axis=0), Ts)
         - 20.0 * ttc.tsIntegral(((x[0:1, : L + 1] - y) ** 2).sum(axis=0), Ts))
    return ttc.Mpcmhe(objective=J, state_variable=x, past_output_variable=y,
                      past_control_variable=up, future_control_variable=uf,
                      disturbance_variable=d, state_derivative=f,
                      output_function=lambda xs, *_: xs[0:1], sample_time=Ts,
                      backward_horizon=L, forward_horizon=T, parameters=[ref],
                      control_constraints=[uf >= -5.0, uf <= 5.0],
                      disturbance_constraints=[d >= -10.0, d <= 10.0],
                      scaleCost=0.0, scaleInequalities=False, **options)


def app_mpcmhe_solve(mhe):
    """One game solve from seeded past windows (numpy seed 0)."""
    T, L = MMAPP_T, MMAPP_L
    rng = np.random.default_rng(0)
    u_past = 0.1 * rng.standard_normal((1, L))
    y_past = (0.05 * np.sin(0.5 * (np.arange(-L, 1) * 0.05))[None, :]
              + 0.02 * rng.standard_normal((1, L + 1)))
    mhe.set_parameter("bmha_ref", np.sign(np.sin(0.5 * np.arange(T) * 0.05))[None, :])
    return mhe.solve(y_past, u_past, mu0=1e-3, max_iter=100)


def sysid_data():
    """tests/test_apps.py:323's data (numpy seed 0): x+ = 0.9 x + 0.5 u
    + N(0, 0.05^2), y = x + N(0, 0.1^2), N = 40."""
    rng = np.random.default_rng(0)
    N = 40
    u_seq = rng.standard_normal((1, N))
    x_seq = np.zeros((1, N))
    for k in range(N - 1):
        x_seq[0, k + 1] = 0.9 * x_seq[0, k] + 0.5 * u_seq[0, k] + 0.05 * rng.standard_normal()
    return u_seq, x_seq + 0.1 * rng.standard_normal((1, N))


def build_app_sysid(ttc, **options):
    return ttc.Sysid(f=lambda x, u, a: a * x + 0.5 * u, g=lambda x, a: x, n_states=1,
                     n_outputs=1, n_inputs=1, horizon=40,
                     parameters=[ttc.ParameterSpec("a", (), lower=-2.0, upper=2.0)],
                     name="bsid", noise_std=0.1, disturbance_std=0.05,
                     forecast_instants=[5, 20, 35], **options)


def phase_apps(ttc, fb, lu, dl):
    """[apps]: each app's entry point on the card in float64 (the apps'
    default), its backend and launches read around it: the Mpc app's
    closed loop, examples/mpc_lti's, examples/mpc_fleet.run_fleet(64, 20,
    20 periods), the Mpcmhe app's game at T = 12, L = 16 and a Sysid fit
    with its forecast and parameter_std.  Returns what finish_apps holds
    against the CPU, and the launches by path."""
    from tenscalc_tpu_torch.examples import mpc_fleet, mpc_lti

    mods = (fb, lu, dl)
    out, launches = {}, {}

    def counted(name, fn):
        reset_counts(*mods)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        launches[name] = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
        return r, time.perf_counter() - t0

    ttc.clear_variables()
    mpc = build_app_mpc(ttc)
    check(mpc.solver.device.type == "cuda", "the Mpc app's default device is the card")
    hist, sec = counted("mpc", lambda: app_mpc_loop(mpc))
    check(hist["status"].shape == (15,) and (hist["status"] == 0).all(),
          f"the Mpc app's closed loop at status 0: {hist['status']}")
    check(hist["x"].shape == (2, 16) and (np.abs(hist["x"]) <= 0.47).all()
          and (np.abs(hist["u"]) <= 1 + 1e-6).all(), "its states and controls in the box")
    out["mpc"] = hist
    log(f"[apps] Mpc app (T=15, nK {mpc.solver.nU + mpc.solver.nG}, backend "
        f"{mpc.solver.kkt_backend_resolved}): 15 steps at status 0 in {sec:.2f} s, iterations "
        f"{hist['iter'].tolist()}; launches {launches['mpc']}")

    ttc.clear_variables()
    lti = mpc_lti.build_solver()
    hist, sec = counted("mpc_lti", lambda: mpc_lti.run_closed_loop(lti))
    check(len(hist["x"]) == 30 and (hist["status"] == 0).all()
          and (np.abs(hist["x"][:, 0]) <= 0.4 + 1e-6).all(),
          f"mpc_lti's closed loop: statuses {set(hist['status'].tolist())}")
    out["mpc_lti"] = hist
    log(f"[apps] examples/mpc_lti (T=20, delay 1, backend {lti.kkt_backend_resolved}): 30 "
        f"steps at status 0 in {sec:.2f} s; launches {launches['mpc_lti']}")

    ttc.clear_variables()
    B, T, steps = APP_FLEET
    hist, sec = counted("mpc_fleet", lambda: mpc_fleet.run_fleet(B=B, T=T, n_steps=steps))
    check(hist["status"].shape == (steps, B) and (hist["status"] == 0).all(),
          f"mpc_fleet: every plant at status 0 in every period ({hist['status'].shape})")
    check(np.abs(hist["x"]).max() < 0.45, "mpc_fleet's states inside the box")
    out["mpc_fleet"] = hist
    log(f"[apps] examples/mpc_fleet B={B} T={T} {steps} periods: all at status 0 in "
        f"{sec:.2f} s ({B * steps / sec:.1f} solves/s over the loop), max iterations a period "
        f"{hist['iters_max'].tolist()}; launches {launches['mpc_fleet']}")

    ttc.clear_variables()
    mhe = build_app_mpcmhe(ttc)
    sol, sec = counted("mpcmhe", lambda: app_mpcmhe_solve(mhe))
    check(sol.status == 0, f"the Mpcmhe app's solve: status {sol.status}")
    check(np.isfinite(sol.state).all() and (np.abs(sol.control) <= 5 + 1e-6).all(),
          "its state finite, its controls in their box")
    plan = getattr(mhe.solver, "kkt_plan", None)
    out["mpcmhe"] = (sol.status, sol.iter, sol.control, sol.state)
    log(f"[apps] Mpcmhe app (T={MMAPP_T}, L={MMAPP_L}, backend "
        f"{mhe.solver.kkt_backend_resolved}, RCM w "
        f"{plan.bandwidth if plan is not None else None}): status 0, {sol.iter} iterations, "
        f"{sec:.2f} s; launches {launches['mpcmhe']}")

    ttc.clear_variables()
    sid = build_app_sysid(ttc)
    u_seq, y_seq = sysid_data()
    (sol, est), sec = counted("sysid", lambda: sid.fit(u_seq, y_seq, x0=y_seq, mu0=1.0))
    check(sol.status == 0, f"the Sysid fit: {sol.describe()}")
    t0 = time.perf_counter()
    rep = sid.forecast(sol, u_seq, y_seq)
    std = sid.parameter_std(sol)
    torch.cuda.synchronize()
    sec_h = time.perf_counter() - t0
    check(rep["H_sign"] > 0 and np.isfinite(rep["logMarginal"]), "the forecast's Hessian")
    out["sysid"] = ({k: sol.variables[k] for k in sol.variables}, sol.status, sol.iters, rep,
                    std)
    log(f"[apps] Sysid (N=40, soft dynamics, backend {sid.solver.kkt_backend_resolved}): "
        f"status 0, {sol.iters} iterations, a {float(est['a']):.6f}, {sec:.2f} s; launches "
        f"{launches['sysid']}; forecast and parameter_std (torch.func.hessian, float64, on "
        f"the card) in {sec_h:.2f} s: std {rep['std'].ravel().tolist()}, logMarginal "
        f"{rep['logMarginal']:.6f}, std(a) {float(std['theta']['a']):.6e}")
    return out, launches


def apps_cpu(card_sysid_vars):
    """[apps-cross-check]'s CPU side: every [apps] drive again on the CPU;
    the Sysid's forecast and parameter_std also at the card's solution."""
    import tenscalc_tpu_torch as ttc
    from tenscalc_tpu_torch.examples import mpc_fleet, mpc_lti

    out = {}
    ttc.clear_variables()
    out["mpc"] = app_mpc_loop(build_app_mpc(ttc, device="cpu"))
    ttc.clear_variables()
    out["mpc_lti"] = mpc_lti.run_closed_loop(mpc_lti.build_solver(device="cpu"))
    ttc.clear_variables()
    B, T, steps = APP_FLEET
    out["mpc_fleet"] = mpc_fleet.run_fleet(B=B, T=T, n_steps=steps, device="cpu")
    ttc.clear_variables()
    sol = app_mpcmhe_solve(build_app_mpcmhe(ttc, device="cpu"))
    out["mpcmhe"] = (sol.status, sol.iter, sol.control, sol.state)
    ttc.clear_variables()
    sid = build_app_sysid(ttc, device="cpu")
    u_seq, y_seq = sysid_data()
    sol, _ = sid.fit(u_seq, y_seq, x0=y_seq, mu0=1.0)
    at_card = SimpleNamespace(variables=card_sysid_vars)
    out["sysid"] = (sol.variables, sol.status, sol.iters,
                    sid.forecast(at_card, u_seq, y_seq), sid.parameter_std(at_card))
    return out


def finish_apps(card, out):
    """The card's [apps] against the port on the CPU, every comparison
    logged before any is held: statuses equal, iterations within one,
    the Mpc app's and mpc_lti's closed-loop states and controls within
    APP_ATOL; mpc_fleet's first period's controls within U_ATOL and the
    whole loop's states and controls within APP_FLEET_ATOL; the Mpcmhe
    app's controls and states within APP_ATOL; the Sysid's estimates
    within APP_ATOL and its forecast and parameter_std at the card's
    solution within SYSID_RTOL relative."""
    cpu, seconds = out
    parts, held = [], []

    def hold(cond, msg):
        held.append((bool(cond), msg))

    for name in ("mpc", "mpc_lti"):
        a, b = card[name], cpu[name]
        hold(np.array_equal(a["status"], b["status"]), f"{name}: statuses card against CPU")
        if "iter" in a:
            hold((np.abs(a["iter"] - b["iter"]) <= 1).all(),
                 f"{name}: iterations card {a['iter']} cpu {b['iter']}")
        d = max(float(np.abs(a["x"] - b["x"]).max()), float(np.abs(a["u"] - b["u"]).max()))
        hold(d <= APP_ATOL, f"{name}: states and controls within {APP_ATOL} ({d:.3e})")
        parts.append(f"{name} max |dx|, |du| {d:.3e}")
    a, b = card["mpc_fleet"], cpu["mpc_fleet"]
    hold(np.array_equal(a["status"], b["status"]), "mpc_fleet: statuses card against CPU")
    hold((np.abs(a["iters_max"] - b["iters_max"]) <= 1).all(),
         f"mpc_fleet: max iterations card {a['iters_max']} cpu {b['iters_max']}")
    du_p = np.abs(a["u"] - b["u"]).reshape(len(a["u"]), -1).max(axis=1)
    dx = float(np.abs(a["x"] - b["x"]).max())
    hold(du_p[0] <= U_ATOL, f"mpc_fleet: the first period's u within {U_ATOL} ({du_p[0]:.3e})")
    hold(du_p.max() <= APP_FLEET_ATOL and dx <= APP_FLEET_ATOL,
         f"mpc_fleet: u ({du_p.max():.3e}) and x ({dx:.3e}) within {APP_FLEET_ATOL}")
    parts.append(f"mpc_fleet max |du| a period {np.array2string(du_p, precision=1)}, max "
                 f"|dx| {dx:.3e}")
    (sa, ia, ca, xa), (sb, ib, cb, xb) = card["mpcmhe"], cpu["mpcmhe"]
    d = max(float(np.abs(ca - cb).max()), float(np.abs(xa - xb).max()))
    hold(sa == sb and abs(ia - ib) <= 1 and d <= APP_ATOL,
         f"Mpcmhe app: status {sa}/{sb}, iterations {ia}/{ib}, max diff {d:.3e}")
    parts.append(f"Mpcmhe app iterations {ia}/{ib}, max |du|, |dx| {d:.3e}")
    (va, sa, ia, ra, stda), (vb, sb, ib, rb, stdb) = card["sysid"], cpu["sysid"]
    dv = max(float(np.abs(np.asarray(va[k]) - np.asarray(vb[k])).max()) for k in va)
    hold(sa == sb and abs(ia - ib) <= 1 and dv <= APP_ATOL,
         f"Sysid: status {sa}/{sb}, iterations {ia}/{ib}, estimates {dv:.3e}")
    rel = 0.0
    for k in ("mean", "std", "logJoint", "logMarginal", "logdetH"):
        x, y = np.asarray(ra[k], float), np.asarray(rb[k], float)
        rel = max(rel, float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)))
    for x, y in ((stda["theta"]["a"], stdb["theta"]["a"]), (stda["x"], stdb["x"])):
        rel = max(rel, float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)))
    hold(rel <= SYSID_RTOL, f"Sysid's Laplace Hessians card against CPU: {rel:.3e} relative")
    parts.append(f"Sysid iterations {ia}/{ib}, estimates {dv:.3e}, forecast and "
                 f"parameter_std at the card's solution {rel:.3e} relative")
    log(f"[apps-cross-check] on the CPU in {seconds:.1f} s beside the other phases: "
        + "; ".join(parts))
    for cond, msg in held:
        check(cond, msg)


# ---------------------------------------------------------------------------
# slice 20: the structured KKT backends and the mesh paths (plain PyTorch:
# batched LU factors and solves, products, eigvalsh; no hand-written kernel
# but K1/K2 in the [mesh] fleet)
# ---------------------------------------------------------------------------

# the min-max fleet on 'tridiag' and the structured flagship fleets: the
# CPU sides solve these instances again
STRUCT_CHECKS = FLEET_CHECKS
# [tridiag]'s and [cyclic]'s cross-checks: at the flagship's default
# tolerances u is not determined to U_ATOL on part of the fleet (the
# card's 'tridiag' and 'fleet_banded' answers part by up to 9.2e-3 at
# objectives 3.3e-5 apart, the card's and the CPU's 'tridiag' by 1.02e-2
# at 4.1e-6, and [cyclic]'s CPU side logs the CPU's own float64 'cyclic'
# and 'dense' answers up to 7.4e-3 apart), so these hold the objective
# within J_RTOL and u within STRUCT_U_ATOL, and count the instances on
# one path (iterations equal, u within F64_U_ATOL)
STRUCT_U_ATOL = 2e-2
F64_U_ATOL = 1e-6
# the virtual meshes: four entries of the card ([spike], [mesh])
MESH_VIRTUAL = 4
# measure_scaling's weak-scaling sweep on a virtual list of cuda:0 entries
SCALE_PER_DEVICE, SCALE_COUNTS = 256, (1, 2, 4)
# tests/test_planner.py:44's Sysid: a within this of the truth (0.8)
SYSID_A_ATOL = 5e-3


def _tensors(x):
    """Every tensor in x: a tensor, or tuples, lists and dicts of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


@contextlib.contextmanager
def factor_placement(*classes):
    """While open, every adapter of ``classes`` built records the device
    types of the tensors it holds; yields (device types, adapters built)."""
    types, built = set(), [0]
    saved = [(c, c.__init__) for c in classes]

    def wrap(orig):
        def init(self, *args, **kwargs):
            orig(self, *args, **kwargs)
            built[0] += 1
            types.update(t.device.type for t in _tensors(list(vars(self).values())))
        return init

    for c, orig in saved:
        c.__init__ = wrap(orig)
    try:
        yield types, built
    finally:
        for c, orig in saved:
            c.__init__ = orig


def struct_fleet(label, solver, run, classes, kmods, B, kernels_allowed=()):
    """A fleet phase of slice 20: a warm-up, a timed solve (its adapters'
    tensors on the card; no hand-written kernel but ``kernels_allowed``),
    a profiled solve; logs statuses, iterations, solves/s, host and device
    ms and CUDA launches a lockstep iteration.  Returns the timed result
    and the hand-written kernels' launches."""
    run()  # warm-up (first-call allocations)
    reset_counts(*kmods)
    with factor_placement(*classes) as (types, built):
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    kern = {k: v for m in kmods for k, v in m.LAUNCHES.items() if v}
    check(built[0] > 0 and types == {"cuda"},
          f"[{label}] its factors on the card: {built[0]} built, on {sorted(types)}")
    check(set(kern) <= set(kernels_allowed), f"[{label}] hand-written kernels: {kern}")
    status, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    check(bool(torch.isfinite(res.u).all()), f"[{label}] finite u")
    lockstep = max(int(iters.max()) - 1, 1)  # the last trip only runs the exit tests
    pwall, busy, n_launch, _ = device_profile(run)
    log(f"[{label}] B={B}: backend {solver.kkt_backend_resolved}; statuses "
        f"{ {int(a): int(c) for a, c in zip(*np.unique(status, return_counts=True))} }; "
        f"iterations max {iters.max()} "
        f"mean {iters.mean():.2f}; wall {wall:.4f} s, {B / wall:.1f} solves/s; a lockstep "
        f"iteration: host {1e3 * wall / lockstep:.2f} ms, device {1e3 * busy / lockstep:.3f} ms "
        f"(profiled wall {pwall:.4f} s, device idle {1 - busy / pwall:.3f}), CUDA launches "
        f"{n_launch / lockstep:.1f}; hand-written kernels a lockstep iteration "
        f"{ {k: round(v / lockstep, 2) for k, v in kern.items()} }; adapters built "
        f"{built[0]}, on {sorted(types)}; {card_line()}")
    return res, kern


def _sync(res):
    """``res`` once the card is done."""
    torch.cuda.synchronize()
    return res


def structured_cpu(case, params, inits):
    """The CPU side of slice 20's cross-checks: the port on the CPU on the
    same inputs (the instances the card's phase picked)."""
    import tenscalc_tpu_torch as ttc
    from tenscalc_tpu_torch.examples import mpc_dcmotor as mpc
    from tenscalc_tpu_torch.parallel import Mesh, virtual_devices

    if case == "minmax-tridiag":
        cpu = build_minmax(ttc, "bmt_", device="cpu", kkt_backend="tridiag")
        return numpy_result(cpu.solve_many(params, inits=inits, mu0=1.0, max_iter=60))
    if case == "l1l2":
        from tenscalc_tpu_torch.examples import l1l2estimation as l12

        os.environ["TENSCALC_AUTO_FLEET"] = "0"
        cpu = l12.build_l1l2(N=L12_N, ns="bl12a_", device="cpu", **l12.BENCH_OPTIONS)
        sol = cpu.solve(params, init=inits, mu0=l12.BENCH_MU0, max_iter=l12.BENCH_MAX_ITER)
        return (cpu.kkt_backend_resolved, sol.status, sol.iters,
                np.asarray(sol.outputs["position"], float))
    backend, dtype = {"tridiag": ("tridiag", "float32"), "cyclic": ("cyclic", "float64"),
                      "spike": ("spike", "float32")}[case]
    kw = ({"kkt_mesh": Mesh(virtual_devices("cpu", MESH_VIRTUAL), ("stages",))}
          if case == "spike" else {})
    ns = f"f{case[:3]}_"
    cpu = mpc.build_solver(T=FLEET_T, namespace=ns, dtype=dtype, kkt_backend=backend,
                           device="cpu", **kw)
    out = numpy_result(cpu.solve_many(params, inits=inits, mu0=1e-3, max_iter=100))
    if case != "cyclic":
        return out
    # the spread of the float64 answers between two backends on the CPU
    dense = mpc.build_solver(T=FLEET_T, namespace=ns, dtype=dtype, kkt_backend="dense",
                             device="cpu")
    return out, numpy_result(dense.solve_many(params, inits=inits, mu0=1e-3, max_iter=100))


def fleet_subset(params, inits, ns, idx, batched=("ref", "xinit")):
    """The instances ``idx`` of a flagship fleet's inputs."""
    return ({k: (v[idx] if k in {ns + b for b in batched} else v) for k, v in params.items()},
            {k: v[idx] for k, v in inits.items()})


def finish_struct_cross_check(label, out, res, idx, f64, u_atol=U_ATOL, u_cols=None):
    """A card fleet's instances ``idx`` against the port on the CPU: status
    equal, iterations within one, u within ``u_atol``; where ``u_atol``
    is STRUCT_U_ATOL, also the objective within J_RTOL.  ``f64``: the CPU
    side also solved the instances on 'dense', whose spread from its
    'cyclic' answers is logged."""
    r, seconds = out
    spread = None
    if f64:
        r, dense = r
        spread = np.abs(r.u - dense.u).max(axis=1)
    card = numpy_result(res, idx)
    sl = slice(None) if u_cols is None else slice(0, u_cols)
    du = np.abs(r.u[:, sl] - card.u[:, sl]).max(axis=1)
    dj = np.abs(r.f - card.f) / np.abs(r.f)
    same = (r.iters == card.iters) & (du <= F64_U_ATOL)
    log(f"[{label}-cross-check] {len(idx)} instances on the CPU ({seconds:.1f} s): status card "
        f"{card.status.tolist()} cpu {r.status.tolist()}; iterations card {card.iters.tolist()} "
        f"cpu {r.iters.tolist()}; |du| {np.array2string(du, precision=3)}; objective rel diff "
        f"max {dj.max():.3e}; one path (iterations equal, u within {F64_U_ATOL}) on "
        f"{int(same.sum())} of {len(idx)}"
        + ("" if spread is None else "; the CPU's 'cyclic' against its 'dense' |du| "
           f"{np.array2string(spread, precision=3)}"))
    check((r.status == card.status).all(), f"[{label}] status equal")
    check((np.abs(r.iters - card.iters) <= 1).all(), f"[{label}] iterations within one")
    check((du <= u_atol).all(), f"[{label}] u within {u_atol} ({du.max():.3e})")
    if u_atol == STRUCT_U_ATOL:
        check((dj <= J_RTOL).all(), f"[{label}] objective within {J_RTOL} ({dj.max():.3e})")


def phase_tridiag(ttc, mpc, flag_res, kmods):
    """[tridiag]: the flagship fleet (T = 30, B = 1024, f32, the flagship
    options) on kkt_backend='tridiag', its u held against the card's own
    fleet_banded flagship where both converge."""
    from tenscalc_tpu_torch.kkt.tridiag import TridiagFactorization

    ns = "ftri_"
    t0 = time.perf_counter()
    solver = mpc.build_solver(T=FLEET_T, namespace=ns, dtype="float32", kkt_backend="tridiag")
    check(solver.device.type == "cuda", "[tridiag] the solver on the card")
    check(solver.kkt_backend_resolved == "tridiag" and solver.kkt_plan.block == 4,
          "[tridiag] 'tridiag', blocks of 4")
    log(f"[tridiag] built in {time.perf_counter() - t0:.1f} s; plan n {solver.kkt_plan.n}, "
        f"s {solver.kkt_plan.block}, {solver.kkt_plan.n_blocks} blocks")
    params, inits = mpc.fleet_inputs(FLEET_T, FLEET_B, ns, seed=0)
    res, _ = struct_fleet("tridiag", solver, lambda: _sync(solver.solve_many(
        params, inits=inits, mu0=1e-3, max_iter=100)), (TridiagFactorization,), kmods, FLEET_B)
    status = res.status.cpu().numpy()
    check(int((status == 0).sum()) == FLEET_B, f"[tridiag] all at status 0: {np.bincount(status)}")
    both = (status == 0) & (flag_res.status.cpu().numpy() == 0)
    du = (res.u - flag_res.u).abs().amax(dim=1).cpu().numpy()[both]
    dj = ((res.f - flag_res.f).abs() / flag_res.f.abs()).cpu().numpy()[both]
    log(f"[tridiag] against the card's fleet_banded flagship: {int(both.sum())} both at status "
        f"0; |du| median {np.median(du):.3e}, max {du.max():.3e}, {int((du > U_ATOL).sum())} "
        f"above {U_ATOL}, {int((du == 0).sum())} bitwise; objective rel diff max {dj.max():.3e}")
    # two float32 factorizations stop at different points of the default
    # tolerances' ball, where u is not determined to U_ATOL on part of
    # the fleet: the objective is held, u logged
    check((dj <= J_RTOL).all(), f"[tridiag] objective within {J_RTOL} of the fleet_banded "
          f"flagship ({dj.max():.3e})")
    sub = fleet_subset(params, inits, ns, STRUCT_CHECKS)
    return res, start_cpu_side(structured_cpu, "tridiag", *sub)


def phase_minmax_tridiag(ttc, kmods):
    """[minmax-tridiag]: bench.py's min-max fleet (n = 80, B = 1024, f32)
    on kkt_backend='tridiag' (the saddle KKT by the block-tridiagonal
    LDL^T, its inertia from the Schur blocks)."""
    from tenscalc_tpu_torch.kkt.tridiag import TridiagFactorization

    ns = "bmt_"
    t0 = time.perf_counter()
    solver = build_minmax(ttc, ns, kkt_backend="tridiag")
    check(solver.device.type == "cuda", "[minmax-tridiag] the solver on the card")
    check(solver.kkt_backend_resolved == "tridiag" and solver._solve_raw.band_mode is None,
          "[minmax-tridiag] 'tridiag', no band mode")
    log(f"[minmax-tridiag] built in {time.perf_counter() - t0:.1f} s; plan n "
        f"{solver.kkt_plan.n}, s {solver.kkt_plan.block}, {solver.kkt_plan.n_blocks} blocks")
    params, inits = minmax_inputs(ns, MM_B)
    res, _ = struct_fleet("minmax-tridiag", solver, lambda: _sync(solver.solve_many(
        params, inits=inits, mu0=1.0, max_iter=60)), (TridiagFactorization,), kmods, MM_B)
    status = res.status.cpu().numpy()
    check(int((status == 0).sum()) == MM_B, f"[minmax-tridiag] all at status 0: "
          f"{np.bincount(status)}")
    sub = ({k: v[MM_CHECKS] for k, v in params.items()},
           {k: v[MM_CHECKS] for k, v in inits.items()})
    return res, start_cpu_side(structured_cpu, "minmax-tridiag", *sub)


def planner_sysid(ttc):
    """tests/test_planner.py:44's Sysid (a, b global: an arrow over the
    horizon's band) and its clean data."""
    sysid = ttc.Sysid(
        f=lambda x, u, a, b: a * x + b * u, g=lambda x, a, b: x,
        n_states=1, n_outputs=1, n_inputs=1, horizon=40,
        parameters=[ttc.ParameterSpec("a", (), lower=0.0, upper=1.0),
                    ttc.ParameterSpec("b", (), lower=-2.0, upper=2.0)])
    rng = np.random.default_rng(0)
    N = 40
    u_seq = rng.standard_normal((1, N))
    x_seq = np.zeros((1, N))
    for k in range(N - 1):
        x_seq[0, k + 1] = 0.8 * x_seq[0, k] + 0.5 * u_seq[0, k]
    return sysid, u_seq, x_seq + 1e-3 * rng.standard_normal((1, N))


def phase_auto_cpu_branch(ttc, kmods):
    """[auto-cpu-branch]: 'auto' under TENSCALC_AUTO_FLEET=0 (the JAX
    package's non-fleet branch) on the card: bench.py's l1l2 row resolves
    to 'tridiag' (status 0, mean position error under 0.6, its warm
    latency), tests/test_planner.py:44's Sysid to 'arrow' (a within
    5e-3)."""
    from tenscalc_tpu_torch.examples import l1l2estimation as l12
    from tenscalc_tpu_torch.kkt.arrow import ArrowFactorization
    from tenscalc_tpu_torch.kkt.tridiag import TridiagFactorization

    before = os.environ.get("TENSCALC_AUTO_FLEET")
    os.environ["TENSCALC_AUTO_FLEET"] = "0"
    try:
        ns = "bl12a_"
        t0 = time.perf_counter()
        solver = l12.build_l1l2(N=L12_N, ns=ns, **l12.BENCH_OPTIONS)
        build = time.perf_counter() - t0
        sysid, u_seq, y_seq = planner_sysid(ttc)
    finally:
        if before is None:
            os.environ.pop("TENSCALC_AUTO_FLEET")
        else:
            os.environ["TENSCALC_AUTO_FLEET"] = before
    check(solver.device.type == "cuda", "[auto-cpu-branch] the solver on the card")
    check(solver.kkt_backend_resolved == "tridiag",
          f"[auto-cpu-branch] l1l2 resolves to 'tridiag': {solver.kkt_backend_resolved}")
    check(sysid.solver.kkt_backend_resolved == "arrow",
          f"[auto-cpu-branch] the Sysid resolves to 'arrow': {sysid.solver.kkt_backend_resolved}")
    params, init, true_pos = l12.bench_inputs(L12_N, ns)

    def solve():
        sol = solver.solve(params, init=init, mu0=l12.BENCH_MU0, max_iter=l12.BENCH_MAX_ITER)
        torch.cuda.synchronize()
        return sol

    solve()  # warm-up
    reset_counts(*kmods)
    with factor_placement(TridiagFactorization) as (types, built):
        sol = solve()
    check(built[0] > 0 and types == {"cuda"}, f"[auto-cpu-branch] l1l2's factors on the "
          f"card: {built[0]}, {sorted(types)}")
    check(not any(v for m in kmods for v in m.LAUNCHES.values()),
          "[auto-cpu-branch] no hand-written kernel on 'tridiag'")
    check(sol.status == 0, f"[auto-cpu-branch] l1l2: {sol.describe()}")
    pos = np.asarray(sol.outputs["position"], float)
    err = float(np.abs(pos - true_pos).mean())
    check(np.isfinite(pos).all() and err < L12_ERR_BOUND,
          f"[auto-cpu-branch] mean position error {err:.4f} below {L12_ERR_BOUND}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve()
        walls.append(time.perf_counter() - t0)
    lockstep = max(sol.iters - 1, 1)
    pwall, busy, n_launch, _ = device_profile(solve)
    wall = statistics.median(walls)
    log(f"[auto-cpu-branch] l1l2 N={L12_N} f32 (TENSCALC_AUTO_FLEET=0): built in {build:.1f} s, "
        f"backend tridiag, s {solver.kkt_plan.block}, {solver.kkt_plan.n_blocks} blocks; status "
        f"0, {sol.iters} iterations; warm solve {wall:.4f} s (median of 3, "
        f"{min(walls):.4f}..{max(walls):.4f}), {1 / wall:.2f} solves/s; a lockstep iteration: "
        f"host {1e3 * wall / lockstep:.2f} ms, device {1e3 * busy / lockstep:.3f} ms (profiled "
        f"wall {pwall:.4f} s), CUDA launches {n_launch / lockstep:.1f}; mean |position - truth| "
        f"{err:.4f}; {card_line()}")
    reset_counts(*kmods)
    with factor_placement(ArrowFactorization) as (types, built):
        t0 = time.perf_counter()
        fit, est = sysid.fit(u_seq, y_seq, x0=y_seq)
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t0
    check(built[0] > 0 and types == {"cuda"}, f"[auto-cpu-branch] the Sysid's arrow factors "
          f"on the card: {built[0]}, {sorted(types)}")
    check(fit.ok and abs(float(est["a"]) - 0.8) <= SYSID_A_ATOL,
          f"[auto-cpu-branch] Sysid: {fit.describe()}, a {float(est['a']):.6f}")
    log(f"[auto-cpu-branch] Sysid (horizon 40): backend arrow, n_arrow "
        f"{sysid.solver.kkt_plan.n_arrow}; status 0, {fit.iters} iterations, {fwall:.3f} s; a "
        f"{float(est['a']):.6f} b {float(est['b']):.6f} (truth 0.8, 0.5)")
    return sol, start_cpu_side(structured_cpu, "l1l2", params, init)


def finish_auto_cpu_branch(out, sol):
    (backend, status, iters, pos), seconds = out
    dp = float(np.abs(np.asarray(sol.outputs["position"], float) - pos).max())
    check(backend == "tridiag" and status == sol.status and abs(iters - sol.iters) <= 1,
          f"[auto-cpu-branch] l1l2 card status {sol.status} ({sol.iters} it), CPU {backend} "
          f"{status} ({iters} it)")
    check(dp <= L12_POS_ATOL, f"[auto-cpu-branch] l1l2 position within {L12_POS_ATOL} ({dp:.3e})")
    log(f"[auto-cpu-branch-cross-check] the CPU's l1l2 solve ({seconds:.1f} s): {backend}, "
        f"status {status}, iterations card {sol.iters} cpu {iters}, max |d position| {dp:.3e}")


def phase_cyclic(mpc, kmods):
    """[cyclic]: the flagship fleet (T = 30, B = 1024) in float64 on
    kkt_backend='cyclic' (block cyclic reduction, refactored at every
    solve)."""
    from tenscalc_tpu_torch.kkt.cyclic import CyclicFactorization

    ns = "fcyc_"
    t0 = time.perf_counter()
    solver = mpc.build_solver(T=FLEET_T, namespace=ns, dtype="float64", kkt_backend="cyclic")
    check(solver.device.type == "cuda", "[cyclic] the solver on the card")
    check(solver.kkt_backend_resolved == "cyclic", "[cyclic] 'cyclic'")
    log(f"[cyclic] built in {time.perf_counter() - t0:.1f} s")
    params, inits = mpc.fleet_inputs(FLEET_T, FLEET_B, ns, seed=0)
    res, _ = struct_fleet("cyclic", solver, lambda: _sync(solver.solve_many(
        params, inits=inits, mu0=1e-3, max_iter=100)), (CyclicFactorization,), kmods, FLEET_B)
    status = res.status.cpu().numpy()
    check(int((status == 0).sum()) == FLEET_B, f"[cyclic] all at status 0: {np.bincount(status)}")
    return res, start_cpu_side(structured_cpu, "cyclic",
                               *fleet_subset(params, inits, ns, STRUCT_CHECKS))


def phase_spike(mpc, kmods):
    """[spike]: the flagship fleet (T = 30, B = 1024, f32) on
    kkt_backend='spike' over a virtual mesh of 4 x cuda:0."""
    from tenscalc_tpu_torch.kkt.spike import SpikeFactorization
    from tenscalc_tpu_torch.parallel import Mesh, virtual_devices

    ns = "fspi_"
    mesh = Mesh(virtual_devices("cuda:0", MESH_VIRTUAL), ("stages",))
    t0 = time.perf_counter()
    solver = mpc.build_solver(T=FLEET_T, namespace=ns, dtype="float32", kkt_backend="spike",
                              kkt_mesh=mesh)
    check(solver.device.type == "cuda", "[spike] the solver on the card")
    check(solver.kkt_backend_resolved == "spike", "[spike] 'spike'")
    log(f"[spike] built in {time.perf_counter() - t0:.1f} s; mesh {mesh}")
    params, inits = mpc.fleet_inputs(FLEET_T, FLEET_B, ns, seed=0)
    res, _ = struct_fleet("spike", solver, lambda: _sync(solver.solve_many(
        params, inits=inits, mu0=1e-3, max_iter=100)), (SpikeFactorization,), kmods, FLEET_B)
    status = res.status.cpu().numpy()
    check(int((status == 0).sum()) == FLEET_B, f"[spike] all at status 0: {np.bincount(status)}")
    return res, start_cpu_side(structured_cpu, "spike",
                               *fleet_subset(params, inits, ns, STRUCT_CHECKS))


def phase_mesh(mpc, solver, params, inits, flag_res, fb, kmods):
    """[mesh]: the flagship fleet on 'auto' (K1/K2) through
    solve_many(mesh=...): on make_mesh() (the card's devices), then on a
    virtual mesh of 4 x cuda:0, each held against the unsharded fleet;
    then measure_scaling over 1, 2 and 4 entries of cuda:0 with 256
    instances an entry (its solves/s measure no scaling: one card)."""
    from tenscalc_tpu_torch.interop import inits_from_numpy
    from tenscalc_tpu_torch.kkt.fleet_banded import FleetBandedFromBand
    from tenscalc_tpu_torch.parallel import make_mesh, virtual_devices
    from tenscalc_tpu_torch.parallel.scaling import measure_scaling

    ref = numpy_result(flag_res)
    launches = {}
    for name, mesh in (("make_mesh()", make_mesh()),
                       (f"{MESH_VIRTUAL} x cuda:0",
                        make_mesh(MESH_VIRTUAL, devices=virtual_devices("cuda:0", MESH_VIRTUAL)))):
        check(all(d.type == "cuda" for d in mesh.devices), f"[mesh] {name} on the card")
        res, kern = struct_fleet(f"mesh {name}", solver, lambda: _sync(solver.solve_many(
            params, inits=inits, mu0=1e-3, max_iter=100, mesh=mesh)), (FleetBandedFromBand,),
            kmods, FLEET_B, kernels_allowed=("factor_solve", "solve"))
        check(kern.get("factor_solve", 0) > 0 and kern.get("solve", 0) > 0,
              f"[mesh] K1 and K2 on the sharded fleet: {kern}")
        launches = kern if not launches else launches
        r = numpy_result(res)
        du = np.abs(r.u - ref.u).max(axis=1)
        check((r.status == ref.status).all() and (np.abs(r.iters - ref.iters) <= 1).all()
              and (du <= U_ATOL).all(),
              f"[mesh] {name}: statuses equal, iterations within one, u within {U_ATOL} of the "
              f"unsharded fleet ({du.max():.3e})")
        log(f"[mesh] {name} ({mesh.size} entries, {len(mesh.groups())} device): against the "
            f"unsharded fleet, statuses equal, max |du| {du.max():.3e}, "
            f"{int((du == 0).sum())} of {FLEET_B} instances bitwise, iterations equal on "
            f"{int((r.iters == ref.iters).sum())}")
    ns = solver.namespace
    dt = solver.opts.torch_dtype

    def make_batch(B):
        p, i = mpc.fleet_inputs(FLEET_T, B, ns, seed=0)
        penv = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
                if k not in (ns + "ref", ns + "xinit") else v for k, v in p.items()}
        return inits_from_numpy(solver, i, B, solver.device, dt), penv

    rows = measure_scaling(solver, make_batch, per_device_batch=SCALE_PER_DEVICE,
                           device_counts=SCALE_COUNTS, mu0=1e-3, max_iter=100, reps=1,
                           devices=virtual_devices("cuda:0", max(SCALE_COUNTS)))
    check([r["devices"] for r in rows] == list(SCALE_COUNTS)
          and all(r["converged"] == r["batch"] for r in rows),
          f"[mesh] measure_scaling converged at every count: {rows}")
    for r in rows:
        log(f"[mesh] measure_scaling on {r['devices']} x cuda:0, B {r['batch']}: "
            f"{r['solves_per_s']:.1f} solves/s, efficiency {r['efficiency']:.3f} (a virtual "
            f"mesh on one card: no target), {r['converged']} converged")
    return launches


# ---------------------------------------------------------------------------
# the tooling (M17) and the run across processes (M16's last item);
# K1/K2 on the flagship fleet with the history recorded, and split over
# two processes of cuda:0
# ---------------------------------------------------------------------------

# the two-process run: processes, mesh entries a process; its whole run's
# time limit (two processes reaching the card, five solver builds each)
DIST_NPROC, DIST_LOCAL, DIST_TIMEOUT = 2, 2, 400


def phase_profiling(mpc, fb, lu, solver, params, inits, slice_res, slice_wall, prof_k12):
    """[profiling]: the flagship fleet (T = 30, B = 1024, f32) with
    profiling=True and allowSave=True: bitwise [slice]'s fleet, its history
    on the card and finite up to each instance's iters - 1 (NaN after),
    K1/K2 as profiling.kernel_times reads them (1.00 and 2.00 a lockstep
    iteration, their device us beside [profile]'s), flop_counts; the
    profiled wall time beside [slice]'s unprofiled one."""
    import re

    from tenscalc_tpu_torch.ipm.solver import HISTORY_COLUMNS
    from tenscalc_tpu_torch.profiling import flop_counts, kernel_times

    ns = "fleet_"
    t0 = time.perf_counter()
    on = mpc.build_solver(T=FLEET_T, namespace=ns, dtype="float32", profiling=True,
                          allowSave=True)
    build = time.perf_counter() - t0
    check(on.kkt_backend_resolved == "fleet_banded" and on._solve_raw.band_mode == "hoisted",
          "[profiling] the flagship's backend and band mode")

    def run():
        res = on.solve_many(params, inits=inits, mu0=1e-3, max_iter=100)
        torch.cuda.synchronize()
        return res

    run()
    reset_counts(fb, lu)
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    check(torch.equal(res.u, slice_res.u) and torch.equal(res.status, slice_res.status)
          and torch.equal(res.iters, slice_res.iters),
          "[profiling] status, iterations and u bitwise [slice]'s")
    iters = res.iters
    lockstep = int(iters.max()) - 1
    check(launches["factor_solve"] == lockstep and launches["solve"] == 2 * lockstep
          and launches["factor"] == 0, f"[profiling] K1 1.00, K2 2.00: {launches}")
    h = res.history
    check(h.device.type == "cuda", f"[profiling] the history on the card, not {h.device}")
    check(tuple(h.shape) == (FLEET_B, on.opts.maxIter, len(HISTORY_COLUMNS)),
          f"[profiling] history shape {tuple(h.shape)}")
    rows = torch.arange(h.shape[1], device=h.device)[None, :] < (iters - 1)[:, None]
    check(bool(torch.isfinite(h[rows]).all()) and bool(torch.isnan(h[~rows]).all()),
          "[profiling] every instance's rows finite up to its iters - 1, NaN after")
    check(len(res.saved) == 6 and all(v.device.type == "cuda" for v in res.saved),
          "[profiling] the allowSave snapshot on the card")
    nu_res = res.nu_init_residual
    check(nu_res.device.type == "cuda" and bool(torch.isfinite(nu_res).all()),
          "[profiling] the CG nu-initializer's residual")
    kt = kernel_times(lambda: on.solve_many(params, inits=inits, mu0=1e-3, max_iter=100), n=1)
    check(kt is not None, "[profiling] kernel_times saw the hand-written kernels")
    k1 = {k: v for k, v in kt.items() if re.search(r"\bfactor_solve_kernel\b", k)}
    k2 = {k: v for k, v in kt.items() if re.search(r"\bsolve_kernel\b", k)}
    occ1 = sum(v["occ_per_call"] for v in k1.values())
    occ2 = sum(v["occ_per_call"] for v in k2.values())
    check(k1 and k2 and occ1 == lockstep and occ2 == 2 * lockstep,
          f"[profiling] kernel_times: K1 {occ1}, K2 {occ2} launches a solve ({lockstep} "
          f"lockstep iterations): {kt}")
    us1 = sum(v["us_per_occ"] * v["occ_per_call"] for v in k1.values()) / occ1
    us2 = sum(v["us_per_occ"] * v["occ_per_call"] for v in k2.values()) / occ2
    fc = flop_counts(on)
    log(f"[profiling] flagship B={FLEET_B} T={FLEET_T} f32, profiling and allowSave on (built "
        f"in {build:.1f} s): bitwise [slice]'s fleet; wall {wall:.4f} s profiled, "
        f"{slice_wall:.4f} s unprofiled ([slice]), {FLEET_B / wall:.1f} solves/s; history "
        f"{tuple(h.shape)} on {h.device}, rows finite up to iters - 1; nu-init residual max "
        f"{float(nu_res.max()):.3e}; launches {launches}")
    log(f"[profiling] kernel_times: K1 {occ1 / lockstep:.2f} and K2 {occ2 / lockstep:.2f} a "
        f"lockstep iteration, {us1:.2f} and {us2:.2f} us a launch ([profile]: "
        f"{prof_k12[0]:.2f} and {prof_k12[1]:.2f}); all: {kt}")
    log(f"[profiling] flop_counts (a lockstep iteration of one instance): "
        + ", ".join(f"{k} {v:.4g}" for k, v in fc.items()))
    return launches


def _misscaled(ttc, device):
    """tests/test_diagnostics.py:193's problem: a variable on a 1e6-worse
    scale."""
    n = 4
    good, bad, pvar = (ttc.variable("cw_good", (n,)), ttc.variable("cw_bad", (n,)),
                       ttc.variable("cw_p", (n,)))
    J = ttc.norm2(good - pvar) + 1e10 * ttc.norm2(bad) + ttc.norm2(good - 1e4 * bad)
    return ttc.optimize(objective=J, optimizationVariables=[good, bad],
                        constraints=[good >= -2.0, good <= 2.0], parameters=[pvar],
                        allowSave=True, profiling=True, maxIter=40, device=device)


MISSCALED_P = {"cw_p": np.array([0.5, -0.25, 1.0, 0.1])}


def phase_capture_ww(ttc, dl):
    """[capture-ww]: the mis-scaled problem on the card ('fleet', one
    instance: K8/K7): capture_ww at the largest direction error
    localizes the mis-scaled variable, with the iterate and advice the
    port on the CPU gives; WW at it = 2 against the CPU's.  Returns the
    dense kernels' launches of its three solves, and leaves their counts
    at 0."""
    t0 = time.perf_counter()
    card = _misscaled(ttc, None)
    reset_counts(dl)
    cap = card.capture_ww(MISSCALED_P, mu0=1.0)
    cap2 = card.capture_ww(MISSCALED_P, it=2, mu0=1.0)
    launches = dict(dl.LAUNCHES)
    reset_counts(dl)
    seconds = time.perf_counter() - t0
    check(launches["ldl_factor_solve"] > 0 and launches["ldl_solve"] > 0,
          f"[capture-ww] K8 and K7 on the card: {launches}")
    cpu = _misscaled(ttc, "cpu")
    ref, ref2 = cpu.capture_ww(MISSCALED_P, mu0=1.0), cpu.capture_ww(MISSCALED_P, it=2, mu0=1.0)
    rep = cap["report"]["variables"]
    ratio = rep["cw_bad"]["hess_diag_range"][1] / rep["cw_good"]["hess_diag_range"][1]
    check(ratio > 1e6 and any("rescal" in a for a in cap["report"]["advice"]),
          f"[capture-ww] the mis-scaled variable localized ({ratio:.3e})")
    check(cap["it"] == ref["it"] and cap["report"]["advice"] == ref["report"]["advice"],
          f"[capture-ww] it {cap['it']} and advice as the CPU's (it {ref['it']})")
    rel = np.abs(cap2["WW"] - ref2["WW"]).max() / np.abs(ref2["WW"]).max()
    check(cap2["it"] == 2 and rel <= 1e-8, f"[capture-ww] WW at it = 2 against the CPU's: {rel:.3e}")
    log(f"[capture-ww] {card.kkt_backend_resolved} on the card ({seconds:.2f} s, two "
        f"captures): it {cap['it']} (the CPU's {ref['it']}), cw_bad's Hessian diagonal "
        f"{ratio:.3e}x cw_good's, advice {cap['report']['advice']}; WW at it = 2 within "
        f"{rel:.3e} of the CPU's (relative to its largest entry); dense kernels' launches "
        f"{launches}")
    return launches


def phase_distributed(solver, params, inits, flag_res):
    """[distributed]: two processes on cuda:0 in one gloo group, two mesh
    entries each (parallel/distributed_smoke.py): the JAX run's workload
    (the T = 6 fleet, B = 8; the 16-stage 'spike' solve), then the
    flagship fleet (T = 30, B = 1024) split over the four entries: bitwise
    the same instances solved here as one fleet a process (each process's
    two entries share cuda:0, so it solves them as one fleet of 512) and
    the fleet of 1024 with its batched gemv in calls of 512 rows, and
    held against the unsplit fleet of 1024 ([slice]); the workers load
    the libraries this run built and build none."""
    import tempfile

    from tenscalc_tpu_torch.parallel.batch_rounding import ChunkedBmm
    from tenscalc_tpu_torch.parallel.distributed_smoke import run

    ref = numpy_result(flag_res)
    # each process's instances solved here as one fleet: what the split
    # should give bitwise (a fleet of 512 is not bitwise one of 1024: the
    # CG nu-initializer's Gu.v, aten.bmm (B,60,89)@(B,89,1), takes
    # cuBLAS's gemvx kernel at B = 1024 and gemv2N at 512;
    # parallel/batch_rounding.py finds it the only operator whose rows
    # round by the batch's size)
    per_proc = FLEET_B // DIST_NPROC
    local = []
    for r in range(DIST_NPROC):
        idx = np.arange(r * per_proc, (r + 1) * per_proc)
        p, i = fleet_subset(params, inits, solver.namespace, idx)
        local.append(numpy_result(solver.solve_many(p, inits=i, mu0=1e-3, max_iter=100)))
    local = SimpleNamespace(**{k: np.concatenate([getattr(x, k) for x in local])
                               for k in ("u", "status", "iters", "f")})
    # the unsplit fleet with that bmm in calls of 512 rows
    with ChunkedBmm(FLEET_B, per_proc) as cut:
        chunked = numpy_result(solver.solve_many(params, inits=inits, mu0=1e-3, max_iter=100))
    with tempfile.TemporaryDirectory(prefix="tc_dist_") as td:
        t0 = time.perf_counter()
        art = run(nproc=DIST_NPROC, n_local=DIST_LOCAL, device="cuda", flagship_dir=td,
                  timeout=DIST_TIMEOUT)
        seconds = time.perf_counter() - t0
        outs = [np.load(f"{td}/flagship_rank{r}.npz") for r in range(DIST_NPROC)]
        outs = [{k: o[k] for k in o.files} for o in outs]
    ws = art["workers"]
    check(art["ok"] and len(ws) == DIST_NPROC, f"[distributed] both workers ok: {art}")
    for w in ws:
        check(w["device"] == "cuda" and w["n_global"] == DIST_NPROC * DIST_LOCAL
              and w["fleet_converged"] == w["fleet_batch"] == 2 * DIST_NPROC * DIST_LOCAL
              and w["spike_status"] == 0 and w["spike_backend"] == "spike",
              f"[distributed] process {w['process']}: the JAX run's checks: {w}")
        check(w["built"] == [], f"[distributed] process {w['process']} built {w['built']}")
        check(w["flagship_backend"] == "fleet_banded" and w["flagship_u_device"].startswith("cuda"),
              f"[distributed] process {w['process']}: the flagship on the card through K1/K2")
        lock = w["flagship_local_lockstep"]
        lc = w["flagship_launches"]
        check(lc["factor_solve"] == lock and lc["solve"] == 2 * lock,
              f"[distributed] process {w['process']}: K1 1.00, K2 2.00 a lockstep iteration "
              f"of its fleet ({lock}): {lc}")
    dj_spike = abs(ws[0]["spike_J"] - ws[1]["spike_J"])
    check(dj_spike < 1e-12, f"[distributed] the spike's J equal in both processes "
          f"({dj_spike:.3e})")
    check(all(np.array_equal(outs[0][k], o[k]) for o in outs[1:] for k in outs[0]),
          "[distributed] both processes hold the same whole result")
    r = outs[0]
    check(all(np.array_equal(r[k], getattr(local, k)) for k in ("u", "status", "iters", "f")),
          "[distributed] the split flagship bitwise its processes' instances solved here as "
          f"fleets of {per_proc} (max |du| {np.abs(r['u'] - local.u).max():.3e})")
    check(cut.calls > 0 and all(np.array_equal(r[k], getattr(chunked, k))
                                for k in ("u", "status", "iters", "f")),
          f"[distributed] the split flagship bitwise the unsplit fleet of {FLEET_B} solved with "
          f"its batched gemv (aten.bmm, {cut.calls} calls) in calls of {per_proc} rows")
    du = np.abs(r["u"] - ref.u).max(axis=1)
    dj = np.abs(r["f"] - ref.f) / np.abs(ref.f)
    log(f"[distributed] the split flagship against the unsplit fleet of {FLEET_B}: statuses "
        f"{np.bincount(r['status']).tolist()}, iterations differ on "
        f"{int((r['iters'] != ref.iters).sum())} (max {int(np.abs(r['iters'] - ref.iters).max())}), "
        f"max |du| {du.max():.3e} ({int((du > U_ATOL).sum())} above {U_ATOL}), objective rel "
        f"diff max {dj.max():.3e}")
    # that gemv's last bits (3.7e-9 apart) move u by up to 8.3e-3 at
    # objectives 5.2e-5 apart: as at [tridiag], u is not determined to
    # U_ATOL on part of the fleet at the flagship's tolerances, so the
    # objective holds J_RTOL and u STRUCT_U_ATOL against the fleet of 1024
    check((r["status"] == 0).all() and (np.abs(r["iters"] - ref.iters) <= 1).all()
          and (dj <= J_RTOL).all() and (du <= STRUCT_U_ATOL).all(),
          f"[distributed] the split flagship: status 0, iterations within one, objective "
          f"within {J_RTOL} and u within {STRUCT_U_ATOL} of the unsplit fleet")
    log(f"[distributed] {DIST_NPROC} processes x {DIST_LOCAL} entries of cuda:0, gloo on host "
        f"copies, {seconds:.1f} s in all: the T = 6 fleet {ws[0]['fleet_converged']} of "
        f"{ws[0]['fleet_batch']} at status 0 ({ws[0]['fleet_backend']}, K4/K5 launches "
        f"{[w['oracle_launches'] for w in ws]}); the spike at status 0 in "
        f"{ws[0]['spike_iters']} iterations, J {ws[0]['spike_J']!r} in both (|dJ| {dj_spike:.1e}); "
        f"no library built")
    log(f"[distributed] the flagship fleet B={FLEET_B} split over the {DIST_NPROC} processes: "
        f"status 0 for all, bitwise its processes' fleets of {per_proc} solved here and the "
        f"unsplit fleet with its bmm in calls of {per_proc} ({cut.calls} calls); against "
        f"the unsplit fleet max |du| {du.max():.3e}, {int((du == 0).sum())} of {FLEET_B} "
        f"instances bitwise, iterations equal on {int((r['iters'] == ref.iters).sum())}; solves/s "
        f"{[round(w['flagship_solves_per_s'], 1) for w in ws]} (wall "
        f"{[round(w['flagship_wall_s'], 4) for w in ws]} s); K1/K2 launches "
        f"{[w['flagship_launches'] for w in ws]} over "
        f"{[w['flagship_local_lockstep'] for w in ws]} lockstep iterations")
    fb_counts = {k: sum(w["flagship_launches"][k] for w in ws) for k in ws[0]["flagship_launches"]}
    dense_counts = {k: sum(w["oracle_launches"][k] for w in ws) for k in ws[0]["oracle_launches"]}
    return fb_counts, dense_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import tenscalc_tpu_torch as ttc
    from tenscalc_tpu_torch import native
    from tenscalc_tpu_torch._build import build_log
    from tenscalc_tpu_torch.examples import mpc_dcmotor as mpc
    from tenscalc_tpu_torch.examples import mpcmhe_dcmotor as mm
    from tenscalc_tpu_torch.examples import sls
    from tenscalc_tpu_torch.kkt import banded_lu as lu
    from tenscalc_tpu_torch.kkt import dense_ldl as dl
    from tenscalc_tpu_torch.kkt import fleet as fl
    from tenscalc_tpu_torch.kkt import fleet_banded as fb
    from tenscalc_tpu_torch.kkt import pallas_ldl as pl

    card = card_line()
    log(f"[setup] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t_start = t0 = time.perf_counter()

    def elapsed(what: str) -> None:
        log(f"[time] {time.perf_counter() - t_start:.1f} s from the start to {what}")

    with ThreadPoolExecutor(max_workers=4) as pool:
        for f in [pool.submit(fb._load), pool.submit(lu._load),
                  pool.submit(dl._load), pool.submit(native._load)]:
            f.result()
    log(f"[setup] native sources built in {time.perf_counter() - t0:.1f} s")
    log(f"[setup] ptxas, csrc/fleet_banded.cu: no spills at w=1..{fb.MAX_W} on either "
        f"route; registers a thread at w=4: {ptxas_report(fb, 4, ('staged', 'ring'))}; "
        f"at w=16: {ptxas_report(fb, 16, ('staged', 'ring'))}; on the wide route at "
        f"capacity 31 (w = 24..31): {ptxas_report(fb, 31, ('staged', 'ring'))}; at 63: "
        f"{ptxas_report(fb, 63, ('staged', 'ring'))}")
    log(f"[setup] ptxas, csrc/banded_lu.cu: no spills at w=1..{lu.MAX_W} on either "
        f"route; registers a thread at w=10: "
        f"{ptxas_report(lu, 10, ('staged', 'ring'))}; at w=22: "
        f"{ptxas_report(lu, 22, ('staged', 'ring'))}; at w=31: "
        f"{ptxas_report(lu, 31, ('staged', 'ring'))}; two rows a lane at capacity 63: "
        f"{ptxas_report(lu, 63, ('staged', 'ring'))}")
    dense_regs = dense_ptxas_report(build_log(dl.LIB_PATH), -(-dl.FLEET_MAX_N // 32))
    log(f"[setup] ptxas, csrc/dense_ldl.cu: no spills; registers a thread: {dense_regs}")

    elapsed("the kernels")
    recs = phase_kernels(fb)
    elapsed("K1-K3's wide route")
    phase_wide_kernels(fb, recs)
    elapsed("the block route")
    block_rows = phase_block_kernels(fb, lu)

    # the quadcopter fleet: its KKT (the large Newton matrix) assembled
    # densely at every iterate, K1/K2 on the wide route; its CPU
    # cross-check runs in a process of its own beside the later phases
    from tenscalc_tpu_torch.examples import mpc_quadcopter

    elapsed("the quadcopter slice")
    csolver, cparams, cinits, cres, quad_launches, quad_wall, clock = phase_quadcopter(
        mpc_quadcopter, fb, (lu, dl))
    quad_check = start_quadcopter_cross_check(cparams, cinits, cres)
    elapsed("[profile9]")
    cwall, cbusy, _ = phase_profile("profile9", lambda: csolver.solve_many(
        cparams, inits=cinits, mu0=1e-1, max_iter=PROFILE9_ITERS),
        watch=(("K1", r"\bfactor_solve_wide_kernel<"), ("K2", r"\bsolve_wide_kernel<")),
        host_ops=False)
    log(f"[profile9] the quadcopter fleet, its first {PROFILE9_ITERS} iterations: device "
        f"kernel time {cbusy:.4f} s, {1e3 * cbusy / PROFILE9_ITERS:.2f} ms a lockstep "
        f"iteration; host {1e3 * cwall / PROFILE9_ITERS:.1f} ms a lockstep iteration profiled "
        f"({1e3 * quad_wall / clock:.1f} unprofiled over the whole solve)")
    del csolver

    # the deconvolution fleet (K1/K2 on the block route), its CPU
    # cross-check beside the later phases, and its game (K9/K10)
    elapsed("the deconvolution fleet")
    dsolver, dparams, dinits, dres, dc_launches, dc_wall, dc_lock = phase_deconv(
        ttc, fb, (lu, dl))
    # the CPU sides of [deconv] and [tutorials] run beside the game, whose
    # lockstep iterations keep the card busy and the host waiting
    dc_idx, dc_p, dc_i = deconv_cross_check_inputs(dparams, dinits, dres)
    deconv_side = start_cpu_side(deconv_cpu, dc_p, dc_i)
    tutorials_side = start_cpu_side(tutorials_cpu)
    pwall, pbusy, dshares = phase_profile("profile10", lambda: dsolver.solve_many(
        dparams, inits=dinits, mu0=1.0, max_iter=DC_MAX_ITER),
        watch=(("K1's factor (factor_block_kernel)", r"\bfactor_block_kernel\b"),
               ("K2 and K1's solve (solve_block_kernel)", r"\bsolve_block_kernel<")),
        host_ops=False)
    log(f"[profile10] the deconvolution fleet: device kernel time {pbusy:.4f} s a solve, "
        f"{1e3 * pbusy / dc_lock:.2f} ms a lockstep iteration; host "
        f"{1e3 * dc_wall / dc_lock:.1f} ms a lockstep iteration unprofiled "
        f"({1e3 * pwall / dc_lock:.1f} profiled)")
    log(f"[deconv] the fleet's kernels' device shares ([profile10]): K1's factor "
        f"{dshares[0]:.4f}, the solves (K1's and K2's, one kernel) {dshares[1]:.4f}; "
        f"K1 and K2 together {sum(dshares):.4f}")
    del dsolver
    elapsed("the deconvolution game")
    gsolver, gparams, ginits, dg_launches, dg_wall, dg_lock = phase_deconv_game(
        ttc, lu, (fb, dl), dres)
    gwall, gbusy, _ = phase_profile("profile11", lambda: gsolver.solve_many(
        gparams, inits=ginits, mu0=1.0, max_iter=PROFILE11_ITERS),
        watch=(("K9's factor (lu_factor_block_kernel)", r"\blu_factor_block_kernel\b"),
               ("K10 and K9's solve (lu_solve_block_kernel)", r"\blu_solve_block_kernel\b")),
        host_ops=False)
    log(f"[profile11] the deconvolution game, its first {PROFILE11_ITERS} iterations: device "
        f"kernel time {gbusy:.4f} s, {1e3 * gbusy / PROFILE11_ITERS:.2f} ms a lockstep "
        f"iteration; host {1e3 * gwall / PROFILE11_ITERS:.1f} ms a lockstep iteration "
        f"profiled ({1e3 * dg_wall / dg_lock:.1f} unprofiled over the whole solve)")
    del gsolver
    torch.cuda.empty_cache()
    # slice 19, its CPU sides beside the later phases: bench.py's l1l2 row
    # and a fleet of 1024 estimations (K1/K2 on the lane route), one Lasso
    # fit (K8/K7 at n = 401), the apps
    from tenscalc_tpu_torch.examples import l1l2estimation as l12

    elapsed("the l1l2 slice")
    lsolver, lparams, linit, lsol, l12_launches = phase_l1l2(l12, fb, (lu, dl))
    l12_side = start_cpu_side(l1l2_cpu, lparams, linit)
    lfparams, lfinits, lfres, l12f_launches, lf_wall, lf_lock, lbands = phase_l1l2_fleet(
        lsolver, l12, fb, (lu, dl))
    l12f_side = start_cpu_side(l1l2_fleet_cpu, *l1l2_fleet_cross_check_inputs(lfparams, lfinits))
    lpwall, lpbusy, lshares = phase_profile("profile12", lambda: lsolver.solve_many(
        lfparams, inits=lfinits, mu0=l12.BENCH_MU0, max_iter=l12.BENCH_MAX_ITER),
        watch=(("K1", r"\bfactor_solve_kernel<"), ("K2", r"\bsolve_kernel<")), host_ops=False)
    log(f"[profile12] the l1l2 fleet: device kernel time {lpbusy:.4f} s a solve, "
        f"{1e3 * lpbusy / lf_lock:.2f} ms a lockstep iteration; host "
        f"{1e3 * lf_wall / lf_lock:.1f} ms a lockstep iteration unprofiled "
        f"({1e3 * lpwall / lf_lock:.1f} profiled); K1 {lshares[0]:.4f} and K2 {lshares[1]:.4f} "
        f"of the device time")
    l12_pos = lsolver.packing.slice_of("bl12_position")
    del lsolver
    phase_l1l2_kernels(fb, recs, lbands)
    del lbands
    torch.cuda.empty_cache()
    elapsed("[lasso]")
    lasso_sol, lasso_launches = phase_lasso(ttc, dl, (fb, lu))
    lasso_side = start_cpu_side(lasso_cpu)
    elapsed("[apps]")
    apps_card, apps_launches = phase_apps(ttc, fb, lu, dl)
    apps_side = start_cpu_side(apps_cpu, apps_card["sysid"][0])
    reset_counts(fb, lu, dl)  # the later phases read their counts from 0
    elapsed("the rest of the API")
    phase_api(mpc)
    elapsed("the tutorials")
    tutorials_card = phase_tutorials(ttc)

    solver, params, inits, res, launches, entry_launches, slice_wall = phase_slice(mpc, fb, lu)
    check(not any(dl.LAUNCHES.values()), "no dense kernel on the flagship path")
    # every cross-check's CPU side runs in a process of its own beside the
    # later phases; each is held at the end
    flagship_side = start_cpu_side(flagship_cpu, params, inits)
    _, pbusy0, pshares0 = phase_profile("profile", lambda: solver.solve_many(
        params, inits=inits, mu0=1e-3, max_iter=100),
        watch=(("K1", r"\bfactor_solve_kernel<"), ("K2", r"\bsolve_kernel<")))
    # [profile]'s K1 and K2 device us a launch, for [profiling]'s kernel_times
    prof_k12 = (pshares0[0] * pbusy0 * 1e6 / launches["factor_solve"],
                pshares0[1] * pbusy0 * 1e6 / launches["solve"])

    # slice 20: the structured backends and the mesh paths, their CPU
    # sides beside the later phases
    kmods = (fb, lu, dl)
    elapsed("slice 20's [tridiag]")
    tri_res, tri_side = phase_tridiag(ttc, mpc, res, kmods)
    elapsed("[minmax-tridiag]")
    mmt_res, mmt_side = phase_minmax_tridiag(ttc, kmods)
    elapsed("[auto-cpu-branch]")
    acb_sol, acb_side = phase_auto_cpu_branch(ttc, kmods)
    elapsed("[cyclic]")
    cyc_res, cyc_side = phase_cyclic(mpc, kmods)
    elapsed("[spike]")
    spk_res, spk_side = phase_spike(mpc, kmods)
    elapsed("[mesh]")
    mesh_launches = phase_mesh(mpc, solver, params, inits, res, fb, kmods)
    torch.cuda.empty_cache()

    # the tooling and the run across processes
    elapsed("the tooling's [profiling]")
    prof_launches = phase_profiling(mpc, fb, lu, solver, params, inits, res, slice_wall,
                                    prof_k12)
    elapsed("[capture-ww]")
    cap_launches = phase_capture_ww(ttc, dl)
    elapsed("[distributed]")
    dist_fb, dist_dense = phase_distributed(solver, params, inits, res)
    torch.cuda.empty_cache()

    elapsed("slice 2")
    lu_recs = phase_lu_kernels(lu)
    phase_wide_lu_kernels(lu, lu_recs)
    msolver, mparams, mres, lu_launches, lu_entry_launches = phase_mpcmhe(mm, fb, lu)
    check(not any(dl.LAUNCHES.values()), "no dense kernel on the MPC-MHE path")
    mmhe_card = numpy_result(mres, MMHE_CHECKS)
    mmhe_side = start_cpu_side(mpcmhe_cpu, mparams, mmhe_card)
    phase_profile("profile2", lambda: msolver.solve_many(
        mparams, mu0=1e-3, max_iter=100))

    # slice 3: the dense KKT path (sls constrained least squares)
    elapsed("slice 3")
    dense_recs = phase_dense_kernels(dl, fl, pl)
    elapsed("[sls-single]")
    single_launches = phase_sls_single(sls, dl, (fb, lu))
    ssolver, sdata, sres, fleet_launches = phase_sls_fleet(
        "sls-fleet", sls, dl, (fb, lu), "slsf_", SLS_B, SLS_N, seed=0)
    check(fleet_launches["fleet_factor"] > 0 and fleet_launches["fleet_solve"] > 0
          and fleet_launches["ldl_factor"] == fleet_launches["ldl_solve"]
          == fleet_launches["ldl_factor_solve"] == 0,
          f"the sls fleet through K4 and K5 alone: {fleet_launches}")
    sls_side = start_cpu_side(sls_cpu, {k: v[SLS_CHECKS] for k, v in sdata.items()})
    wsolver, _, _, wide_launches = phase_sls_fleet(
        "sls-wide", sls, dl, (fb, lu), "slsw_", SLS_B, WIDE_N, seed=1)
    check(wsolver.kkt_backend_resolved == "fleet" and wsolver.kkt_plan is None
          and wide_launches["fleet_factor"] > 0 and wide_launches["fleet_solve"] > 0,
          f"n={WIDE_N} unbanded through K4/K5: {wide_launches}")
    elapsed("[sls-pallas]")
    pallas_launches = phase_sls_pallas(sls, dl, (fb, lu))
    elapsed("[profile3]")
    phase_profile("profile3", lambda: solve_sls_fleet(ssolver, "slsf_", sdata))

    # the min-max slice: K1/K2 on the saddle KKT, K3 on the HessD inertia
    elapsed("the min-max slice")
    mmsolver, mmparams, mminits, mmres, mm_launches = phase_minmax(ttc, fb, (lu, dl))
    minmax_side = start_cpu_side(minmax_cpu, mmparams, mminits)
    elapsed("[profile4]")
    phase_profile("profile4", lambda: mmsolver.solve_many(
        mmparams, inits=mminits, mu0=1.0, max_iter=60),
        watch=(("K1", r"\bfactor_solve_kernel<"), ("K2", r"\bsolve_kernel<"),
               ("K3", r"\bfactor_kernel<")))

    # the nonlinear unicycle fleet: the per-iteration band mode, K1/K2
    from tenscalc_tpu_torch.examples import mpc_unicycle

    elapsed("the unicycle slice")
    usolver, uparams, uinits, ures, uni_launches, uwall, ulock = phase_unicycle(
        mpc_unicycle, fb, (lu, dl))
    uni_card = numpy_result(ures, UNI_CHECKS)
    uni_side = start_cpu_side(nonconvex_cpu, "mpc_unicycle", {"T": UNI_T, "ns": "buni_"},
                              UNI_CHECKS, uparams, uinits, uni_card, 200)
    elapsed("[profile7]")
    pwall, pbusy, _ = phase_profile("profile7", lambda: usolver.solve_many(
        uparams, inits=uinits, mu0=1e-1, max_iter=PROFILE7_ITERS),
        watch=(("K1", r"\bfactor_solve_kernel<"), ("K2", r"\bsolve_kernel<")), host_ops=False)
    log(f"[profile7] the unicycle fleet, its first {PROFILE7_ITERS} iterations: device kernel "
        f"time {pbusy:.4f} s, {1e3 * pbusy / PROFILE7_ITERS:.2f} ms a lockstep iteration; host "
        f"{1e3 * pwall / PROFILE7_ITERS:.1f} ms a lockstep iteration profiled "
        f"({1e3 * uwall / ulock:.1f} unprofiled over the whole solve)")

    # the nonlinear MPC-MHE pursuit fleet: its KKT assembled densely at
    # every iterate, K9/K10
    from tenscalc_tpu_torch.examples import mpcmhe_unicycle

    elapsed("the pursuit slice")
    psolver, pparams, pinits, pres, pur_launches, pur_wall, plock = phase_pursuit(
        mpcmhe_unicycle, lu, (fb, dl))
    pur_card = numpy_result(pres, PUR_CHECKS)
    pur_side = start_cpu_side(nonconvex_cpu, "mpcmhe_unicycle",
                              {"T": PUR_T, "L": PUR_L, "ns": "pur_"}, PUR_CHECKS, pparams,
                              pinits, pur_card, 300)
    elapsed("[profile8]")
    qwall, qbusy, _ = phase_profile("profile8", lambda: psolver.solve_many(
        pparams, inits=pinits, mu0=1e-1, max_iter=300),
        watch=(("K9", r"\blu_factor_solve_kernel<"), ("K10", r"\blu_solve_kernel<")),
        host_ops=False)
    log(f"[profile8] the pursuit fleet: device kernel time {qbusy:.4f} s a solve, "
        f"{1e3 * qbusy / plock:.2f} ms a lockstep iteration; host {1e3 * pur_wall / plock:.1f} "
        f"ms a lockstep iteration unprofiled ({1e3 * qwall / plock:.1f} profiled)")

    # the slice of problems without inequalities: K8/K7 on one instance's
    # dense KKT up to 896 rows, the blocked LDL^T above
    from tenscalc_tpu_torch.examples import flops, slseq

    elapsed("the slice without inequalities")
    flops_launches, (fsolver, fparams, finit) = phase_flops(flops, dl, (fb, lu))
    phase_flops_backends(flops, dl, (fb, lu))
    phase_flops_cross_check(flops)
    from tenscalc_tpu_torch.examples import mls

    mls_launches = phase_mls(mls, dl, (fb, lu))
    slseq_launches, qsolver, qparams, qinit = phase_slseq(slseq, dl, (fb, lu))
    # the tiles route: K8's factor launches, K8's solve, K7
    k87 = (("K8's factor (tile_factor_kernel)", r"\btile_factor_kernel\b"),
           ("K8's solve (tile_solve_kernel<8>)", r"\btile_solve_kernel<8>"),
           ("K7 (tile_solve_kernel<7>)", r"\btile_solve_kernel<7>"))
    phase_profile("profile5", lambda: fsolver.solve(fparams, init=finit, mu0=1.0,
                                                    max_iter=60), watch=k87)
    phase_profile("profile6", lambda: qsolver.solve(qparams, init=qinit, mu0=1.0,
                                                    max_iter=60), watch=k87)


    # launches: the count on the path that runs the kernel;
    # entry_point_launches: the count of the separate drive of a kernel
    # that no main path runs; ms: host launch overhead included, as the
    # first kernels were timed; device_ms: the device's time alone
    def entry(name, source, replaces, n_launch, n_entry, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "entry_point_launches": n_entry,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "device_ms": rec["device_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
                **({"main_shapes": rec["main_shapes"]} if "main_shapes" in rec else {})}

    dense_launches = {
        "fleet_factor": fleet_launches["fleet_factor"],
        "fleet_solve": fleet_launches["fleet_solve"],
        "ldl_factor": pallas_launches["ldl_factor"],
        # K7/K8: every one-instance path that runs them, each read alone:
        # the sls single solves, the flops curve, mls, slseq and the Lasso
        **{k: single_launches[k] + flops_launches[k] + mls_launches[k] + slseq_launches[k]
           + lasso_launches[k] for k in ("ldl_solve", "ldl_factor_solve")},
    }
    # K1/K2: the flagship's counts and shapes (the min-max path's counts
    # are in its [minmax] line); K3: the min-max HessD inertia, its only
    # main-path caller, at the shape that path gives it
    fb_launches = {**launches, "factor": mm_launches["factor"]}
    fb_paths = {"flagship": launches, "mesh": mesh_launches, "profiling": prof_launches,
                "distributed": dist_fb, "minmax": mm_launches,
                "unicycle": uni_launches,
                "quadcopter": quad_launches, "deconv": dc_launches, "l1l2": l12_launches,
                "l1l2_fleet": l12f_launches,
                **{f"app_{p}": {k: c.get(k, 0) for k in fb.LAUNCHES}
                   for p, c in apps_launches.items()}}
    # block_route: each kernel's rows at BLOCK_SHAPES ([block-kernels])
    kernels = [
        {**entry(NAMES[k], SOURCE, REPLACES[k], fb_launches[k], entry_launches.get(k), recs[k]),
         "launches_by_path": {p: c.get(k, 0) for p, c in fb_paths.items()},
         "block_route": block_rows[k]}
        for k in ("factor_solve", "solve", "factor")
    ] + [
        {**entry(DENSE_NAMES[k], DENSE_SOURCE, DENSE_REPLACES[k], dense_launches[k], None,
                 dense_recs[k]),
         **({"launches_by_path": {"sls_fleet": fleet_launches[k], "sls_wide": wide_launches[k],
                                  "distributed_oracle": dist_dense[k]}}
            if k in ("fleet_factor", "fleet_solve") else {}),
         **({"launches_by_path": {"sls_single": single_launches[k], "flops": flops_launches[k],
                                  "mls": mls_launches[k], "slseq": slseq_launches[k],
                                  "lasso": lasso_launches[k], "capture_ww": cap_launches[k]}}
            if k in ("ldl_solve", "ldl_factor_solve") else {})}
        for k in DENSE_REPLACES
    ] + [
        {**entry(LU_NAMES[k], LU_SOURCE, LU_REPLACES[k], lu_launches[k],
                 lu_entry_launches.get(k), lu_recs[k]),
         "launches_by_path": {"mpcmhe": lu_launches[k], "pursuit": pur_launches[k],
                              "deconv_game": dg_launches[k],
                              "app_mpcmhe": apps_launches["mpcmhe"].get(k, 0)},
         "block_route": block_rows[k]}
        for k in ("lu_factor_solve", "lu_solve", "lu_factor")
    ]
    elapsed("the CPU sides")
    phase_cross_check(collect_cpu_side(flagship_side), res)
    phase_mpcmhe_cross_check(collect_cpu_side(mmhe_side), mmhe_card, msolver.opts)
    phase_sls_cross_check(collect_cpu_side(sls_side), sres)
    phase_minmax_cross_check(collect_cpu_side(minmax_side), mmres)
    phase_unicycle_cross_check(collect_cpu_side(uni_side), uni_card)
    phase_pursuit_cross_check(collect_cpu_side(pur_side), pur_card)
    finish_deconv_cross_check(dc_idx, collect_cpu_side(deconv_side), dres)
    finish_tutorials(tutorials_card, collect_cpu_side(tutorials_side))
    finish_quadcopter_cross_check(*quad_check)
    finish_l1l2_cross_check(collect_cpu_side(l12_side), lsol)
    finish_l1l2_fleet_cross_check(collect_cpu_side(l12f_side), lfres, l12_pos)
    finish_lasso_cross_check(collect_cpu_side(lasso_side), lasso_sol)
    finish_apps(apps_card, collect_cpu_side(apps_side))
    finish_struct_cross_check("tridiag", collect_cpu_side(tri_side), tri_res, STRUCT_CHECKS,
                              f64=False, u_atol=STRUCT_U_ATOL)
    finish_struct_cross_check("minmax-tridiag", collect_cpu_side(mmt_side), mmt_res, MM_CHECKS,
                              f64=False, u_cols=MM_N)
    finish_auto_cpu_branch(collect_cpu_side(acb_side), acb_sol)
    finish_struct_cross_check("cyclic", collect_cpu_side(cyc_side), cyc_res, STRUCT_CHECKS,
                              f64=True, u_atol=STRUCT_U_ATOL)
    finish_struct_cross_check("spike", collect_cpu_side(spk_side), spk_res, STRUCT_CHECKS,
                              f64=False)
    elapsed("the end")
    print(json.dumps({"kernels": kernels}))
    print(card_line(fresh=True))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:  # a failed phase leaves no CPU side running
        for cpu_pool in CPU_POOLS:
            cpu_pool.terminate()
    sys.exit(code)
