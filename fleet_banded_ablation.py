"""Design choices of csrc/fleet_banded.cu (K1 factor+solve, K2 solve, K3
factor), each undone in turn and timed against the design on one NVIDIA
card; or the design against another commit's source.

    python3 fleet_banded_ablation.py [--parent PATH]

Each variant is the CUDA source with one textual edit (named below and
checked to apply), built with nvcc at w = 4 alone and launched on the
flagship fleet's shape (B = 1024, n = 149, w = 4) with the binding's
launch plan.  Times are device times alone (CUDA events after the card
spins, median of 40 calls, as chip_smoke.py's ``device_ms``); every variant
that computes the kernels' function is held bitwise against the plain
versions.  The design is also timed over n, whose slope and intercept
split a launch into its per-row and fixed costs.  ``--parent`` instead
times the design against another commit's fleet_banded.cu with the same
C entries (for instance ``git show <commit>:tenscalc_tpu_torch/csrc/
fleet_banded.cu`` written into the git-ignored ``_scratch/``), both built
at the narrow widths of PARENT_SHAPES, in the order design, parent,
parent, design at each shape, every launch held bitwise against the
plain versions.  Prints the card's name and power limit and one JSON
line of the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "tenscalc_tpu_torch" / "csrc" / "fleet_banded.cu"
SHAPE = (1024, 149, 4)
CLAMP = 1e-7
# the narrow route's main paths (the flagship fleet, the min-max saddle
# and the nonlinear unicycle fleet) and the wide route's (the quadcopter)
PARENT_SHAPES = [(1024, 149, 4), (1024, 480, 6), (512, 439, 9), (512, 286, 30)]

# name -> (edits of the source, chunk rows, ring rows, exact): each edit
# (old, new) must apply; `exact` variants compute the kernels' function
VARIANTS = {
    "design": ([], None, None, True),
    # every quotient by __fdiv_rn, one after another (the first design)
    "fdiv": ([("  return W <= 8;", "  return false;")], None, None, True),
    # the moderate-range checks with short circuits (compiled to branches)
    "branchy checks": ([("  return (a >= 0x1p-60f) & (a <= 0x1p60f);",
                         "  return a >= 0x1p-60f && a <= 0x1p60f;"),
                        ("  return (x == 0.0f) | moderate(x);",
                         "  return x == 0.0f || moderate(x);"),
                        ("      fast &= fast_numerator(win[0][k]);",
                         "      fast = fast && fast_numerator(win[0][k]);")],
                       None, None, True),
    # __frcp_rn, with its range check and slow path, for the reciprocal
    "frcp_rn": ([('  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d));\n'
                  '  return __fmaf_rn(y, __fmaf_rn(-d, y, 1.0f), y);',
                  "  y = __frcp_rn(d);\n  return y;")], None, None, True),
    # the sweeps' rows loaded five steps before their own, not two
    "sweeps 4 ahead": ([("constexpr int kAhead = 1;", "constexpr int kAhead = 4;")],
                       None, None, True),
    # chunks of 32 rows, a ring of 128
    "chunk 32": ([], 32, 128, True),
    # the staging, copies and stores alone: no elimination, no sweeps
    "no chain": ([("if (chain)", "if (false)")], None, None, False),
}


def variant_source(edits, src=None, widths=(4,)) -> str:
    src = SOURCE.read_text() if src is None else src
    src, n = re.subn(r"#define TC_FOR_EACH_W\(X\) \\\n.*\n.*\n",
                     "#define TC_FOR_EACH_W(X) " + " ".join(f"X({w})" for w in widths)
                     + "\n", src)
    assert n == 1, "the width list moved"
    for old, new in edits:
        assert old in src, f"the edit {old!r} does not apply"
        src = src.replace(old, new)
    return src


def build(name: str, fb, out: Path, text=None) -> ctypes.CDLL:
    """The library of variant ``name``, or of source ``text`` when given."""
    edits, chunk, ring, _ = VARIANTS.get(name, ([], None, None, True))
    src = out / (re.sub(r"\W", "_", name) + ".cu")
    src.write_text(variant_source(edits) if text is None else text)
    lib = src.with_suffix(".so")
    subprocess.run(
        ["/usr/local/cuda/bin/nvcc", *fb.NVCC_FLAGS,
         f"-DTC_FB_CHUNK_ROWS={chunk or fb.CHUNK_ROWS}",
         f"-DTC_FB_RING_ROWS={ring or fb.RING_ROWS}",
         f"-DTC_FB_MAX_GROUP={fb.MAX_GROUP}", f"-DTC_FB_SMEM_MAX={fb.SMEM_MAX}",
         "-o", str(lib), str(src)], check=True, capture_output=True, timeout=600)
    h = ctypes.CDLL(str(lib))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.tc_fleet_banded_factor_solve.argtypes = [I, I, I, I, I, P, P, P, P, I, I, Fl, P]
    h.tc_fleet_banded_solve.argtypes = [I, I, I, I, I, P, P, P, I, I, P]
    h.tc_fleet_banded_factor.argtypes = [I, I, I, I, I, P, P, I, I, Fl, P]
    assert h.tc_fleet_banded_init() == 0
    return h


def kernels(h, fb, band, rhs, fband):
    """K1, K2, K3 of library ``h`` on these inputs, with their outputs."""
    B, n, R = band.shape
    w = R - 1
    plan = fb.launch_plan(n, w, B, torch.cuda.get_device_properties(0).multi_processor_count)
    a = (w, int(plan.ring), plan.group, plan.rows, plan.stride)
    f, x = torch.empty_like(band), torch.empty_like(rhs)
    s = torch.cuda.current_stream().cuda_stream
    return (
        lambda: h.tc_fleet_banded_factor_solve(*a, band.data_ptr(), rhs.data_ptr(),
                                               f.data_ptr(), x.data_ptr(), n, B, CLAMP, s),
        lambda: h.tc_fleet_banded_solve(*a, fband.data_ptr(), rhs.data_ptr(),
                                        x.data_ptr(), n, B, s),
        lambda: h.tc_fleet_banded_factor(*a, band.data_ptr(), f.data_ptr(), n, B, CLAMP, s),
    ), f, x


def against_parent(fb, parent: Path) -> dict:
    """Device ms of K1/K2/K3, design and parent in the order design,
    parent, parent, design at each of PARENT_SHAPES (the narrow route's
    widths instantiated alone; the wide route's capacities as they are)."""
    widths = sorted({w for _, _, w in PARENT_SHAPES if w <= fb.NARROW_W})
    texts = {"design": variant_source([], widths=widths),
             "parent": variant_source([], parent.read_text(), widths)}
    times = {name: {} for name in texts}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        libs = dict(zip(texts, pool.map(lambda kv: build(kv[0], fb, Path(tmp), kv[1]),
                                        texts.items())))
        for B, n, w in PARENT_SHAPES:
            band, rhs = cs.test_band(B, n, w, seed=n + w)
            pf, px = fb.fleet_banded_factor_solve_plain(band, rhs, w, CLAMP)
            px2 = fb.fleet_banded_solve_plain(pf, rhs, w)
            runs = {name: kernels(h, fb, band, rhs, pf) for name, h in libs.items()}
            for name, (ks, f, x) in runs.items():
                for k, want in zip(ks, ((pf, px), (None, px2), (pf, None))):
                    assert k() == 0
                    torch.cuda.synchronize()
                    cs.check(all(torch.equal(o, p) for o, p in zip((f, x), want)
                                 if p is not None),
                             f"{name} at {(B, n, w)}: bitwise against the plain versions")
            got = {name: [] for name in texts}
            for name in ("design", "parent", "parent", "design"):
                got[name].append([cs.cuda_ms(k, 40, spin=True) for k in runs[name][0]])
            for name, pair in got.items():
                times[name][f"{B},{n},{w}"] = pair
                cs.log(f"[ablation] {name} B={B} n={n} w={w}: K1/K2/K3 device ms "
                       + "; ".join("/".join(f"{t:.4f}" for t in ts) for ts in pair))
            d, p = ([sum(ts[i] for ts in got[nm]) / 2 for i in range(3)]
                    for nm in ("design", "parent"))
            cs.log(f"[ablation] B={B} n={n} w={w}: design / parent K1 {d[0] / p[0]:.4f}, "
                   f"K2 {d[1] / p[1]:.4f}, K3 {d[2] / p[2]:.4f}")
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another commit's fleet_banded.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fleet_banded_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from tenscalc_tpu_torch.kkt import fleet_banded as fb

    card = cs.card_line()
    if args.parent is not None:
        print(json.dumps({"device_ms": against_parent(fb, args.parent)}))
        print(card)
        return 0
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda v: build(v, fb, Path(tmp)), VARIANTS)))
        B, n, w = SHAPE
        band, rhs = cs.test_band(B, n, w, seed=n + w)
        pf, px = fb.fleet_banded_factor_solve_plain(band, rhs, w, CLAMP)
        px2 = fb.fleet_banded_solve_plain(pf, rhs, w)
        times = {}
        for name, h in libs.items():
            ks, f, x = kernels(h, fb, band, rhs, pf)
            if VARIANTS[name][3]:
                for k, want in zip(ks, ((pf, px), (None, px2), (pf, None))):
                    assert k() == 0
                    torch.cuda.synchronize()
                    cs.check(all(torch.equal(o, p) for o, p in zip((f, x), want)
                                 if p is not None), f"{name}: bitwise against the plain versions")
            times[name] = [cs.cuda_ms(k, 40, spin=True) for k in ks]
            cs.log(f"[ablation] {name}: K1/K2/K3 device ms "
                   + "/".join(f"{t:.4f}" for t in times[name]))
        by_n = {}
        for nn in (32, 64, 149, 298, 596):
            bb, rr = cs.test_band(B, nn, w, seed=nn)
            fn, _ = fb.fleet_banded_factor_solve_plain(bb, rr, w, CLAMP)
            ks, _, _ = kernels(libs["design"], fb, bb, rr, fn)
            by_n[nn] = [cs.cuda_ms(k, 20, spin=True) for k in ks]
        for i, k in enumerate(("K1", "K2", "K3")):
            slope = (by_n[596][i] - by_n[298][i]) / 298
            cs.log(f"[ablation] design {k} over n at B={B} w={w}: "
                   + ", ".join(f"n={nn} {t[i]:.4f}" for nn, t in by_n.items())
                   + f" ms; {slope * 1e6:.1f} ns a row, {by_n[298][i] - 298 * slope:.4f} ms"
                   " at n = 0")
    print(json.dumps({"shape": SHAPE, "device_ms": times, "design_by_n": by_n}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
