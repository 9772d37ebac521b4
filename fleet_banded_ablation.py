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
plain versions; the parent's block route (w > 63) runs at its own plan
(a CTA an instance, group 1, no panel).  ``--plans`` times the design's
block route at each of BLOCK_SHAPES over its plans: K1 and K3 over the
factor's panel steps and a factor CTA's threads, K2 over the solve's
instances a CTA, every launch held bitwise.  Prints the card's name and
power limit and one JSON line of the times.
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
# the block route's shapes (the deconvolution fleet's first) and the
# widest that the warp solve takes; --parent times them after PARENT_SHAPES
BLOCK_SHAPES = [*cs.BLOCK_SHAPES, (2, 4100, 1024)]
# --plans: panel steps and threads a factor CTA (K1, K3), solve instances
# a CTA (K2)
PLAN_PANELS = (16, 24, 32, 48, 64)
PLAN_THREADS = (128, 256, 384, 512)
PLAN_GROUPS = (1, 2, 4)
# --plans: design choices of the block route's factor, each undone in
# turn and timed at the plan on BLOCK_SHAPES[0]; `exact` variants compute
# the kernels' function
BLOCK_VARIANTS = {
    # every thread forms the pivot beside its own entry (the two chains
    # in one loop), divides at once and thread 0 stores d: one block
    # barrier a step
    "one barrier a step": ([
        ("""    for (int k = t; k <= w; k += T) {
      const int i0 = max(0, j + k - w);
      const float* a = sm + i0 * S1 + j + k;   // r_{j-i+k} of slot i
      const float* b = sm + i0 * S1 + bU + j;  // e_{j-i} of slot i
      float v = row[k];
#pragma unroll 4
      for (int i = i0; i < j; ++i, a += S1, b += S1) v = __fsub_rn(v, __fmul_rn(*b, *a));
      row[k] = k == 0 ? clamp_pivot(v, clamp) : v;
    }
    __syncthreads();  // the pivot and the row's products are in place
    const float d = row[0];
    for (int k = 1 + t; k <= w; k += T) {
      const float r = __fdiv_rn(row[k], d);
      row[k] = r;
      row[bU + k] = __fmul_rn(d, r);
    }
    __syncthreads();""",
         """    const float p0 = row[0];
    float d = 0.0f;
    for (int k = 1 + t; k <= w; k += T) {
      const int i0 = j + k - w;
      const float* a = sm + j;
      const float* b = sm + bU + j;
      float p = p0, v = row[k];
      for (int i = 0; i < j; ++i, a += S1, b += S1) {
        const float e = *b;
        p = __fsub_rn(p, __fmul_rn(e, *a));
        const float u = __fsub_rn(v, __fmul_rn(e, a[k]));
        v = i >= i0 ? u : v;
      }
      d = clamp_pivot(p, clamp);
      const float r = __fdiv_rn(v, d);
      row[k] = r;
      row[bU + k] = __fmul_rn(d, r);
    }
    __syncthreads();
    if (t == 0) row[0] = d;"""),
        ("""  for (int e = threadIdx.x; e < np * R; e += blockDim.x) {
    const int j = e / R;
    dst[e] = sm[j * S + e - j * R];
  }""",
         """  __syncthreads();
  for (int e = threadIdx.x; e < np * R; e += blockDim.x) {
    const int j = e / R;
    dst[e] = sm[j * S + e - j * R];
  }""")], True),
    # the left-looking loop as written, unrolled as the compiler chooses
    "loop not unrolled": ([("#pragma unroll 4\n      for (int i = i0; i < j;",
                            "      for (int i = i0; i < j;")], True),
    # timing only: the panel's rows without their products
    "no panel products": ([("for (int i = i0; i < j; ++i", "for (int i = j; i < j; ++i")],
                          False),
    # timing only: no rank-nb update of the trailing triangle
    "no rank-nb update": ([("    if (np == nb && c + nb < n) trailing_update(sm, A, F, c, nb, n, w);\n",
                            "")], False),
}

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
    defines = [d for d in fb.DEFINES if not d.startswith(("-DTC_FB_CHUNK_ROWS=",
                                                          "-DTC_FB_RING_ROWS="))]
    out = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", *fb.NVCC_FLAGS, *defines,
         f"-DTC_FB_CHUNK_ROWS={chunk or fb.CHUNK_ROWS}",
         f"-DTC_FB_RING_ROWS={ring or fb.RING_ROWS}",
         "-o", str(lib), str(src)], check=True, capture_output=True, text=True, timeout=900)
    regs, kernel = [], None
    for line in out.stderr.splitlines():  # the block route's registers (-Xptxas -v)
        m = re.search(r"Compiling entry function '.*?\d((?:factor|solve)_(?:block|inplace)_kernel"
                      r"(?:ILi\d+E)?)", line)
        kernel = m.group(1) if m else kernel if "Compiling" not in line else None
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            regs.append(f"{kernel} {m.group(1)}")
    cs.log(f"[ablation] {name}: block-route registers a thread: {', '.join(regs)}")
    h = ctypes.CDLL(str(lib))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.tc_fleet_banded_factor_solve.argtypes = [I, I, I, I, I, P, P, P, P, I, I, Fl, P]
    h.tc_fleet_banded_solve.argtypes = [I, I, I, I, I, P, P, P, I, I, P]
    h.tc_fleet_banded_factor.argtypes = [I, I, I, I, I, P, P, I, I, Fl, P]
    assert h.tc_fleet_banded_init() == 0
    return h


def kernels(h, fb, band, rhs, fband, a=None):
    """K1, K2, K3 of library ``h`` on these inputs, with their outputs, at
    the C entries' plan arguments ``a`` (w, ring, group, rows, stride), by
    default the binding's launch plan."""
    B, n, R = band.shape
    w = R - 1
    if a is None:
        plan = fb.launch_plan(n, w, B,
                              torch.cuda.get_device_properties(0).multi_processor_count)
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


def held(ks, f, x, want, what: str) -> None:
    """Launch K1, K2, K3 (``ks``, writing ``f`` and ``x``) once each and
    hold their outputs bitwise against the plain versions ``want``."""
    for k, ref in zip(ks, want):
        rc = k()
        torch.cuda.synchronize()
        cs.check(rc == 0 and all(cs.same_bits(o, p) for o, p in zip((f, x), ref)
                                 if p is not None),
                 f"{what}: rc {rc}, not bitwise against the plain versions")


def plain(fb, band, rhs, w):
    """The plain versions' outputs, as ``held`` takes them, and the factor."""
    pf, px = fb.fleet_banded_factor_solve_plain(band, rhs, w, CLAMP)
    px2 = fb.fleet_banded_solve_plain(pf, rhs, w)
    return ((pf, px), (None, px2), (pf, None)), pf


def reps_at(B, n, w) -> int:
    """Calls a median is taken over: fewer where PR 16's block route takes
    tens of milliseconds a call."""
    return 40 if B * n * w * w < 5e9 else 5


def against_parent(fb, parent: Path) -> dict:
    """Device ms of K1/K2/K3, design and parent in the order design,
    parent, parent, design at each of PARENT_SHAPES (the narrow route's
    widths instantiated alone; the wide route's capacities as they are),
    then at BLOCK_SHAPES, the parent at its own block plan."""
    widths = sorted({w for _, _, w in PARENT_SHAPES if w <= fb.NARROW_W})
    texts = {"design": variant_source([], widths=widths),
             "parent": variant_source([], parent.read_text(), widths)}
    times = {name: {} for name in texts}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        libs = dict(zip(texts, pool.map(lambda kv: build(kv[0], fb, Path(tmp), kv[1]),
                                        texts.items())))
        for B, n, w in [*PARENT_SHAPES, *BLOCK_SHAPES]:
            band, rhs = cs.test_band(B, n, w, seed=n + w)
            want, pf = plain(fb, band, rhs, w)
            args = {"design": None, "parent": (w, 0, 1, 0, 0) if w > fb.MAX_W else None}
            runs = {name: kernels(h, fb, band, rhs, pf, args[name]) for name, h in libs.items()}
            for name, (ks, f, x) in runs.items():
                held(ks, f, x, want, f"{name} at {(B, n, w)}")
            got = {name: [] for name in texts}
            for name in ("design", "parent", "parent", "design"):
                got[name].append([cs.cuda_ms(k, reps_at(B, n, w), spin=True)
                                  for k in runs[name][0]])
            for name, pair in got.items():
                times[name][f"{B},{n},{w}"] = pair
                cs.log(f"[ablation] {name} B={B} n={n} w={w}: K1/K2/K3 device ms "
                       + "; ".join("/".join(f"{t:.4f}" for t in ts) for ts in pair))
            d, p = ([sum(ts[i] for ts in got[nm]) / 2 for i in range(3)]
                    for nm in ("design", "parent"))
            cs.log(f"[ablation] B={B} n={n} w={w}: design / parent K1 {d[0] / p[0]:.4f}, "
                   f"K2 {d[1] / p[1]:.4f}, K3 {d[2] / p[2]:.4f}")
            del band, rhs, want, pf, runs
            torch.cuda.empty_cache()
    return times


def plans(fb) -> dict:
    """Device ms of the design's block route at each of BLOCK_SHAPES over
    its plans: K1 and K3 at each panel of PLAN_PANELS that fits and each
    of PLAN_THREADS, K2 at each of PLAN_GROUPS; every launch bitwise."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(BLOCK_VARIANTS)) as pool:
        texts = {name: variant_source(edits) for name, (edits, _) in BLOCK_VARIANTS.items()}
        libs = dict(zip(texts, pool.map(lambda kv: build(kv[0], fb, Path(tmp), kv[1]),
                                         texts.items())))
        h = build("design", fb, Path(tmp))
        B, n, w = BLOCK_SHAPES[0]
        band, rhs = cs.test_band(B, n, w, seed=n + w)
        want, pf = plain(fb, band, rhs, w)
        res = out["variants"] = {}
        for name, lib in {"design": h, **libs, "design again": h}.items():
            ks, f, x = kernels(lib, fb, band, rhs, pf)
            if BLOCK_VARIANTS.get(name, ([], True))[1]:
                held(ks, f, x, want, f"{name} at {(B, n, w)}")
            res[name] = t = [cs.cuda_ms(ks[i], 20, spin=True) for i in (0, 2)]
            cs.log(f"[plans] {name} B={B} n={n} w={w}: K1 {t[0]:.4f}, K3 {t[1]:.4f} device ms")
        for B, n, w in BLOCK_SHAPES:
            band, rhs = cs.test_band(B, n, w, seed=n + w)
            want, pf = plain(fb, band, rhs, w)
            plan = fb.launch_plan(n, w, B, sms)
            reps = 20 if B * n * w * w < 5e9 else 5
            res = out[f"{B},{n},{w}"] = {"plan": list(plan), "factor": {}, "solve": {}}
            for nb in PLAN_PANELS:
                if nb > w or fb.block_smem(w, 1, nb, True) > fb.SMEM_MAX:
                    continue
                for T in PLAN_THREADS:
                    ks, f, x = kernels(h, fb, band, rhs, pf, (w, 0, plan.group, nb, T))
                    held(ks, f, x, want, f"nb={nb} threads={T} at {(B, n, w)}")
                    t = [cs.cuda_ms(ks[i], reps, spin=True) for i in (0, 2)]
                    res["factor"][f"{nb},{T}"] = t
                    cs.log(f"[plans] B={B} n={n} w={w} nb={nb} threads={T}: K1 {t[0]:.4f}, "
                           f"K3 {t[1]:.4f} device ms")
            for G in PLAN_GROUPS:
                if G * fb.solve_bytes(w) > fb.SMEM_MAX:
                    continue
                ks, f, x = kernels(h, fb, band, rhs, pf, (w, 0, G, plan.rows, plan.stride))
                held(ks, f, x, want, f"group {G} at {(B, n, w)}")
                res["solve"][G] = t = cs.cuda_ms(ks[1], reps, spin=True)
                cs.log(f"[plans] B={B} n={n} w={w} group={G}: K2 {t:.4f} device ms")
            del band, rhs, want, pf
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another commit's fleet_banded.cu")
    ap.add_argument("--plans", action="store_true", help="time the block route's plans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fleet_banded_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from tenscalc_tpu_torch.kkt import fleet_banded as fb

    card = cs.card_line()
    if args.plans:
        print(json.dumps({"plans_device_ms": plans(fb)}))
        print(card)
        return 0
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
                held(ks, f, x, ((pf, px), (None, px2), (pf, None)), name)
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
