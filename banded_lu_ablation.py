"""Design choices of csrc/banded_lu.cu (K9 factor+solve, K10 solve, K11
factor) timed against the design on one NVIDIA card, in turns.

    python3 banded_lu_ablation.py [--parent PATH] [--panels 32,48] [--block-only]
                                  [--shapes B,n,w;B,n,w]

Each variant is the CUDA source with one textual edit (named below and
checked to apply), built with nvcc at the timed widths alone; ``--parent``
adds another commit's banded_lu.cu with the same C entries (for instance
``git show <commit>:tenscalc_tpu_torch/csrc/banded_lu.cu`` written into
the git-ignored ``_scratch/``), built with its own width list and
launched with its own plan on the block route (a CTA an instance, no
panel).  ``--panels`` adds the design at other panel widths of the block
route's factor (the plan's ``rows``).  Every source is launched with the
binding's launch plan on the MPC-MHE fleet's band (B = 1024, n = 290,
w = 10), the pursuit fleet's (B = 512, n = 585, w = 22), a w = 31 fleet
(B = 1000, n = 77) and two rows a lane at w = 48 (B = 512, n = 286), and
on the block route at chip_smoke.py's BLOCK_SHAPES, the deconvolution
game's band (B = 256, n = 3000, w = 381) and its LU_WIDE_BLOCK_SHAPES
(w = 1024 and 1800); ``--shapes`` times the given shapes alone;
each held bitwise against the plain
versions, and timed by device time alone (CUDA events after the card
spins, median of 40 calls, 3 on the block route, as chip_smoke.py's
``device_ms``), the sources in the order design, variants, parent, then
in reverse.  Prints each library's registers and spills, the card's name
and power limit and one JSON line of the times.
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
SOURCE = ROOT / "tenscalc_tpu_torch" / "csrc" / "banded_lu.cu"
# the lane maps' shapes, and two rows a lane (a capacity kernel, w a
# run-time argument) at w = 48
WARP_SHAPES = [(1024, 290, 10), (512, 585, 22), (1000, 77, 31), (512, 286, 48)]
# the block route (w > 63): chip_smoke.py's shapes, the game's band and
# the wide bands
BLOCK_SHAPES = [*cs.BLOCK_SHAPES, cs.GAME_BAND, *cs.LU_WIDE_BLOCK_SHAPES]
SHAPES = WARP_SHAPES + BLOCK_SHAPES
WIDTHS = sorted({w for _, _, w in SHAPES if w <= 31})  # the per-width templates
BLOCK_REPS = 3
CLAMP = 1e-4
PARENT_MAX_W = 63  # the widest warp-route width the parent's source takes

# name -> edits of the source; each edit (old, new) must apply
# (a name starting with "~" is timed only: its edit breaks the results)
VARIANTS = {
    "design": [],
    # the one-lane factor's code at every width: below w = 16 its
    # generic map is two lanes a row, each entry's place formed at its
    # load and again at its store (the first widened design)
    "places formed twice below w = 16": [("  if constexpr (W <= 15) {", "  if constexpr (false) {")],
    # the solve's copies two groups (16 rows) ahead instead of three
    "solve ring 16": [("constexpr int kSolveRing = TC_LU_SOLVE_RING;",
                       "constexpr int kSolveRing = 16;")],
    "~forward only": [("  // ---- backward: window", "  return;\n  // ---- backward: window")],
    # the factor's parts: the panels alone, and the panels with no products
    "~no rank-nb update": [("    if (np == nb && c + nb < n) trailing_update(sm, A, F, c, nb, n, w);",
                            "")],
    "~no panel products": [("      for (int i = i0; i < j; ++i, a += S1, b += S1) v = __fsub_rn(v, __fmul_rn(*a, *b));",
                            "")],
}


def variant_source(text: str, edits, widths=WIDTHS) -> str:
    text, n = re.subn(r"#define TC_FOR_EACH_W\(X\).*?\n(?!\s*X\()",
                      "#define TC_FOR_EACH_W(X) " + " ".join(f"X({w})" for w in widths) + "\n",
                      text, flags=re.S)
    assert n == 1, "the width list moved"
    for old, new in edits:
        assert old in text, f"the edit {old!r} does not apply"
        text = text.replace(old, new)
    return text


def build(name: str, text: str, lu, out: Path):
    """The library of source ``text`` (bound with the binding's argument
    types) and its ptxas report."""
    src = out / (re.sub(r"\W", "_", name) + ".cu")
    src.write_text(text)
    lib = src.with_suffix(".so")
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", *lu.NVCC_FLAGS, *lu.DEFINES, "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True, timeout=900)
    h = ctypes.CDLL(str(lib))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.tc_banded_lu_factor_solve.argtypes = [I, I, I, I, P, P, P, P, I, I, Fl, P]
    h.tc_banded_lu_solve.argtypes = [I, I, I, I, P, P, P, I, I, P]
    h.tc_banded_lu_factor.argtypes = [I, I, I, I, P, P, I, I, Fl, P]
    assert h.tc_banded_lu_init() == 0
    return h, proc.stdout + proc.stderr


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes of each kernel at the timed widths and
    on the block route."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'.*\d(?:lu_)?((?:factor_solve|solve|factor)(?:_wide|_block)?_kernel)"
                          r"(?:ILi(\d+)E(?:Lb([01])E)?)?", line)
            name = None
            if m and m.group(3):
                name = f"{m.group(1)}<{m.group(2)},{'ring' if m.group(3) == '1' else 'staged'}>"
            elif m and m.group(2):  # the block route's, by a lane's leaves
                name = f"{m.group(1)}<{m.group(2)}>"
            elif m:
                name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and int(m.group(1)) + int(m.group(2)):
            out.append(f"{name} SPILLS {int(m.group(1)) + int(m.group(2))} B")
    return ", ".join(out)


def kernels(h, lu, band, rhs, fband, plan=None):
    """K9, K10, K11 of library ``h`` on these inputs (with the binding's
    launch plan, or ``plan``'s (ring, group, rows)), and their outputs."""
    B, n, R = band.shape
    w = (R - 1) // 2
    if plan is None:
        p = lu.launch_plan(n, w, B, torch.cuda.get_device_properties(0).multi_processor_count)
        plan = (int(p.ring), p.group, p.rows)
    a = (w, *plan)
    f, x = torch.empty_like(band), torch.empty_like(rhs)
    s = torch.cuda.current_stream().cuda_stream
    return (
        lambda: h.tc_banded_lu_factor_solve(*a, band.data_ptr(), rhs.data_ptr(), f.data_ptr(),
                                            x.data_ptr(), n, B, CLAMP, s),
        lambda: h.tc_banded_lu_solve(*a, fband.data_ptr(), rhs.data_ptr(), x.data_ptr(), n, B, s),
        lambda: h.tc_banded_lu_factor(*a, band.data_ptr(), f.data_ptr(), n, B, CLAMP, s),
    ), f, x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another commit's banded_lu.cu")
    ap.add_argument("--panels", default="",
                    help="other panel widths of the block route's factor, comma-separated")
    ap.add_argument("--block-only", action="store_true", help="the block route's shapes alone")
    ap.add_argument("--shapes", default="", help="shapes B,n,w separated by ';' alone")
    args = ap.parse_args()
    panels = [int(p) for p in args.panels.split(",") if p]
    shapes = BLOCK_SHAPES if args.block_only else SHAPES
    if args.shapes:
        shapes = [tuple(int(v) for v in sh.split(",")) for sh in args.shapes.split(";")]
    if not torch.cuda.is_available():
        print("banded_lu_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from tenscalc_tpu_torch.kkt import banded_lu as lu

    card = cs.card_line()
    design = SOURCE.read_text()
    texts = {name: variant_source(design, edits) for name, edits in VARIANTS.items()}
    if args.parent is not None:
        # the parent's kernels may stop short of the design's widths
        texts["parent"] = variant_source(args.parent.read_text(), [],
                                         [w for w in WIDTHS if w <= min(PARENT_MAX_W, 31)])
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(kv[0], kv[1], lu, Path(tmp)),
                                         texts.items())))
        for name, (_, log) in built.items():
            cs.log(f"[ablation] {name}: ptxas {ptxas_summary(log)}")
        times = {name: {} for name in [*texts, *(f"design nb={p}" for p in panels)]}
        for B, n, w in shapes:
            block = lu.route(w) == "block"
            # the parent's block route: a CTA an instance, no panel
            plans = {name: ((0, 1, 0) if name == "parent" and block else None) for name in texts}
            if block:
                plans.update({f"design nb={p}": (0, 1, p) for p in panels
                              if p <= w and lu.panel_bytes(w, p) <= lu.SMEM_MAX})
            order = list(plans)
            band, rhs = cs.test_lu_band(B, n, w, seed=n + w)
            pf, px = lu.fleet_banded_lu_factor_solve_plain(band, rhs, w, CLAMP)
            px10 = lu.fleet_banded_lu_solve_plain(pf, rhs, w)
            runs = {name: kernels(built[name.split(" nb=")[0]][0], lu, band, rhs, pf, plans[name])
                    for name in order}
            for name, (ks, f, x) in runs.items():
                if name.startswith("~"):
                    continue
                for k, want in zip(ks, ((pf, px), (None, px10), (pf, None))):
                    assert k() == 0
                    torch.cuda.synchronize()
                    cs.check(all(torch.equal(o, p) for o, p in zip((f, x), want)
                                 if p is not None),
                             f"{name} at {(B, n, w)}: bitwise against the plain versions")
            got = {name: [] for name in order}
            reps = BLOCK_REPS if block else 40
            for turn in (order, order[::-1]):
                for name in turn:
                    got[name].append([cs.cuda_ms(k, reps, spin=True) for k in runs[name][0]])
            for name, pair in got.items():
                times[name][f"{B},{n},{w}"] = pair
                cs.log(f"[ablation] {name} B={B} n={n} w={w}: K9/K10/K11 device ms "
                       + "; ".join("/".join(f"{t:.4f}" for t in ts) for ts in pair))
    print(json.dumps({"device_ms": times}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
