"""KKT structure planner (port of ``tenscalc_tpu/kkt/structure.py``).

The KKT sparsity pattern is probed once at build time with random
parameter and primal values, a reverse Cuthill-McKee ordering reduces
its bandwidth, and the plan says whether a banded elimination beats a
dense one.  MPC horizons make the KKT block-banded in the stage index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PROBE_TRIALS = 2  # random probes whose union is the pattern
MIN_BLOCKS = 4    # the reference's least number of s-blocks for a band


@dataclasses.dataclass
class BandedPlan:
    """Static factorization plan: permutation + block partition."""

    perm: np.ndarray          # permutation: WWp = WW[perm][:, perm]
    iperm: np.ndarray         # inverse permutation
    block: int                # block size s (>= half bandwidth)
    n_blocks: int             # number of s-blocks (padded)
    n: int                    # original dimension
    bandwidth: int            # half bandwidth after permutation
    worthwhile: bool          # whether banded beats dense


def probe_pattern(assemble_fn, n: int) -> np.ndarray:
    """Union of the nonzeros of a few random probes -> boolean pattern."""
    pat = np.zeros((n, n), dtype=bool)
    for t in range(PROBE_TRIALS):
        pat |= np.abs(np.asarray(assemble_fn(t))) > 0
    return pat | pat.T  # symmetrize (quasi-definite KKT is structurally sym)


def plan_banded(pattern: np.ndarray) -> BandedPlan:
    """RCM ordering + the decision whether banded elimination pays off
    (flops: dense ~ n^3/3 vs banded ~ n_blocks * (7/3) * block^3)."""
    from .. import native

    n = pattern.shape[0]
    perm = native.rcm(pattern)
    bw = native.bandwidth(pattern, perm)
    block = max(bw, 1)
    n_blocks = -(-n // block)
    worthwhile = (
        n_blocks >= MIN_BLOCKS
        and n_blocks * 7 * block**3 < n**3
    )
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    return BandedPlan(
        perm=perm, iperm=iperm, block=block, n_blocks=n_blocks, n=n,
        bandwidth=bw, worthwhile=worthwhile,
    )
