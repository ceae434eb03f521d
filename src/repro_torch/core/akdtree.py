"""Adaptive k-D Tree (AKDTree) — paper §III-C, Algorithm 3, Figs. 10/11.

For *medium-density* levels, where OpST's O(N²·d) update cost bites:
recursively split the unit-block grid until every leaf is *empty or full*.

Faithful to the paper's dynamic splitting:

  1. **Pre-split**: while ``max(x,y,z)/min(x,y,z) ≥ 2``, split the largest
     dimension in half (keeps the data 3D instead of flattening it).
  2. **cube → flat → slim rotation**: a *cube* node is split along the axis
     with the maximum child-count difference ``diff_axis`` computed from its
     eight octant counts; the resulting *flat* node reuses four of those
     counts to pick between the two remaining axes; the *slim* node splits
     the single remaining axis; its children are cubes again.  Counting is
     only needed at cube nodes — one count per three tree levels, hence the
     paper's O(N/3 · log N).

Counts are O(1) range sums over a 3D summed-area table of the occupancy
grid (a stand-in for the paper's streamed counting; the result
is identical).  Full leaves become :class:`SubBlock`\\ s, one SHE
sub-block each.
"""
from __future__ import annotations

import numpy as np

from .blocks import BlockGrid, SubBlock

__all__ = ["akdtree_partition"]


def _sat(occ: np.ndarray) -> np.ndarray:
    """3D summed-area table with a zero guard layer."""
    s = occ.astype(np.int64)
    for ax in range(3):
        s = np.cumsum(s, axis=ax)
    return np.pad(s, ((1, 0), (1, 0), (1, 0)))


def _count(sat: np.ndarray, lo, hi) -> int:
    """Number of non-empty unit blocks in [lo, hi) — O(1)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    return int(sat[x1, y1, z1] - sat[x0, y1, z1] - sat[x1, y0, z1]
               - sat[x1, y1, z0] + sat[x0, y0, z1] + sat[x0, y1, z0]
               + sat[x1, y0, z0] - sat[x0, y0, z0])


def _split(lo, hi, axis):
    mid = (lo[axis] + hi[axis]) // 2
    hi1 = list(hi); hi1[axis] = mid
    lo2 = list(lo); lo2[axis] = mid
    return (lo, tuple(hi1)), (tuple(lo2), hi)


def akdtree_partition(grid: BlockGrid) -> list[SubBlock]:
    sat = _sat(grid.occ)
    out: list[SubBlock] = []
    # stack items: (lo, hi, pending_axes) — pending_axes tracks the
    # cube→flat→slim rotation (None = cube: recount octants).
    stack = [((0, 0, 0), grid.bshape, None)]
    while stack:
        lo, hi, pending = stack.pop()
        dims = tuple(h - l for l, h in zip(lo, hi))
        if min(dims) == 0:
            continue
        vol = dims[0] * dims[1] * dims[2]
        cnt = _count(sat, lo, hi)
        if cnt == 0:
            continue                      # empty leaf — dropped
        if cnt == vol:
            out.append(SubBlock(origin=lo, bsize=dims))   # full leaf
            continue
        # pre-split of elongated boxes (Eq. 1): keep the data 3D
        mx, mn = max(dims), min(dims)
        if mn > 0 and mx / mn >= 2 and mx > 1:
            axis = int(np.argmax(dims))
            (a, b) = _split(lo, hi, axis)
            stack.append((a[0], a[1], None))
            stack.append((b[0], b[1], None))
            continue
        splittable = [ax for ax in range(3) if dims[ax] > 1]
        if not splittable:
            # 1×1×1 mixed is impossible (cnt==0 or cnt==vol above)
            continue
        if pending is None or not any(dims[ax] > 1 for ax in pending):
            pending = tuple(splittable)   # (re)enter cube state
        cand = [ax for ax in pending if dims[ax] > 1]
        # maxDiff choice over the candidate axes (cube: 3-way from octant
        # counts; flat: 2-way from the reused quadrant counts; slim: forced)
        best_ax, best_diff = cand[0], -1
        for ax in cand:
            (a, b) = _split(lo, hi, ax)
            d = abs(_count(sat, *a) - _count(sat, *b))
            if d > best_diff:
                best_ax, best_diff = ax, d
        remaining = tuple(ax for ax in pending if ax != best_ax)
        (a, b) = _split(lo, hi, best_ax)
        stack.append((a[0], a[1], remaining))
        stack.append((b[0], b[1], remaining))
    return out
