"""Optimized Sparse Tensor (OpST) — paper §III-B, Algorithm 2, Fig. 8.

For *low-density* levels: a 3D dynamic program finds, for every unit block,
the edge length ``BS(x,y,z)`` of the largest cube of non-empty unit blocks
whose bottom-right-rear corner is that block:

    BS = 0                         if block empty
    BS = 1                         on a boundary (x, y or z == 0)
    BS = 1 + min(7 lower neighbors) otherwise

Sub-blocks are extracted greedily scanning from the bottom-right-rear
corner to the top-left-front corner: at each non-empty corner a
``BS³``-unit cube is cut out, the occupancy and ``BS`` inside it are
zeroed, and ``BS`` is *partially* recomputed in a window bounded by
``maxSide`` (paper line 15 / `updateBs`) — which is what makes the method
O(N²·d): denser data → larger ``maxSide`` → bigger update windows.

Each extracted cube becomes one SHE sub-block.
"""
from __future__ import annotations

import numpy as np

from .blocks import BlockGrid, SubBlock

__all__ = ["compute_bs", "opst_partition", "merge_subblocks"]


def compute_bs(occ: np.ndarray) -> np.ndarray:
    """Full maximal-cube DP over the occupancy grid (Alg. 2 lines 1–10)."""
    bx, by, bz = occ.shape
    bs = np.zeros((bx, by, bz), dtype=np.int32)
    # vectorize over (y, z) planes; the x recurrence is sequential
    for x in range(bx):
        row = occ[x]
        if x == 0:
            bs[0] = row.astype(np.int32)
            continue
        prev = bs[x - 1]
        # min over the 4 neighbors in the x-1 plane
        m = prev.copy()
        m[1:, :] = np.minimum(m[1:, :], prev[:-1, :])
        m[:, 1:] = np.minimum(m[:, 1:], prev[:, :-1])
        m[1:, 1:] = np.minimum(m[1:, 1:], prev[:-1, :-1])
        # same-plane neighbors (x, y-1, z), (x, y, z-1), (x, y-1, z-1) must be
        # handled sequentially in y,z — do a small python loop over y with
        # vectorized z via running minima.
        plane = np.zeros_like(prev)
        for y in range(by):
            up = plane[y - 1] if y > 0 else None
            mrow = m[y]
            out = np.empty(bz, dtype=np.int32)
            for z in range(bz):
                if not row[y, z]:
                    out[z] = 0
                    continue
                if y == 0 or z == 0:
                    out[z] = 1
                    continue
                out[z] = 1 + min(mrow[z], up[z], out[z - 1],
                                 up[z - 1] if up is not None else 0)
            plane[y] = out
        # boundary x==... x>0 here; y==0 or z==0 handled above; empty → 0
        bs[x] = np.where(row, plane, 0)
    return bs


def _update_bs_window(bs: np.ndarray, occ: np.ndarray,
                      lo: tuple[int, int, int], hi: tuple[int, int, int]) -> None:
    """Recompute the DP inside [lo, hi) in forward order (Alg. 2 line 15).

    Values just outside the window's low faces are valid (extraction can
    only have affected blocks ≥ the removed cube's low corner per dim)."""
    for a in range(lo[0], hi[0]):
        for b in range(lo[1], hi[1]):
            for c in range(lo[2], hi[2]):
                if not occ[a, b, c]:
                    bs[a, b, c] = 0
                elif a == 0 or b == 0 or c == 0:
                    bs[a, b, c] = 1
                else:
                    bs[a, b, c] = 1 + min(
                        bs[a - 1, b, c], bs[a, b - 1, c], bs[a, b, c - 1],
                        bs[a - 1, b - 1, c], bs[a, b - 1, c - 1],
                        bs[a - 1, b, c - 1], bs[a - 1, b - 1, c - 1])


def opst_partition(grid: BlockGrid) -> list[SubBlock]:
    """Algorithm 2: extract maximal cubes, updating the DP after each cut."""
    occ = grid.occ.copy()
    bs = compute_bs(occ)
    max_side = int(bs.max(initial=0))
    bx, by, bz = occ.shape
    out: list[SubBlock] = []
    for x in range(bx - 1, -1, -1):
        for y in range(by - 1, -1, -1):
            for z in range(bz - 1, -1, -1):
                s = int(bs[x, y, z])
                if s < 1:
                    continue
                ox, oy, oz = x - s + 1, y - s + 1, z - s + 1
                out.append(SubBlock(origin=(ox, oy, oz), bsize=(s, s, s)))
                occ[ox:x + 1, oy:y + 1, oz:z + 1] = False
                bs[ox:x + 1, oy:y + 1, oz:z + 1] = 0
                # partial update bounded by maxSide (O(N²·d) total)
                lo = (ox, oy, oz)
                hi = (min(bx, x + max_side + 1), min(by, y + max_side + 1),
                      min(bz, z + max_side + 1))
                _update_bs_window(bs, occ, lo, hi)
    return out


def merge_subblocks(grid: BlockGrid, subblocks: list[SubBlock]
                    ) -> dict[tuple[int, int, int], np.ndarray]:
    """Group extracted sub-blocks by (sorted) size into 4D arrays.

    Same-size blocks are stacked into one ``(n, sx·u, sy·u, sz·u)`` array
    for joint compression (§III-B step 5); differently-oriented cuboids of
    equal sorted size are axis-aligned first, largest dim first (§III-C:
    the paper tracks orientations instead of transposing; the bits on
    disk are the same either way).
    """
    u = grid.unit
    groups: dict[tuple[int, int, int], list[np.ndarray]] = {}
    for sb in subblocks:
        ox, oy, oz = sb.cell_origin(u)
        sx, sy, sz = sb.cell_size(u)
        brick = grid.data[ox:ox + sx, oy:oy + sy, oz:oz + sz]
        order = np.argsort(brick.shape)[::-1]
        brick = np.transpose(brick, order)
        groups.setdefault(tuple(brick.shape), []).append(brick)
    return {k: np.stack(v) for k, v in groups.items()}
