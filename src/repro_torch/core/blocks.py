"""Unit-block partitioning utilities (paper §III-A/B/C).

Every TAC pre-process strategy first partitions a level's 3D grid into
*unit blocks* (16³ in the paper for 512³ grids; scaled down here).  A unit
block is *empty* when no valid cell of the level falls inside it.  GSP pads
empty blocks, NaST/OpST/AKDTree remove them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["BlockGrid", "SubBlock", "make_block_grid", "extract_subblock",
           "subblocks_tile_exactly"]


@dataclass
class BlockGrid:
    """A level partitioned into unit blocks."""

    data: np.ndarray          # the level's (padded) 3D data
    mask: np.ndarray          # validity mask, same shape
    unit: int                 # unit block edge length (cells)
    occ: np.ndarray           # (bx,by,bz) bool: unit block is non-empty
    counts: np.ndarray        # (bx,by,bz) int: valid cells per unit block

    @property
    def bshape(self) -> tuple[int, int, int]:
        return tuple(self.occ.shape)

    @property
    def n_blocks(self) -> int:
        return int(np.prod(self.occ.shape))

    @property
    def n_nonempty(self) -> int:
        return int(self.occ.sum())

    @property
    def block_density(self) -> float:
        """Fraction of non-empty unit blocks — the density that drives the
        hybrid strategy thresholds T0/T1/T2 (paper §III-E)."""
        return self.n_nonempty / max(self.n_blocks, 1)


def _pad_to_multiple(a: np.ndarray, unit: int, fill=0) -> np.ndarray:
    pads = [(0, (-s) % unit) for s in a.shape]
    if any(p[1] for p in pads):
        a = np.pad(a, pads, constant_values=fill)
    return a


def make_block_grid(data: np.ndarray, mask: np.ndarray | None = None, *,
                    unit: int = 8) -> BlockGrid:
    """Partition ``data`` into unit blocks (padding the grid up to a
    multiple of ``unit`` with empty cells if needed)."""
    if mask is None:
        mask = data != 0
    data = _pad_to_multiple(np.asarray(data), unit)
    mask = _pad_to_multiple(np.asarray(mask, dtype=bool), unit, fill=False)
    bx, by, bz = (s // unit for s in data.shape)
    m6 = mask.reshape(bx, unit, by, unit, bz, unit)
    counts = m6.sum(axis=(1, 3, 5)).astype(np.int64)
    occ = counts > 0
    return BlockGrid(data=data, mask=mask, unit=unit, occ=occ, counts=counts)


@dataclass
class SubBlock:
    """A cuboid of unit blocks extracted by OpST/AKDTree (block coords)."""

    origin: tuple[int, int, int]   # unit-block coordinates of the corner
    bsize: tuple[int, int, int]    # size in unit blocks per dim

    def cell_origin(self, unit: int) -> tuple[int, int, int]:
        return tuple(o * unit for o in self.origin)

    def cell_size(self, unit: int) -> tuple[int, int, int]:
        return tuple(s * unit for s in self.bsize)

    @property
    def n_units(self) -> int:
        return int(np.prod(self.bsize))

    def meta_bits(self) -> int:
        """Side-info cost of one sub-block: 3 coords + 3 sizes @16 bit."""
        return 6 * 16


def extract_subblock(grid: BlockGrid, sb: SubBlock) -> np.ndarray:
    ox, oy, oz = sb.cell_origin(grid.unit)
    sx, sy, sz = sb.cell_size(grid.unit)
    return grid.data[ox:ox + sx, oy:oy + sy, oz:oz + sz]


def subblocks_tile_exactly(grid: BlockGrid, subblocks: list[SubBlock]) -> bool:
    """Partition invariant: the sub-blocks cover every non-empty unit
    block exactly once and no empty unit block."""
    cover = np.zeros(grid.bshape, dtype=np.int32)
    for sb in subblocks:
        x, y, z = sb.origin
        dx, dy, dz = sb.bsize
        cover[x:x + dx, y:y + dy, z:z + dz] += 1
    return bool(((cover == 1) == grid.occ).all() and (cover <= 1).all())
