"""Naive Sparse Tensor (NaST) — paper §III-B, Fig. 7, on the device.

The baseline partition strategy: split the level into unit blocks, drop
the empty ones, and stack the survivors into a 4D array
``(n_blocks, u, u, u)``; decompression scatters the blocks back by their
saved coordinates.  NaST removes all empty space but gives up spatial
locality — the motivation for OpST and AKDTree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .blocks import BlockGrid, make_block_grid

__all__ = ["nast_pack", "nast_unpack", "nast_meta_bits"]


def nast_pack(data, mask=None, *, unit: int = 8,
              device: str | torch.device = "cuda",
              ) -> tuple[torch.Tensor, np.ndarray, BlockGrid]:
    """(packed (n,u,u,u) float tensor on ``device``, block coordinates
    (n,3) int32 in C order, grid) of the non-empty unit blocks."""
    device = resolve_device(device)
    grid = make_block_grid(np.asarray(data), mask, unit=unit)
    u = grid.unit
    bx, by, bz = grid.bshape
    blocks = (torch.from_numpy(np.ascontiguousarray(grid.data)).to(device)
              .reshape(bx, u, by, u, bz, u).permute(0, 2, 4, 1, 3, 5)
              .reshape(bx * by * bz, u, u, u))
    idx = np.argwhere(grid.occ.reshape(-1)).ravel()
    coords = np.stack(np.unravel_index(idx, grid.bshape), axis=1)
    return (blocks[torch.from_numpy(idx).to(device)],
            coords.astype(np.int32), grid)


def nast_unpack(packed: torch.Tensor, coords: np.ndarray,
                grid: BlockGrid) -> torch.Tensor:
    """Scatter packed blocks back into a zero float32 grid (the block
    grid's padded shape) on ``packed``'s device."""
    u = grid.unit
    bx, by, bz = grid.bshape
    out = torch.zeros((bx * by * bz, u, u, u), dtype=torch.float32,
                      device=packed.device)
    flat = np.ravel_multi_index(
        np.asarray(coords, dtype=np.int64).reshape(-1, 3).T, grid.bshape)
    out[torch.from_numpy(flat).to(packed.device)] = packed.float()
    return (out.reshape(bx, by, bz, u, u, u).permute(0, 3, 1, 4, 2, 5)
            .reshape(grid.data.shape))


def nast_meta_bits(coords: np.ndarray) -> int:
    """3×16-bit block coordinates per non-empty block + header."""
    return coords.shape[0] * 3 * 16 + 3 * 32
