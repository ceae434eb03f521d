"""Ghost-Shell Padding (GSP) — paper §III-A, Algorithm 1, on the device.

For *high-density* levels: instead of filling empty unit blocks with
zeros (which poisons the predictor at their boundaries), each empty block
takes ``m = min(unit/2, 4)`` layers of the *average boundary slice* of
each non-empty face neighbour.  Where pads from several neighbours
overlap (edges and corners of an empty block) the contributions are
averaged.  Compression sends the padded full grid to SZ; decompression
restores exact zeros in empty blocks from the occupancy bitmap.

The arithmetic is the reference's numpy order: each boundary-slice mean
adds its ``m`` float32 slices one after another and divides by ``m`` in
float32; the contributions accumulate in float64 in the loop order
axis 0..2, sign +1 then −1, and are divided by their count.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import true_divide
from .blocks import BlockGrid, make_block_grid

__all__ = ["gsp_pad", "gsp_unpad", "gsp_meta_bits"]


def _blocks(t: torch.Tensor, u: int) -> torch.Tensor:
    """(X,Y,Z) → (bx,by,bz, u,u,u) view (writes go through to ``t``)."""
    bx, by, bz = (s // u for s in t.shape)
    return t.reshape(bx, u, by, u, bz, u).permute(0, 2, 4, 1, 3, 5)


def _boundary_slice_mean(blocks: torch.Tensor, m: int, axis: int,
                         side: str) -> torch.Tensor:
    """Per-block float32 mean of the ``m`` boundary slices on ``side`` of
    ``axis``: (bx,by,bz, u,u), summed slice by slice as numpy does."""
    ax = 3 + axis
    u = blocks.shape[ax]
    first = 0 if side == "lo" else u - m
    acc = torch.zeros_like(blocks.select(ax, 0))
    for i in range(first, first + m):
        acc = acc + blocks.select(ax, i)
    return true_divide(acc, float(m))


def gsp_pad(data, mask=None, *, unit: int = 8,
            device: str | torch.device = "cuda",
            ) -> tuple[torch.Tensor, BlockGrid]:
    """Algorithm 1: (padded float32 grid on ``device``, block grid).

    ``data`` and ``mask`` are host arrays; the unit-block grid (host
    numpy) is the reference's.
    """
    device = resolve_device(device)
    grid = make_block_grid(np.asarray(data), mask, unit=unit)
    u = grid.unit
    m = min(u // 2, 4)
    occ = torch.from_numpy(grid.occ).to(device)
    data_t = torch.from_numpy(np.ascontiguousarray(grid.data)).to(device)
    blocks = _blocks(data_t, u)
    acc = torch.zeros(data_t.shape, dtype=torch.float64, device=device)
    cnt = torch.zeros(data_t.shape, dtype=torch.int32, device=device)
    acc_b, cnt_b = _blocks(acc, u), _blocks(cnt, u)

    for axis in range(3):
        for sign in (+1, -1):
            # an empty block receives from its non-empty neighbour at
            # sign·axis, into its m layers next to that neighbour
            n = occ.shape[axis]
            src = slice(1, None) if sign > 0 else slice(0, n - 1)
            dst = slice(0, n - 1) if sign > 0 else slice(1, None)
            src_i = tuple(src if a == axis else slice(None) for a in range(3))
            dst_i = tuple(dst if a == axis else slice(None) for a in range(3))
            nocc = torch.zeros_like(occ)
            nocc[dst_i] = occ[src_i]
            recv = ~occ & nocc
            if not bool(recv.any()):
                continue
            # the neighbour's face toward us: its low slices when it sits
            # at +axis, its high slices at -axis
            bslice = _boundary_slice_mean(blocks, m, axis,
                                          "lo" if sign > 0 else "hi")
            shifted = torch.zeros_like(bslice)
            shifted[dst_i] = bslice[src_i]
            pad = (shifted.double() * recv[..., None, None].double()
                   ).unsqueeze(3 + axis)
            layers = (slice(u - m, u) if sign > 0 else slice(0, m))
            sl = tuple(layers if a == 3 + axis else slice(None)
                       for a in range(6))
            acc_b[sl] += pad
            cnt_b[sl] += recv[..., None, None, None].int()

    padded = torch.where(cnt > 0, acc / cnt, data_t.double())
    return padded.float(), grid


def gsp_unpad(recon: torch.Tensor, grid: BlockGrid) -> torch.Tensor:
    """Restore exact zeros in empty unit blocks (decompression side)."""
    u = grid.unit
    occ = torch.from_numpy(grid.occ).to(recon.device)
    cells = occ.repeat_interleave(u, 0).repeat_interleave(u, 1) \
               .repeat_interleave(u, 2)
    return torch.where(cells, recon, 0.0).float()


def gsp_meta_bits(grid: BlockGrid) -> int:
    """Occupancy bitmap + dims/eb header."""
    return grid.n_blocks + 3 * 32
