"""Hybrid level-wise AMR compression — the TAC+ path (paper §III-E).

Per AMR level the unit-block density picks the partition (OpST+ below
T0 = 50 %, AKDTree+ above); the sub-blocks go through SHE (per-block
Lor/Reg prediction + one shared Huffman codebook) on the device, and the
level reconstruction is scattered back on the device, exact zeros
outside the mask.  Partitioning is integer host logic (numpy).

Only the default TAC+ path (``she=True``, ``algorithm="lor_reg"``,
``batched=True``, strategy opst or akdtree) is ported; GSP, NaST, the
merged-4D TAC path and the sequential path raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from . import huffman
from .akdtree import akdtree_partition
from .amr import AMRDataset
from .blocks import BlockGrid, SubBlock, extract_subblock, make_block_grid
from .opst import opst_partition
from .she import she_encode
from .sz import SZResult

__all__ = ["LevelArtifacts", "LevelResult", "AMRCompressionResult",
           "compress_level", "compress_amr", "choose_strategy",
           "partition_level", "T0", "T1", "T2"]

T0 = 0.50   # Lor/Reg+SHE: OpST+ vs AKDTree+ (Fig. 12 / Fig. 14)
T1 = 0.50   # Interp: OpST vs AKDTree (Fig. 13)
T2 = 0.85   # Interp: AKDTree vs GSP (Fig. 13)


@dataclass
class LevelArtifacts:
    """Serialization-grade level state: code streams, sub-block placement
    and the shared codebook the TACZ writer needs."""

    mask: np.ndarray              # validity mask at the level's orig shape
    orig_shape: tuple[int, ...]   # level shape before unit-block padding
    grid_shape: tuple[int, ...]   # padded block-grid data shape
    unit: int                     # unit-block edge (cells)
    sz_block: int                 # Lor/Reg regression block edge
    subblocks: list[SubBlock]     # placement
    results: list[SZResult]       # per-sub-block codes/branch/betas
    codebook: huffman.Codebook | None  # shared Huffman codebook


@dataclass
class LevelResult:
    strategy: str
    algorithm: str
    she: bool
    payload_bits: int
    codebook_bits: int
    meta_bits: int
    recon: torch.Tensor          # reconstructed level grid (exact zeros outside)
    n_values: int                # stored values at this level
    density: float
    eb: float
    n_subblocks: int = 0
    ratio: int = 1               # coarsening ratio vs the finest grid
    artifacts: LevelArtifacts | None = field(default=None, repr=False)

    @property
    def total_bits(self) -> int:
        return int(self.payload_bits + self.codebook_bits + self.meta_bits)


@dataclass
class AMRCompressionResult:
    levels: list[LevelResult]
    method: str

    @property
    def total_bits(self) -> int:
        return sum(l.total_bits for l in self.levels)

    @property
    def n_values(self) -> int:
        return sum(l.n_values for l in self.levels)

    def compression_ratio(self, dtype_bits: int = 32) -> float:
        return self.n_values * dtype_bits / max(self.total_bits, 1)

    def bit_rate(self, dtype_bits: int = 32) -> float:
        return self.total_bits / max(self.n_values, 1)


def choose_strategy(density: float, *, algorithm: str, she: bool) -> str:
    """§III-E hybrid policy on unit-block density."""
    if she and algorithm == "lor_reg":
        return "opst" if density < T0 else "akdtree"
    if density < T1:
        return "opst"
    if density < T2:
        return "akdtree"
    return "gsp"


def partition_level(data: np.ndarray, mask: np.ndarray, *, unit: int = 8,
                    algorithm: str = "lor_reg", she: bool = True,
                    strategy: str | None = None,
                    ) -> tuple[BlockGrid, str, float, list[SubBlock]]:
    """One level's unit-block grid, strategy, density and sub-blocks
    (``subblocks`` is empty for ``"gsp"``), without compressing.

    :raises NotImplementedError: for ``strategy="nast"``.
    :raises ValueError: on an unknown ``strategy``.
    """
    grid = make_block_grid(data, mask, unit=unit)
    density = grid.block_density
    if strategy is None:
        strategy = choose_strategy(density, algorithm=algorithm, she=she)
    if strategy == "gsp":
        return grid, "gsp", density, []
    if strategy == "opst":
        subblocks = opst_partition(grid)
    elif strategy == "akdtree":
        subblocks = akdtree_partition(grid)
    elif strategy == "nast":
        raise NotImplementedError("the nast strategy is not yet ported")
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return grid, strategy, density, subblocks


def compress_level(data: np.ndarray, mask: np.ndarray, *, eb: float,
                   unit: int = 8, algorithm: str = "lor_reg",
                   she: bool = True, strategy: str | None = None,
                   sz_block: int = 6, batched: bool = True,
                   ratio: int = 1, keep_artifacts: bool = True,
                   device: str | torch.device = "cuda") -> LevelResult:
    """One level end to end on ``device``; ``recon`` is a device tensor."""
    device = resolve_device(device)
    if not she or algorithm != "lor_reg":
        raise NotImplementedError("only TAC+ (she=True, algorithm='lor_reg') "
                                  "is ported; the merged-4D TAC path and the "
                                  "interp/lorenzo algorithms are not yet "
                                  "ported")
    if not batched:
        raise NotImplementedError("the sequential batched=False path is not "
                                  "yet ported")
    grid, strategy, density, subblocks = partition_level(
        data, mask, unit=unit, algorithm=algorithm, she=she,
        strategy=strategy)
    if strategy == "gsp":
        raise NotImplementedError("the gsp strategy is not yet ported")
    orig_shape = tuple(data.shape)
    u = grid.unit
    enc = she_encode([extract_subblock(grid, sb) for sb in subblocks], eb,
                     block=sz_block, device=device)
    recon = torch.zeros(grid.data.shape, dtype=torch.float32, device=device)
    for sb, r in zip(subblocks, enc.results):
        ox, oy, oz = sb.cell_origin(u)
        sx, sy, sz = sb.cell_size(u)
        recon[ox:ox + sx, oy:oy + sy, oz:oz + sz] = r.recon
    recon = recon[tuple(slice(0, s) for s in orig_shape)]
    mask_t = torch.from_numpy(np.asarray(mask, dtype=bool)).to(device)
    recon = torch.where(mask_t, recon, 0.0)
    art = None
    if keep_artifacts:
        art = LevelArtifacts(mask=np.asarray(mask, dtype=bool),
                             orig_shape=orig_shape,
                             grid_shape=tuple(grid.data.shape),
                             unit=grid.unit, sz_block=sz_block,
                             subblocks=subblocks, results=enc.results,
                             codebook=enc.codebook)
    sb_meta = sum(sb.meta_bits() for sb in subblocks)
    return LevelResult(strategy=strategy, algorithm=algorithm, she=True,
                       payload_bits=enc.payload_bits,
                       codebook_bits=enc.codebook_bits,
                       meta_bits=enc.meta_bits + sb_meta,
                       recon=recon, n_values=int(np.asarray(mask).sum()),
                       density=density, eb=eb,
                       n_subblocks=len(subblocks), ratio=ratio,
                       artifacts=art)


def compress_amr(ds: AMRDataset, *, eb: float | list[float],
                 unit: int = 8, algorithm: str = "lor_reg",
                 she: bool = True, strategy: str | None = None,
                 sz_block: int = 6, batched: bool = True,
                 keep_artifacts: bool = True,
                 device: str | torch.device = "cuda") -> AMRCompressionResult:
    """Level-wise TAC+ over a whole AMR dataset on ``device``.

    ``eb`` may be a scalar or one bound per level.  ``unit`` is the
    finest level's unit-block edge; coarser levels use
    ``max(2, unit // ratio)``.  ``keep_artifacts=True`` keeps what
    :func:`repro_torch.io.write` needs.
    """
    device = resolve_device(device)
    ebs = eb if isinstance(eb, (list, tuple)) else [eb] * ds.n_levels
    if len(ebs) != ds.n_levels:
        raise ValueError("need one error bound per level")
    levels = []
    for lvl, e in zip(ds.levels, ebs):
        levels.append(compress_level(
            lvl.data, lvl.mask, eb=float(e), unit=max(2, unit // lvl.ratio),
            algorithm=algorithm, she=she, strategy=strategy,
            sz_block=sz_block, batched=batched, ratio=lvl.ratio,
            keep_artifacts=keep_artifacts, device=device))
    return AMRCompressionResult(levels=levels, method=f"tac+/{algorithm}")
