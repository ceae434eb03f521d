"""Hybrid level-wise AMR compression — the TAC and TAC+ drivers (paper
§III-E).

Per AMR level the unit-block density picks the pre-process strategy:

* **Lor/Reg + SHE (TAC+)**: OpST+ below T0 = 50 %, AKDTree+ above;
* **Interp, Lorenzo, or Lor/Reg without SHE (TAC)**: OpST below
  T1 = 50 % ≤ AKDTree below T2 = 85 % ≤ GSP.

The strategy feeds the matching SZ path, on the device:

* GSP → the padded full grid → one global compression;
* OpST/AKDTree/NaST with SHE → per-sub-block Lor/Reg prediction and one
  shared Huffman codebook;
* OpST/AKDTree/NaST without SHE → same-size sub-blocks merged into 4D
  arrays, each compressed globally (prediction crosses sub-block
  boundaries — the artifact SHE removes).

Level reconstructions are scattered back on the device, exact zeros
outside the mask.  Partitioning is integer host logic (numpy).  The SHE
path runs each same-shape group of bricks as one batch (``batched=True``)
or brick by brick (``batched=False``); both give the same codes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..obs import metrics as obsm
from . import huffman
from .akdtree import akdtree_partition
from .amr import AMRDataset
from .blocks import BlockGrid, SubBlock, extract_subblock, make_block_grid
from .gsp import gsp_meta_bits, gsp_pad, gsp_unpad
from .opst import opst_partition
from .she import check_engine_names, she_encode
from .sz import SZResult, compress_interp, compress_lor_reg, compress_lorenzo

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
    subblocks: list[SubBlock]     # placement (empty for gsp/global levels)
    results: list[SZResult]       # per-sub-block codes/branch/betas
    codebook: huffman.Codebook | None  # shared Huffman codebook (SHE levels)


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


def _global_compress(x: torch.Tensor, eb: float, algorithm: str,
                     sz_block: int = 6) -> SZResult:
    if algorithm == "interp":
        return compress_interp(x, eb)
    if algorithm == "lorenzo":
        return compress_lorenzo(x, eb)
    if algorithm == "lor_reg":
        # the block edge must match what the level records (the TACZ index
        # stores sz_block and the decoder rebuilds the betas grid from it)
        return compress_lor_reg(x, eb, block=sz_block)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _merged_compress(groups: dict[tuple[int, ...], torch.Tensor], eb: float,
                     algorithm: str,
                     ) -> tuple[list[SZResult], dict[tuple[int, ...],
                                                     torch.Tensor]]:
    """TAC path: one global compression per same-size 4D group.  Lor/Reg
    without SHE compresses each group with the global Lorenzo predictor,
    which runs across the block-stacking axis (the paper's boundary
    artifact)."""
    alg = "lorenzo" if algorithm == "lor_reg" else algorithm
    results, recon = [], {}
    for shape, arr in groups.items():
        r = _global_compress(arr, eb, alg)
        results.append(r)
        recon[shape] = r.recon
    return results, recon


def partition_level(data: np.ndarray, mask: np.ndarray, *, unit: int = 8,
                    algorithm: str = "lor_reg", she: bool = True,
                    strategy: str | None = None,
                    ) -> tuple[BlockGrid, str, float, list[SubBlock]]:
    """One level's unit-block grid, strategy, density and sub-blocks
    (``subblocks`` is empty for ``"gsp"``; one unit sub-block per
    non-empty block for ``"nast"``), without compressing.

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
        subblocks = [SubBlock(origin=tuple(int(v) for v in c),
                              bsize=(1, 1, 1)) for c in np.argwhere(grid.occ)]
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return grid, strategy, density, subblocks


def compress_level(data: np.ndarray, mask: np.ndarray, *, eb: float,
                   unit: int = 8, algorithm: str = "lor_reg",
                   she: bool = True, strategy: str | None = None,
                   sz_block: int = 6, batched: bool = True,
                   ratio: int = 1, keep_artifacts: bool = True,
                   lorenzo_engine: str = "auto",
                   entropy_engine: str = "auto",
                   device: str | torch.device = "cuda") -> LevelResult:
    """One level end to end on ``device``; ``recon`` is a device tensor.

    ``lorenzo_engine`` and ``entropy_engine`` take the reference's engine
    names for signature parity; every name runs the same kernels.  The
    level's wall time goes into ``tacz_compress_level_seconds{strategy}``
    under a ``compress_level`` span, ending where the recon is ready (the
    stage timings — prequant, branch_score, entropy — are recorded inside
    sz/she).

    :raises ValueError: for an unknown algorithm or engine name.
    """
    device = resolve_device(device)
    with obs.trace("compress_level"):
        t0 = time.perf_counter()
        res = _compress_level(
            data, mask, eb=eb, unit=unit, algorithm=algorithm, she=she,
            strategy=strategy, sz_block=sz_block, batched=batched,
            ratio=ratio, keep_artifacts=keep_artifacts,
            lorenzo_engine=lorenzo_engine, entropy_engine=entropy_engine,
            device=device)
        hist = obsm.COMPRESS_LEVEL_SECONDS.labels(res.strategy)
        if device.type == "cuda" and obs.is_enabled():
            torch.cuda.current_stream(device).synchronize()
        hist.observe(time.perf_counter() - t0)
        return res


def _compress_level(data: np.ndarray, mask: np.ndarray, *, eb: float,
                    unit: int, algorithm: str, she: bool,
                    strategy: str | None, sz_block: int, batched: bool,
                    ratio: int, keep_artifacts: bool, lorenzo_engine: str,
                    entropy_engine: str, device: torch.device,
                    ) -> LevelResult:
    if algorithm not in ("lor_reg", "lorenzo", "interp"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    check_engine_names(lorenzo_engine=lorenzo_engine,
                       entropy_engine=entropy_engine)
    grid, strategy, density, subblocks = partition_level(
        data, mask, unit=unit, algorithm=algorithm, she=she,
        strategy=strategy)
    orig_shape = tuple(data.shape)
    crop = tuple(slice(0, s) for s in orig_shape)
    mask_np = np.asarray(mask, dtype=bool)
    n_values = int(mask_np.sum())

    if strategy == "gsp":
        padded, grid = gsp_pad(data, mask, unit=unit, device=device)
        r = _global_compress(padded, eb, algorithm, sz_block)
        art = None
        if keep_artifacts:
            art = LevelArtifacts(mask=mask_np, orig_shape=orig_shape,
                                 grid_shape=tuple(grid.data.shape),
                                 unit=unit, sz_block=sz_block,
                                 subblocks=[], results=[r], codebook=None)
        return LevelResult(strategy="gsp", algorithm=algorithm, she=False,
                           payload_bits=r.payload_bits,
                           codebook_bits=r.codebook_bits,
                           meta_bits=r.meta_bits + gsp_meta_bits(grid),
                           recon=gsp_unpad(r.recon, grid)[crop],
                           n_values=n_values, density=density, eb=eb,
                           ratio=ratio, artifacts=art)

    u = grid.unit
    sb_meta = sum(sb.meta_bits() for sb in subblocks)
    mask_t = torch.from_numpy(mask_np).to(device)
    recon = torch.zeros(grid.data.shape, dtype=torch.float32, device=device)

    def place(sb: SubBlock, brick: torch.Tensor) -> None:
        recon[tuple(slice(o, o + s) for o, s
                    in zip(sb.cell_origin(u), sb.cell_size(u)))] = brick

    if she and algorithm == "lor_reg":
        enc = she_encode([extract_subblock(grid, sb) for sb in subblocks],
                         eb, block=sz_block, batched=batched, device=device)
        for sb, r in zip(subblocks, enc.results):
            place(sb, r.recon)
        art = None
        if keep_artifacts:
            art = LevelArtifacts(mask=mask_np, orig_shape=orig_shape,
                                 grid_shape=tuple(grid.data.shape),
                                 unit=grid.unit, sz_block=sz_block,
                                 subblocks=subblocks, results=enc.results,
                                 codebook=enc.codebook)
        return LevelResult(strategy=strategy, algorithm=algorithm, she=True,
                           payload_bits=enc.payload_bits,
                           codebook_bits=enc.codebook_bits,
                           meta_bits=enc.meta_bits + sb_meta,
                           recon=torch.where(mask_t, recon[crop], 0.0),
                           n_values=n_values, density=density, eb=eb,
                           n_subblocks=len(subblocks), ratio=ratio,
                           artifacts=art)

    # TAC path: merge same-size sub-blocks into 4D arrays, largest edge
    # first; the permutation is numpy's argsort, whose tie order the
    # reference's group keys depend on
    grid_t = torch.from_numpy(np.ascontiguousarray(grid.data)).to(device)
    members: dict[tuple[int, ...], list] = {}
    for sb in subblocks:
        size = sb.cell_size(u)
        order = tuple(int(a) for a in np.argsort(size)[::-1])
        brick = grid_t[tuple(slice(o, o + s) for o, s
                             in zip(sb.cell_origin(u), size))]
        members.setdefault(tuple(size[a] for a in order), []).append(
            (sb, order, brick.permute(order)))
    results, recons = _merged_compress(
        {shape: torch.stack([b for _, _, b in items])
         for shape, items in members.items()}, eb, algorithm)
    for shape, items in members.items():
        for i, (sb, order, _) in enumerate(items):
            place(sb, recons[shape][i].permute(
                tuple(int(a) for a in np.argsort(order))))
    # merged groups interleave many sub-blocks into one code stream, so
    # no per-sub-block payload exists and the level has no artifacts
    return LevelResult(strategy=strategy, algorithm=algorithm, she=False,
                       payload_bits=sum(r.payload_bits for r in results),
                       codebook_bits=sum(r.codebook_bits for r in results),
                       meta_bits=sb_meta + len(results) * 64,
                       recon=torch.where(mask_t, recon[crop], 0.0),
                       n_values=n_values, density=density, eb=eb,
                       n_subblocks=len(subblocks), ratio=ratio)


def compress_amr(ds: AMRDataset, *, eb: float | list[float],
                 unit: int = 8, algorithm: str = "lor_reg",
                 she: bool = True, strategy: str | None = None,
                 sz_block: int = 6, batched: bool = True,
                 keep_artifacts: bool = True,
                 lorenzo_engine: str = "auto",
                 entropy_engine: str = "auto",
                 device: str | torch.device = "cuda") -> AMRCompressionResult:
    """Level-wise TAC/TAC+ over a whole AMR dataset on ``device``.

    ``eb`` may be a scalar or one bound per level (see
    :func:`repro_torch.core.adaptive_eb.level_error_bounds`).  ``unit`` is
    the finest level's unit-block edge; coarser levels use
    ``max(2, unit // ratio)``.  ``keep_artifacts=True`` keeps what
    :func:`repro_torch.io.write` needs.  ``batched`` and the engine names
    are :func:`compress_level`'s.
    """
    check_engine_names(lorenzo_engine=lorenzo_engine,
                       entropy_engine=entropy_engine)
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
    name = "tac+" if (she and algorithm == "lor_reg") else "tac"
    return AMRCompressionResult(levels=levels, method=f"{name}/{algorithm}")
