"""Comparison baselines (paper §IV-A): naive-1D, zMesh, 3D-upsampling.

* **1D baseline** — each AMR level's valid values are flattened row-major
  and compressed as a 1D stream (1D Lorenzo + Huffman): spatial information
  lost, one compressor launch per level.
* **zMesh [28]** — levels are traversed *together* in octree (z-) order:
  a coarse cell emits its value if stored at the coarse level, otherwise
  descends into its 2³ refined children.  On tree-based data this inserts
  cross-level jumps, which is why the paper finds zMesh *slightly worse*
  than the 1D baseline (Fig. 28).
* **3D baseline** — upsample every coarse level to the finest resolution
  (piecewise-constant), compress the combined full-resolution field in 3D.
  The compression ratio is charged against the *original* AMR value count.

The port of ``repro.core.baselines``: streams and level reconstructions
are tensors on ``device``, the traversal and the bit shares are the
reference's numpy/float64 arithmetic, so bits and recon are its own.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .amr import AMRDataset, uniform_resolution
from .hybrid import AMRCompressionResult, LevelResult
from .sz import (SZResult, compress_interp, compress_lor_reg,
                 compress_lorenzo, dequant, entropy_bits, lorenzo_nd_codes,
                 lorenzo_nd_recon, prequant)

__all__ = ["compress_1d_naive", "compress_zmesh", "compress_3d_baseline",
           "zmesh_order"]


def _compress_1d_stream(values: torch.Tensor, eb: float) -> SZResult:
    """1D dual-quant Lorenzo + Huffman on a flat stream."""
    q = prequant(values, eb)
    codes = lorenzo_nd_codes(q)
    payload, cb_bits = entropy_bits(codes)
    recon = dequant(lorenzo_nd_recon(codes), eb)
    return SZResult(recon=recon, codes=codes, payload_bits=payload,
                    codebook_bits=cb_bits, meta_bits=96, eb=eb, method="1d")


def compress_1d_naive(ds: AMRDataset, eb: float | list[float], *,
                      device: str | torch.device = "cuda"
                      ) -> AMRCompressionResult:
    device = resolve_device(device)
    ebs = eb if isinstance(eb, (list, tuple)) else [eb] * ds.n_levels
    levels = []
    for lvl, e in zip(ds.levels, ebs):
        data = torch.from_numpy(lvl.data).to(device)
        mask = torch.from_numpy(lvl.mask).to(device)
        r = _compress_1d_stream(data[mask], float(e))
        recon = torch.zeros_like(data)
        recon[mask] = r.recon
        levels.append(LevelResult(strategy="flatten", algorithm="1d",
                                  she=False, payload_bits=r.payload_bits,
                                  codebook_bits=r.codebook_bits,
                                  meta_bits=r.meta_bits, recon=recon,
                                  n_values=int(lvl.mask.sum()),
                                  density=lvl.density, eb=float(e)))
    return AMRCompressionResult(levels=levels, method="1d-naive")


def zmesh_order(ds: AMRDataset) -> tuple[np.ndarray, list[np.ndarray],
                                         np.ndarray]:
    """Octree traversal across levels (zMesh reordering, Fig. 28), on the
    host.

    Returns (reordered 1D value stream, per-level flat cell indices in
    traversal order, per-element level tags) — enough to invert exactly.
    """
    n_levels = ds.n_levels
    stream: list[float] = []
    tags: list[int] = []
    index_per_level: list[list[int]] = [[] for _ in range(n_levels)]
    masks = [l.mask for l in ds.levels]
    datas = [l.data for l in ds.levels]

    def descend(level: int, x: int, y: int, z: int) -> None:
        # level indexes ds.levels (0 = finest); cell (x,y,z) in that grid
        if masks[level][x, y, z]:
            flat = int(np.ravel_multi_index((x, y, z), masks[level].shape))
            index_per_level[level].append(flat)
            stream.append(float(datas[level][x, y, z]))
            tags.append(level)
            return
        if level == 0:
            raise AssertionError("tiling invariant violated in zmesh_order")
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    descend(level - 1, 2 * x + dx, 2 * y + dy, 2 * z + dz)

    cx, cy, cz = ds.levels[-1].shape
    for x in range(cx):
        for y in range(cy):
            for z in range(cz):
                descend(n_levels - 1, x, y, z)
    return (np.asarray(stream, dtype=np.float32),
            [np.asarray(ix, dtype=np.int64) for ix in index_per_level],
            np.asarray(tags, dtype=np.int32))


def compress_zmesh(ds: AMRDataset, eb: float, *,
                   device: str | torch.device = "cuda"
                   ) -> AMRCompressionResult:
    device = resolve_device(device)
    stream, idx, tags = zmesh_order(ds)
    r = _compress_1d_stream(torch.from_numpy(stream).to(device), eb)
    tags_t = torch.from_numpy(tags).to(device)
    levels = []
    for lvl, lev in enumerate(ds.levels):
        recon = torch.zeros(lev.shape, dtype=torch.float32, device=device)
        recon.view(-1)[torch.from_numpy(idx[lvl]).to(device)] = \
            r.recon[tags_t == lvl]
        share = lev.mask.sum() / max(stream.size, 1)
        levels.append(LevelResult(
            strategy="zorder", algorithm="1d", she=False,
            payload_bits=int(r.payload_bits * share),
            codebook_bits=int(r.codebook_bits * share),
            meta_bits=int(r.meta_bits * share),
            recon=recon, n_values=int(lev.mask.sum()),
            density=lev.density, eb=eb))
    return AMRCompressionResult(levels=levels, method="zmesh")


def compress_3d_baseline(ds: AMRDataset, eb: float, *,
                         algorithm: str = "lor_reg",
                         device: str | torch.device = "cuda"
                         ) -> AMRCompressionResult:
    """Upsample-and-merge 3D baseline (§II-D 'High-dimensional');
    ``algorithm="lorenzo"`` runs kernels 5 and 6 on the uniform field."""
    device = resolve_device(device)
    uni_np = uniform_resolution(ds)
    uni = torch.from_numpy(uni_np).to(device)
    if algorithm == "interp":
        r = compress_interp(uni, eb)
    elif algorithm == "lorenzo":
        r = compress_lorenzo(uni, eb)
    else:
        r = compress_lor_reg(uni, eb)
    # reconstruct each level by sampling the corner cell of its footprint —
    # the upsampling was piecewise-constant, so this is decoder-exact and
    # keeps the per-value error within eb.
    levels = []
    for lvl in ds.levels:
        ratio = lvl.ratio
        sampled = r.recon[::ratio, ::ratio, ::ratio]
        mask = torch.from_numpy(lvl.mask).to(device)
        recon = torch.where(mask, sampled, 0.0).float()
        share = (lvl.mask.sum() * ratio ** 3) / uni_np.size
        levels.append(LevelResult(
            strategy="upsample", algorithm=algorithm, she=False,
            payload_bits=int(r.payload_bits * share),
            codebook_bits=int(r.codebook_bits * share),
            meta_bits=int(r.meta_bits * share),
            recon=recon, n_values=int(lvl.mask.sum()),
            density=lvl.density, eb=eb))
    return AMRCompressionResult(levels=levels,
                                method=f"3d-baseline/{algorithm}")
