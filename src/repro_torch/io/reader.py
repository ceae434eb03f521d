"""TACZ reader: full decode, region-of-interest decode, corruption checks.

The reader parses the footer + CRC'd index, then seeks straight to the
byte ranges it needs (host I/O, CRCs and the zlib/zstd byte pass).  All
Huffman payloads of one level that a call needs are decoded in one launch
of kernel 4 on the reader's device, and each (shape, branch) group of
bricks is reconstructed in one batch (Lorenzo bricks on kernel 2).
Levels and crops come back as float32 tensors on that device,
bit-identical to the compress-time reconstruction.  A gsp or global level
is one payload of the whole grid: it decodes as a unit (region reads
decode it fully, then crop).  Multi-part snapshots raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import io as _stdio
import os
import threading
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core import entropy, huffman, sz
from ..core.blocks import make_block_grid
from ..core.compat import HAVE_ZSTD, zstd_decompress
from ..core.gsp import gsp_unpad
from ..device import resolve_device
from . import format as fmt
from . import frontier as frt

__all__ = ["ROILevel", "TACZReader", "open_snapshot", "read", "read_roi"]

Box = tuple[tuple[int, int], tuple[int, int], tuple[int, int]]


@dataclass
class ROILevel:
    """One level's crop of a region-of-interest read."""

    level: int                    # level index in the file
    ratio: int                    # coarsening ratio vs the finest grid
    box: Box                      # the decoded box, in *level* cells
    data: torch.Tensor            # recon crop, shape = box extents

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.box)


def _decompress(buf: bytes, compressor: int) -> bytes:
    if compressor == fmt.COMPRESSOR_NONE:
        return buf
    if compressor == fmt.COMPRESSOR_ZLIB:
        return zlib.decompress(buf)
    if compressor == fmt.COMPRESSOR_ZSTD:
        if not HAVE_ZSTD:
            raise ModuleNotFoundError(
                "this TACZ file was written with zstd payloads but "
                "zstandard is not installed")
        return zstd_decompress(buf)
    raise ValueError(f"unknown compressor {compressor}")


class TACZReader:
    """Random-access reader over a TACZ container, decoding on ``device``.

    The constructor validates framing eagerly (header magic/version,
    footer, index bounds, index CRC), so a truncated or corrupt file fails
    at open time.  A damaged optional ``TACF`` frontier section is
    reported in :attr:`frontier_error`, never raised.

    :param src: file path, raw ``bytes``/``bytearray``, or a seekable
        binary file object (not closed on :meth:`close`).
    :param device: where payloads decode (default ``"cuda"``).
    :raises ValueError: if the bytes are not a valid TACZ container.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """

    _SHE_STRATEGIES = (fmt.STRATEGY_OPST, fmt.STRATEGY_AKDTREE,
                       fmt.STRATEGY_NAST)

    def __init__(self, src, *, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._engine = entropy.TorchEngine(self.device)
        if isinstance(src, (bytes, bytearray)):
            self._f = _stdio.BytesIO(bytes(src))
            self._own = True
        elif hasattr(src, "seek"):
            self._f = src
            self._own = False
        else:
            self._f = open(src, "rb")
            self._own = True
        self._io_lock = threading.Lock()   # seek+read must be atomic
        try:
            self._f.seek(0, 2)
            self._size = self._f.tell()
            self.version = fmt.parse_header(
                self._read_at(0, min(fmt.HEADER_SIZE, self._size)))
            idx_off, idx_len, idx_crc = fmt.parse_footer(
                self._read_at(max(0, self._size - fmt.FOOTER_SIZE),
                              min(fmt.FOOTER_SIZE, self._size)))
            if idx_off + idx_len + fmt.FOOTER_SIZE > self._size:
                raise ValueError("truncated TACZ file: index out of bounds")
            index = self._read_at(idx_off, idx_len)
            if fmt.index_crc(index) != idx_crc:
                raise ValueError("corrupt TACZ file: index CRC mismatch")
            self.index_crc = idx_crc & 0xFFFFFFFF
            self.levels: list[fmt.LevelEntry] = fmt.parse_index(
                index, version=self.version)
            self.frontier: frt.Frontier | None = None
            self.frontier_error: str | None = None
            gap = (self._size - fmt.FOOTER_SIZE) - (idx_off + idx_len)
            if gap > 0:
                try:
                    self.frontier = frt.parse_section(
                        self._read_at(idx_off + idx_len, gap))
                except ValueError as exc:
                    self.frontier_error = str(exc)
        except BaseException:
            self.close()
            raise
        self._codebooks: dict[int, huffman.Codebook] = {}
        self._masks: dict[int, torch.Tensor | None] = {}

    # ------------------------------ plumbing -------------------------------

    def close(self) -> None:
        """Close the underlying handle (no-op for caller-owned files)."""
        if self._own:
            self._f.close()

    def __enter__(self) -> "TACZReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def _read_at(self, off: int, length: int) -> bytes:
        with self._io_lock:
            self._f.seek(off)
            buf = self._f.read(length)
        if len(buf) != length:
            raise ValueError("truncated TACZ file: unexpected EOF")
        return buf

    def _section(self, off: int, length: int, crc: int, what: str,
                 li: int) -> bytes:
        buf = self._read_at(off, length)
        if (zlib.crc32(buf) & 0xFFFFFFFF) != (crc & 0xFFFFFFFF):
            raise IOError(f"TACZ corruption: {what} section CRC mismatch "
                          f"(level {li})")
        return buf

    def _codebook(self, li: int) -> huffman.Codebook:
        if li not in self._codebooks:
            e = self.levels[li]
            self._codebooks[li] = huffman.deserialize_codebook(
                self._section(e.codebook_off, e.codebook_len,
                              e.codebook_crc, "codebook", li))
        return self._codebooks[li]

    def _mask(self, li: int) -> torch.Tensor | None:
        """Level validity mask on the device, or None (all-True)."""
        if li not in self._masks:
            e = self.levels[li]
            if e.mask_len == 0:
                self._masks[li] = None
            else:
                raw = _decompress(
                    self._section(e.mask_off, e.mask_len, e.mask_crc,
                                  "mask", li),
                    e.mask_compressor)
                n = int(np.prod(e.shape))
                bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8),
                                     count=n)
                self._masks[li] = torch.from_numpy(
                    bits.astype(bool).reshape(e.shape)).to(self.device)
        return self._masks[li]

    # ------------------------------ decoding -------------------------------

    @staticmethod
    def _prefix_limit(sb: fmt.SubBlockEntry, shape: tuple[int, ...],
                      sz_block: int, hi: tuple[int, int, int]) -> int:
        """Leading codes needed to reconstruct every brick-local cell
        below ``hi``: Lorenzo recon of (i,j,k) sums the code rectangle
        [0..i]×[0..j]×[0..k], all at C-order flat index ≤ flat(i,j,k); the
        regression branch is block-local with blocks in C order; interp
        is global, with no partial decode."""
        corner = tuple(h - 1 for h in hi)
        if sb.branch == fmt.BRANCH_REG:
            b, bgrid = sz.reg_block_grid(shape, sz_block)
            bc = tuple(c // b for c in corner)
            flat = (bc[0] * bgrid[1] + bc[1]) * bgrid[2] + bc[2]
            return (flat + 1) * b ** 3
        if sb.branch == fmt.BRANCH_LORENZO:
            flat = (corner[0] * shape[1] + corner[1]) * shape[2] + corner[2]
            return flat + 1
        return sb.n_codes

    def _payload_parts(self, li: int, sb: fmt.SubBlockEntry,
                       shape: tuple[int, ...],
                       ) -> tuple[bytes, np.ndarray | None]:
        """Fetch + CRC-check one payload → (code bytes, betas)."""
        e = self.levels[li]
        payload = self._read_at(sb.payload_off, sb.payload_len)
        if (zlib.crc32(payload) & 0xFFFFFFFF) != sb.crc:
            raise IOError(f"TACZ corruption: sub-block payload CRC mismatch "
                          f"(level {li}, offset {sb.payload_off})")
        betas = None
        if sb.betas_len:
            _, bgrid = sz.reg_block_grid(shape, e.sz_block)
            betas = np.frombuffer(payload, dtype="<f4",
                                  count=int(np.prod(bgrid)) * 4,
                                  offset=0).reshape(bgrid + (4,))
        return _decompress(payload[sb.betas_len:], sb.compressor), betas

    def _decode_payloads(self, li: int, jobs,
                         ) -> list[tuple[torch.Tensor, np.ndarray | None]]:
        """(device codes, host betas) per ``(sub-block entry, shape,
        limit)`` job; every Huffman payload goes through one
        ``decode_payloads`` launch.  With a ``limit`` only the leading
        ``limit`` codes are decoded; the rest are zeros."""
        out: list = [None] * len(jobs)
        huff: list[tuple[int, tuple[bytes, int, int]]] = []
        metas = []
        for pos, (sb, shape, limit) in enumerate(jobs):
            code_bytes, betas = self._payload_parts(li, sb, shape)
            n_decode = (sb.n_codes if limit is None
                        else min(int(limit), sb.n_codes))
            metas.append((sb, n_decode, betas))
            if sb.codec == fmt.CODEC_HUFFMAN:
                huff.append((pos, (code_bytes, sb.nbits, n_decode)))
            elif sb.codec in (fmt.CODEC_RAW_I16, fmt.CODEC_RAW_I32):
                dt = "<i2" if sb.codec == fmt.CODEC_RAW_I16 else "<i4"
                codes = np.frombuffer(code_bytes, dtype=dt, count=n_decode)
                out[pos] = torch.from_numpy(codes.astype(np.int64)).to(
                    self.device)
            else:
                raise ValueError(f"unknown payload codec {sb.codec}")
        if huff:
            decoded = self._engine.decode_payloads(
                self._codebook(li), [p for _, p in huff])
            for (pos, _), codes in zip(huff, decoded):
                out[pos] = codes
        result = []
        for codes, (sb, n_decode, betas) in zip(out, metas):
            if n_decode < sb.n_codes:
                full = torch.zeros(sb.n_codes, dtype=torch.int64,
                                   device=self.device)
                full[:n_decode] = codes
                codes = full
            result.append((codes, betas))
        return result

    def subblock_shape(self, li: int, sbi: int) -> tuple[int, ...]:
        """Decode shape of one sub-block payload: the brick for SHE
        levels, the padded grid (gsp) or the level shape (global) for
        single-payload levels."""
        e = self.levels[li]
        if e.strategy in self._SHE_STRATEGIES:
            return tuple(int(s) for s in e.subblocks[sbi].size)
        if e.strategy == fmt.STRATEGY_GSP:
            return tuple(int(s) for s in e.grid_shape)
        return tuple(int(s) for s in e.shape)

    def decode_subblocks(self, li: int, sbis, limits=None,
                         ) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
        """(codes, betas) device tensors for many sub-blocks of one level,
        in input order; every Huffman payload of the batch decodes in one
        launch.  ``limits`` gives optional per-entry prefix limits."""
        e = self.levels[li]
        jobs = [(e.subblocks[sbi], self.subblock_shape(li, sbi),
                 None if limits is None else limits[pos])
                for pos, sbi in enumerate(sbis)]
        return [(codes, None if betas is None
                 else torch.from_numpy(betas.copy()).to(self.device))
                for codes, betas in self._decode_payloads(li, jobs)]

    def _decode_bricks(self, li: int, jobs) -> list[torch.Tensor]:
        """Reconstructed bricks for many ``(sbi, limit)`` jobs of one SHE
        level: one entropy launch over every payload, then one batched
        reconstruction per (shape, branch) group."""
        e = self.levels[li]
        sbis = [sbi for sbi, _ in jobs]
        decoded = self._decode_payloads(
            li, [(e.subblocks[sbi], self.subblock_shape(li, sbi), lim)
                 for sbi, lim in jobs])
        groups: dict[tuple[tuple[int, ...], int], list[int]] = {}
        for pos, sbi in enumerate(sbis):
            key = (self.subblock_shape(li, sbi), e.subblocks[sbi].branch)
            groups.setdefault(key, []).append(pos)
        out: list[torch.Tensor | None] = [None] * len(jobs)
        for (shape, branch), poss in groups.items():
            codes = torch.stack([decoded[p][0] for p in poss])
            betas = None
            if branch == fmt.BRANCH_REG:
                betas = torch.from_numpy(
                    np.stack([decoded[p][1] for p in poss])).to(self.device)
            recon = sz.decode_codes_batched(
                codes, shape, e.eb, branch=fmt.BRANCH_NAMES[branch],
                block=e.sz_block, betas=betas)
            for p, brick in zip(poss, recon):
                out[p] = brick
        return out

    def read_level(self, li: int) -> torch.Tensor:
        """Full decode of one level: float32 at the level's original
        shape, bit-identical to the compress-time recon.

        :raises IOError: if a section or payload fails its CRC check.
        """
        e = self.levels[li]
        mask = self._mask(li)
        if e.strategy in self._SHE_STRATEGIES:
            acc = torch.zeros(e.grid_shape, dtype=torch.float32,
                              device=self.device)
            bricks = self._decode_bricks(
                li, [(sbi, None) for sbi in range(len(e.subblocks))])
            for sb, brick in zip(e.subblocks, bricks):
                acc[tuple(slice(o, o + s)
                          for o, s in zip(sb.origin, sb.size))] = brick
            recon = acc[tuple(slice(0, s) for s in e.shape)]
            if mask is not None:
                recon = torch.where(mask, recon, 0.0)
            return recon.contiguous()
        if e.strategy not in (fmt.STRATEGY_GSP, fmt.STRATEGY_GLOBAL):
            raise ValueError(f"unknown strategy {e.strategy}")
        shape = self.subblock_shape(li, 0)
        (codes, betas), = self.decode_subblocks(li, [0])
        recon = sz.decode_codes(
            codes, shape, e.eb, branch=fmt.BRANCH_NAMES[e.subblocks[0].branch],
            block=e.sz_block, betas=betas)
        if e.strategy == fmt.STRATEGY_GSP:
            # the occupancy of the unit blocks comes back from the mask
            m = (np.ones(e.shape, dtype=bool) if mask is None
                 else mask.cpu().numpy())
            grid = make_block_grid(np.zeros(e.shape, dtype=np.float32), m,
                                   unit=e.unit)
            return gsp_unpad(recon, grid)[
                tuple(slice(0, s) for s in e.shape)].contiguous()
        if mask is not None:
            recon = torch.where(mask, recon, 0.0)
        return recon.contiguous()

    def read(self) -> list[torch.Tensor]:
        """Full decode of every level, in file order."""
        return [self.read_level(i) for i in range(self.n_levels)]

    # ------------------------------ ROI decode -----------------------------

    def level_box(self, li: int, box: Box) -> Box:
        """Map a finest-grid box into level ``li`` cells (lows floored,
        highs ceiled through the ratio, clipped to the level extent)."""
        e = self.levels[li]
        if e.rank != 3:
            raise ValueError("ROI reads need 3D levels")
        r = max(int(e.ratio), 1)
        return tuple(
            (min(max(lo // r, 0), s), min(-(-hi // r), s))
            for (lo, hi), s in zip(box, e.shape))

    def intersecting_subblocks(self, li: int, lbox: Box,
                               ) -> list[tuple[int, Box]]:
        """``(sub_block_index, intersection_box)`` of every sub-block of
        level ``li`` overlapping ``lbox`` (level cells), in index order."""
        out: list[tuple[int, Box]] = []
        for i, sb in enumerate(self.levels[li].subblocks):
            isect = tuple(
                (max(lo, o), min(hi, o + s))
                for (lo, hi), o, s in zip(lbox, sb.origin, sb.size))
            if all(hi > lo for lo, hi in isect):
                out.append((i, isect))
        return out

    def read_level_box(self, li: int, lbox: Box) -> torch.Tensor:
        """Decode one level's crop of a box given in *level* cells
        (clipped to the level), decoding only the prefix of each
        intersecting sub-block that the box needs (gsp/global levels
        decode whole, then crop)."""
        if len(lbox) != 3:
            raise ValueError("box must be ((x0,x1),(y0,y1),(z0,z1))")
        e = self.levels[li]
        clipped = tuple((min(max(int(lo), 0), s), min(max(int(hi), 0), s))
                        for (lo, hi), s in zip(lbox, e.shape))
        return self._level_roi(li, clipped)

    def _level_roi(self, li: int, lbox: Box) -> torch.Tensor:
        bshape = tuple(max(hi - lo, 0) for lo, hi in lbox)
        if 0 in bshape:
            return torch.zeros(bshape, dtype=torch.float32,
                               device=self.device)
        e = self.levels[li]
        if e.strategy not in self._SHE_STRATEGIES:
            # one global payload: decode fully, then crop (interpolation
            # and padding are not block-local)
            return self.read_level(li)[
                tuple(slice(lo, hi) for lo, hi in lbox)].contiguous()
        tasks = self.intersecting_subblocks(li, lbox)
        acc = torch.zeros(bshape, dtype=torch.float32, device=self.device)
        if not tasks:
            return acc
        jobs = []
        for sbi, isect in tasks:
            sb = e.subblocks[sbi]
            local_hi = tuple(hi - o for (_, hi), o in zip(isect, sb.origin))
            jobs.append((sbi, self._prefix_limit(sb, sb.size, e.sz_block,
                                                 local_hi)))
        for (sbi, isect), brick in zip(tasks, self._decode_bricks(li, jobs)):
            sb = e.subblocks[sbi]
            src = tuple(slice(lo - o, hi - o) for (lo, hi), o
                        in zip(isect, sb.origin))
            dst = tuple(slice(lo - b0, hi - b0) for (lo, hi), (b0, _)
                        in zip(isect, lbox))
            acc[dst] = brick[src]
        mask = self._mask(li)
        if mask is not None:
            acc = torch.where(mask[tuple(slice(lo, hi) for lo, hi in lbox)],
                              acc, 0.0)
        return acc

    def read_roi(self, box: Box) -> list[ROILevel]:
        """Decode only the region of interest: ``box`` is three half-open
        ranges in *finest-grid* cells, mapped through every level's ratio;
        each crop equals slicing that level's full reconstruction."""
        if len(box) != 3:
            raise ValueError("box must be ((x0,x1),(y0,y1),(z0,z1))")
        out: list[ROILevel] = []
        for li, e in enumerate(self.levels):
            lbox = self.level_box(li, box)
            out.append(ROILevel(level=li, ratio=max(int(e.ratio), 1),
                                box=lbox, data=self._level_roi(li, lbox)))
        return out

    def verify(self) -> bool:
        """Check every section and payload CRC (the index CRC was checked
        at open).

        :raises IOError: at the first corrupt byte range.
        """
        for li, e in enumerate(self.levels):
            if e.codebook_len:
                self._section(e.codebook_off, e.codebook_len,
                              e.codebook_crc, "codebook", li)
            if e.mask_len:
                self._section(e.mask_off, e.mask_len, e.mask_crc, "mask", li)
            for sb in e.subblocks:
                payload = self._read_at(sb.payload_off, sb.payload_len)
                if (zlib.crc32(payload) & 0xFFFFFFFF) != sb.crc:
                    raise IOError(
                        f"TACZ corruption: sub-block payload CRC mismatch "
                        f"(level {li}, offset {sb.payload_off})")
        return True


def open_snapshot(src, *, device: str | torch.device = "cuda") -> TACZReader:
    """Open a single-file snapshot (path, bytes or file object).

    :raises NotImplementedError: for a multi-part snapshot directory.
    """
    if isinstance(src, (str, os.PathLike)) and (
            os.path.isdir(src) or os.path.basename(src) == "manifest.json"):
        raise NotImplementedError("multi-part snapshots are not yet ported")
    return TACZReader(src, device=device)


def read(path, *, device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """Decode every level of ``path`` (file path or container bytes)."""
    with TACZReader(path, device=device) as rd:
        return rd.read()


def read_roi(path, box: Box, *, device: str | torch.device = "cuda",
             ) -> list[ROILevel]:
    """ROI decode of ``path`` — see :meth:`TACZReader.read_roi`."""
    with TACZReader(path, device=device) as rd:
        return rd.read_roi(box)
