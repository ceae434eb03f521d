"""TACZ reader: full decode, region-of-interest decode, corruption checks.

The reader parses the footer + CRC'd index, then seeks straight to the
byte ranges it needs (host I/O, CRCs and the zlib/zstd byte pass).  All
Huffman payloads of one level that a call needs are decoded in one launch
of kernel 4 on the reader's device, each (shape, branch) group of bricks
is reconstructed in one batch (Lorenzo bricks on kernel 2) and placed
with one scatter, and the host arrays of a call reach the device in one
staged (pinned) copy.  Levels and crops come back as float32 tensors on that device,
bit-identical to the compress-time reconstruction.  A gsp or global level
is one payload of the whole grid: it decodes as a unit (region reads
decode it fully, then crop).  :func:`open_snapshot` opens a multi-part
snapshot directory as a :class:`repro_torch.io.parallel.MultiPartReader`
behind the same surface.
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
from ..obs import metrics as obsm
from . import format as fmt
from . import frontier as frt
from . import manifest as _manifest

__all__ = ["ROILevel", "TACZReader", "WHOLE_LEVEL", "open_snapshot",
           "probe_index_crc", "read", "read_roi"]

Box = tuple[tuple[int, int], tuple[int, int], tuple[int, int]]

#: Sub-block index standing for the single payload of a gsp/global level
#: in a ``(level, sub_block)`` key (cache keys, shard placement).
WHOLE_LEVEL = -1

#: Boxes covering at most this many unit blocks find their sub-blocks
#: through a level's unit-block map (``intersecting_subblocks``).
SMALL_BOX_UNITS = 64
#: Largest unit-block map a level keeps (int32 entries, 16 MiB).
OWNER_MAP_MAX = 1 << 22

#: Most destination indices one placement scatter builds at a time
#: (int64, 64 MiB): larger groups go in chunks of bricks.
PLACE_CHUNK = 1 << 23


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
    :param entropy_engine: one of the reference's engine names
        (``"auto"``, ``"numpy"``, ``"batched"``, ``"pallas"``), accepted
        for signature parity.  Its engines are bit-identical, so every
        name decodes through kernel 4 on ``device``; the name is only
        validated.
    :param device: where payloads decode (default ``"cuda"``).
    :raises ValueError: if the bytes are not a valid TACZ container, or
        for an unknown engine name.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """

    _SHE_STRATEGIES = (fmt.STRATEGY_OPST, fmt.STRATEGY_AKDTREE,
                       fmt.STRATEGY_NAST)

    def __init__(self, src, *, entropy_engine: str = "auto",
                 device: str | torch.device = "cuda"):
        entropy.check_engine_name(entropy_engine)
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
        # per level: sub-block origins and ends, (n, 3) int64, and the
        # unit-block map of ``_subblock_index``
        self._extents: dict[int, tuple] = {}

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
                # the packed bits reach the device (an eighth of the
                # bytes, in one staged copy) and are unpacked there
                n = int(np.prod(e.shape))
                nbytes = -(-n // 8)
                packed = np.frombuffer(raw, dtype=np.uint8)[:nbytes]
                if packed.size < nbytes:      # np.unpackbits' zero padding
                    packed = np.concatenate(
                        [packed, np.zeros(nbytes - packed.size, np.uint8)])
                staging = entropy.HostStaging()
                staging.add(packed)
                dev, = staging.upload(self.device)
                shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                                      device=self.device)
                bits = (dev[:, None] >> shifts) & 1
                self._masks[li] = bits.reshape(-1)[:n].bool().reshape(e.shape)
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
                         ) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
        """(codes, betas) device tensors per ``(sub-block entry, shape,
        limit)`` job.  The call's host arrays (payload bytes, kernel 4's
        offsets, counts and tables, raw-codec codes, betas) reach the
        device in one staged copy, and every Huffman payload decodes in
        the same launch of kernel 4.  Each codes tensor has ``sb.n_codes``
        entries; with a ``limit`` only the leading ``limit`` are decoded
        and the rest are zeros."""
        staging = entropy.HostStaging()
        huff: list[tuple[bytes, int, int]] = []
        spans: list[int] = []
        parts: list[tuple[int | None, int | None]] = []
        for sb, shape, limit in jobs:
            code_bytes, betas = self._payload_parts(li, sb, shape)
            n_decode = (sb.n_codes if limit is None
                        else min(int(limit), sb.n_codes))
            b_part = None if betas is None else staging.add(betas)
            if sb.codec == fmt.CODEC_HUFFMAN:
                huff.append((code_bytes, sb.nbits, n_decode))
                spans.append(sb.n_codes)
                parts.append((None, b_part))
            elif sb.codec in (fmt.CODEC_RAW_I16, fmt.CODEC_RAW_I32):
                dt = "<i2" if sb.codec == fmt.CODEC_RAW_I16 else "<i4"
                codes = np.zeros(sb.n_codes, dtype=np.int64)
                codes[:n_decode] = np.frombuffer(code_bytes, dtype=dt,
                                                 count=n_decode)
                parts.append((staging.add(codes), b_part))
            else:
                raise ValueError(f"unknown payload codec {sb.codec}")
        batch = (self._engine.stage(staging, self._codebook(li), huff,
                                    spans=spans) if huff else None)
        views = staging.upload(self.device)
        decoded = iter(())
        if batch is not None:
            # kernel 4; the timer waits for its codes (registry enabled)
            with obsm.timed(obsm.ENTROPY_DECODE_SECONDS.labels(),
                            "entropy_decode", sync=self.device):
                decoded = iter(self._engine.decode_staged(batch, views))
        return [(next(decoded) if c is None else views[c],
                 None if b is None else views[b]) for c, b in parts]

    def _subblock_codes(self, li: int, sb: fmt.SubBlockEntry,
                        shape: tuple[int, ...], limit: int | None = None,
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Entropy-decode one payload → (codes, betas), no prediction
        replay: the single-payload case of :meth:`_decode_payloads`."""
        return self._decode_payloads(li, [(sb, shape, limit)])[0]

    def subblock_shape(self, li: int, sbi: int) -> tuple[int, ...]:
        """Decode shape of one sub-block payload: the brick for SHE
        levels, the padded grid (gsp) or the level shape (global) for
        single-payload levels."""
        e = self.levels[li]
        if e.strategy in self._SHE_STRATEGIES:
            return e.subblocks[sbi].size      # a tuple of ints from the index
        if e.strategy == fmt.STRATEGY_GSP:
            return tuple(int(s) for s in e.grid_shape)
        return tuple(int(s) for s in e.shape)

    def subblock_codes(self, li: int, sbi: int, limit: int | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(codes, betas) of sub-block ``sbi`` of level ``li``."""
        e = self.levels[li]
        return self._subblock_codes(li, e.subblocks[sbi],
                                    self.subblock_shape(li, sbi), limit)

    def decode_subblocks(self, li: int, sbis, limits=None,
                         ) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
        """(codes, betas) device tensors for many sub-blocks of one level,
        in input order; every Huffman payload of the batch decodes in one
        launch.  ``limits`` gives optional per-entry prefix limits."""
        e = self.levels[li]
        return self._decode_payloads(
            li, [(e.subblocks[sbi], self.subblock_shape(li, sbi),
                  None if limits is None else limits[pos])
                 for pos, sbi in enumerate(sbis)])

    def _decode_subblock(self, li: int, sb: fmt.SubBlockEntry,
                         shape: tuple[int, ...],
                         limit: int | None = None) -> torch.Tensor:
        """One payload's reconstructed brick, alone: the per-brick
        reference the batched route (:meth:`_decode_groups`) is held to.
        With a ``limit`` only cells whose code rectangle lies in the
        prefix are specified."""
        e = self.levels[li]
        codes, betas = self._subblock_codes(li, sb, shape, limit)
        return sz.decode_codes(codes, shape, e.eb,
                               branch=fmt.BRANCH_NAMES[sb.branch],
                               block=e.sz_block, betas=betas)

    def _decode_groups(self, li: int, jobs,
                       ) -> list[tuple[list[int], torch.Tensor]]:
        """Reconstruct many ``(sbi, limit)`` jobs of one SHE level: one
        entropy launch over every payload, then one batched reconstruction
        per (shape, branch) group.  Returns ``(job positions, (n, *shape)
        stack)`` per group, in first-appearance order."""
        e = self.levels[li]
        decoded = self.decode_subblocks(li, [sbi for sbi, _ in jobs],
                                        [lim for _, lim in jobs])
        groups: dict[tuple[tuple[int, ...], int], list[int]] = {}
        for pos, (sbi, _) in enumerate(jobs):
            key = (self.subblock_shape(li, sbi), e.subblocks[sbi].branch)
            groups.setdefault(key, []).append(pos)
        out = []
        for (shape, branch), poss in groups.items():
            codes = torch.stack([decoded[p][0] for p in poss])
            betas = (torch.stack([decoded[p][1] for p in poss])
                     if branch == fmt.BRANCH_REG else None)
            out.append((poss, sz.decode_codes_batched(
                codes, shape, e.eb, branch=fmt.BRANCH_NAMES[branch],
                block=e.sz_block, betas=betas)))
        return out

    def _decode_bricks(self, li: int, jobs) -> list[torch.Tensor]:
        """One reconstructed brick per ``(sbi, limit)`` job of one SHE
        level (views of :meth:`_decode_groups`' stacks)."""
        out: list[torch.Tensor | None] = [None] * len(jobs)
        for poss, recon in self._decode_groups(li, jobs):
            for p, brick in zip(poss, recon):
                out[p] = brick
        return out

    def _place(self, acc: torch.Tensor, lo: tuple[int, ...], groups) -> None:
        """Write bricks into ``acc``, whose cell 0 sits at level cell
        ``lo``: ``groups`` holds ``(stack (n, *shape), origins)`` pairs of
        same-shape bricks.  Each group goes in with one ``index_copy_``
        (in chunks of at most :data:`PLACE_CHUNK` values), its destination
        indices computed on the device from its origins plus one
        brick-local offset table; all those host arrays reach the device
        in one staged copy.  Sub-blocks are disjoint, so no index repeats.
        """
        dims = acc.shape
        strides = np.array([dims[1] * dims[2], dims[2], 1], dtype=np.int64)
        staging = entropy.HostStaging()
        local: dict[tuple[int, ...], int] = {}
        plan = []
        for stack, origins in groups:
            shape = tuple(stack.shape[1:])
            if shape not in local:
                x, y, z = (np.arange(n, dtype=np.int64) * st
                           for n, st in zip(shape, strides))
                local[shape] = staging.add(
                    (x[:, None, None] + y[None, :, None] + z).reshape(-1))
            rel = np.asarray(origins, dtype=np.int64) - np.asarray(lo)
            plan.append((stack, staging.add(rel @ strides), local[shape]))
        views = staging.upload(acc.device)
        flat = acc.view(-1)
        for stack, base, offsets in plan:
            base, offsets = views[base], views[offsets]
            per = max(1, PLACE_CHUNK // offsets.numel())
            for c0 in range(0, stack.shape[0], per):
                idx = base[c0:c0 + per, None] + offsets[None, :]
                flat.index_copy_(0, idx.reshape(-1),
                                 stack[c0:c0 + per].reshape(-1))

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
            groups = self._decode_groups(
                li, [(sbi, None) for sbi in range(len(e.subblocks))])
            self._place(acc, (0, 0, 0), [
                (recon, [e.subblocks[p].origin for p in poss])
                for poss, recon in groups])
            recon = acc[tuple(slice(0, s) for s in e.shape)]
            if mask is not None:
                recon = torch.where(mask, recon, 0.0)
            return _compact(recon)
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
            return _compact(gsp_unpad(recon, grid)[
                tuple(slice(0, s) for s in e.shape)])
        if mask is not None:
            recon = torch.where(mask, recon, 0.0)
        return _compact(recon)

    def read(self) -> list[torch.Tensor]:
        """Full decode of every level, in file order."""
        return [self.read_level(i) for i in range(self.n_levels)]

    # ------------------------------ ROI decode -----------------------------
    # read_roi and the serving layer (repro_torch.serving.regions) share box
    # mapping, intersection and crop assembly; only where a decoded brick
    # comes from differs (prefix-stop decode here, the brick cache there).

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
        level ``li`` overlapping ``lbox`` (level cells), in index order.

        A box covering at most :data:`SMALL_BOX_UNITS` unit blocks (a
        router's part, a small region) finds its candidates in the
        level's map of unit blocks to sub-blocks and intersects them in
        Python; a larger one scans every sub-block's extent with numpy.
        Many small queries from many serving threads then make no numpy
        call, each of which would hand the interpreter lock over."""
        if li not in self._extents:
            self._extents[li] = self._subblock_index(li)
        org, end, owners = self._extents[li]
        if owners is not None:
            owner, unit, org_l, end_l = owners
            sl = tuple(slice(max(int(lo), 0) // unit, -(-int(hi) // unit))
                       for lo, hi in lbox)
            n_units = 1
            for s_ in sl:
                n_units *= max(s_.stop - s_.start, 0)
            if n_units <= SMALL_BOX_UNITS:
                ids = set()
                if n_units:
                    for plane in owner[sl].tolist():
                        for row in plane:
                            ids.update(row)
                out = []
                for i in sorted(ids - {-1}):
                    lo = tuple(max(int(b0), o) for (b0, _), o
                               in zip(lbox, org_l[i]))
                    hi = tuple(min(int(b1), e_) for (_, b1), e_
                               in zip(lbox, end_l[i]))
                    if all(h > l for l, h in zip(lo, hi)):
                        out.append((i, tuple(zip(lo, hi))))
                return out
        box = np.asarray(lbox, dtype=np.int64).reshape(3, 2)
        lo = np.maximum(box[:, 0], org)
        hi = np.minimum(box[:, 1], end)
        hit = np.flatnonzero((hi > lo).all(axis=1))
        return [(i, tuple(zip(l, h))) for i, l, h
                in zip(hit.tolist(), lo[hit].tolist(), hi[hit].tolist())]

    def _subblock_index(self, li: int):
        """``(origins, ends, owners)`` of level ``li``'s sub-blocks:
        ``owners`` is ``(unit-block → sub-block index map (-1: none),
        unit, origins, ends as lists)`` when every sub-block lies on the
        unit-block grid, else None."""
        e = self.levels[li]
        org = np.array([sb.origin for sb in e.subblocks],
                       dtype=np.int64).reshape(-1, 3)
        end = org + np.array([sb.size for sb in e.subblocks],
                             dtype=np.int64).reshape(-1, 3)
        unit = int(e.unit)
        if (e.rank != 3 or unit < 1 or not len(org) or (org % unit).any()
                or (end % unit).any()):
            return org, end, None
        uorg, uend = org // unit, end // unit
        dims = tuple(int(v) for v in uend.max(axis=0))
        if int(np.prod(dims)) > OWNER_MAP_MAX:
            return org, end, None
        owner = np.full(dims, -1, dtype=np.int32)
        for i, (a, b) in enumerate(zip(uorg.tolist(), uend.tolist())):
            owner[a[0]:b[0], a[1]:b[1], a[2]:b[2]] = i
        return org, end, (owner, unit, org.tolist(), end.tolist())

    def subblock_keys(self, levels: list[int] | None = None,
                      ) -> list[tuple[int, int]]:
        """Every ``(level, sub_block)`` key, file order: one per sub-block
        of a SHE level, ``(level, WHOLE_LEVEL)`` for a gsp/global level.
        The key universe of cache entries and shard placement.

        :param levels: restrict to these level indices (default: all).
        :raises IndexError: if ``levels`` names an out-of-range level.
        """
        lis = range(self.n_levels) if levels is None else levels
        out: list[tuple[int, int]] = []
        for li in lis:
            e = self.levels[li]
            if e.strategy in self._SHE_STRATEGIES:
                out.extend((li, sbi) for sbi in range(len(e.subblocks)))
            else:
                out.append((li, WHOLE_LEVEL))
        return out

    def level_signature(self, li: int) -> tuple:
        """Content signature of one level, independent of byte placement:
        the decode-relevant index fields and the CRC32 of every stored
        section, not file offsets.  Equal signatures reconstruct equally;
        the tuple equals the reference reader's field for field.

        :raises IndexError: if ``li`` is out of range.
        """
        e = self.levels[li]
        return (e.shape, e.grid_shape, e.strategy, e.algorithm, e.unit,
                e.sz_block, e.ratio, e.eb, e.n_values,
                e.codebook_crc & 0xFFFFFFFF, e.mask_len,
                e.mask_crc & 0xFFFFFFFF, e.mask_compressor,
                tuple((sb.origin, sb.size, sb.branch, sb.codec,
                       sb.payload_len, sb.nbits, sb.n_codes, sb.betas_len,
                       sb.crc & 0xFFFFFFFF) for sb in e.subblocks))

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
        return self.assemble_level_roi(li, clipped, self._fetch_bricks_prefix,
                                       self.read_level)

    def assemble_level_roi(self, li: int, lbox: Box, fetch_bricks,
                           fetch_level, tasks=None) -> torch.Tensor:
        """Assemble one level's crop from decoded bricks.

        ``fetch_bricks(li, [(sbi, local_hi), ...])`` returns one brick per
        job, sub-block ``sbi``'s, valid at least on brick-local cells below
        ``local_hi``; ``fetch_level(li)`` the full level (gsp/global
        levels).  ``tasks`` may carry ``intersecting_subblocks(li, lbox)``.
        Whole bricks are placed, one scatter per shape group, into a zeroed
        accumulator over the bounding box of the bricks and ``lbox``, which
        is cropped to ``lbox`` once: sub-blocks are disjoint, and the cells
        a prefix decode leaves unspecified lie outside ``lbox``.  The crop
        owns storage of its own size: it shares none with a brick, a level
        the fetchers return, or the accumulator.
        """
        e = self.levels[li]
        bshape = tuple(max(hi - lo, 0) for lo, hi in lbox)
        if 0 in bshape:
            return torch.zeros(bshape, dtype=torch.float32,
                               device=self.device)
        if e.strategy not in self._SHE_STRATEGIES:
            # one global payload: decode fully, then crop (interpolation
            # and padding are not block-local)
            return fetch_level(li)[tuple(slice(lo, hi) for lo, hi in lbox)
                                   ].clone(memory_format=torch.contiguous_format)
        if tasks is None:
            tasks = self.intersecting_subblocks(li, lbox)
        if not tasks:
            return torch.zeros(bshape, dtype=torch.float32,
                               device=self.device)
        sbs = [e.subblocks[sbi] for sbi, _ in tasks]
        jobs = [(sbi, tuple(hi - o for (_, hi), o in zip(isect, sb.origin)))
                for (sbi, isect), sb in zip(tasks, sbs)]
        bricks = fetch_bricks(li, jobs)
        if len(tasks) == 1 and tasks[0][1] == tuple(lbox):
            # the box lies inside one sub-block (a router's part): its
            # crop is the brick's slice, copied out, with no placement
            crop = bricks[0][tuple(slice(lo - o, hi - o) for (lo, hi), o
                                   in zip(lbox, sbs[0].origin))]
            mask = self._mask(li)
            if mask is None:
                return crop.clone(memory_format=torch.contiguous_format)
            return torch.where(mask[tuple(slice(b0, b1) for b0, b1 in lbox)],
                               crop, 0.0)
        lo = tuple(min([b0] + [sb.origin[d] for sb in sbs])
                   for d, (b0, _) in enumerate(lbox))
        hi = tuple(max([b1] + [sb.origin[d] + sb.size[d] for sb in sbs])
                   for d, (_, b1) in enumerate(lbox))
        acc = torch.zeros(tuple(h - l for l, h in zip(lo, hi)),
                          dtype=torch.float32, device=self.device)
        by_shape: dict[tuple[int, ...], tuple[list, list]] = {}
        for sb, brick in zip(sbs, bricks):
            group = by_shape.setdefault(tuple(brick.shape), ([], []))
            group[0].append(brick)
            group[1].append(sb.origin)
        self._place(acc, lo, [
            (torch.stack(bs) if len(bs) > 1 else bs[0][None], origins)
            for bs, origins in by_shape.values()])
        crop = acc[tuple(slice(b0 - l, b1 - l)
                         for (b0, b1), l in zip(lbox, lo))]
        mask = self._mask(li)
        if mask is not None:
            crop = torch.where(mask[tuple(slice(b0, b1) for b0, b1 in lbox)],
                               crop, 0.0)
        return _compact(crop)

    def _fetch_bricks_prefix(self, li: int, jobs) -> list[torch.Tensor]:
        """read_roi's brick source: each ``(sbi, local_hi)`` job decodes
        only the payload prefix up to the box's high corner (C-order prefix
        ⊇ Lorenzo code rectangle); one entropy launch + one batched recon
        per (shape, branch) group."""
        e = self.levels[li]
        return self._decode_bricks(
            li, [(sbi, self._prefix_limit(e.subblocks[sbi],
                                          e.subblocks[sbi].size,
                                          e.sz_block, local_hi))
                 for sbi, local_hi in jobs])

    def read_roi(self, box: Box) -> list[ROILevel]:
        """Decode only the region of interest: ``box`` is three half-open
        ranges in *finest-grid* cells, mapped through every level's ratio;
        each crop equals slicing that level's full reconstruction."""
        if len(box) != 3:
            raise ValueError("box must be ((x0,x1),(y0,y1),(z0,z1))")
        out: list[ROILevel] = []
        for li, e in enumerate(self.levels):
            lbox = self.level_box(li, box)
            data = self.assemble_level_roi(
                li, lbox, self._fetch_bricks_prefix, self.read_level)
            out.append(ROILevel(level=li, ratio=max(int(e.ratio), 1),
                                box=lbox, data=data))
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


def _compact(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous in storage of exactly its own size: a view of a
    larger buffer is copied out, so holding it does not keep the buffer."""
    if (t.is_contiguous() and t.untyped_storage().nbytes()
            == t.numel() * t.element_size()):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def probe_index_crc(path) -> int | None:
    """A snapshot's identity CRC, the serving layer's hot-swap check: the
    index CRC from a single file's 20-byte footer, or the manifest's own
    CRC for a multi-part snapshot directory (or its ``manifest.json``;
    the manifest is the commit point).

    :returns: the CRC as an unsigned 32-bit int, or None when the file is
        missing, truncated or not a TACZ container (or the manifest fails
        validation).
    """
    if _manifest.is_multipart(path):
        return _manifest.probe_crc(path)
    try:
        with open(path, "rb") as f:
            f.seek(-fmt.FOOTER_SIZE, os.SEEK_END)
            _, _, crc = fmt.parse_footer(f.read(fmt.FOOTER_SIZE))
    except (OSError, ValueError):
        return None
    return crc & 0xFFFFFFFF


def open_snapshot(src, *, entropy_engine: str = "auto",
                  device: str | torch.device = "cuda") -> TACZReader:
    """Open a snapshot, single-file or multi-part, behind one surface: a
    snapshot directory holding a ``manifest.json`` (or that file) yields a
    :class:`repro_torch.io.parallel.MultiPartReader`; a ``.tacz`` path,
    bytes or a seekable file object a :class:`TACZReader`.

    :raises ValueError: if the snapshot fails validation.
    :raises OSError: if the path cannot be opened.
    """
    if _manifest.is_multipart(src):
        from .parallel import MultiPartReader
        return MultiPartReader(src, entropy_engine=entropy_engine,
                               device=device)
    return TACZReader(src, entropy_engine=entropy_engine, device=device)


def read(path, *, device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """Decode every level of ``path`` (file path or container bytes)."""
    with TACZReader(path, device=device) as rd:
        return rd.read()


def read_roi(path, box: Box, *, device: str | torch.device = "cuda",
             ) -> list[ROILevel]:
    """ROI decode of ``path`` — see :meth:`TACZReader.read_roi`."""
    with TACZReader(path, device=device) as rd:
        return rd.read_roi(box)
