"""TACZ container format: framing, enums, and index (de)serialization.

Layout of a ``.tacz`` file (little-endian throughout)::

    +--------------------------------------------------------------+
    | HEADER (16 B): magic "TACZ", u16 version, u16 flags, u64 rsvd|
    +--------------------------------------------------------------+
    | level 0 sections:  [codebook][mask][payload payload ...]     |
    | level 1 sections:  [codebook][mask][payload payload ...]     |
    | ...              (appended in arrival order — streamable)    |
    +--------------------------------------------------------------+
    | INDEX: per-level entry + per-sub-block entries (see below)   |
    +--------------------------------------------------------------+
    | FOOTER (20 B): u64 index_off, u32 index_len, u32 index_crc,  |
    |                magic "TACZ"                                  |
    +--------------------------------------------------------------+

The index is written *last* so the writer can stream level payloads as
they arrive without back-patching; readers locate it through the footer.
Every sub-block payload carries its own CRC32 so corruption is localized
to one sub-block, and the index itself is CRC'd so a truncated file fails
loudly at open time instead of decoding garbage.

A *sub-block entry* records everything needed to decode that sub-block in
isolation — origin/shape (cells, in padded-grid coordinates), prediction
branch, payload codec, byte offset/length, exact bit count, code count,
and the length of the inline regression-betas prefix.  This per-sub-block
granularity is what makes region-of-interest decode possible: the reader
touches only the payload byte ranges whose cuboids intersect the query.

Version history:

  * **v1** — initial container: raw packed-bits Huffman payloads.
  * **v2** — adds an optional lossless byte pass (zstd, or zlib via
    ``repro_torch.core.compat`` fallback) over the shared-Huffman payload
    sections and records the level's configured codec in a new
    ``payload_compressor`` byte in the per-level index head.  The
    per-sub-block ``compressor`` field (present since v1) stays the
    authoritative decode-side switch — a sub-block whose pass did not
    shrink keeps ``COMPRESSOR_NONE``.  v1 files remain readable: the
    index head is parsed by the version the header advertises.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

TACZ_MAGIC = b"TACZ"
TACZ_VERSION = 2

MAX_RANK = 8

# --- enums (u8 on the wire) -------------------------------------------------

# level strategy
STRATEGY_OPST = 0
STRATEGY_AKDTREE = 1
STRATEGY_GSP = 2
STRATEGY_GLOBAL = 3      # single global payload (e.g. checkpoint tensors)
STRATEGY_NAST = 4

STRATEGY_NAMES = {STRATEGY_OPST: "opst", STRATEGY_AKDTREE: "akdtree",
                  STRATEGY_GSP: "gsp", STRATEGY_GLOBAL: "global",
                  STRATEGY_NAST: "nast"}
STRATEGY_CODES = {v: k for k, v in STRATEGY_NAMES.items()}

# level algorithm
ALGO_LOR_REG = 0
ALGO_LORENZO = 1
ALGO_INTERP = 2
ALGO_NAMES = {ALGO_LOR_REG: "lor_reg", ALGO_LORENZO: "lorenzo",
              ALGO_INTERP: "interp"}
ALGO_CODES = {v: k for k, v in ALGO_NAMES.items()}

# per-sub-block prediction branch (what `repro_torch.core.sz.decode_codes` takes)
BRANCH_LORENZO = 0
BRANCH_REG = 1
BRANCH_INTERP = 2
BRANCH_NAMES = {BRANCH_LORENZO: "lorenzo", BRANCH_REG: "reg",
                BRANCH_INTERP: "interp"}

# payload codec: how the code stream is represented on the wire
CODEC_HUFFMAN = 0        # canonical-Huffman packed bits (shared codebook)
CODEC_RAW_I16 = 1        # raw little-endian int16 codes ("sz-light")
CODEC_RAW_I32 = 2        # raw little-endian int32 codes

# byte-level lossless pass over the (non-betas part of the) payload
COMPRESSOR_NONE = 0
COMPRESSOR_ZLIB = 1
COMPRESSOR_ZSTD = 2

# --- framing ----------------------------------------------------------------

_HEADER = struct.Struct("<4sHHQ")                 # magic, version, flags, rsvd
_FOOTER = struct.Struct("<QII4s")                 # off, len, crc, magic
HEADER_SIZE = _HEADER.size                        # 16
FOOTER_SIZE = _FOOTER.size                        # 20

# v1: rank, strategy, algorithm, mask_compressor, sz_block, unit, ratio,
# eb, n_values, density
_LEVEL_HEAD_V1 = struct.Struct("<BBBBBHHdQd")
# v2 inserts payload_compressor after mask_compressor
_LEVEL_HEAD = struct.Struct("<BBBBBBHHdQd")
# codebook off/len/crc, mask off/len/crc, n_subblocks
_LEVEL_SECTIONS = struct.Struct("<QIIQIII")
# origin xyz, size xyz, branch, codec, compressor, payload off/len,
# nbits, n_codes, betas_len, crc
_SUBBLOCK = struct.Struct("<6I3BQIQQII")


def pack_header(flags: int = 0, *, version: int = TACZ_VERSION) -> bytes:
    """The 16-byte file header (magic, version, flags, reserved)."""
    return _HEADER.pack(TACZ_MAGIC, version, flags, 0)


def parse_header(buf: bytes) -> int:
    """Validate the header; returns the format version."""
    if len(buf) < HEADER_SIZE:
        raise ValueError("not a TACZ file: truncated header")
    magic, version, _flags, _rsvd = _HEADER.unpack_from(buf, 0)
    if magic != TACZ_MAGIC:
        raise ValueError("not a TACZ file: bad magic")
    if version > TACZ_VERSION:
        raise ValueError(f"unsupported TACZ version {version}")
    return version


def pack_footer(index_off: int, index_len: int, index_crc: int) -> bytes:
    """The 20-byte trailer locating (and checksumming) the index."""
    return _FOOTER.pack(index_off, index_len, index_crc & 0xFFFFFFFF,
                        TACZ_MAGIC)


def parse_footer(buf: bytes) -> tuple[int, int, int]:
    """(index_off, index_len, index_crc) from the trailing FOOTER_SIZE bytes."""
    if len(buf) < FOOTER_SIZE:
        raise ValueError("truncated TACZ file: missing footer")
    off, length, crc, magic = _FOOTER.unpack_from(buf, len(buf) - FOOTER_SIZE)
    if magic != TACZ_MAGIC:
        raise ValueError("truncated or corrupt TACZ file: bad footer magic")
    return off, length, crc


# --- index entries ----------------------------------------------------------


@dataclass
class SubBlockEntry:
    """Index record for one independently-decodable sub-block payload."""

    origin: tuple[int, int, int]      # cell coords in the padded level grid
    size: tuple[int, int, int]        # cell extent per dim
    branch: int                       # BRANCH_*
    codec: int                        # CODEC_*
    compressor: int                   # COMPRESSOR_* (code bytes only)
    payload_off: int                  # absolute file offset
    payload_len: int                  # stored bytes (betas prefix included)
    nbits: int                        # exact Huffman bit count (codec 0)
    n_codes: int                      # symbols in the code stream
    betas_len: int                    # bytes of float32 betas at payload start
    crc: int                          # CRC32 of the stored payload bytes


@dataclass
class LevelEntry:
    """Index record for one level (or one tensor, strategy=GLOBAL)."""

    shape: tuple[int, ...]            # original level shape (rank dims)
    grid_shape: tuple[int, ...]       # padded block-grid shape
    strategy: int                     # STRATEGY_*
    algorithm: int                    # ALGO_*
    unit: int                         # unit-block edge (cells)
    sz_block: int                     # Lor/Reg regression block edge
    ratio: int                        # coarsening ratio vs the finest grid
    eb: float                         # absolute error bound
    n_values: int                     # stored values at this level
    density: float                    # unit-block density
    codebook_off: int = 0
    codebook_len: int = 0             # 0 → no codebook section
    codebook_crc: int = 0             # CRC32 of the codebook section bytes
    mask_off: int = 0
    mask_len: int = 0                 # 0 → mask is all-True
    mask_crc: int = 0                 # CRC32 of the stored mask bytes
    mask_compressor: int = COMPRESSOR_ZLIB
    # the level's *configured* payload pass (v2); decode always follows the
    # per-sub-block compressor field (COMPRESSOR_NONE when the pass lost)
    payload_compressor: int = COMPRESSOR_NONE
    subblocks: list[SubBlockEntry] = field(default_factory=list)

    @property
    def rank(self) -> int:
        """Number of dimensions of the level."""
        return len(self.shape)

    def shift_offsets(self, base: int) -> None:
        """Turn blob-relative section offsets into absolute file offsets."""
        if self.codebook_len:
            self.codebook_off += base
        if self.mask_len:
            self.mask_off += base
        for sb in self.subblocks:
            sb.payload_off += base


def pack_index(levels: list[LevelEntry], *,
               version: int = TACZ_VERSION) -> bytes:
    """Serialize the index: u32 level count + per-level records.

    :param levels: entries with *absolute* section offsets.
    :param version: index-head layout to emit (v1 drops the
        ``payload_compressor`` byte).
    :raises ValueError: on an unsupported rank or shape-rank mismatch.
    """
    out = bytearray(struct.pack("<I", len(levels)))
    for e in levels:
        rank = e.rank
        if not 1 <= rank <= MAX_RANK:
            raise ValueError(f"unsupported rank {rank}")
        if len(e.grid_shape) != rank:
            raise ValueError("grid_shape rank mismatch")
        if version >= 2:
            out += _LEVEL_HEAD.pack(rank, e.strategy, e.algorithm,
                                    e.mask_compressor, e.payload_compressor,
                                    e.sz_block, e.unit, e.ratio, e.eb,
                                    e.n_values, e.density)
        else:
            out += _LEVEL_HEAD_V1.pack(rank, e.strategy, e.algorithm,
                                       e.mask_compressor, e.sz_block, e.unit,
                                       e.ratio, e.eb, e.n_values, e.density)
        out += struct.pack(f"<{rank}I", *e.shape)
        out += struct.pack(f"<{rank}I", *e.grid_shape)
        out += _LEVEL_SECTIONS.pack(e.codebook_off, e.codebook_len,
                                    e.codebook_crc & 0xFFFFFFFF,
                                    e.mask_off, e.mask_len,
                                    e.mask_crc & 0xFFFFFFFF,
                                    len(e.subblocks))
        for sb in e.subblocks:
            out += _SUBBLOCK.pack(*sb.origin, *sb.size, sb.branch, sb.codec,
                                  sb.compressor, sb.payload_off,
                                  sb.payload_len, sb.nbits, sb.n_codes,
                                  sb.betas_len, sb.crc & 0xFFFFFFFF)
    return bytes(out)


def parse_index(buf: bytes, *, version: int = TACZ_VERSION
                ) -> list[LevelEntry]:
    """Inverse of :func:`pack_index`.

    :param buf: the index bytes (CRC already verified by the caller).
    :param version: the layout the file header advertised.
    :raises ValueError: on truncation or an implausible rank.
    """
    try:
        (n_levels,) = struct.unpack_from("<I", buf, 0)
        pos = 4
        levels: list[LevelEntry] = []
        for _ in range(n_levels):
            if version >= 2:
                (rank, strategy, algorithm, mask_comp, payload_comp,
                 sz_block, unit, ratio, eb, n_values,
                 density) = _LEVEL_HEAD.unpack_from(buf, pos)
                pos += _LEVEL_HEAD.size
            else:
                (rank, strategy, algorithm, mask_comp, sz_block, unit, ratio,
                 eb, n_values, density) = _LEVEL_HEAD_V1.unpack_from(buf, pos)
                payload_comp = COMPRESSOR_NONE
                pos += _LEVEL_HEAD_V1.size
            if not 1 <= rank <= MAX_RANK:
                raise ValueError(f"corrupt index: rank {rank}")
            shape = struct.unpack_from(f"<{rank}I", buf, pos)
            pos += 4 * rank
            grid_shape = struct.unpack_from(f"<{rank}I", buf, pos)
            pos += 4 * rank
            (cb_off, cb_len, cb_crc, mask_off, mask_len, mask_crc,
             n_sb) = _LEVEL_SECTIONS.unpack_from(buf, pos)
            pos += _LEVEL_SECTIONS.size
            entry = LevelEntry(shape=tuple(shape), grid_shape=tuple(grid_shape),
                               strategy=strategy, algorithm=algorithm,
                               unit=unit, sz_block=sz_block, ratio=ratio,
                               eb=eb, n_values=n_values, density=density,
                               codebook_off=cb_off, codebook_len=cb_len,
                               codebook_crc=cb_crc,
                               mask_off=mask_off, mask_len=mask_len,
                               mask_crc=mask_crc, mask_compressor=mask_comp,
                               payload_compressor=payload_comp)
            for _ in range(n_sb):
                vals = _SUBBLOCK.unpack_from(buf, pos)
                pos += _SUBBLOCK.size
                entry.subblocks.append(SubBlockEntry(
                    origin=tuple(vals[0:3]), size=tuple(vals[3:6]),
                    branch=vals[6], codec=vals[7], compressor=vals[8],
                    payload_off=vals[9], payload_len=vals[10],
                    nbits=vals[11], n_codes=vals[12], betas_len=vals[13],
                    crc=vals[14]))
            levels.append(entry)
        return levels
    except struct.error as exc:
        raise ValueError("corrupt TACZ index") from exc


def index_crc(index_bytes: bytes) -> int:
    """CRC32 of the index bytes — the snapshot's content identity."""
    return zlib.crc32(index_bytes) & 0xFFFFFFFF
