"""Canonical Huffman codec over integer symbol streams.

This is the lossless-encoding stage of SZ (paper §II-A step 3) and the
substrate for Shared Huffman Encoding (paper §III-D).  Tree construction and
canonical code assignment run on the host (NumPy/heapq) — entropy coding is
irreducibly bit-serial at its core, so the tree build stays on the host
while predict/quantize, packing and decode run on the device
(``repro_torch.core.entropy``).
"""
from __future__ import annotations

import heapq
import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Codebook",
    "build_codebook",
    "encode",
    "decode",
    "encoded_size_bits",
    "symbol_indices",
    "code_lengths_for",
    "codebook_size_bits",
    "serialize_codebook",
    "deserialize_codebook",
]


@dataclass
class Codebook:
    """Canonical Huffman codebook.

    symbols are arbitrary (possibly negative) int64 values; internally we
    operate on the sorted unique alphabet.
    """

    symbols: np.ndarray          # unique symbols, sorted by (length, symbol)
    lengths: np.ndarray          # code length per symbol (same order)
    codes: np.ndarray            # canonical codeword per symbol (same order)
    # Decode acceleration tables (canonical decode):
    first_code: np.ndarray = field(default=None)   # per length L: first codeword
    first_index: np.ndarray = field(default=None)  # per length L: index of first symbol
    count: np.ndarray = field(default=None)        # per length L: #codes of that length
    _enc_map: dict = field(default=None, repr=False)

    @property
    def max_length(self) -> int:
        return int(self.lengths.max(initial=0))

    def encoder_map(self) -> dict:
        """``{symbol: (code, length)}``, built once and cached."""
        if self._enc_map is None:
            self._enc_map = {
                int(s): (int(c), int(l))
                for s, c, l in zip(self.symbols, self.codes, self.lengths)
            }
        return self._enc_map

def _code_lengths_from_hist(symbols: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths via the standard two-queue/heap construction."""
    n = len(symbols)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n == 1:
        return np.ones(1, dtype=np.int64)
    # heap items: (freq, tiebreak, node). Leaves are ints, internal = list of leaf ids.
    heap = [(int(f), i, [i]) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    lengths = np.zeros(n, dtype=np.int64)
    tiebreak = n
    while len(heap) > 1:
        f1, _, l1 = heapq.heappop(heap)
        f2, _, l2 = heapq.heappop(heap)
        for leaf in l1:
            lengths[leaf] += 1
        for leaf in l2:
            lengths[leaf] += 1
        heapq.heappush(heap, (f1 + f2, tiebreak, l1 + l2))
        tiebreak += 1
    return lengths


def _canonicalize(symbols: np.ndarray, lengths: np.ndarray) -> Codebook:
    """Canonical code assignment from (symbol, length) pairs.

    The (length, symbol) order fully determines the canonical codes, so this
    is the shared tail of :func:`build_codebook` and
    :func:`deserialize_codebook` — a codebook round-trips through
    serialization bit-identically because both paths end here.
    """
    order = np.lexsort((symbols, lengths))
    symbols, lengths = symbols[order], lengths[order]
    maxlen = int(lengths.max(initial=0))
    codes = np.zeros(len(symbols), dtype=np.int64)
    count = np.zeros(maxlen + 1, dtype=np.int64)
    for l in lengths:
        count[l] += 1
    first_code = np.zeros(maxlen + 2, dtype=np.int64)
    first_index = np.zeros(maxlen + 2, dtype=np.int64)
    code = 0
    idx = 0
    for l in range(1, maxlen + 1):
        first_code[l] = code
        first_index[l] = idx
        code = (code + count[l]) << 1
        idx += count[l]
    next_code = first_code.copy()
    for i, l in enumerate(lengths):
        codes[i] = next_code[l]
        next_code[l] += 1
    return Codebook(symbols=symbols, lengths=lengths, codes=codes,
                    first_code=first_code, first_index=first_index,
                    count=count)


def build_codebook(data: np.ndarray | None = None, *,
                   symbols: np.ndarray | None = None,
                   freqs: np.ndarray | None = None) -> Codebook:
    """Build a canonical Huffman codebook from a symbol stream or histogram."""
    if data is not None:
        data = np.asarray(data).ravel()
        symbols, freqs = np.unique(data, return_counts=True)
    symbols = np.asarray(symbols, dtype=np.int64)
    freqs = np.asarray(freqs, dtype=np.int64)
    keep = freqs > 0
    symbols, freqs = symbols[keep], freqs[keep]
    lengths = _code_lengths_from_hist(symbols, freqs)
    return _canonicalize(symbols, lengths)


def serialize_codebook(cb: Codebook) -> bytes:
    """Canonical codebook → bytes: u32 count, u8 symbol width, symbols
    (i32 when they fit — the quantization-code common case — i64
    otherwise), u8 lengths.

    Only (symbol, length) pairs are stored — canonical codes are a pure
    function of those (the property canonical Huffman exists for).  The
    i32 fast path makes the wire cost match :func:`codebook_size_bits`'
    (32+8)-bits-per-symbol accounting (+5 header bytes).  Code lengths fit
    u8: depth L needs total frequency ≥ Fib(L+1), so int64 histograms cap
    depth well under 255.  Handles the degenerate empty and single-symbol
    codebooks (both appear constantly in per-sub-block container payloads:
    all-zero bricks quantize to a one-symbol alphabet).
    """
    symbols = np.ascontiguousarray(cb.symbols, dtype=np.int64)
    lengths = np.ascontiguousarray(cb.lengths, dtype=np.uint8)
    width = 8 if symbols.size and (int(symbols.min()) < -2 ** 31
                                   or int(symbols.max()) >= 2 ** 31) else 4
    return (struct.pack("<IB", len(symbols), width)
            + symbols.astype(f"<i{width}").tobytes() + lengths.tobytes())


def deserialize_codebook(buf: bytes) -> Codebook:
    """Inverse of :func:`serialize_codebook` (bit-identical codebook)."""
    if len(buf) < 5:
        raise ValueError("truncated codebook")
    n, width = struct.unpack_from("<IB", buf, 0)
    if width not in (4, 8):
        raise ValueError("corrupt codebook header")
    need = 5 + n * (width + 1)
    if len(buf) < need:
        raise ValueError("truncated codebook")
    symbols = np.frombuffer(buf, dtype=f"<i{width}", count=n,
                            offset=5).astype(np.int64)
    lengths = np.frombuffer(buf, dtype=np.uint8, count=n,
                            offset=5 + width * n).astype(np.int64)
    return _canonicalize(symbols, lengths)


def encoded_size_bits(cb: Codebook, data: np.ndarray | None = None, *,
                      symbols: np.ndarray | None = None,
                      freqs: np.ndarray | None = None) -> int:
    """Exact payload size in bits without materializing the bitstream."""
    if data is not None:
        return int(code_lengths_for(cb, data).sum())
    symbols = np.asarray(symbols, dtype=np.int64).ravel()
    freqs = np.asarray(freqs, dtype=np.int64).ravel()
    if symbols.size == 0:
        return 0
    idx = symbol_indices(cb, symbols)
    return int((cb.lengths[idx] * freqs).sum())


def symbol_indices(cb: Codebook, data: np.ndarray) -> np.ndarray:
    """Vectorized symbol → codebook-row lookup (searchsorted on a
    symbol-sorted view); raises on symbols outside the codebook."""
    sym_order = np.argsort(cb.symbols, kind="stable")
    sorted_syms = cb.symbols[sym_order]
    pos = np.searchsorted(sorted_syms, data)
    if (np.any(pos >= len(sorted_syms))
            or np.any(sorted_syms[np.minimum(pos, len(sorted_syms) - 1)] != data)):
        raise ValueError("symbol not in codebook")
    return sym_order[pos]


def code_lengths_for(cb: Codebook, data: np.ndarray) -> np.ndarray:
    """Per-occurrence code lengths of a host symbol stream:
    ``code_lengths_for(cb, data).sum() == encode(cb, data)[1]`` exactly.
    (``repro_torch.core.entropy.code_lengths`` does the same on a device
    tensor.)"""
    data = np.asarray(data, dtype=np.int64).ravel()
    if data.size == 0:
        return np.zeros(0, dtype=np.int64)
    return cb.lengths[symbol_indices(cb, data)]


def codebook_size_bits(cb: Codebook) -> int:
    """Serialized codebook cost: (symbol int32 + length uint8) per entry.

    This is the per-tree header cost that makes many small Huffman trees
    expensive — the overhead SHE removes (paper §III-D).
    """
    return len(cb.symbols) * (32 + 8)


def encode(cb: Codebook, data: np.ndarray, *,
           indices: np.ndarray | None = None) -> tuple[np.ndarray, int]:
    """Encode one symbol stream on the host.  Returns (packed uint8
    bitstream, nbits).

    ``indices`` may carry a precomputed ``symbol_indices(cb, data)``.
    This is the single-stream serial oracle
    (``repro_torch.core.entropy.encode_stream``); many payloads under one
    codebook go through ``entropy.get_engine(...).encode_payloads``.
    """
    from . import entropy
    return entropy.encode_stream(cb, data, indices=indices)


def decode(cb: Codebook, packed: np.ndarray, nbits: int,
           n_symbols: int) -> np.ndarray:
    """Decode ``n_symbols`` symbols from a packed bitstream on the host
    (canonical walk).

    An empty codebook decodes only the empty stream, a single-symbol
    alphabet checks the advertised bit count, and a stream that ends
    mid-codeword raises ``ValueError``.  This is the single-stream serial
    oracle (``repro_torch.core.entropy.decode_stream``); many payloads
    under one codebook go through
    ``entropy.get_engine(...).decode_payloads`` (kernel 4).
    """
    from . import entropy
    return entropy.decode_stream(cb, packed, nbits, n_symbols)
