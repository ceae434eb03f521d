"""Seeded adversarial payload sets for kernel 4's chunked Huffman decode.

Each case puts the hard spots of the self-synchronising decode where a
chunk of ``chunk_bits`` bits begins or ends: codewords that straddle a
chunk boundary, a sync that takes more than one chunk, a stream that never
syncs, truncation and codeword-free gaps on either side of ``n_decode``.
The tests and ``chip_smoke.py`` hold the kernel against its plain version
(and the plain version against the reference's serial oracle) on them.

:func:`cases` returns ``[(name, codebook, payloads)]`` with ``payloads`` a
list of ``(packed uint8 bytes, nbits, n_decode)`` triples, the argument of
``TorchEngine.huffdec_args``.
"""
from __future__ import annotations

import numpy as np

from ..core import huffman

__all__ = ["cases"]


def _book(lengths, rng) -> huffman.Codebook:
    """A canonical codebook over distinct random int64 symbols."""
    lengths = np.asarray(lengths, dtype=np.int64)
    symbols = rng.choice(np.arange(-5000, 5000), size=lengths.size,
                         replace=False).astype(np.int64)
    return huffman._canonicalize(symbols, lengths)


def _bits(cb: huffman.Codebook, rows) -> np.ndarray:
    """The 0/1 bits of the codewords of codebook rows ``rows``."""
    out = [((int(cb.codes[r]) >> np.arange(int(cb.lengths[r]) - 1, -1, -1))
            & 1) for r in rows]
    return (np.concatenate(out) if out else np.zeros(0, np.int64)).astype(
        np.uint8)


def _payload(bits: np.ndarray, nbits: int | None = None,
             n_decode: int = 0) -> tuple[bytes, int, int]:
    nb = bits.size if nbits is None else nbits
    return np.packbits(bits).tobytes(), int(nb), int(n_decode)


def _random_rows(cb, rng, n, max_len=None) -> np.ndarray:
    """``n`` rows drawn with probability 2^-length (a Huffman source),
    among rows of at most ``max_len`` bits."""
    lens = cb.lengths.astype(np.float64)
    p = np.where(lens <= (max_len or lens.max()), 2.0 ** -lens, 0.0)
    return rng.choice(lens.size, size=n, p=p / p.sum())


def _fill_to(cb, rng, rows, pos, target, max_len):
    """Append random rows of at most ``max_len`` bits while the stream
    (now ``pos`` bits) stays short of ``target``; returns the new pos."""
    while pos < target:
        r = int(_random_rows(cb, rng, 1, max_len)[0])
        rows.append(r)
        pos += int(cb.lengths[r])
    return pos


def _row_of_len(cb, length: int) -> int:
    return int(np.flatnonzero(cb.lengths == length)[0])


def cases(chunk_bits: int, seed: int = 0):
    """The adversarial cases for chunks of ``chunk_bits`` bits."""
    if chunk_bits < 64 or chunk_bits % 8 or chunk_bits % 3 == 0:
        raise ValueError("chunk_bits must be a multiple of 8, >= 64, and "
                         "not divisible by 3")
    rng = np.random.default_rng(seed)
    c = chunk_bits
    out = []

    # a fixed 3-bit code: a decode started off the true grid stays off it
    # and never syncs, so the payload takes the serial walk
    cb = _book([3] * 8, rng)
    rows = rng.integers(0, 8, size=12 * c // 3)
    out.append(("fixed_length_never_syncs", cb,
                [_payload(_bits(cb, rows), n_decode=rows.size)]))

    # 57 bits deep, with a 57-bit codeword straddling every chunk boundary
    cb = _book(list(range(1, 57)) + [57, 57], rng)
    deep = [_row_of_len(cb, 57), int(np.flatnonzero(cb.lengths == 57)[1]),
            _row_of_len(cb, 40)]
    rows, pos = [], 0
    for k in range(1, 7):
        pos = _fill_to(cb, rng, rows, pos, k * c - 30, 8)
        r = deep[k % len(deep)]
        rows.append(r)
        pos += int(cb.lengths[r])
    pos = _fill_to(cb, rng, rows, pos, pos + c // 2, 8)
    out.append(("depth_57_straddling", cb,
                [_payload(_bits(cb, rows), n_decode=len(rows))]))

    # "0" and eight 4-bit codes: inside a run of 1111 a decode keeps
    # whatever phase it started with, and a run of four 0s puts any decode
    # back on the true grid.  One leading 0 sets the grid one bit off every
    # chunk's first bit (C is a multiple of 4), so each chunk boundary cuts
    # a codeword; a run of 0s every 1.5 C leaves some chunks without one,
    # and the true boundary reaches them through a synced predecessor: the
    # sync takes more than one chunk
    cb = _book([1] + [4] * 8, rng)
    zero, ones = _row_of_len(cb, 1), int(np.argmax(cb.codes * (cb.lengths == 4)))
    rows = [zero]
    for _ in range(6):
        rows += [ones] * (3 * c // 8) + [zero] * 4
    out.append(("slow_sync_straddling", cb,
                [_payload(_bits(cb, rows), n_decode=len(rows))]))

    # a Huffman source, read with prefix limits: n_decode below the symbols
    # present, ending inside, at the start of and past a chunk
    cb = _book([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 14], rng)
    rows = _random_rows(cb, rng, 3 * c)
    bits = _bits(cb, rows)
    ends = np.cumsum(cb.lengths[rows])
    at_chunk = int(np.searchsorted(ends, 2 * c))   # first codeword past 2C
    limits = [rows.size, rows.size - 1, rows.size // 2, at_chunk, 1, 0]
    out.append(("prefix_limits", cb,
                [_payload(bits, n_decode=n) for n in limits]))

    # truncation exactly at a chunk boundary: inside a 14-bit codeword at
    # 2C, and on a codeword boundary at 3C (truncated if n_decode asks for
    # more, clean if not)
    one = _row_of_len(cb, 1)
    rows, pos = [], 0
    pos = _fill_to(cb, rng, rows, pos, 2 * c - 5, 4)
    rows.append(_row_of_len(cb, 14))
    pos += 14
    pos = _fill_to(cb, rng, rows, pos, 3 * c - 16, 14)
    while pos < 3 * c:
        rows.append(one)
        pos += 1
    n_at = len(rows)
    pos = _fill_to(cb, rng, rows, pos, 4 * c, 14)
    bits = _bits(cb, rows)
    out.append(("truncated_at_chunk_boundary", cb, [
        _payload(bits, 2 * c, len(rows)),      # cut inside a codeword
        _payload(bits, 3 * c, len(rows)),      # cut on a boundary, too few
        _payload(bits, 3 * c, n_at),           # cut on a boundary, enough
        _payload(bits, None, len(rows))]))

    # an incomplete code (0, 10, 110, 1110; 1111 is free): a gap past the
    # first chunk, before and after n_decode, and one too close to the end
    # for the oracle's corrupt check
    cb = _book([1, 2, 3, 4], rng)
    head = _random_rows(cb, rng, int(1.2 * c))
    n_head = head.size
    gap = np.ones(4, np.uint8)
    tail = _bits(cb, _random_rows(cb, rng, c // 4))
    bits = np.concatenate([_bits(cb, head), gap, tail])
    short = np.concatenate([_bits(cb, head), gap, np.zeros(0, np.uint8)])
    out.append(("gap_past_first_chunk", cb, [
        _payload(bits, n_decode=n_head + 5),   # corrupt
        _payload(bits, n_decode=n_head),       # stops before the gap
        _payload(short, n_decode=n_head + 1),  # truncated
        _payload(_bits(cb, head), n_decode=n_head)]))

    # payloads shorter than a chunk, exactly one or two chunks, empty
    cb = _book([1, 2, 3, 4, 5, 6, 7, 8, 8], rng)
    one = _row_of_len(cb, 1)
    pays = []
    for target in (10, c - 1, c, 2 * c):
        rows, pos = [], 0
        pos = _fill_to(cb, rng, rows, pos, target - 8, 8)
        while pos < target:
            rows.append(one)
            pos += 1
        pays.append(_payload(_bits(cb, rows), n_decode=len(rows)))
    pays += [(b"", 0, 0), (b"", 0, 1), (b"\x00", 8, 0)]
    out.append(("short_and_empty", cb, pays))
    return out
