"""Entropy stage on the device: batch Huffman encode and decode under one
shared codebook.

:class:`TorchEngine` is the port's one engine.  It works on the device it
is given:

* ``encode_payloads`` packs every payload of a level in one offset-scatter
  pass over the pooled symbol stream (torch ops).  Each payload lands at
  its own byte-aligned offset, so the bytes equal the serial oracle's
  per-payload ``packbits`` framing.
* ``decode_payloads`` packs the payload bytes, offsets, counts and
  codebook tables into one host buffer (:class:`HostStaging`, pinned for
  a CUDA device), moves it with one copy and decodes every payload in one
  call of ``kernels.ops.huffdec``: the CUDA kernel for a CUDA device, its
  plain version on the CPU.  Errors are the oracle's, including which
  payload's error is raised (the lowest-index one).

The serial :func:`encode_stream` / :func:`decode_stream` are the bit-exact
oracle, kept on the host with numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops, ref
from . import huffman

__all__ = ["ENGINE_NAMES", "HostStaging", "HuffdecBatch", "TorchEngine",
           "check_engine_name", "code_lengths", "decode_stream",
           "encode_stream", "symbol_indices"]

#: The reference's entropy-engine names.  Its engines are bit-identical,
#: so the port decodes every one of them through kernel 4.
ENGINE_NAMES = ("auto", "numpy", "batched", "pallas")

_ERRORS = {1: "truncated bitstream", 2: "corrupt bitstream",
           3: "cannot decode symbols with an empty codebook"}


# --------------------------------------------------------------------------
# serial primitives — the bit-exact oracle
# --------------------------------------------------------------------------


def encode_stream(cb: huffman.Codebook, data: np.ndarray, *,
                  indices: np.ndarray | None = None,
                  ) -> tuple[np.ndarray, int]:
    """Encode one symbol stream.  Returns (packed uint8 bitstream, nbits)."""
    data = np.asarray(data, dtype=np.int64).ravel()
    if data.size == 0:
        return np.zeros(0, dtype=np.uint8), 0
    idx = huffman.symbol_indices(cb, data) if indices is None else indices
    codes = cb.codes[idx]
    lens = cb.lengths[idx]
    maxlen = int(lens.max())
    ends = np.cumsum(lens)
    starts = ends - lens
    nbits = int(ends[-1])
    bitstream = np.zeros(nbits, dtype=np.uint8)
    sel = np.ones(data.size, dtype=bool)
    for j in range(maxlen):
        if j > 0:
            sel = lens > j
            if not sel.any():
                break
        c, l, s = codes[sel], lens[sel], starts[sel]
        bitstream[s + j] = (c >> (l - 1 - j)) & 1
    return np.packbits(bitstream), nbits


def decode_stream(cb: huffman.Codebook, packed: np.ndarray, nbits: int,
                  n_symbols: int) -> np.ndarray:
    """Decode ``n_symbols`` from one packed bitstream (canonical walk),
    raising the contract's errors: ``"truncated bitstream"`` when the
    stream ends mid-codeword, ``"corrupt bitstream"`` when ``maxlen`` bits
    match nothing."""
    if n_symbols == 0:
        return np.zeros(0, dtype=np.int64)
    symbols = cb.symbols
    if len(symbols) == 0:
        raise ValueError(_ERRORS[3])
    bits = np.unpackbits(np.asarray(packed, dtype=np.uint8))[:nbits]
    nbits = min(int(nbits), bits.size)
    out = np.empty(n_symbols, dtype=np.int64)
    if len(symbols) == 1:
        if nbits < n_symbols:
            raise ValueError(_ERRORS[1])
        out[:] = symbols[0]
        return out
    maxlen = cb.max_length
    first_code, first_index, count = cb.first_code, cb.first_index, cb.count
    i = 0
    bl = bits.tolist()
    for k in range(n_symbols):
        code = 0
        l = 0
        while True:
            if i >= nbits:
                raise ValueError(_ERRORS[1])
            code = (code << 1) | bl[i]
            i += 1
            l += 1
            if l > maxlen:
                raise ValueError(_ERRORS[2])
            c0 = first_code[l]
            if count[l] and code - c0 < count[l] and code >= c0:
                out[k] = symbols[first_index[l] + (code - c0)]
                break
    return out


# --------------------------------------------------------------------------
# device lookups
# --------------------------------------------------------------------------


def symbol_indices(cb: huffman.Codebook, data: torch.Tensor) -> torch.Tensor:
    """Codebook row of every symbol of ``data`` (on ``data``'s device);
    raises on symbols outside the codebook."""
    order = np.argsort(cb.symbols, kind="stable")
    sorted_syms = torch.from_numpy(cb.symbols[order]).to(data.device)
    n = sorted_syms.numel()
    if n == 0:
        if data.numel():
            raise ValueError("symbol not in codebook")
        return torch.zeros(0, dtype=torch.int64, device=data.device)
    pos = torch.searchsorted(sorted_syms, data).clamp_(max=n - 1)
    if bool((sorted_syms[pos] != data).any()):
        raise ValueError("symbol not in codebook")
    return torch.from_numpy(order).to(data.device)[pos]


def code_lengths(cb: huffman.Codebook, data: torch.Tensor) -> torch.Tensor:
    """Per-occurrence code lengths (int64) of a device symbol stream."""
    lengths = torch.from_numpy(np.asarray(cb.lengths, dtype=np.int64))
    return lengths.to(data.device)[symbol_indices(cb, data)]


def check_engine_name(name: str) -> None:
    """Raise ``ValueError`` unless ``name`` is one of :data:`ENGINE_NAMES`."""
    if name not in ENGINE_NAMES:
        raise ValueError(f"unknown entropy engine {name!r} "
                         f"(expected one of {ENGINE_NAMES})")


def _raise_payload_error(err: torch.Tensor) -> None:
    """Raise the oracle's error for the lowest-index failed payload."""
    bad = torch.nonzero(err).reshape(-1)
    if bad.numel():
        raise ValueError(_ERRORS[int(err[bad[0]])])


def _as_u8(buf) -> np.ndarray:
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return np.frombuffer(buf, dtype=np.uint8)
    return np.asarray(buf, dtype=np.uint8).ravel()


class TorchEngine:
    """Batch entropy coding under one shared codebook on ``device``.

    ``encode_payloads(cb, streams)`` → one ``(payload bytes, nbits)`` pair
    per symbol stream.  ``decode_payloads(cb, payloads, n_codes=None)`` →
    one int64 device tensor per payload; ``payloads`` are ``(buf, nbits,
    n_codes)`` triples, or ``(buf, nbits)`` pairs with ``n_codes`` given
    separately.  Both match the serial oracle bit for bit, errors
    included.
    """

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)

    def _tensor(self, s) -> torch.Tensor:
        return torch.as_tensor(s, dtype=torch.int64).to(self.device).reshape(-1)

    def encode_payloads(self, cb: huffman.Codebook, streams,
                        ) -> list[tuple[bytes, int]]:
        streams = [self._tensor(s) for s in streams]
        sizes_l = [s.numel() for s in streams]
        if sum(sizes_l) == 0:
            return [(b"", 0)] * len(streams)
        dev = self.device
        pooled = torch.cat(streams)
        idx = symbol_indices(cb, pooled)
        lens = torch.from_numpy(np.asarray(cb.lengths, np.int64)).to(dev)[idx]
        codes = torch.from_numpy(np.asarray(cb.codes, np.int64)).to(dev)[idx]
        sizes = torch.tensor(sizes_l, dtype=torch.int64, device=dev)
        cum_bits = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
        bounds = torch.cumsum(sizes, 0)
        start_sym = bounds - sizes
        nbits_p = cum_bits[bounds] - cum_bits[start_sym]
        bytelen_p = (nbits_p + 7) // 8
        base_bits = 8 * (torch.cumsum(bytelen_p, 0) - bytelen_p)
        # global bit offset of every codeword: its offset inside its own
        # payload, shifted to the payload's byte-aligned base; the gap bits
        # stay 0, exactly the per-payload packbits padding
        stream_of = torch.repeat_interleave(
            torch.arange(len(streams), device=dev), sizes)
        starts = (cum_bits[:-1] - cum_bits[start_sym][stream_of]
                  + base_bits[stream_of])
        total_bits = 8 * int(bytelen_p.sum())
        # one spare slot past the end takes the writes of finished codewords
        bits = torch.zeros(total_bits + 1, dtype=torch.uint8, device=dev)
        for j in range(int(lens.max())):
            live = lens > j
            dst = torch.where(live, starts + j, total_bits)
            bit = (codes >> (lens - 1 - j).clamp(min=0)) & 1
            bits.scatter_(0, dst, torch.where(live, bit, 0).to(torch.uint8))
        b = bits[:-1].view(-1, 8)
        packed = b[:, 0] << 7
        for k in range(1, 8):
            packed |= b[:, k] << (7 - k)
        host = packed.cpu().numpy()
        out = []
        for b0, nb, nby in zip((base_bits // 8).tolist(), nbits_p.tolist(),
                               bytelen_p.tolist()):
            out.append((host[b0:b0 + nby].tobytes(), int(nb)))
        return out

    def decode_payloads(self, cb: huffman.Codebook, payloads, n_codes=None,
                        ) -> list[torch.Tensor]:
        """Decode a batch in one launch of kernel 4."""
        staging = HostStaging()
        batch = self.stage(staging, cb, payloads, n_codes)
        if batch is None:
            return []
        return self.decode_staged(batch, staging.upload(self.device))

    def decode_staged(self, batch: "HuffdecBatch", views,
                      ) -> list[torch.Tensor]:
        """Run kernel 4 on a batch whose host arrays were uploaded as
        ``views`` (:meth:`HostStaging.upload`); one tensor per payload,
        split by the batch's host spans."""
        out, err = ops.huffdec(*batch.args(views))
        _raise_payload_error(err)
        return list(torch.split(out, batch.spans))

    def huffdec_args(self, cb: huffman.Codebook, payloads, n_codes=None):
        """The argument tuple of ``kernels.ops.huffdec`` for a batch of
        payloads (one byte buffer, per-payload offsets and counts, the
        codebook tables) on this engine's device, or None for no
        payloads."""
        staging = HostStaging()
        batch = self.stage(staging, cb, payloads, n_codes)
        return None if batch is None else batch.args(
            staging.upload(self.device))

    def stage(self, staging: "HostStaging", cb: huffman.Codebook, payloads,
              n_codes=None, *, spans=None) -> "HuffdecBatch | None":
        """Add a batch's host arrays to ``staging`` (payload bytes first,
        then offsets, counts and the codebook tables); None for no
        payloads.  With ``spans``, payload ``a``'s codes take ``spans[a]
        >= n_codes[a]`` slots of the output, the slots past its codes
        zeros: a prefix-limited decode in the same launch."""
        if n_codes is None:
            triples = [(_as_u8(b), int(nb), int(nc)) for b, nb, nc in payloads]
        else:
            triples = [(_as_u8(b), int(nb), int(nc)) for (b, nb), nc
                       in zip(payloads, n_codes, strict=True)]
        if not triples:
            return None
        sizes = np.array([buf.size for buf, _, _ in triples], dtype=np.int64)
        nbits = np.minimum([nb for _, nb, _ in triples], 8 * sizes)
        n_dec = np.array([nc for _, _, nc in triples], dtype=np.int64)
        span = n_dec if spans is None else np.asarray(spans, dtype=np.int64)
        if span.shape != n_dec.shape or bool((span < n_dec).any()):
            raise ValueError("each span must hold its payload's codes")
        maxlen = cb.max_length
        if maxlen > ref.HUFF_MAXLEN and len(cb.symbols) > 1 and n_dec.any():
            raise ValueError(f"codebook depth {maxlen} exceeds the decoder's "
                             f"{ref.HUFF_MAXLEN}-bit limit")
        maxlen = min(maxlen, ref.HUFF_MAXLEN)

        def table(a) -> np.ndarray:
            t = np.zeros(maxlen + 1, dtype=np.int64)
            a = np.asarray(a, dtype=np.int64)[:maxlen + 1]
            t[:a.size] = a
            return t

        data = np.concatenate([buf for buf, _, _ in triples])
        parts = [staging.add(a) for a in (
            data, np.cumsum(sizes) - sizes, nbits, n_dec,
            np.cumsum(span) - span, np.asarray(cb.symbols, dtype=np.int64),
            table(cb.first_code), table(cb.first_index), table(cb.count))]
        return HuffdecBatch(parts, int(span.sum()), maxlen, span.tolist())


class HuffdecBatch:
    """A staged kernel-4 batch: where its arrays lie in a
    :class:`HostStaging`, the output length and the host spans."""

    def __init__(self, parts: list[int], n_out: int, maxlen: int,
                 spans: list[int]):
        self.parts, self.n_out, self.maxlen = parts, n_out, maxlen
        self.spans = spans

    def args(self, views) -> tuple:
        """The argument tuple of ``kernels.ops.huffdec`` from the
        uploaded views."""
        data, byte_off, nbits, n_dec, out_off, symbols, fc, fi, cnt = (
            views[i] for i in self.parts)
        return (data, byte_off, nbits, n_dec, out_off, self.n_out, symbols,
                fc, fi, cnt, self.maxlen)


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}


class HostStaging:
    """One call's host arrays packed into one buffer, each part at an
    8-byte-aligned offset, and moved to the device with one copy.

    For a CUDA device the buffer is pinned (``torch.empty(...,
    pin_memory=True)``) and the copy is ``non_blocking``: PyTorch's
    caching host allocator keeps the block until the copy's stream is done
    with it, so nothing here reuses a buffer.  On the CPU the views are of
    the host buffer itself.  Parts are uint8, int64 or float32 arrays."""

    def __init__(self):
        self._parts: list[tuple[int, np.ndarray]] = []
        self._size = 0

    def add(self, a) -> int:
        """Queue one array; returns its index in :meth:`upload`'s list."""
        a = np.ascontiguousarray(a)
        if a.dtype not in _TORCH_DTYPES:
            raise TypeError(f"cannot stage a {a.dtype} array")
        self._parts.append((self._size, a))
        self._size += -(-a.nbytes // 8) * 8
        return len(self._parts) - 1

    def upload(self, device: str | torch.device) -> list[torch.Tensor]:
        """Device views of every queued array, in :meth:`add` order."""
        dev = torch.device(device)
        host = torch.empty(max(self._size, 8), dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        flat = host.numpy()
        for off, a in self._parts:
            flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        buf = host.to(dev, non_blocking=True)
        return [buf[off:off + a.nbytes].view(_TORCH_DTYPES[a.dtype])
                .reshape(a.shape) for off, a in self._parts]
