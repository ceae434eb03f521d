"""Shared Huffman Encoding (SHE) — paper §III-D, Algorithm 4, on the device.

Every sub-block is predicted and quantized on its own (restoring
Lorenzo/regression locality); all blocks' codes then share one Huffman
codebook built from one aggregated histogram (kernel 3).  Sub-blocks are
grouped by shape and each group runs as one batch through
:func:`repro_torch.core.sz.compress_lor_reg_batched` (``batched=True``,
the default); ``batched=False`` and 4D bricks take the per-brick
:func:`repro_torch.core.sz.compress_lor_reg`, bit-identical to the batch.
``shared=False`` prices the per-block baseline SHE replaces: one codebook
and one bitstream per brick.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from ..obs import metrics as obsm
from . import entropy, huffman
from .compat import HAVE_ZSTD, zstd_size_bits
from .sz import SZResult, compress_lor_reg, compress_lor_reg_batched

__all__ = ["SHEResult", "she_encode", "aggregate_histogram",
           "encode_brick_payloads", "decode_brick_payloads",
           "check_engine_names"]

#: The reference's histogram and Lorenzo engine names.  They select host
#: or TPU arithmetic there; here every name runs the same kernels, so the
#: names are only validated.
HIST_ENGINES = ("numpy", "pallas")
LORENZO_ENGINES = ("auto", "numpy", "pallas")

# Above this code span the dense histogram would be larger than the unique
# pass it replaces (outlier-heavy streams only).
_MAX_HIST_SPAN = 1 << 22


def check_engine_names(*, hist_engine: str = "numpy",
                       lorenzo_engine: str = "auto",
                       entropy_engine: str = "auto") -> None:
    """Validate the reference's engine names.  An entry point accepts them
    for signature parity, checks them once here, and neither stores nor
    forwards them: every name runs the same kernels.

    :raises ValueError: for an unknown name.
    """
    if hist_engine not in HIST_ENGINES:
        raise ValueError(f"unknown histogram engine {hist_engine!r}")
    if lorenzo_engine not in LORENZO_ENGINES:
        raise ValueError(f"unknown Lorenzo engine {lorenzo_engine!r}")
    entropy.check_engine_name(entropy_engine)


@dataclass
class SHEResult:
    results: list[SZResult]       # per-brick prediction results (recon etc.)
    payload_bits: int             # Σ per-brick payloads under the codebook
    codebook_bits: int
    meta_bits: int                # per-brick prediction side info + counts
    codebook: huffman.Codebook | None   # None for shared=False

    @property
    def total_bits(self) -> int:
        return int(self.payload_bits + self.codebook_bits + self.meta_bits)


def aggregate_histogram(codes: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(symbols, freqs) of the pooled code stream — Alg. 4's one histogram,
    equal to ``np.unique(codes, return_counts=True)``.

    Spans up to ``_MAX_HIST_SPAN`` count on kernel 3 over the shifted
    codes; wider spans take ``torch.unique``, as the reference takes
    ``np.unique``.
    """
    codes = codes.reshape(-1)
    if codes.numel() == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo, hi = (int(v) for v in torch.aminmax(codes))
    span = hi - lo + 1
    if span > _MAX_HIST_SPAN:
        sym, cnt = torch.unique(codes, return_counts=True)
        return sym.cpu().numpy(), cnt.cpu().numpy()
    counts = ops.hist(codes.contiguous(), lo, span).cpu().numpy()
    nz = np.flatnonzero(counts)
    return nz + lo, counts[nz]


def _shared_entropy_stage(results: list[SZResult], *, use_zstd: bool,
                          device: torch.device,
                          ) -> tuple[int, int, huffman.Codebook]:
    """One histogram → one codebook → exact payload pricing (and one
    encode for the zstd pass when zstandard is installed).  Timed as the
    ``entropy`` stage; the histogram and the pricing come to the host, so
    the stage ends with its work done."""
    with obsm.timed(obsm.COMPRESS_STAGE_SECONDS.labels("entropy"),
                    "entropy"):
        all_codes = (torch.cat([r.codes for r in results]) if results
                     else torch.zeros(0, dtype=torch.int64, device=device))
        symbols, freqs = aggregate_histogram(all_codes)
        cb = huffman.build_codebook(symbols=symbols, freqs=freqs)
        lengths = entropy.code_lengths(cb, all_codes)
        payload = int(lengths.sum())
        if use_zstd and HAVE_ZSTD and payload:
            (blob, _), = entropy.get_engine(device=device).encode_payloads(
                cb, [all_codes])
            zbits = zstd_size_bits(blob)
            if zbits is not None:
                payload = min(payload, zbits)
        # per-brick payloads (diagnostics only; totals use the shared stream)
        if results:
            sizes = torch.tensor([r.codes.numel() for r in results],
                                 device=lengths.device)
            ends = torch.cumsum(sizes, 0)
            cum = torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])
            per = cum[ends] - cum[ends - sizes]
            for r, bits in zip(results, per.tolist()):
                r.payload_bits = int(bits)
        return int(payload), huffman.codebook_size_bits(cb), cb


def encode_brick_payloads(cb: huffman.Codebook, codes_list, *,
                          engine: str = "auto",
                          device: str | torch.device = "cuda",
                          ) -> list[tuple[bytes, int]]:
    """One byte-aligned packed bitstream per brick under the shared
    codebook (the TACZ payload framing), packed on ``device`` in one pass:
    ``(payload bytes, nbits)`` per brick.  ``engine`` is one of the
    reference's entropy-engine names or an engine
    (:func:`~repro_torch.core.entropy.get_engine`; every name packs the
    same bytes)."""
    return entropy.get_engine(engine, device=device).encode_payloads(
        cb, codes_list)


def decode_brick_payloads(cb: huffman.Codebook, payloads, *,
                          engine: str = "auto",
                          device: str | torch.device = "cuda",
                          ) -> list[torch.Tensor]:
    """Inverse of :func:`encode_brick_payloads`: ``payloads`` are
    ``(payload bytes, nbits, n_codes)`` triples under one codebook; every
    payload decodes in one launch of kernel 4 on ``device`` into an int64
    tensor.  Errors are the serial oracle's."""
    return entropy.get_engine(engine, device=device).decode_payloads(
        cb, payloads)


def _per_block_entropy_stage(results: list[SZResult], *, use_zstd: bool,
                             ) -> tuple[int, int]:
    """The per-block baseline: one codebook, one bitstream and one zstd
    sizing per brick, on the host (the reference's serial oracle).  Sets
    each result's ``payload_bits`` and ``codebook_bits``."""
    payload = cb_bits = 0
    sizes = [r.codes.numel() for r in results]
    flat = (torch.cat([r.codes for r in results]).cpu().numpy()
            if results else np.zeros(0, np.int64))
    for r, codes in zip(results, np.split(flat, np.cumsum(sizes)[:-1])):
        rcb = huffman.build_codebook(codes)
        packed, nbits = entropy.encode_stream(rcb, codes)
        bits = nbits
        if use_zstd and nbits:
            zbits = zstd_size_bits(packed.tobytes())
            if zbits is not None:
                bits = min(bits, zbits)
        r.payload_bits = int(bits)
        r.codebook_bits = huffman.codebook_size_bits(rcb)
        payload += r.payload_bits
        cb_bits += r.codebook_bits
    return payload, cb_bits


def she_encode(bricks: list, eb: float, *, block: int = 6,
               shared: bool = True, use_zstd: bool = True,
               batched: bool = True, hist_engine: str = "numpy",
               lorenzo_engine: str = "auto", entropy_engine: str = "auto",
               device: str | torch.device = "cuda") -> SHEResult:
    """Compress a list of 3D or 4D bricks (numpy arrays or tensors) with
    per-brick Lor/Reg prediction on ``device``.

    ``shared=True`` is Algorithm 4: one Huffman codebook over every
    brick's codes (kernel 3's histogram), one priced stream.
    ``shared=False`` is the per-block baseline: one codebook and one
    bitstream per brick (``codebook`` is then None).  ``batched=True``
    runs each same-shape group of 3D bricks as one batch; ``batched=False``
    and 4D bricks take the per-brick compressor.  Codes, branches,
    reconstructions and bit counts equal the reference's numpy host path
    either way.  ``hist_engine``, ``lorenzo_engine`` and ``entropy_engine``
    take the reference's engine names for signature parity; every name
    runs the same kernels here.

    :raises ValueError: for an unknown engine name.
    """
    check_engine_names(hist_engine=hist_engine,
                       lorenzo_engine=lorenzo_engine,
                       entropy_engine=entropy_engine)
    device = torch.device(device)

    def on_device(brk) -> torch.Tensor:
        t = brk if isinstance(brk, torch.Tensor) else torch.from_numpy(
            np.asarray(brk))
        return t.to(device=device, dtype=torch.float32)

    results: list[SZResult | None] = [None] * len(bricks)
    groups: dict[tuple[int, ...], list[int]] = {}
    for i, brk in enumerate(bricks):
        if batched and brk.ndim == 3:
            groups.setdefault(tuple(brk.shape), []).append(i)
        else:
            results[i] = compress_lor_reg(on_device(brk), eb, block=block,
                                          count_entropy=False)
    for idxs in groups.values():
        if isinstance(bricks[idxs[0]], torch.Tensor):
            stack = torch.stack([bricks[i] for i in idxs])
        else:
            stack = torch.from_numpy(np.stack([bricks[i] for i in idxs]))
        stack = stack.to(device=device, dtype=torch.float32)
        for i, r in zip(idxs, compress_lor_reg_batched(stack, eb,
                                                       block=block)):
            results[i] = r
    meta = sum(r.meta_bits for r in results) + 32 * len(results)
    if shared:
        payload, cb_bits, cb = _shared_entropy_stage(
            results, use_zstd=use_zstd, device=device)
    else:
        (payload, cb_bits), cb = _per_block_entropy_stage(
            results, use_zstd=use_zstd), None
    return SHEResult(results=results, payload_bits=int(payload),
                     codebook_bits=int(cb_bits), meta_bits=int(meta),
                     codebook=cb)
