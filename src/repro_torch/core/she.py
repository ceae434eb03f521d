"""Shared Huffman Encoding (SHE) — paper §III-D, Algorithm 4, on the device.

Every sub-block is predicted and quantized on its own (restoring
Lorenzo/regression locality); all blocks' codes then share one Huffman
codebook built from one aggregated histogram (kernel 3).  Sub-blocks are
grouped by shape and each group runs as one batch through
:func:`repro_torch.core.sz.compress_lor_reg_batched`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from . import entropy, huffman
from .compat import HAVE_ZSTD, zstd_size_bits
from .sz import SZResult, compress_lor_reg_batched

__all__ = ["SHEResult", "she_encode", "aggregate_histogram"]

# Above this code span the dense histogram would be larger than the unique
# pass it replaces (outlier-heavy streams only).
_MAX_HIST_SPAN = 1 << 22


@dataclass
class SHEResult:
    results: list[SZResult]       # per-brick prediction results (recon etc.)
    payload_bits: int             # Σ per-brick payloads under the codebook
    codebook_bits: int
    meta_bits: int                # per-brick prediction side info + counts
    codebook: huffman.Codebook

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
    encode for the zstd pass when zstandard is installed)."""
    all_codes = (torch.cat([r.codes for r in results]) if results
                 else torch.zeros(0, dtype=torch.int64, device=device))
    symbols, freqs = aggregate_histogram(all_codes)
    cb = huffman.build_codebook(symbols=symbols, freqs=freqs)
    lengths = entropy.code_lengths(cb, all_codes)
    payload = int(lengths.sum())
    if use_zstd and HAVE_ZSTD and payload:
        (blob, _), = entropy.TorchEngine(device).encode_payloads(
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


def she_encode(bricks: list, eb: float, *, block: int = 6,
               shared: bool = True, use_zstd: bool = True,
               batched: bool = True,
               device: str | torch.device = "cuda") -> SHEResult:
    """Compress a list of 3D bricks (numpy arrays or tensors) with
    per-brick Lor/Reg prediction and one shared Huffman codebook.

    Only the batched, shared path is ported; ``shared=False``,
    ``batched=False`` and 4D bricks raise :class:`NotImplementedError`.
    """
    if not shared:
        raise NotImplementedError("per-block codebooks (shared=False) are "
                                  "not yet ported")
    if not batched:
        raise NotImplementedError("the sequential batched=False path is not "
                                  "yet ported")
    device = torch.device(device)
    results: list[SZResult | None] = [None] * len(bricks)
    groups: dict[tuple[int, ...], list[int]] = {}
    for i, brk in enumerate(bricks):
        if brk.ndim != 3:
            raise NotImplementedError("4D bricks are not yet ported")
        groups.setdefault(tuple(brk.shape), []).append(i)
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
    payload, cb_bits, cb = _shared_entropy_stage(results, use_zstd=use_zstd,
                                                 device=device)
    return SHEResult(results=results, payload_bits=int(payload),
                     codebook_bits=int(cb_bits), meta_bits=int(meta),
                     codebook=cb)
