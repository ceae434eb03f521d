"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes, on
any device.  ``repro_torch.kernels.ops`` runs them for CPU tensors (the
CPU tests hold them against the JAX package's reference), and the chip
smoke test holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

__all__ = ["lorenzo3d_codes_batched", "lorenzo3d_recon_batched",
           "lorenzo3d_codes", "lorenzo3d_recon", "check_tile", "hist",
           "huffdec", "HUFF_MAXLEN"]

#: Longest codeword the decoders take: a 64-bit window read at any bit
#: offset inside its first byte holds 57 whole bits.
HUFF_MAXLEN = 57


def lorenzo3d_codes_batched(x: torch.Tensor, eb: float) -> torch.Tensor:
    """(N,X,Y,Z) float32 → int64 codes: ``rint(float64(x) / 2eb)``, then
    zero-halo first differences along X, Y and Z within each brick."""
    c = torch.round(x.double() / (2.0 * eb)).long()
    for ax in (1, 2, 3):
        c = torch.diff(c, dim=ax, prepend=torch.zeros_like(c.narrow(ax, 0, 1)))
    return c


def lorenzo3d_recon_batched(codes: torch.Tensor, eb: float) -> torch.Tensor:
    """Inverse of :func:`lorenzo3d_codes_batched`: int64 inclusive prefix
    sums along X, Y and Z, then ``float32(float64(q) · 2eb)``."""
    q = codes
    for ax in (1, 2, 3):
        q = torch.cumsum(q, dim=ax)
    return (q.double() * (2.0 * eb)).float()


def check_tile(shape: tuple[int, ...], tile: tuple[int, ...]
               ) -> tuple[int, int, int]:
    """``tile`` clamped to ``shape``, as the TPU kernel's grid takes it.

    :raises ValueError: for a tile that is not three positive edges, or
        that does not divide ``shape``.
    """
    if len(tile) != 3 or any(int(t) < 1 for t in tile):
        raise ValueError(f"tile {tuple(tile)} must be three positive edges")
    tile = tuple(max(1, min(int(t), int(s))) for t, s in zip(tile, shape))
    if any(s % t for s, t in zip(shape, tile)):
        raise ValueError(f"shape {tuple(shape)} not divisible by tile {tile}")
    return tile


def _tile_view(a: torch.Tensor, tile: tuple[int, int, int]) -> torch.Tensor:
    """(X,Y,Z) → (gx,tx, gy,ty, gz,tz) view; tile axes are 1, 3 and 5."""
    gx, gy, gz = (s // t for s, t in zip(a.shape, tile))
    return a.reshape(gx, tile[0], gy, tile[1], gz, tile[2])


def lorenzo3d_codes(x: torch.Tensor, eb: float,
                    tile: tuple[int, int, int]) -> torch.Tensor:
    """(X,Y,Z) float32 → int64 codes: ``rint(float64(x) / 2eb)``, then
    first differences along X, Y and Z with a zero halo at the low faces
    of every tile (checked by :func:`check_tile`)."""
    tile = check_tile(tuple(x.shape), tile)
    c = _tile_view(torch.round(x.double() / (2.0 * eb)).long(), tile)
    for ax in (1, 3, 5):
        c = torch.diff(c, dim=ax, prepend=torch.zeros_like(c.narrow(ax, 0, 1)))
    return c.reshape(x.shape)


def lorenzo3d_recon(codes: torch.Tensor, eb: float,
                    tile: tuple[int, int, int]) -> torch.Tensor:
    """Inverse of :func:`lorenzo3d_codes`: int64 inclusive prefix sums
    along X, Y and Z inside every tile, then ``float32(float64(q) · 2eb)``."""
    q = _tile_view(codes, check_tile(tuple(codes.shape), tile))
    for ax in (1, 3, 5):
        q = torch.cumsum(q, dim=ax)
    return (q.double() * (2.0 * eb)).float().reshape(codes.shape)


def hist(codes: torch.Tensor, lo: int, n_bins: int) -> torch.Tensor:
    """int64 counts of ``codes - lo`` clipped to [0, n_bins)."""
    idx = (codes.reshape(-1) - lo).clamp_(0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int64, device=codes.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx))


def huffdec(data, byte_off, nbits, n_decode, out_off, n_out, symbols,
            first_code, first_index, count, maxlen):
    """Decode many canonical-Huffman payloads packed in one byte buffer.

    Payload ``a`` starts at byte ``byte_off[a]`` of ``data`` (uint8), has
    ``nbits[a]`` usable bits and ``n_decode[a]`` symbols to decode, which
    land at ``out[out_off[a]:]`` of the int64 output (length ``n_out``,
    zeros elsewhere).  Returns ``(out, err)`` with one int32 error kind
    per payload: 1 truncated, 2 corrupt, 3 empty codebook.

    Payloads advance in lockstep, one symbol per step: each reads the
    ``maxlen``-bit window at its bit position, finds the code length with
    one ``searchsorted`` over the left-justified canonical interval
    uppers, and emits the symbol.  Bits past a payload's end may enter the
    window; they only decide cases that end as "truncated" either way.
    """
    dev = data.device
    a_n = byte_off.numel()
    # one spare slot past the end takes the writes of lanes that emit nothing
    out = torch.zeros(n_out + 1, dtype=torch.int64, device=dev)
    err = torch.zeros(a_n, dtype=torch.int32, device=dev)
    live = n_decode > 0
    n_sym = symbols.numel()
    if a_n == 0 or not bool(live.any()):
        return out[:n_out], err
    if n_sym == 0:
        err[live] = 3
        return out[:n_out], err
    if n_sym == 1:
        short = live & (nbits < n_decode)
        err[short] = 1
        fill = torch.where(live & ~short, n_decode, 0)
        starts = torch.repeat_interleave(out_off, fill)
        first = torch.cumsum(fill, 0) - fill
        k = torch.arange(starts.numel(), device=dev) - torch.repeat_interleave(
            first, fill)
        out[starts + k] = symbols[0]
        return out[:n_out], err
    cnt = count[:maxlen + 1]
    ls = torch.nonzero(cnt[1:]).reshape(-1) + 1
    uppers = (first_code[ls] + cnt[ls]) << (maxlen - ls)
    n_ls = ls.numel()
    buf = torch.cat([data, torch.zeros(8, dtype=torch.uint8, device=dev)]).long()
    lane = torch.arange(8, device=dev)
    pos = torch.zeros(a_n, dtype=torch.int64, device=dev)
    steps = int(n_decode.max())
    for k in range(steps):
        act = (k < n_decode) & (err == 0)
        if k % 256 == 0 and not bool(act.any()):
            break
        s = pos & 7
        by = buf[(byte_off + (pos >> 3))[:, None] + lane]
        by[:, 0] &= s.new_full(s.shape, 255) >> s
        # window = the maxlen bits at `pos`; each byte is a disjoint bit
        # field, so the fields shift into place independently
        e = s[:, None] + (maxlen - 8) - 8 * lane
        w = torch.where(e >= 0, by << e.clamp(min=0),
                        by >> (-e).clamp(min=0)).sum(1)
        ii = torch.searchsorted(uppers, w, right=True)
        valid = ii < n_ls
        l = ls[ii.clamp(max=n_ls - 1)]
        rem = nbits - pos
        ok = act & valid & (l <= rem)
        corrupt = ~valid & (rem >= maxlen + 1)
        err = torch.where(act & ~ok, torch.where(corrupt, 2, 1).int(), err)
        sidx = (first_index[l] + (w >> (maxlen - l)) - first_code[l]).clamp(
            0, n_sym - 1)
        dst = torch.where(ok, out_off + k, n_out)
        out.scatter_(0, dst, torch.where(ok, symbols[sidx], 0))
        pos = torch.where(ok, pos + l, pos)
    return out[:n_out], err
