"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes, on
any device.  ``repro_torch.kernels.ops`` runs them for CPU tensors (the
CPU tests hold them against the JAX package's reference), and the chip
smoke test holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

__all__ = ["true_divide", "lorenzo3d_codes_batched",
           "lorenzo3d_recon_batched", "lorenzo3d_codes", "lorenzo3d_recon",
           "check_tile", "hist", "huffdec", "HUFF_MAXLEN", "check_groups",
           "group_quant", "group_dequant", "quantize_kv_into"]

#: Longest codeword the decoders take: a 64-bit window read at any bit
#: offset inside its first byte holds 57 whole bits.
HUFF_MAXLEN = 57


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, correctly rounded on any device, as numpy divides.

    PyTorch's CUDA kernels turn a division by a Python number into a
    product with its reciprocal, which can round one ulp away (and so
    across a tie of ``rint``); a divisor on the tensor's own device keeps
    the IEEE division.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def lorenzo3d_codes_batched(x: torch.Tensor, eb: float) -> torch.Tensor:
    """(N,X,Y,Z) float32 → int64 codes: ``rint(float64(x) / 2eb)``, then
    zero-halo first differences along X, Y and Z within each brick."""
    c = torch.round(true_divide(x.double(), 2.0 * eb)).long()
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
    c = _tile_view(torch.round(true_divide(x.double(), 2.0 * eb)).long(),
                   tile)
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


def check_groups(shape: tuple[int, ...], group: int) -> int:
    """The number of groups of ``group`` values in an (n, d) array.

    :raises ValueError: unless the array is 2-D and ``group`` is positive
        and divides ``d``.
    """
    if len(shape) != 2:
        raise ValueError(f"expected an (n, d) array, got {tuple(shape)}")
    if group < 1 or shape[1] % group:
        raise ValueError(f"shape {tuple(shape)} needs d % {group} == 0")
    return shape[0] * (shape[1] // group)


def group_quant(x: torch.Tensor, group: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) float32 or bfloat16 → int8 codes (n, d) and float32 scales
    (n, d/group): per group of ``group`` values along d, ``scale =
    max|x|/127`` (1 for an all-zero group) and ``q = clip(rint(x / scale),
    −127, 127)``, computed in float32.

    Both divisions divide by a tensor: PyTorch turns a division by a
    Python number into a product with its reciprocal on CUDA, which
    differs from the reference's division at ties.
    """
    check_groups(tuple(x.shape), group)
    n, d = x.shape
    g = x.float().reshape(n, d // group, group)
    amax = g.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.round(g / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8).reshape(n, d), scale


def group_dequant(q: torch.Tensor, scale: torch.Tensor, group: int
                  ) -> torch.Tensor:
    """Inverse of :func:`group_quant`: float32 ``q · scale`` per group."""
    check_groups(tuple(q.shape), group)
    n, d = q.shape
    g = q.reshape(n, d // group, group).float()
    return (g * scale.float()[..., None]).reshape(n, d)


def quantize_kv_into(k: torch.Tensor, v: torch.Tensor, cache: dict,
                     start: int) -> None:
    """A decode step's write into one layer's int8 KV cache, in place:
    ``k``/``v`` (B, Sq, H, hd) each through :func:`group_quant` at
    ``group = hd``, the codes into ``cache["k"]``/``cache["v"]`` (B, S, H,
    hd) and the scales into ``cache["k_scale"]``/``cache["v_scale"]`` (B,
    S, H) at positions ``start:start + Sq``."""
    hd, end = k.shape[-1], start + k.shape[1]
    for name, x in (("k", k), ("v", v)):
        q, s = group_quant(x.reshape(-1, hd), hd)
        cache[name][:, start:end] = q.reshape(x.shape)
        cache[name + "_scale"][:, start:end] = s.reshape(x.shape[:-1])
