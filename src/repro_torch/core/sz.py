"""SZ Lor/Reg prediction core (paper §II-A) on torch tensors.

Dual quantization: ``q = rint(x / 2eb)`` first (so ``|x − 2eb·q| ≤ eb``),
then prediction on the exact integer grid.  This module holds the parts of
the reference's ``sz`` module that the TAC+ path runs: prequant/dequant,
N-D Lorenzo codes and recon, the per-block regression fit, the batched
Lor/Reg compressor and the batched decoder.  Every function works on the
device of the tensors it is given; the Lorenzo codes and the Lorenzo
recon of a brick stack run on kernels 1 and 2 (``kernels.ops``).

Arithmetic follows the reference's float64/int64 host path bit for bit.
Two places need care:

* the regression fit's float32 block mean and its float64 block sums
  reproduce numpy's summation order (:func:`_block_sum`);
* the branch score (:func:`_code_cost_bits_rows`) sums in torch's order
  and torch's ``log2``, which may round differently from numpy's in the
  last bits; only a near-tie between the branches could then flip.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops

__all__ = [
    "SZResult", "prequant", "dequant", "lorenzo_nd_codes",
    "lorenzo_nd_recon", "reg_block_grid", "compress_lor_reg_batched",
    "decode_codes", "decode_codes_batched",
]


@dataclass
class SZResult:
    """One compressed brick + exact storage accounting (bits)."""

    recon: torch.Tensor        # reconstructed values (brick shape)
    codes: torch.Tensor        # int64 quantization-code stream (flattened)
    payload_bits: int          # entropy-coded code stream
    codebook_bits: int         # serialized Huffman codebook(s)
    meta_bits: int             # side info: coeffs, choices, dims, eb, ...
    eb: float
    method: str
    extras: dict = field(default_factory=dict)

    @property
    def total_bits(self) -> int:
        return int(self.payload_bits + self.codebook_bits + self.meta_bits)


def prequant(x: torch.Tensor, eb: float) -> torch.Tensor:
    """``q = rint(float64(x) / 2eb)`` as int64 — ``|x − 2eb·q| ≤ eb``."""
    if eb <= 0:
        raise ValueError("error bound must be positive")
    return torch.round(x.double() / (2.0 * eb)).long()


def dequant(q: torch.Tensor, eb: float) -> torch.Tensor:
    return (q.double() * (2.0 * eb)).float()


def lorenzo_nd_codes(q: torch.Tensor, axes: tuple[int, ...] | None = None
                     ) -> torch.Tensor:
    """Exact integer N-D Lorenzo delta: zero-prepend first differences."""
    c = q.long()
    for ax in (tuple(range(c.dim())) if axes is None else axes):
        c = torch.diff(c, dim=ax, prepend=torch.zeros_like(c.narrow(ax, 0, 1)))
    return c


def lorenzo_nd_recon(codes: torch.Tensor, axes: tuple[int, ...] | None = None
                     ) -> torch.Tensor:
    """Inverse Lorenzo: N-D inclusive prefix sum (exact in integers)."""
    q = codes.long()
    for ax in (tuple(range(q.dim())) if axes is None else axes):
        q = torch.cumsum(q, dim=ax)
    return q


_DIM_META_BITS = 3 * 32 + 64  # dims + eb


def reg_block_grid(shape: tuple[int, ...], block: int
                   ) -> tuple[int, tuple[int, ...]]:
    """(block edge b, blocked-grid shape) for a brick's regression branch
    — the one derivation the encoder, the decoder and the container's
    betas/prefix arithmetic share."""
    b = min(block, min(shape)) if min(shape) >= 2 else 1
    return b, tuple(-(-s // b) for s in shape)


def _block_view_batched(a: torch.Tensor, b: int
                        ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(N,X,Y,Z) → (N, bx,by,bz, b,b,b) view after per-brick edge padding."""
    px, py, pz = ((-s) % b for s in a.shape[1:])
    if px or py or pz:
        a = F.pad(a[:, None], (0, pz, 0, py, 0, px), mode="replicate")[:, 0]
    n = a.shape[0]
    bx, by, bz = (s // b for s in a.shape[1:])
    return (a.reshape(n, bx, b, by, b, bz, b)
             .permute(0, 1, 3, 5, 2, 4, 6)), (bx, by, bz)


def _pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise summation over the last axis, in ``t``'s dtype:
    sequential below 8 terms, eight strided partial sums up to 128, and a
    split at a multiple of 8 above."""
    n = t.shape[-1]
    if n < 8:
        res = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for i in range(n):
            res = res + t[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = t[..., 0:8]
        for i in range(8, m, 8):
            r = r + t[..., i:i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
              ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            res = res + t[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(t[..., :n2]) + _pairwise_sum(t[..., n2:])


def _block_sum(xb: torch.Tensor) -> torch.Tensor:
    """Sum of each (b,b,b) block of a (N, bx,by,bz, b,b,b) view, in the
    order numpy reduces the same view over its last three axes.

    numpy walks a C-contiguous array's block view with the reduced axes
    interleaved between the grid axes, drops unit grid axes and merges
    reduced axes that become adjacent and contiguous.  The innermost run
    is summed pairwise, and the runs are added one by one to an
    accumulator that starts at 0.
    """
    b = xb.shape[-1]
    lead = xb.shape[:-3]
    by, bz = xb.shape[-5], xb.shape[-4]
    if bz > 1:
        runs = xb.reshape(lead + (b * b, b))
    elif by > 1:
        runs = xb.reshape(lead + (b, b * b))
    else:
        runs = xb.reshape(lead + (1, b ** 3))
    acc = torch.zeros(lead, dtype=xb.dtype, device=xb.device)
    for o in range(runs.shape[-2]):
        acc = acc + _pairwise_sum(runs[..., o, :])
    return acc


def _coord(b: int, device) -> torch.Tensor:
    return torch.arange(b, dtype=torch.float64, device=device) - (b - 1) / 2.0


def _fit_from_betas(betas: torch.Tensor, b: int) -> torch.Tensor:
    """Replay the plane fit from stored float32 betas (float64 eval), the
    same on the encoder and the decoder."""
    c = _coord(b, betas.device)
    bf = betas.double()
    return (((bf[..., 0, None, None, None]
              + bf[..., 1, None, None, None] * c[:, None, None])
             + bf[..., 2, None, None, None] * c[None, :, None])
            + bf[..., 3, None, None, None] * c[None, None, :])


def _regression_fit(xb: torch.Tensor, b: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form per-block plane fit f = β0 + β1 i + β2 j + β3 k on a
    (N, bx,by,bz, b,b,b) block view.  Returns (betas float32 (...,4),
    fit float64) with the fit evaluated from the float32-cast betas."""
    coord = np.arange(b, dtype=np.float64) - (b - 1) / 2.0
    var = float((coord ** 2).sum()) * b * b
    mean = _block_sum(xb) / float(b ** 3)   # float32 divide, as numpy
    xc = xb.double() - mean.double()[..., None, None, None]
    c = _coord(b, xb.device)
    b1 = _block_sum(xc * c[:, None, None]) / var
    b2 = _block_sum(xc * c[None, :, None]) / var
    b3 = _block_sum(xc * c[None, None, :]) / var
    betas = torch.stack([mean.double(), b1, b2, b3], dim=-1).float()
    return betas, _fit_from_betas(betas, b)


def _code_cost_bits_rows(codes: torch.Tensor) -> torch.Tensor:
    """Per-brick Huffman-size proxy: Σ log2(1 + 2|code|) + 1 over each
    brick (everything but axis 0)."""
    mag = torch.log2(1.0 + 2.0 * codes.abs().double())
    return mag.reshape(mag.shape[0], -1).sum(dim=1) + 1.0


def _unblock(rr: torch.Tensor, b: int, bgrid, bshape) -> torch.Tensor:
    """(n, bx,by,bz, b,b,b) blocks → (n, X,Y,Z) bricks, padding cropped."""
    bx, by, bz = bgrid
    n = rr.shape[0]
    rr = (rr.reshape(n, bx, by, bz, b, b, b)
            .permute(0, 1, 4, 2, 5, 3, 6)
            .reshape(n, bx * b, by * b, bz * b))
    return rr[(slice(None),) + tuple(slice(0, s) for s in bshape)]


def compress_lor_reg_batched(x: torch.Tensor, eb: float, *, block: int = 6
                             ) -> list[SZResult]:
    """Lor/Reg over a (N, X, Y, Z) float32 stack of same-shape bricks.

    Per brick: zero-halo dual-quant Lorenzo (kernel 1) against per-block
    plane fits; the cheaper branch by the bit proxy wins, and only its
    reconstruction is made (Lorenzo recon on kernel 2).  Each result
    equals the reference's ``compress_lor_reg_batched`` on the numpy host
    path.  Payloads are left at 0: SHE prices all bricks under one shared
    codebook.
    """
    if x.dim() != 4:
        raise ValueError("expected a (N, X, Y, Z) stack of 3D bricks")
    if eb <= 0:
        raise ValueError("error bound must be positive")
    x = x.float().contiguous()
    n = x.shape[0]
    if n == 0:
        return []
    bshape = tuple(x.shape[1:])
    b, _ = reg_block_grid(bshape, block)

    codes_lor = ops.lorenzo3d_codes_batched(x, eb)
    cost_lor = _code_cost_bits_rows(codes_lor)
    n_blocks = 0
    if b >= 2:
        xb, bgrid = _block_view_batched(x, b)
        betas, fit = _regression_fit(xb, b)
        codes_reg = torch.round((xb.double() - fit) / (2.0 * eb)).long()
        n_blocks = int(np.prod(bgrid))
        cost_reg = _code_cost_bits_rows(codes_reg) + n_blocks * 4 * 32
        use_reg = cost_reg < cost_lor
    else:
        use_reg = torch.zeros(n, dtype=torch.bool, device=x.device)

    use = use_reg.tolist()
    lor_idx = torch.tensor([i for i in range(n) if not use[i]],
                           dtype=torch.int64, device=x.device)
    reg_idx = torch.tensor([i for i in range(n) if use[i]],
                           dtype=torch.int64, device=x.device)
    recon = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rows: dict[int, tuple[str, int]] = {}
    if lor_idx.numel():
        lor_codes = codes_lor[lor_idx]
        recon[lor_idx] = ops.lorenzo3d_recon_batched(lor_codes, eb)
        rows.update((i, ("lorenzo", r)) for r, i in enumerate(lor_idx.tolist()))
    del codes_lor
    if reg_idx.numel():
        reg_codes = codes_reg[reg_idx]
        reg_betas = betas[reg_idx]
        rr = (fit[reg_idx] + reg_codes.double() * (2.0 * eb)).float()
        recon[reg_idx] = _unblock(rr, b, bgrid, bshape)
        rows.update((i, ("reg", r)) for r, i in enumerate(reg_idx.tolist()))

    out: list[SZResult] = []
    for i in range(n):
        branch, r = rows[i]
        if branch == "reg":
            out.append(SZResult(
                recon=recon[i], codes=reg_codes[r].reshape(-1),
                payload_bits=0, codebook_bits=0,
                meta_bits=_DIM_META_BITS + 1 + n_blocks * 4 * 32, eb=eb,
                method="lor_reg/reg",
                extras={"betas": reg_betas[r], "branch": "reg"}))
        else:
            out.append(SZResult(
                recon=recon[i], codes=lor_codes[r].reshape(-1),
                payload_bits=0, codebook_bits=0,
                meta_bits=_DIM_META_BITS + 1, eb=eb,
                method="lor_reg/lorenzo", extras={"branch": "lorenzo"}))
    return out


def decode_codes_batched(codes: torch.Tensor, shape: tuple[int, ...],
                         eb: float, *, branch: str, block: int = 6,
                         betas: torch.Tensor | None = None) -> torch.Tensor:
    """Reconstruct an (N, \\*shape) float32 stack from (N, n_codes) code
    streams of same-shape 3D bricks — bit-identical to the encoder's
    recon.  ``branch="lorenzo"`` runs kernel 2; ``branch="reg"`` replays
    the plane fits from the (N, bx, by, bz, 4) float32 ``betas``."""
    shape = tuple(int(s) for s in shape)
    if codes.dim() != 2:
        raise ValueError("expected a (N, n_codes) stack of code streams")
    if len(shape) != 3:
        raise NotImplementedError("decoding non-3D payloads is not yet ported")
    n = codes.shape[0]
    codes = codes.long()
    if branch == "lorenzo":
        return ops.lorenzo3d_recon_batched(
            codes.reshape((n,) + shape).contiguous(), eb)
    if branch == "reg":
        if betas is None:
            raise ValueError("regression branch needs betas")
        b, bgrid = reg_block_grid(shape, block)
        codes_reg = codes.reshape((n,) + tuple(bgrid) + (b, b, b))
        fit = _fit_from_betas(betas, b)
        rr = (fit + codes_reg.double() * (2.0 * eb)).float()
        return _unblock(rr, b, bgrid, shape)
    if branch == "interp":
        raise NotImplementedError("the interp branch is not yet ported")
    raise ValueError(f"unknown branch {branch!r}")


def decode_codes(codes: torch.Tensor, shape: tuple[int, ...], eb: float, *,
                 branch: str, block: int = 6,
                 betas: torch.Tensor | None = None) -> torch.Tensor:
    """Single-brick :func:`decode_codes_batched`."""
    return decode_codes_batched(
        codes.reshape(1, -1), shape, eb, branch=branch, block=block,
        betas=None if betas is None else betas[None])[0]
