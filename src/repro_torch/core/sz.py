"""SZ prediction core (paper §II-A) on torch tensors.

Dual quantization: ``q = rint(x / 2eb)`` first (so ``|x − 2eb·q| ≤ eb``),
then prediction on the exact integer grid.  Three compressors share one
result type:

* :func:`compress_lorenzo` — global N-D Lorenzo (GSP grids, merged 4D
  groups); a 3D array runs on kernels 5 and 6 with one tile covering the
  array, a 4D stack on kernels 1 and 2 plus a difference along axis 0;
* :func:`compress_lor_reg` — Lorenzo against per-block regression, one
  choice per array; :func:`compress_lor_reg_batched` does the same for a
  stack of same-shape bricks (the SHE path) on kernels 1 and 2;
* :func:`compress_interp` — global multi-level interpolation (SZ3), in
  torch on the device (the reference has no TPU kernel for it).

:func:`entropy_stage` prices a code stream with a real Huffman bitstream
(histogram on kernel 3, packing on the device).  :func:`decode_codes` and
:func:`decode_codes_batched` replay any of them from serialized codes.
Every function works on the device of the tensors it is given.

Arithmetic follows the reference's float64/int64 host path bit for bit.
Places that need care:

* the regression fit's float32 block mean and its float64 block sums
  reproduce numpy's summation order (:func:`_block_sum`);
* the whole-array branch score (:func:`_code_cost_bits`) sums in numpy's
  order (:func:`_numpy_sum`); the batched per-brick score
  (:func:`_code_cost_bits_rows`) sums in torch's order;
* both scores use torch's ``log2``, which may round differently from
  numpy's in the last bit; only a near-tie between the branches could
  then flip.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import true_divide
from ..obs import metrics as obsm
from . import entropy, huffman
from .compat import zstd_size_bits

__all__ = [
    "SZResult", "prequant", "dequant", "lorenzo_nd_codes",
    "lorenzo_nd_recon", "lorenzo_codes", "lorenzo_decode",
    "interp_nd_codes", "interp_nd_recon",
    "compress_lorenzo", "compress_lor_reg", "compress_lor_reg_batched",
    "compress_interp", "decode_codes", "decode_codes_batched",
    "entropy_bits", "entropy_stage", "reg_block_grid",
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

    def compression_ratio(self, n_values: int | None = None,
                          dtype_bits: int = 32) -> float:
        n = (int(np.prod(tuple(self.recon.shape))) if n_values is None
             else n_values)
        return n * dtype_bits / max(self.total_bits, 1)


def prequant(x: torch.Tensor, eb: float) -> torch.Tensor:
    """``q = rint(float64(x) / 2eb)`` as int64 — ``|x − 2eb·q| ≤ eb``."""
    if eb <= 0:
        raise ValueError("error bound must be positive")
    return torch.round(true_divide(x.double(), 2.0 * eb)).long()


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


def lorenzo_codes(x: torch.Tensor, eb: float) -> torch.Tensor:
    """Global dual-quant Lorenzo codes of ``x`` (any rank), int64.

    A 3D float32 array runs on kernel 5 with one tile covering it.  A 4D
    stack runs kernel 1 on its 3D bricks, then differences along axis 0:
    the Lorenzo codes are first differences along every axis, and integer
    differences along different axes commute, so this is exact.  Other
    ranks and dtypes take the plain integer Lorenzo of :func:`prequant`.
    """
    if x.dtype == torch.float32 and x.dim() == 3:
        return ops.lorenzo3d_codes(x.contiguous(), eb, tuple(x.shape))
    if x.dtype == torch.float32 and x.dim() == 4:
        c = ops.lorenzo3d_codes_batched(x.contiguous(), eb)
        return torch.diff(c, dim=0, prepend=torch.zeros_like(c[:1]))
    return lorenzo_nd_codes(prequant(x, eb))


def lorenzo_decode(codes: torch.Tensor, eb: float) -> torch.Tensor:
    """Inverse of :func:`lorenzo_codes` for codes shaped like the array:
    kernel 6 for 3D, an int64 prefix sum along axis 0 then kernel 2 for
    4D (exact, as the differences commute), the plain recon otherwise."""
    codes = codes.long().contiguous()
    if codes.dim() == 3:
        return ops.lorenzo3d_recon(codes, eb, tuple(codes.shape))
    if codes.dim() == 4:
        return ops.lorenzo3d_recon_batched(
            torch.cumsum(codes, dim=0).contiguous(), eb)
    return dequant(lorenzo_nd_recon(codes), eb)


# --------------------------------------------------------------------------
# N-D multi-level interpolation on the integer grid (SZ3 "Interp")
# --------------------------------------------------------------------------


def _interp_schedule(shape: tuple[int, ...]) -> list[tuple[int, int]]:
    """(axis, stride) stages, coarsest level first, axis by axis."""
    max_dim = max(shape)
    s = 1
    while s < max_dim:
        s *= 2
    stages = []
    while s >= 2:
        for ax in range(len(shape)):
            stages.append((ax, s))
        s //= 2
    return stages


def _interp_stage_indices(dim: int, stride: int, device):
    """Midpoint + 4-point stencil indices of one axis stage, as int64
    device tensors ``(mids, left, right, left2, right2, cubic_ok)``:
    cubic where the stencil fits, linear at the edges, copy-left where
    no right neighbour exists."""
    half = stride // 2
    mids = np.arange(half, dim, stride)
    left = mids - half
    right_raw = mids + half
    has_right = right_raw < dim
    right = np.where(has_right, np.minimum(right_raw, dim - 1), left)
    left2_raw = mids - 3 * half
    right2_raw = mids + 3 * half
    cubic_ok = (left2_raw >= 0) & (right2_raw < dim) & has_right
    left2 = np.where(cubic_ok, np.maximum(left2_raw, 0), left)
    right2 = np.where(cubic_ok, np.minimum(right2_raw, dim - 1), right)
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
                 for a in (mids, left, right, left2, right2)) + (
        torch.from_numpy(cubic_ok).to(device),)


def _interp_predict(q: torch.Tensor, ax: int, left, right, left2, right2,
                    cubic_ok) -> torch.Tensor:
    """Integer prediction, identical on encoder and decoder: the rounded
    cubic ``(−a + 9b + 9c − d + 8) >> 4`` where the stencil fits, else
    the floor average ``(b + c) >> 1``.  torch's ``>>`` on int64 is the
    arithmetic shift, so it floors negative values as numpy does."""
    ql = q.index_select(ax, left)
    qr = q.index_select(ax, right)
    lin = (ql + qr) >> 1
    qa = q.index_select(ax, left2)
    qd = q.index_select(ax, right2)
    cub = (-qa + 9 * ql + 9 * qr - qd + 8) >> 4
    shape = [1] * q.dim()
    shape[ax] = cubic_ok.numel()
    return torch.where(cubic_ok.reshape(shape), cub, lin)


def interp_nd_codes(q: torch.Tensor) -> torch.Tensor:
    """Residual codes of global multi-level interpolation on the integer
    grid: every stage predicts from true ``q`` values, which the decoder
    has recovered exactly by then; anchors keep ``code = q``."""
    q = q.long()
    codes = q.clone()
    for ax, stride in _interp_schedule(tuple(q.shape)):
        mids, left, right, left2, right2, ok = _interp_stage_indices(
            q.shape[ax], stride, q.device)
        if mids.numel() == 0:
            continue
        pred = _interp_predict(q, ax, left, right, left2, right2, ok)
        codes.index_copy_(ax, mids, q.index_select(ax, mids) - pred)
    return codes


def interp_nd_recon(codes: torch.Tensor) -> torch.Tensor:
    """Decoder replay of :func:`interp_nd_codes` (exact)."""
    codes = codes.long()
    q = codes.clone()
    for ax, stride in _interp_schedule(tuple(codes.shape)):
        mids, left, right, left2, right2, ok = _interp_stage_indices(
            codes.shape[ax], stride, codes.device)
        if mids.numel() == 0:
            continue
        pred = _interp_predict(q, ax, left, right, left2, right2, ok)
        q.index_copy_(ax, mids, pred + codes.index_select(ax, mids))
    return q


# --------------------------------------------------------------------------
# entropy stage: Huffman (+ optional zstd), real bitstreams
# --------------------------------------------------------------------------


def entropy_stage(codes: torch.Tensor, *, use_zstd: bool = True,
                  codebook: huffman.Codebook | None = None,
                  ) -> tuple[int, int, dict]:
    """(payload_bits, codebook_bits, artifacts) of one code stream, from
    a materialized bitstream: one histogram (kernel 3), one codebook, one
    device packing pass, and the zstd pass priced when ``zstandard`` is
    installed.  ``artifacts`` is ``{"codebook", "packed", "nbits"}``,
    which the TACZ writer reuses for gsp/global levels."""
    from .she import aggregate_histogram

    codes = codes.reshape(-1)
    if codes.numel() == 0:
        return 0, 0, {"codebook": None, "packed": b"", "nbits": 0}
    cb = codebook
    if cb is None:
        symbols, freqs = aggregate_histogram(codes)
        cb = huffman.build_codebook(symbols=symbols, freqs=freqs)
    (blob, nbits), = entropy.TorchEngine(codes.device).encode_payloads(
        cb, [codes])
    payload = nbits
    if use_zstd:
        zbits = zstd_size_bits(blob)
        if zbits is not None:
            payload = min(payload, zbits)
    cb_bits = 0 if codebook is not None else huffman.codebook_size_bits(cb)
    return int(payload), int(cb_bits), {"codebook": cb, "packed": blob,
                                        "nbits": int(nbits)}


def entropy_bits(codes: torch.Tensor, *, use_zstd: bool = True,
                 codebook: huffman.Codebook | None = None) -> tuple[int, int]:
    """(payload_bits, codebook_bits) of one code stream."""
    payload, cb_bits, _ = entropy_stage(codes, use_zstd=use_zstd,
                                        codebook=codebook)
    return payload, cb_bits


_DIM_META_BITS = 3 * 32 + 64  # dims + eb


def _global_result(x: torch.Tensor, eb: float, codes: torch.Tensor,
                   recon: torch.Tensor, method: str, use_zstd: bool,
                   codebook: huffman.Codebook | None) -> SZResult:
    payload, cb_bits, ent = entropy_stage(codes, use_zstd=use_zstd,
                                          codebook=codebook)
    return SZResult(recon=recon.reshape(x.shape), codes=codes.reshape(-1),
                    payload_bits=payload, codebook_bits=cb_bits,
                    meta_bits=_DIM_META_BITS, eb=eb, method=method,
                    extras={"entropy": ent})


def compress_lorenzo(x: torch.Tensor, eb: float, *, use_zstd: bool = True,
                     codebook: huffman.Codebook | None = None) -> SZResult:
    """Global N-D dual-quant Lorenzo of ``x`` (kernels 5/6 for 3D, 1/2
    for 4D; see :func:`lorenzo_codes`)."""
    if eb <= 0:
        raise ValueError("error bound must be positive")
    codes = lorenzo_codes(x, eb)
    return _global_result(x, eb, codes, lorenzo_decode(codes, eb), "lorenzo",
                          use_zstd, codebook)


def compress_interp(x: torch.Tensor, eb: float, *, use_zstd: bool = True,
                    codebook: huffman.Codebook | None = None) -> SZResult:
    """Global multi-level interpolation (the SZ3 'Interp' analogue)."""
    codes = interp_nd_codes(prequant(x, eb))
    return _global_result(x, eb, codes, dequant(interp_nd_recon(codes), eb),
                          "interp", use_zstd, codebook)


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
    mean = true_divide(_block_sum(xb), float(b ** 3))  # float32, as numpy
    xc = xb.double() - mean.double()[..., None, None, None]
    c = _coord(b, xb.device)
    b1 = true_divide(_block_sum(xc * c[:, None, None]), var)
    b2 = true_divide(_block_sum(xc * c[None, :, None]), var)
    b3 = true_divide(_block_sum(xc * c[None, None, :]), var)
    betas = torch.stack([mean.double(), b1, b2, b3], dim=-1).float()
    return betas, _fit_from_betas(betas, b)


def _code_cost_bits_rows(codes: torch.Tensor) -> torch.Tensor:
    """Per-brick Huffman-size proxy: Σ log2(1 + 2|code|) + 1 over each
    brick (everything but axis 0)."""
    mag = torch.log2(1.0 + 2.0 * codes.abs().double())
    return mag.reshape(mag.shape[0], -1).sum(dim=1) + 1.0


_NUMPY_BUFSIZE = 8192


def _numpy_sum(t: torch.Tensor) -> float:
    """``np.sum`` of a float64 array in numpy's order: the flattened
    array is cut into chunks of numpy's buffer size (8192), each chunk is
    summed pairwise, and the chunk sums are added one by one to 0.  The
    chunks are summed as one batch on ``t``'s device; the last additions
    run in float64 on the host, which rounds as the device does."""
    t = t.reshape(-1)
    n = t.numel()
    full = n - n % _NUMPY_BUFSIZE
    parts = []
    if full:
        parts.append(_pairwise_sum(t[:full].reshape(-1, _NUMPY_BUFSIZE)))
    if n > full:
        parts.append(_pairwise_sum(t[full:])[None])
    acc = 0.0
    if parts:
        for v in torch.cat(parts).tolist():
            acc += v
    return acc


def _code_cost_bits(codes: torch.Tensor) -> float:
    """Whole-array Huffman-size proxy Σ log2(1 + 2|code|) + 1, summed over
    ``codes`` in C order as numpy sums it (:func:`_numpy_sum`)."""
    return _numpy_sum(torch.log2(1.0 + 2.0 * codes.abs().double())) + 1.0


def _unblock(rr: torch.Tensor, b: int, bgrid, bshape) -> torch.Tensor:
    """(n, bx,by,bz, b,b,b) blocks → (n, X,Y,Z) bricks, padding cropped."""
    bx, by, bz = bgrid
    n = rr.shape[0]
    rr = (rr.reshape(n, bx, by, bz, b, b, b)
            .permute(0, 1, 4, 2, 5, 3, 6)
            .reshape(n, bx * b, by * b, bz * b))
    return rr[(slice(None),) + tuple(slice(0, s) for s in bshape)]


def _block_view(a: torch.Tensor, b: int
                ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(X,Y,Z) → (bx,by,bz, b,b,b) view after edge-replication padding."""
    xb, bgrid = _block_view_batched(a[None], b)
    return xb[0], bgrid


def _reg_recon(betas: torch.Tensor, codes_reg: torch.Tensor, b: int,
               bgrid: tuple[int, int, int], orig_shape: tuple[int, ...],
               eb: float) -> torch.Tensor:
    """Regression-branch reconstruction of one 3D array from its float32
    betas (bx,by,bz,4) and blocked codes — the encoder's recon and the
    container's decode path."""
    fit = _fit_from_betas(betas, b)
    rr = (fit + codes_reg.reshape(fit.shape).double() * (2.0 * eb)).float()
    return _unblock(rr[None], b, bgrid, orig_shape)[0]


def compress_lor_reg(x: torch.Tensor, eb: float, *, block: int = 6,
                     use_zstd: bool = True,
                     codebook: huffman.Codebook | None = None,
                     count_entropy: bool = True) -> SZResult:
    """SZ2 Lor/Reg on one array: the global Lorenzo of the whole array
    (:func:`lorenzo_codes`: kernel 5, recon on kernel 6, for float32)
    against per-``block``³ plane fits; the cheaper branch by the bit
    proxy wins, with one branch bit.

    A rank above 3 runs on its trailing 3D bricks, one by one, and prices
    their codes as one stream.  ``count_entropy=False`` skips the entropy
    stage (payload 0).
    """
    if x.dim() < 3:
        raise ValueError("compress_lor_reg needs an array of rank 3 or more")
    if eb <= 0:
        raise ValueError("error bound must be positive")
    x = x.contiguous()
    orig_shape = tuple(x.shape)
    if x.dim() != 3:
        x3 = x.reshape((-1,) + orig_shape[-3:])
        parts = [compress_lor_reg(x3[i], eb, block=block, use_zstd=False,
                                  codebook=codebook, count_entropy=False)
                 for i in range(x3.shape[0])]
        codes = torch.cat([p.codes for p in parts])
        payload = cb_bits = 0
        extras: dict = {}
        if count_entropy:
            payload, cb_bits, extras["entropy"] = entropy_stage(
                codes, use_zstd=use_zstd, codebook=codebook)
        return SZResult(recon=torch.stack([p.recon for p in parts])
                        .reshape(orig_shape), codes=codes,
                        payload_bits=payload, codebook_bits=cb_bits,
                        meta_bits=sum(p.meta_bits for p in parts), eb=eb,
                        method="lor_reg", extras=extras)

    b, _ = reg_block_grid(orig_shape, block)
    codes_lor = lorenzo_codes(x, eb)
    cost_lor = _code_cost_bits(codes_lor)
    use_reg = False
    if b >= 2:
        xb, bgrid = _block_view(x, b)
        betas, fit = _regression_fit(xb, b)
        codes_reg = torch.round(
            true_divide(xb.double() - fit, 2.0 * eb)).long()
        n_blocks = int(np.prod(bgrid))
        cost_reg = _code_cost_bits(codes_reg) + n_blocks * 4 * 32
        use_reg = cost_reg < cost_lor

    if use_reg:
        recon = _reg_recon(betas, codes_reg, b, bgrid, orig_shape, eb)
        codes = codes_reg
        meta = _DIM_META_BITS + 1 + n_blocks * 4 * 32
        method = "lor_reg/reg"
        extras = {"betas": betas, "branch": "reg"}
    else:
        recon = lorenzo_decode(codes_lor, eb)
        codes = codes_lor
        meta = _DIM_META_BITS + 1
        method = "lor_reg/lorenzo"
        extras = {"branch": "lorenzo"}
    payload = cb_bits = 0
    if count_entropy:
        payload, cb_bits, extras["entropy"] = entropy_stage(
            codes, use_zstd=use_zstd, codebook=codebook)
    return SZResult(recon=recon, codes=codes.reshape(-1),
                    payload_bits=payload, codebook_bits=cb_bits,
                    meta_bits=meta, eb=eb, method=method, extras=extras)


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

    # --- Lorenzo branch: kernel 1; the stage ends where its codes are
    # ready, so the timer synchronizes (only while the registry is on)
    with obsm.timed(obsm.COMPRESS_STAGE_SECONDS.labels("prequant"),
                    "prequant", sync=x.device):
        codes_lor = ops.lorenzo3d_codes_batched(x, eb)

    # --- Regression branch: per-block plane fits + branch scoring; the
    # choice comes to the host, which ends the stage
    with obsm.timed(obsm.COMPRESS_STAGE_SECONDS.labels("branch_score"),
                    "branch_score"):
        cost_lor = _code_cost_bits_rows(codes_lor)
        n_blocks = 0
        if b >= 2:
            xb, bgrid = _block_view_batched(x, b)
            betas, fit = _regression_fit(xb, b)
            codes_reg = torch.round(
                true_divide(xb.double() - fit, 2.0 * eb)).long()
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
    streams of same-shape arrays — bit-identical to the encoder's recon.
    ``branch="lorenzo"`` runs kernel 2 on 3D bricks (the plain recon for
    other ranks); ``"reg"`` replays the plane fits of 3D bricks from the
    (N, bx, by, bz, 4) float32 ``betas``; ``"interp"`` replays each item."""
    shape = tuple(int(s) for s in shape)
    if codes.dim() != 2:
        raise ValueError("expected a (N, n_codes) stack of code streams")
    n = codes.shape[0]
    codes = codes.long()
    if branch == "lorenzo":
        stacked = codes.reshape((n,) + shape).contiguous()
        if len(shape) == 3:
            return ops.lorenzo3d_recon_batched(stacked, eb)
        return dequant(lorenzo_nd_recon(
            stacked, axes=tuple(range(1, len(shape) + 1))), eb)
    if branch == "interp":
        if n == 0:
            return torch.zeros((0,) + shape, dtype=torch.float32,
                               device=codes.device)
        return torch.stack([dequant(interp_nd_recon(c.reshape(shape)), eb)
                            for c in codes])
    if branch == "reg":
        if betas is None:
            raise ValueError("regression branch needs betas")
        if len(shape) != 3:
            raise ValueError("regression branch decodes 3D bricks only")
        b, bgrid = reg_block_grid(shape, block)
        codes_reg = codes.reshape((n,) + tuple(bgrid) + (b, b, b))
        fit = _fit_from_betas(betas, b)
        rr = (fit + codes_reg.double() * (2.0 * eb)).float()
        return _unblock(rr, b, bgrid, shape)
    raise ValueError(f"unknown branch {branch!r}")


def decode_codes(codes: torch.Tensor, shape: tuple[int, ...], eb: float, *,
                 branch: str, block: int = 6,
                 betas: torch.Tensor | None = None) -> torch.Tensor:
    """Reconstruct one array of ``shape`` from its code stream (the read
    path of gsp/global levels): ``"lorenzo"`` inverts
    :func:`compress_lorenzo` for any rank (kernel 6 for 3D, kernel 2 for
    4D), ``"interp"`` inverts :func:`compress_interp`, ``"reg"`` replays
    the regression branch of a 3D array from its (bx, by, bz, 4) betas."""
    shape = tuple(int(s) for s in shape)
    if branch == "lorenzo":
        return lorenzo_decode(codes.reshape(shape), eb)
    if branch == "interp":
        return dequant(interp_nd_recon(codes.reshape(shape)), eb)
    return decode_codes_batched(
        codes.reshape(1, -1), shape, eb, branch=branch, block=block,
        betas=None if betas is None else betas[None])[0]
