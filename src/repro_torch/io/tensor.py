"""TACZ blobs for single tensors (the checkpoint-manager encoding).

One tensor travels as a self-describing one-level TACZ container: a
``STRATEGY_GLOBAL`` level whose one payload holds the dual-quant N-D
Lorenzo codes *raw* (int16 when they fit, int32 otherwise) under a
zstd/zlib byte pass, with no Huffman stage.  The bytes equal the
reference's ``repro.io.tensor`` for the same tensor.  Float32 tensors of
rank 3 run on kernels 5/6 and of rank 4 on kernels 1/2
(:func:`repro_torch.core.sz.lorenzo_codes`); other ranks and dtypes use
the plain integer Lorenzo.
"""
from __future__ import annotations

import zlib

import torch

from ..core.compat import HAVE_ZSTD, zstd_compress
from ..core.sz import lorenzo_codes
from ..device import resolve_device
from . import format as fmt
from .reader import TACZReader
from .writer import build_container

__all__ = ["encode_tensor", "decode_tensor"]


def encode_tensor(a, eb: float, *,
                  device: str | torch.device = "cuda") -> bytes:
    """Error-bounded lossy encoding of one tensor → TACZ container bytes.

    :param a: numpy array or tensor of any numeric dtype, rank 1..8.
    :param eb: absolute error bound; the reconstruction satisfies
        ``|a - decode_tensor(blob)| ≤ eb`` (+ float32 rounding).
    :param device: where the codes are computed (default ``"cuda"``).
    :raises ValueError: if the tensor rank is outside 1..8 or ``eb ≤ 0``.
    """
    device = resolve_device(device)
    t = torch.as_tensor(a).to(device)
    if not 1 <= t.dim() <= fmt.MAX_RANK:
        raise ValueError(f"tensor rank {t.dim()} outside 1..{fmt.MAX_RANK}")
    if eb <= 0:
        raise ValueError("error bound must be positive")
    codes = lorenzo_codes(t, eb).reshape(-1)
    small = codes.numel() == 0 or int(codes.abs().max()) < 2 ** 15
    host = codes.cpu().numpy()
    if small:
        raw, codec = host.astype("<i2").tobytes(), fmt.CODEC_RAW_I16
    else:
        raw, codec = host.astype("<i4").tobytes(), fmt.CODEC_RAW_I32
    if HAVE_ZSTD:
        payload, compressor = zstd_compress(raw), fmt.COMPRESSOR_ZSTD
    else:
        payload, compressor = zlib.compress(raw, 6), fmt.COMPRESSOR_ZLIB
    shape = tuple(int(s) for s in t.shape)
    entry = fmt.LevelEntry(
        shape=shape, grid_shape=shape, strategy=fmt.STRATEGY_GLOBAL,
        algorithm=fmt.ALGO_LORENZO, unit=1, sz_block=6, ratio=1,
        eb=float(eb), n_values=int(t.numel()), density=1.0)
    entry.subblocks.append(fmt.SubBlockEntry(
        origin=(0, 0, 0), size=(shape + (1, 1, 1))[:3],
        branch=fmt.BRANCH_LORENZO, codec=codec, compressor=compressor,
        payload_off=0, payload_len=len(payload), nbits=0,
        n_codes=int(codes.numel()), betas_len=0, crc=zlib.crc32(payload)))
    return build_container([(payload, entry)])


def decode_tensor(blob: bytes, *,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """Inverse of :func:`encode_tensor`: the float32 reconstruction at
    the original shape, on ``device``.

    :raises ValueError: if the blob is not a one-level TACZ container.
    :raises IOError: if the payload fails its CRC check.
    """
    with TACZReader(blob, device=device) as rd:
        if rd.n_levels != 1:
            raise ValueError("tensor blob must hold exactly one level")
        return rd.read_level(0)
