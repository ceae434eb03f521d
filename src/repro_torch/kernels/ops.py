"""Wrappers around the port's CUDA kernels.

Each wrapper checks dtype, shape and contiguity, then:

* for a CPU tensor, returns the plain version from :mod:`.ref`;
* for a CUDA tensor, launches its kernel on the current stream, raises
  if the launch reports an error, and adds one to :data:`launches`;
* for any other device, raises.

There is no fallback: a CUDA tensor reaches its kernel or an exception.

========================  =======================================  ===========================
wrapper                   TPU kernel it replaces                   source
========================  =======================================  ===========================
lorenzo3d_codes_batched   repro/kernels/lorenzo3d.py:139           csrc/lorenzo3d.cu
lorenzo3d_recon_batched   repro/kernels/lorenzo3d.py:157           csrc/lorenzo3d.cu
lorenzo3d_codes           repro/kernels/lorenzo3d.py:64            csrc/lorenzo3d.cu
lorenzo3d_recon           repro/kernels/lorenzo3d.py:82            csrc/lorenzo3d.cu
hist                      repro/kernels/hist.py:41                 csrc/hist.cu
huffdec                   repro/kernels/huffdec.py:48 and :73      csrc/huffdec.cu
========================  =======================================  ===========================
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

__all__ = ["launches", "reset_launches", "lorenzo3d_codes_batched",
           "lorenzo3d_recon_batched", "lorenzo3d_codes", "lorenzo3d_recon",
           "hist", "huffdec"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches = {"lorenzo3d_codes_batched": 0, "lorenzo3d_recon_batched": 0,
            "lorenzo3d_codes": 0, "lorenzo3d_recon": 0, "hist": 0,
            "huffdec": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (kernel), False for CPU inputs (plain
    version); raises on anything else or on mixed devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _require(name: str, t: torch.Tensor, dtype: torch.dtype,
             ndim: int | None = None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    launches[name] += 1


def lorenzo3d_codes_batched(x: torch.Tensor, eb: float) -> torch.Tensor:
    """(N,X,Y,Z) float32 bricks → int64 zero-halo Lorenzo codes of
    ``rint(float64(x) / 2eb)`` (kernel 1)."""
    name = "lorenzo3d_codes_batched"
    _require(name, x, torch.float32, 4)
    if not _on_cuda(name, x):
        return ref.lorenzo3d_codes_batched(x, eb)
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    n, X, Y, Z = x.shape
    with torch.cuda.device(x.device):
        rc = build.library("lorenzo3d").lorenzo3d_codes_batched(
            _ptr(x), _ptr(out), n, X, Y, Z, 2.0 * eb, _stream(x))
    _launched(name, rc)
    return out


def lorenzo3d_recon_batched(codes: torch.Tensor, eb: float) -> torch.Tensor:
    """(N,X,Y,Z) int64 codes → float32 recon (kernel 2)."""
    name = "lorenzo3d_recon_batched"
    _require(name, codes, torch.int64, 4)
    if not _on_cuda(name, codes):
        return ref.lorenzo3d_recon_batched(codes, eb)
    scratch = torch.empty_like(codes)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    n, X, Y, Z = codes.shape
    with torch.cuda.device(codes.device):
        rc = build.library("lorenzo3d").lorenzo3d_recon_batched(
            _ptr(codes), _ptr(scratch), _ptr(out), n, X, Y, Z, 2.0 * eb,
            _stream(codes))
    _launched(name, rc)
    return out


def lorenzo3d_codes(x: torch.Tensor, eb: float,
                    tile: tuple[int, int, int]) -> torch.Tensor:
    """(X,Y,Z) float32 array → int64 Lorenzo codes of
    ``rint(float64(x) / 2eb)`` with a zero halo per ``tile`` (kernel 5).
    The tile is clamped to the shape and must divide it (``ValueError``
    otherwise); ``tile = shape`` is the global Lorenzo of the array."""
    name = "lorenzo3d_codes"
    _require(name, x, torch.float32, 3)
    tile = ref.check_tile(tuple(x.shape), tile)
    if not _on_cuda(name, x):
        return ref.lorenzo3d_codes(x, eb, tile)
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.library("lorenzo3d").lorenzo3d_codes(
            _ptr(x), _ptr(out), *x.shape, *tile, 2.0 * eb, _stream(x))
    _launched(name, rc)
    return out


def lorenzo3d_recon(codes: torch.Tensor, eb: float,
                    tile: tuple[int, int, int]) -> torch.Tensor:
    """(X,Y,Z) int64 codes → float32 recon, scans restarting at every
    ``tile`` edge (kernel 6); the tile is checked as in
    :func:`lorenzo3d_codes`."""
    name = "lorenzo3d_recon"
    _require(name, codes, torch.int64, 3)
    tile = ref.check_tile(tuple(codes.shape), tile)
    if not _on_cuda(name, codes):
        return ref.lorenzo3d_recon(codes, eb, tile)
    scratch = torch.empty_like(codes)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    with torch.cuda.device(codes.device):
        rc = build.library("lorenzo3d").lorenzo3d_recon(
            _ptr(codes), _ptr(scratch), _ptr(out), *codes.shape, *tile,
            2.0 * eb, _stream(codes))
    _launched(name, rc)
    return out


def hist(codes: torch.Tensor, lo: int, n_bins: int) -> torch.Tensor:
    """int64 counts of ``codes - lo`` clipped to [0, n_bins) (kernel 3)."""
    name = "hist"
    _require(name, codes, torch.int64, 1)
    if n_bins < 1 or n_bins >= 2 ** 31:
        raise ValueError(f"{name}: n_bins {n_bins} out of range")
    if not _on_cuda(name, codes):
        return ref.hist(codes, lo, n_bins)
    counts = torch.zeros(n_bins, dtype=torch.int64, device=codes.device)
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    with torch.cuda.device(codes.device):
        rc = build.library("hist").hist_codes(
            _ptr(codes), codes.numel(), int(lo), int(n_bins), _ptr(counts),
            sms, _stream(codes))
    _launched(name, rc)
    return counts


def huffdec(data: torch.Tensor, byte_off: torch.Tensor, nbits: torch.Tensor,
            n_decode: torch.Tensor, out_off: torch.Tensor, n_out: int,
            symbols: torch.Tensor, first_code: torch.Tensor,
            first_index: torch.Tensor, count: torch.Tensor, maxlen: int,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode every payload of a level in one launch (kernel 4).

    See :func:`repro_torch.kernels.ref.huffdec` for the arguments.  The
    tables (``first_code``/``first_index``/``count``) hold at least
    ``maxlen + 1`` entries.  Returns ``(out int64 (n_out,), err int32)``.
    """
    name = "huffdec"
    _require(name, data, torch.uint8, 1)
    for t in (byte_off, nbits, n_decode, out_off, symbols, first_code,
              first_index, count):
        _require(name, t, torch.int64, 1)
    if not 0 <= maxlen <= ref.HUFF_MAXLEN:
        raise ValueError(f"{name}: codeword length {maxlen} exceeds "
                         f"{ref.HUFF_MAXLEN}")
    if min(first_code.numel(), first_index.numel(), count.numel()) < maxlen + 1:
        raise ValueError(f"{name}: tables shorter than maxlen + 1")
    a_n = byte_off.numel()
    if not (nbits.numel() == n_decode.numel() == out_off.numel() == a_n):
        raise ValueError(f"{name}: per-payload arrays differ in length")
    args = (data, byte_off, nbits, n_decode, out_off, symbols, first_code,
            first_index, count)
    if not _on_cuda(name, *args):
        return ref.huffdec(data, byte_off, nbits, n_decode, out_off, n_out,
                           symbols, first_code, first_index, count, maxlen)
    dev = data.device
    out = torch.zeros(n_out, dtype=torch.int64, device=dev)
    err = torch.zeros(a_n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library("huffdec").huffdec_payloads(
            _ptr(data), _ptr(byte_off), _ptr(nbits), _ptr(n_decode),
            _ptr(out_off), a_n, _ptr(symbols), symbols.numel(),
            _ptr(first_code), _ptr(first_index), _ptr(count), int(maxlen),
            _ptr(out), _ptr(err), _stream(data))
    _launched(name, rc)
    return out, err
