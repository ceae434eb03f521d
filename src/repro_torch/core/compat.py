"""Optional-dependency gates.

The container images this repo targets do not all ship ``zstandard``; the
SZ entropy stage treats the zstd pass as a *size-reducing option* (it only
ever tightens ``min(huffman_bits, zstd_bits)``), so a missing module
degrades gracefully to Huffman-only accounting instead of an ImportError.

``zstd_size_bits`` is the single choke point: every caller that previously
did ``len(ZstdCompressor().compress(buf)) * 8`` goes through here.
"""
from __future__ import annotations

__all__ = ["HAVE_ZSTD", "zstd_module", "zstd_size_bits",
           "zstd_compress", "zstd_decompress"]

try:
    import zstandard as _zstd

    HAVE_ZSTD = True
except ImportError:          # pragma: no cover - environment dependent
    _zstd = None
    HAVE_ZSTD = False


def zstd_module():
    """The ``zstandard`` module, or None when not installed."""
    return _zstd


def zstd_size_bits(buf: bytes, *, level: int = 3) -> int | None:
    """Size in bits of ``buf`` after a zstd pass, or None without zstd."""
    if _zstd is None:
        return None
    return len(_zstd.ZstdCompressor(level=level).compress(buf)) * 8


def zstd_compress(buf: bytes, *, level: int = 3) -> bytes:
    """zstd-compress ``buf``; raises if zstandard is unavailable."""
    if _zstd is None:
        raise ModuleNotFoundError("zstandard is not installed")
    return _zstd.ZstdCompressor(level=level).compress(buf)


def zstd_decompress(blob: bytes) -> bytes:
    if _zstd is None:
        raise ModuleNotFoundError("zstandard is not installed")
    return _zstd.ZstdDecompressor().decompress(blob)
