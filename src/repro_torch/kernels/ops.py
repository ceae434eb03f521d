"""Wrappers around the port's CUDA kernels.

Each wrapper checks dtype, shape and contiguity, then:

* for a CPU tensor, returns the plain version from :mod:`.ref`;
* for a CUDA tensor, launches its kernel on the current stream, raises
  if the launch reports an error, and adds one to :data:`launches`;
* for any other device, raises.

There is no fallback: a CUDA tensor reaches its kernel or an exception.
Some kernels choose a route from what the host already knows: the brick
codes (kernel 1, :func:`codes_route`) and recon (kernel 2,
:func:`recon_route`) from the stack's shape, the single-array codes and
recon (kernels 5 and 6, :func:`codes3d_route`, :func:`recon3d_route`)
from the shape and the tile, the quantizer (kernel 7, in
C) from the group size, the number of groups and the pointers'
alignment, the Huffman decode (kernel 4) by a chunk plan of the
payloads' bits (:func:`huffdec_plan`) that leaves payloads it cannot
settle to the kernel's own serial walk.  :func:`quantize_kv_into` is
kernel 7 fused with a decode step's write into an int8 KV cache.

========================  =======================================  ===========================
wrapper                   TPU kernel it replaces                   source
========================  =======================================  ===========================
lorenzo3d_codes_batched   repro/kernels/lorenzo3d.py:139           csrc/lorenzo3d.cu
lorenzo3d_recon_batched   repro/kernels/lorenzo3d.py:157           csrc/lorenzo3d.cu
lorenzo3d_codes           repro/kernels/lorenzo3d.py:64            csrc/lorenzo3d.cu
lorenzo3d_recon           repro/kernels/lorenzo3d.py:82            csrc/lorenzo3d.cu
hist                      repro/kernels/hist.py:41                 csrc/hist.cu
huffdec                   repro/kernels/huffdec.py:48 and :73      csrc/huffdec.cu
group_quant               repro/kernels/qdq.py:43                  csrc/qdq.cu
quantize_kv_into          repro/kernels/qdq.py:43 (fused write)    csrc/qdq.cu
group_dequant             repro/kernels/qdq.py:64                  csrc/qdq.cu
========================  =======================================  ===========================
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build, ref

__all__ = ["launches", "reset_launches", "codes_route",
           "CODES_ELEMENTWISE_MAX", "lorenzo3d_codes_batched",
           "lorenzo3d_recon_batched", "recon_route", "codes3d_route",
           "recon3d_route", "CODES3D_MAX_Z", "RECON3D_MAX_Z",
           "lorenzo3d_codes", "lorenzo3d_recon", "hist", "huffdec",
           "huffdec_plan", "HUFF_CHUNK_BITS", "huffdec_stats",
           "group_quant", "quantize_kv_into", "group_dequant"]

#: Kernel launches per wrapper since the last :func:`reset_launches`,
#: totals over every thread of the process (the updates hold a lock).
launches = {"lorenzo3d_codes_batched": 0, "lorenzo3d_recon_batched": 0,
            "lorenzo3d_codes": 0, "lorenzo3d_recon": 0, "hist": 0,
            "huffdec": 0, "group_quant": 0, "group_dequant": 0}


#: Brick stacks of at most this many values take kernel 1's elementwise
#: route: the plane walk's two dependent plane loads lost there to the
#: elementwise kernel's one (71 bricks of 8 x 16 x 8 on an H100).
CODES_ELEMENTWISE_MAX = 1 << 17

#: Shared memory one block of the brick recon may use (H100: 227 KB).
RECON_SMEM_BUDGET = 232448

#: Longest Z row kernel 5's plane walk takes (``codes3d_route``): 128
#: 16-byte loads (512 loads of one value, off 16-byte alignment or with
#: Z % 4 != 0, at 4 units a thread).
CODES3D_MAX_Z = 512
#: Kernel 5's walk: units a thread, the zero test, blocks per SM aimed at
#: (the best of 1/2/4 units × 1/2/4/8 blocks per SM at 128³ and 512³ on an
#: H100, ``chip_smoke.py``).
K5_UNITS = 1
K5_SKIP_ZERO = True
K5_BLOCKS_PER_SM = 4

#: Longest Z row kernel 6's planes route takes (``recon3d_route``): one
#: band row and the carry row, 64 KB of int64, in shared memory.
RECON3D_MAX_Z = 4096

#: Bits per chunk of the parallel Huffman decode (kernel 4).
HUFF_CHUNK_BITS = 64

#: Device int32 tensor of the last CUDA :func:`huffdec` call, from
#: whichever thread made it: [chunks, sync passes run, payloads walked
#: serially, chunks decoded in each pass].  Only :func:`huffdec` writes
#: it; reading it synchronises.
huffdec_stats: torch.Tensor | None = None


_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
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


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    with _launch_lock:
        launches[name] += 1


def codes_route(x: torch.Tensor) -> str:
    """Kernel 1's route for an (N, X, Y, Z) float32 stack, from its shape
    and alignment: ``"planes"`` (each brick's X planes walked through
    shared memory), or ``"elementwise"`` (one thread per element) for
    stacks of at most :data:`CODES_ELEMENTWISE_MAX` values, where one
    launch's latency sets the time, and for Z rows of more than 128 loads
    (of 16 bytes when Z % 4 == 0 and the input is 16-byte aligned, else of
    one value)."""
    Z = x.shape[-1]
    per_load = 4 if Z % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    if x.numel() <= CODES_ELEMENTWISE_MAX or Z // per_load > 128:
        return "elementwise"
    return "planes"


def lorenzo3d_codes_batched(x: torch.Tensor, eb: float) -> torch.Tensor:
    """(N,X,Y,Z) float32 bricks → int64 zero-halo Lorenzo codes of
    ``rint(float64(x) / 2eb)`` (kernel 1), routed by :func:`codes_route`."""
    name = "lorenzo3d_codes_batched"
    _require(name, x, torch.float32, 4)
    if not _on_cuda(name, x):
        return ref.lorenzo3d_codes_batched(x, eb)
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    n, X, Y, Z = x.shape
    lib = build.library("lorenzo3d")
    entry = lib.lorenzo3d_codes_batched if codes_route(x) == "planes" else \
        lib.lorenzo3d_codes_batched_elementwise
    with torch.cuda.device(x.device):
        rc = entry(_ptr(x), _ptr(out), n, X, Y, Z, 2.0 * eb, _stream(x))
    _launched(name, rc)
    return out


def recon_route(shape: tuple[int, int, int]) -> str:
    """Kernel 2's route for an (X, Y, Z) brick, from the shape alone:
    ``"shared"`` when the brick's int64 image, each Z line padded by one
    element, fits one block's shared memory; ``"planes"`` (Y and Z scans
    on X planes in shared memory, then the X scan) when one padded (Y, Z)
    plane does; ``"three_pass"`` (three scans through device memory)
    otherwise."""
    x, y, z = (int(v) for v in shape)
    if 8 * x * y * (z + 1) <= RECON_SMEM_BUDGET:
        return "shared"
    return "planes" if 8 * y * (z + 1) <= RECON_SMEM_BUDGET else "three_pass"


def lorenzo3d_recon_batched(codes: torch.Tensor, eb: float) -> torch.Tensor:
    """(N,X,Y,Z) int64 codes → float32 recon (kernel 2), routed by
    :func:`recon_route`."""
    name = "lorenzo3d_recon_batched"
    _require(name, codes, torch.int64, 4)
    if not _on_cuda(name, codes):
        return ref.lorenzo3d_recon_batched(codes, eb)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    n, X, Y, Z = codes.shape
    route = recon_route((X, Y, Z))
    # int64 partial sums, which the whole-brick route does not use
    scratch = None if route == "shared" else torch.empty_like(codes)
    lib = build.library("lorenzo3d")
    entry = lib.lorenzo3d_recon_batched if route == "three_pass" else \
        lib.lorenzo3d_recon_bricks
    with torch.cuda.device(codes.device):
        rc = entry(_ptr(codes), _ptr(scratch), _ptr(out), n, X, Y, Z,
                   2.0 * eb, _stream(codes))
    _launched(name, rc)
    return out


def _whole_array(shape: tuple[int, int, int], tile: tuple[int, int, int],
                 max_z: int) -> bool:
    """``tile = shape``, rows of at most ``max_z`` values, and (Y, Z)
    planes of 32-bit indices: what the single-array kernels' new routes
    take."""
    y, z = int(shape[1]), int(shape[2])
    return tuple(int(t) for t in tile) == tuple(int(s) for s in shape) \
        and z <= max_z and y * z < 2 ** 31


def codes3d_route(shape: tuple[int, int, int],
                  tile: tuple[int, int, int]) -> str:
    """Kernel 5's route for an (X, Y, Z) array and its (checked) tile,
    from the two alone: ``"walk"`` (kernel 1's plane walk on a one-brick
    stack) at ``tile = shape`` for rows of at most :data:`CODES3D_MAX_Z`
    values, else ``"elementwise"`` (one thread per element, any tile)."""
    return "walk" if _whole_array(shape, tile, CODES3D_MAX_Z) else \
        "elementwise"


def recon3d_route(shape: tuple[int, int, int],
                  tile: tuple[int, int, int]) -> str:
    """Kernel 6's route for an (X, Y, Z) array and its (checked) tile,
    from the two alone: ``"planes"`` (Y and Z scans of each X plane in
    shared memory, then the X scan fused with the dequant) at ``tile =
    shape`` for rows of at most :data:`RECON3D_MAX_Z` values, else
    ``"three_pass"`` (three scans through device memory, any tile)."""
    return "planes" if _whole_array(shape, tile, RECON3D_MAX_Z) else \
        "three_pass"


def lorenzo3d_codes(x: torch.Tensor, eb: float,
                    tile: tuple[int, int, int]) -> torch.Tensor:
    """(X,Y,Z) float32 array → int64 Lorenzo codes of
    ``rint(float64(x) / 2eb)`` with a zero halo per ``tile`` (kernel 5),
    routed by :func:`codes3d_route`.  The tile is clamped to the shape
    and must divide it (``ValueError`` otherwise); ``tile = shape`` is the
    global Lorenzo of the array."""
    name = "lorenzo3d_codes"
    _require(name, x, torch.float32, 3)
    tile = ref.check_tile(tuple(x.shape), tile)
    if not _on_cuda(name, x):
        return ref.lorenzo3d_codes(x, eb, tile)
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    lib = build.library("lorenzo3d")
    with torch.cuda.device(x.device):
        if codes3d_route(tuple(x.shape), tile) == "walk":
            rc = lib.lorenzo3d_codes_walk(
                _ptr(x), _ptr(out), *x.shape, 2.0 * eb, K5_UNITS,
                int(K5_SKIP_ZERO), K5_BLOCKS_PER_SM, _stream(x))
        else:
            rc = lib.lorenzo3d_codes(_ptr(x), _ptr(out), *x.shape, *tile,
                                     2.0 * eb, _stream(x))
    _launched(name, rc)
    return out


def lorenzo3d_recon(codes: torch.Tensor, eb: float,
                    tile: tuple[int, int, int]) -> torch.Tensor:
    """(X,Y,Z) int64 codes → float32 recon, scans restarting at every
    ``tile`` edge (kernel 6), routed by :func:`recon3d_route`; the tile is
    checked as in :func:`lorenzo3d_codes`."""
    name = "lorenzo3d_recon"
    _require(name, codes, torch.int64, 3)
    tile = ref.check_tile(tuple(codes.shape), tile)
    if not _on_cuda(name, codes):
        return ref.lorenzo3d_recon(codes, eb, tile)
    # int64 partial sums: the planes route's between its two passes, the
    # three-pass route's between its scans
    scratch = torch.empty_like(codes)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    lib = build.library("lorenzo3d")
    with torch.cuda.device(codes.device):
        if recon3d_route(tuple(codes.shape), tile) == "planes":
            rc = lib.lorenzo3d_recon_planes(
                _ptr(codes), _ptr(scratch), _ptr(out), *codes.shape,
                2.0 * eb, _stream(codes))
        else:
            rc = lib.lorenzo3d_recon(
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


def huffdec_plan(nbits: torch.Tensor, n_bytes: int, chunk_bits: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cut every payload into chunks of ``chunk_bits`` bits from its first
    bit, numbered in one flat index over the batch.

    Returns ``(pay_first (A+1,), chunk_pay (cap,), chunk_bit (cap,))``:
    payload ``a`` owns chunks ``pay_first[a]:pay_first[a+1]``; chunk ``c``
    belongs to payload ``chunk_pay[c]`` (``A`` for a spare chunk) and starts
    at its payload's bit ``chunk_bit[c]``.  ``cap = A + ⌈8·n_bytes /
    chunk_bits⌉`` is known on the host without reading ``nbits``, and
    holds every chunk of payloads that do not overlap in a buffer of
    ``n_bytes``; the kernel walks a payload past ``cap`` serially.  Torch
    ops on ``nbits``'s device, with no host synchronisation.
    """
    if chunk_bits < 1:
        raise ValueError(f"chunk_bits {chunk_bits} must be positive")
    a_n = nbits.numel()
    ends = torch.cumsum((nbits.clamp(min=0) + chunk_bits - 1) // chunk_bits, 0)
    pay_first = torch.cat([ends.new_zeros(1), ends])
    cap = a_n + -(-8 * int(n_bytes) // chunk_bits)
    idx = torch.arange(cap, dtype=torch.int64, device=nbits.device)
    chunk_pay = torch.searchsorted(ends, idx, right=True)
    return pay_first, chunk_pay, (idx - pay_first[chunk_pay]) * chunk_bits


def huffdec(data: torch.Tensor, byte_off: torch.Tensor, nbits: torch.Tensor,
            n_decode: torch.Tensor, out_off: torch.Tensor, n_out: int,
            symbols: torch.Tensor, first_code: torch.Tensor,
            first_index: torch.Tensor, count: torch.Tensor, maxlen: int,
            *, chunk_bits: int | None = None, serial: bool = False,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode every payload of a level (kernel 4).

    See :func:`repro_torch.kernels.ref.huffdec` for the arguments.  The
    tables (``first_code``/``first_index``/``count``) hold at least
    ``maxlen + 1`` entries.  Returns ``(out int64 (n_out,), err int32)``.

    On the card the payloads are decoded in chunks of ``chunk_bits``
    (default :data:`HUFF_CHUNK_BITS`) that synchronise themselves; what
    that cannot settle, the kernel walks serially, and ``serial=True``
    walks every payload so.  Either way the result is the plain
    version's; :data:`huffdec_stats` counts the chunks, the sync passes
    and the serially walked payloads.  Nothing here waits for the card.
    """
    global huffdec_stats
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
    chunk = HUFF_CHUNK_BITS if chunk_bits is None else int(chunk_bits)
    args = (data, byte_off, nbits, n_decode, out_off, symbols, first_code,
            first_index, count)
    if not _on_cuda(name, *args):
        return ref.huffdec(data, byte_off, nbits, n_decode, out_off, n_out,
                           symbols, first_code, first_index, count, maxlen)
    dev = data.device
    out = torch.zeros(n_out, dtype=torch.int64, device=dev)
    err = torch.zeros(a_n, dtype=torch.int32, device=dev)
    if a_n == 0:
        return out, err
    lib = build.library("huffdec")
    pay_first, chunk_pay, chunk_bit = huffdec_plan(nbits, data.numel(), chunk)
    cap = chunk_pay.numel()
    # zeroed: per-payload flags, then the stats; the chunk state is written
    # before it is read (counts of chunks without a payload stay unread)
    small = torch.zeros(a_n + 4 + lib.huffdec_sync_passes(),
                        dtype=torch.int32, device=dev)
    flag, stats = small[:a_n], small[a_n:]
    walk_all = bool(serial) or symbols.numel() < 2
    lut = torch.empty(2048, dtype=torch.int32, device=dev)
    state = torch.empty(3 * cap, dtype=torch.int64, device=dev)
    entry, exits = state[:cap], state[cap:]
    count_c = torch.empty(cap, dtype=torch.int32, device=dev)
    common = (_ptr(data), data.numel(), _ptr(byte_off), _ptr(nbits),
              _ptr(n_decode))
    book = (_ptr(first_code), _ptr(first_index), _ptr(count), int(maxlen),
            _ptr(pay_first), _ptr(chunk_pay), _ptr(chunk_bit), cap, chunk,
            _ptr(lut), _ptr(entry), _ptr(exits), _ptr(count_c))
    with torch.cuda.device(dev):
        if not walk_all:
            rc = lib.huffdec_sync(*common, a_n, symbols.numel(), *book,
                                  _ptr(stats), _stream(data))
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA launch failed with error "
                                   f"{rc}")
        excl = torch.cumsum(count_c, 0) - count_c
        rc = lib.huffdec_finish(
            *common, _ptr(out_off), a_n, _ptr(symbols), symbols.numel(),
            *book, _ptr(excl), _ptr(flag), int(walk_all), _ptr(out),
            _ptr(err), _ptr(stats), _stream(data))
    _launched(name, rc)
    huffdec_stats = stats
    return out, err


def group_quant(x: torch.Tensor, group: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) float32 or bfloat16 → (int8 codes (n, d), float32 scales
    (n, d/group)), per-group symmetric int8 (kernel 7); see
    :func:`repro_torch.kernels.ref.group_quant`."""
    name = "group_quant"
    _require_quant_input(name, x, 2)
    n_groups = ref.check_groups(tuple(x.shape), group)
    if not _on_cuda(name, x):
        return ref.group_quant(x, group)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((x.shape[0], x.shape[1] // group),
                        dtype=torch.float32, device=x.device)
    fn = "group_quant_f32" if x.dtype == torch.float32 else "group_quant_bf16"
    with torch.cuda.device(x.device):
        rc = getattr(build.library("qdq"), fn)(
            _ptr(x), _ptr(q), _ptr(scale), n_groups, int(group), _stream(x))
    _launched(name, rc)
    return q, scale


def _require_quant_input(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expected float32 or bfloat16, got {x.dtype}")
    _require(name, x, x.dtype, ndim)


def quantize_kv_into(k: torch.Tensor, v: torch.Tensor, cache: dict,
                     start: int) -> None:
    """Quantize a decode step's K and V and write them into one layer's
    int8 cache at positions ``start:start + Sq``, in place: kernel 7 with
    ``group = hd``, in one launch for both (counted under
    ``launches["group_quant"]``).

    ``k``, ``v``: (B, Sq, H, hd) float32 or bfloat16, contiguous.
    ``cache``: ``{"k", "v"}`` int8 (B, S, H, hd) and ``{"k_scale",
    "v_scale"}`` float32 (B, S, H), each contiguous past its batch axis
    (a layer of a stacked cache is); the kernel takes the batch stride.
    Raises on another dtype or shape, a non-contiguous input, or
    ``start + Sq > S``.  See :func:`repro_torch.kernels.ref.quantize_kv_into`.
    """
    name = "group_quant"
    _require_quant_input(name, k, 4)
    _require_quant_input(name, v, 4)
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"{name}: k {k.dtype} {tuple(k.shape)} and v "
                         f"{v.dtype} {tuple(v.shape)} differ")
    B, Sq, H, hd = k.shape
    ck, cv, sk, sv = (cache[n] for n in ("k", "v", "k_scale", "v_scale"))
    S = ck.shape[1] if ck.dim() == 4 else -1
    for t, dtype, inner in ((ck, torch.int8, (H, hd)),
                            (cv, torch.int8, (H, hd)),
                            (sk, torch.float32, (H,)),
                            (sv, torch.float32, (H,))):
        if t.dtype != dtype:
            raise TypeError(f"{name}: cache leaf {t.dtype}, expected {dtype}")
        if tuple(t.shape) != (B, S, *inner):
            raise ValueError(f"{name}: cache leaf {tuple(t.shape)} does not "
                             f"match k {tuple(k.shape)}")
        if B and not t[0].is_contiguous():
            raise ValueError(f"{name}: cache leaf must be contiguous past "
                             "its batch axis")
    if ck.stride(0) != cv.stride(0) or sk.stride(0) != sv.stride(0):
        raise ValueError(f"{name}: K and V caches have different strides")
    start = int(start)
    if start < 0 or start + Sq > S:
        raise ValueError(f"{name}: positions {start}..{start + Sq} past the "
                         f"cache's {S}")
    if not _on_cuda(name, k, v, ck, cv, sk, sv):
        ref.quantize_kv_into(k, v, cache, start)
        return
    fn = "quantize_kv_f32" if k.dtype == torch.float32 else "quantize_kv_bf16"
    with torch.cuda.device(k.device):
        rc = getattr(build.library("qdq"), fn)(
            _ptr(k), _ptr(v), _ptr(ck), _ptr(cv), _ptr(sk), _ptr(sv), B, Sq,
            H, hd, S, start, ck.stride(0), sk.stride(0), _stream(k))
    _launched(name, rc)


def group_dequant(q: torch.Tensor, scale: torch.Tensor, group: int
                  ) -> torch.Tensor:
    """int8 codes (n, d) and float32 scales (n, d/group) → float32
    ``q · scale`` (kernel 8)."""
    name = "group_dequant"
    _require(name, q, torch.int8, 2)
    _require(name, scale, torch.float32, 2)
    n_groups = ref.check_groups(tuple(q.shape), group)
    if tuple(scale.shape) != (q.shape[0], q.shape[1] // group):
        raise ValueError(f"{name}: scales {tuple(scale.shape)} do not match "
                         f"codes {tuple(q.shape)} at group {group}")
    if not _on_cuda(name, q, scale):
        return ref.group_dequant(q, scale, group)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    with torch.cuda.device(q.device):
        rc = build.library("qdq").group_dequant_f32(
            _ptr(q), _ptr(scale), _ptr(out), n_groups, int(group), sms,
            _stream(q))
    _launched(name, rc)
    return out
