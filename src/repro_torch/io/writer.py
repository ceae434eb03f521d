"""TACZ writer: level serialization + a streaming, double-buffered writer.

* :func:`write` — one-shot: serialize an ``AMRCompressionResult`` (from
  ``repro_torch.core.hybrid.compress_amr``) or compress-and-write an
  ``AMRDataset``.
* :class:`TACZWriter` — streaming: ``add_level(data, mask)`` hands raw
  levels to a background encoder thread (bounded queue → double
  buffering), or encodes them inline with ``background=False``;
  ``close()`` writes the index and publishes the file atomically (tmp
  file + ``os.replace``), or with ``publish=False`` leaves the finished
  tmp file for a multi-part writer's two-phase commit.

The bytes are the reference writer's for the same compressed state: the
payloads of a level are packed on the device in one batched pass
(``entropy.TorchEngine``); framing, CRCs and the optional zlib/zstd byte
pass run on the host.  Serializable levels are SHE levels (per-sub-block
payloads under one shared codebook) and gsp/global levels (one payload
covering the grid).  Merged-4D levels (TAC without SHE) interleave
sub-blocks inside shared code streams, so they have nothing to index and
raise :class:`ValueError`.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import weakref
import zlib

import numpy as np
import torch

from ..core import entropy, huffman
from ..core.amr import AMRDataset
from ..core.compat import HAVE_ZSTD, zstd_compress
from ..core.hybrid import AMRCompressionResult, LevelResult, compress_level
from ..core.sz import SZResult
from ..core.she import check_engine_names
from ..device import resolve_device
from ..obs import metrics as obsm
from . import format as fmt
from . import frontier as frt

__all__ = ["TACZWriter", "build_container", "pack_level", "write"]


def resolve_payload_codec(codec: str) -> int:
    """Map a payload-codec name to its COMPRESSOR_* wire code: ``"auto"``
    is zstd when ``zstandard`` is importable, else zlib; ``"none"`` writes
    v1-style raw packed-bits payloads."""
    if codec == "none":
        return fmt.COMPRESSOR_NONE
    if codec == "zlib":
        return fmt.COMPRESSOR_ZLIB
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise ModuleNotFoundError(
                "payload_codec='zstd' but zstandard is not installed "
                "(use 'auto' to fall back to zlib)")
        return fmt.COMPRESSOR_ZSTD
    if codec == "auto":
        return fmt.COMPRESSOR_ZSTD if HAVE_ZSTD else fmt.COMPRESSOR_ZLIB
    raise ValueError(f"unknown payload codec {codec!r}")


def _lossless_pass(buf: bytes, compressor: int) -> tuple[bytes, int]:
    """The configured byte pass over one payload's code bytes, kept only
    when strictly smaller (else stored raw as ``COMPRESSOR_NONE``)."""
    if compressor == fmt.COMPRESSOR_NONE or len(buf) < 16:
        return buf, fmt.COMPRESSOR_NONE
    if compressor == fmt.COMPRESSOR_ZSTD:
        comp = zstd_compress(buf)
    else:
        comp = zlib.compress(buf, 6)
    if len(comp) < len(buf):
        return comp, compressor
    return buf, fmt.COMPRESSOR_NONE


def _branch_code(r: SZResult) -> int:
    b = (r.extras or {}).get("branch")
    if b == "reg":
        return fmt.BRANCH_REG
    if b == "lorenzo" or r.method == "lorenzo":
        return fmt.BRANCH_LORENZO
    if r.method == "interp":
        return fmt.BRANCH_INTERP
    raise ValueError(f"cannot serialize SZ method {r.method!r}")


def _betas_bytes(results: list[SZResult]) -> list[bytes]:
    """Little-endian float32 betas prefix per result (b"" for Lorenzo
    bricks), copied off the device in one transfer."""
    reg = [i for i, r in enumerate(results)
           if (r.extras or {}).get("branch") == "reg"]
    out = [b""] * len(results)
    if not reg:
        return out
    flat = torch.cat([results[i].extras["betas"].reshape(-1).float()
                      for i in reg]).cpu().numpy().astype("<f4")
    pos = 0
    for i in reg:
        n = results[i].extras["betas"].numel()
        out[i] = flat[pos:pos + n].tobytes()
        pos += n
    return out


def pack_level(lr: LevelResult, *, payload_codec: str = "auto",
               entropy_engine: str = "auto",
               ) -> tuple[bytes, fmt.LevelEntry]:
    """Serialize one compressed level into (section blob, index entry)
    with blob-relative offsets; the caller places the blob and calls
    ``entry.shift_offsets(base)``.

    ``payload_codec`` selects the lossless byte pass over each payload's
    packed-Huffman bytes (betas prefixes stay raw).  A gsp/global level
    reuses the codebook and packed payload its compress-time entropy
    stage made (``SZResult.extras["entropy"]``).  A level whose artifacts
    hold no results (a multi-part writer's stub for a level whose every
    sub-block lives in other parts) packs to a head and mask only.
    ``entropy_engine`` is one of the reference's engine names, validated
    only: the payloads pack in one pass on the codes' device whatever the
    name, and the bytes do not depend on it.
    """
    entropy.check_engine_name(entropy_engine)
    art = lr.artifacts
    if art is None:
        raise ValueError(
            "level has no serialization artifacts — the merged-4D non-SHE "
            "path is not indexable; compress with she=True (TAC+) or "
            "strategy='gsp', and keep_artifacts=True")
    if lr.strategy not in fmt.STRATEGY_CODES:
        raise ValueError(f"unknown strategy {lr.strategy!r}")

    blob = bytearray()

    def append(section: bytes) -> tuple[int, int]:
        off = len(blob)
        blob.extend(section)
        return off, len(section)

    entry = fmt.LevelEntry(
        shape=tuple(int(s) for s in art.orig_shape),
        grid_shape=tuple(int(s) for s in art.grid_shape),
        strategy=fmt.STRATEGY_CODES[lr.strategy],
        algorithm=fmt.ALGO_CODES[lr.algorithm],
        unit=int(art.unit), sz_block=int(art.sz_block), ratio=int(lr.ratio),
        eb=float(lr.eb), n_values=int(lr.n_values), density=float(lr.density))

    # shared codebook section (omitted when the level holds no payloads)
    results = art.results
    memo = None
    cb = art.codebook
    if results and not lr.she:
        # gsp/global level: its one payload was packed at compress time
        if len(results) != 1:
            raise ValueError("a gsp/global level holds exactly one payload")
        memo = results[0].extras["entropy"]
        cb = memo["codebook"]
    if results:
        cb_bytes = huffman.serialize_codebook(cb)
        entry.codebook_off, entry.codebook_len = append(cb_bytes)
        entry.codebook_crc = zlib.crc32(cb_bytes)

    # validity mask section (packbits + zlib; omitted when all-True)
    mask = np.asarray(art.mask, dtype=bool)
    if not mask.all():
        mask_bytes = zlib.compress(np.packbits(mask.ravel()).tobytes(), 6)
        entry.mask_off, entry.mask_len = append(mask_bytes)
        entry.mask_crc = zlib.crc32(mask_bytes)
        entry.mask_compressor = fmt.COMPRESSOR_ZLIB

    level_comp = resolve_payload_codec(payload_codec)
    entry.payload_compressor = level_comp
    if not results:
        return bytes(blob), entry
    if art.subblocks:
        origins = [sb.cell_origin(art.unit) for sb in art.subblocks]
        sizes = [sb.cell_size(art.unit) for sb in art.subblocks]
    else:
        # one payload covering the whole (padded) grid; origin/size are
        # informative for 3D levels only (higher ranks decode via shape)
        origins = [(0, 0, 0)]
        gs = tuple(int(s) for s in art.grid_shape[:3])
        sizes = [gs + (1,) * (3 - len(gs))]
    if memo is not None:
        payloads = [(memo["packed"], memo["nbits"])]
    else:
        payloads = entropy.TorchEngine(results[0].codes.device) \
            .encode_payloads(cb, [r.codes for r in results])
    for r, origin, size, (packed, nbits), betas in zip(
            results, origins, sizes, payloads, _betas_bytes(results)):
        stored, comp = _lossless_pass(packed, level_comp)
        payload = betas + stored
        off, length = append(payload)
        entry.subblocks.append(fmt.SubBlockEntry(
            origin=tuple(int(o) for o in origin),
            size=tuple(int(s) for s in size),
            branch=_branch_code(r), codec=fmt.CODEC_HUFFMAN,
            compressor=comp, payload_off=off, payload_len=length,
            nbits=int(nbits), n_codes=int(r.codes.numel()),
            betas_len=len(betas), crc=zlib.crc32(payload)))
    return bytes(blob), entry


def build_container(packed: list[tuple[bytes, fmt.LevelEntry]], *,
                    version: int = fmt.TACZ_VERSION) -> bytes:
    """Assemble header + level blobs + index + footer into one buffer."""
    out = bytearray(fmt.pack_header(version=version))
    entries = []
    for blob, entry in packed:
        entry.shift_offsets(len(out))
        out.extend(blob)
        entries.append(entry)
    index = fmt.pack_index(entries, version=version)
    index_off = len(out)
    out.extend(index)
    out.extend(fmt.pack_footer(index_off, len(index), fmt.index_crc(index)))
    return bytes(out)


_SENTINEL = object()


def _nudge(q: queue.Queue) -> None:
    """GC finalizer: wake the encoder thread of an abandoned writer."""
    try:
        q.put_nowait(_SENTINEL)
    except queue.Full:   # worker is mid-item; it re-checks liveness next get
        pass


def _reap_sync(f, tmp: str) -> None:
    """GC finalizer for a ``background=False`` writer dropped without
    ``close()``/``abort()``: close the fd and drop the unpublished tmp."""
    try:
        f.close()
    except OSError:      # pragma: no cover - already closed
        pass
    try:
        os.remove(tmp)
    except OSError:
        pass


def _worker_loop(wref, q: queue.Queue, f, tmp: str) -> None:
    """Encoder-thread body.  Holds only a weakref to the writer, so an
    abandoned writer is collected; the thread then closes the fd, drops
    the tmp file and exits."""
    while True:
        item = q.get()
        w = wref()
        try:
            if item is _SENTINEL or w is None:
                if w is None:
                    _reap_sync(f, tmp)
                return
            if w._err is None and not w._aborted:
                w._append_level(w._encode(item))
        except BaseException as exc:  # propagate to the producer thread
            if w is not None:
                w._err = exc
        finally:
            del w
            q.task_done()


class TACZWriter:
    """Streaming TACZ writer with a background encoder thread.

    ``add_level`` snapshots a raw level and returns; a worker thread runs
    the TAC+ pipeline on ``device`` and appends the level's sections.
    The bounded queue (``queue_depth``) double-buffers producer and
    encoder.  ``background=False`` encodes inline on the caller's thread
    instead (``add_level`` then blocks), which is what a caller that is
    already a dedicated worker wants: each part worker of
    :mod:`repro_torch.io.parallel` writes this way.  The file is written
    to ``<path>.tmp`` and moved into place by :meth:`close`; readers never
    observe a partial file.  A writer dropped without ``close()`` or
    ``abort()`` is reaped at collection (fd closed, tmp removed) and
    never published.

    :param path: destination ``.tacz`` path.
    :param eb: default absolute error bound for :meth:`add_level`.
    :param unit: finest unit-block edge; level units follow
        ``max(2, unit // ratio)`` as in ``compress_amr``.
    :param algorithm: prediction algorithm (``"lor_reg"``, ``"lorenzo"``
        or ``"interp"``).
    :param she: encode SHE (per-sub-block payload) levels, which random
        access needs; ``False`` is serializable only with gsp levels.
    :param strategy: partitioning strategy override (default: chosen per
        level from its density).
    :param sz_block: Lor/Reg regression block edge.
    :param batched: run SHE levels' bricks in same-shape batches
        (``False``: brick by brick; the bytes are the same).
    :param lorenzo_engine: the reference's Lorenzo engine names
        (``"auto"``, ``"numpy"``, ``"pallas"``), validated only.
    :param entropy_engine: the reference's entropy engine names, validated
        only; every name packs on ``device`` and the bytes do not depend
        on it.
    :param payload_codec: ``"auto"`` (zstd, zlib fallback), ``"zstd"``,
        ``"zlib"`` or ``"none"``.
    :param queue_depth: bounded encode queue length (≥1).
    :param background: encode on a background thread (default) or inline.
    :param device: where levels compress (default ``"cuda"``).
    :raises ValueError: on an unknown ``payload_codec`` or engine name.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """

    def __init__(self, path: str, *, eb: float | None = None, unit: int = 8,
                 algorithm: str = "lor_reg", she: bool = True,
                 strategy: str | None = None, sz_block: int = 6,
                 batched: bool = True, lorenzo_engine: str = "auto",
                 entropy_engine: str = "auto", payload_codec: str = "auto",
                 queue_depth: int = 2, background: bool = True,
                 device: str | torch.device = "cuda"):
        resolve_payload_codec(payload_codec)   # fail fast on bad names
        check_engine_names(lorenzo_engine=lorenzo_engine,
                           entropy_engine=entropy_engine)
        self.device = resolve_device(device)
        self.path = str(path)
        self._tmp = self.path + ".tmp"
        self._payload_codec = payload_codec
        self._defaults = dict(eb=eb, unit=unit, algorithm=algorithm, she=she,
                              strategy=strategy, sz_block=sz_block,
                              batched=batched)
        self._f = open(self._tmp, "wb")
        self._f.write(fmt.pack_header())
        self._off = fmt.HEADER_SIZE
        self._entries: list[fmt.LevelEntry] = []
        self._frontier: frt.Frontier | None = None
        #: index CRC of the finished file (set by :meth:`close`)
        self.index_crc: int | None = None
        self._err: BaseException | None = None
        # plain stage totals of this writer; a process-mode part worker
        # sends them home, where its registry is not scraped
        self._obs = {"levels": 0, "encode_seconds": 0.0,
                     "pack_seconds": 0.0, "publish_seconds": 0.0,
                     "bytes": 0}
        self._background = bool(background)
        self._finalized = False
        self._aborted = False
        self._sentinel_sent = False
        if self._background:
            self._queue: queue.Queue | None = queue.Queue(
                maxsize=max(1, queue_depth))
            self._thread: threading.Thread | None = threading.Thread(
                target=_worker_loop,
                args=(weakref.ref(self), self._queue, self._f, self._tmp),
                daemon=True)
            self._thread.start()
            self._reaper = weakref.finalize(self, _nudge, self._queue)
        else:
            self._queue = None
            self._thread = None
            self._reaper = weakref.finalize(self, _reap_sync, self._f,
                                            self._tmp)

    def add_level(self, data: np.ndarray, mask: np.ndarray | None = None, *,
                  eb: float | None = None, ratio: int = 1,
                  unit: int | None = None) -> None:
        """Queue one raw level for encoding (snapshot taken now)."""
        self._check_live()
        eb = self._defaults["eb"] if eb is None else eb
        if eb is None:
            raise ValueError("no error bound: pass eb= here or to the writer")
        if unit is None:
            unit = max(2, int(self._defaults["unit"]) // max(int(ratio), 1))
        data = np.array(data, dtype=np.float32, copy=True)
        mask = (data != 0) if mask is None else np.array(mask, dtype=bool,
                                                         copy=True)
        self._put(("raw", data, mask, float(eb), int(ratio), int(unit)))

    def add_compressed(self, lr: LevelResult) -> None:
        """Queue an already-compressed level (needs ``artifacts``)."""
        self._check_live()
        if lr.artifacts is None:
            raise ValueError(
                "LevelResult has no serialization artifacts — the merged-4D "
                "non-SHE path is not indexable (compress with she=True or "
                "strategy='gsp'), and compression must run with "
                "keep_artifacts=True")
        self._put(("level", lr))

    def set_frontier(self, frontier: frt.Frontier | None) -> None:
        """Attach a rate–distortion frontier, written by :meth:`close` as
        the optional ``TACF`` section between index and footer."""
        self._check_live()
        self._frontier = frontier

    def close(self, *, publish: bool = True) -> str:
        """Drain the queue, write index + footer, publish atomically.

        Raises the encoder's error, if any, after dropping the tmp file.
        ``publish=False`` finishes the file (index, footer, fsync, fd
        closed) but leaves it at ``<path>.tmp`` and returns that path: a
        multi-part writer renames its parts only once every one of them
        has finished.
        """
        if self._finalized:
            return self.path
        self._stop_worker()
        if self._aborted:
            raise ValueError("writer was aborted")
        try:
            if self._err is not None:
                raise self._err
            with obsm.timed(obsm.WRITER_LEVEL_SECONDS.labels("publish"),
                            "publish"):
                t0 = time.perf_counter()
                index = fmt.pack_index(self._entries)
                self._f.write(index)
                self.index_crc = fmt.index_crc(index)
                if self._frontier is not None:
                    self._f.write(frt.pack_section(self._frontier))
                self._f.write(fmt.pack_footer(self._off, len(index),
                                              self.index_crc))
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
                if publish:
                    os.replace(self._tmp, self.path)
                self._obs["publish_seconds"] += time.perf_counter() - t0
        except BaseException:
            self.abort()
            raise
        self._finalized = True
        return self.path if publish else self._tmp

    def abort(self) -> None:
        """Drop the partial file (used on error paths)."""
        self._aborted = True
        self._stop_worker()
        try:
            self._f.close()
        except OSError:  # pragma: no cover - double close
            pass
        try:
            os.remove(self._tmp)
        except OSError:
            pass

    def __enter__(self) -> "TACZWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()

    def _stop_worker(self) -> None:
        if not self._sentinel_sent:
            self._sentinel_sent = True
            self._reaper.detach()   # orderly shutdown owns cleanup now
            if self._background:
                self._queue.put(_SENTINEL)
        if self._thread is not None:
            self._thread.join()

    def _check_live(self) -> None:
        if self._finalized or self._aborted or self._sentinel_sent:
            raise ValueError("writer is closed")
        if self._err is not None:
            raise self._err

    def _put(self, item) -> None:
        if self._background:
            self._queue.put(item)
            return
        try:                  # inline encode: errors surface at once
            self._append_level(self._encode(item))
        except BaseException as exc:
            self._err = exc   # close() keeps refusing to publish
            raise

    def _encode(self, item) -> LevelResult:
        if item[0] == "level":
            return item[1]
        _, data, mask, eb, ratio, unit = item
        d = self._defaults
        with obsm.timed(obsm.WRITER_LEVEL_SECONDS.labels("encode"),
                        "encode"):
            t0 = time.perf_counter()
            lr = compress_level(data, mask, eb=eb, unit=unit,
                                algorithm=d["algorithm"], she=d["she"],
                                strategy=d["strategy"],
                                sz_block=d["sz_block"], batched=d["batched"],
                                ratio=ratio, keep_artifacts=True,
                                device=self.device)
            self._obs["encode_seconds"] += time.perf_counter() - t0
            return lr

    def _append_level(self, lr: LevelResult) -> None:
        with obsm.timed(obsm.WRITER_LEVEL_SECONDS.labels("pack"), "pack"):
            t0 = time.perf_counter()
            blob, entry = pack_level(lr, payload_codec=self._payload_codec)
            entry.shift_offsets(self._off)
            self._f.write(blob)
            self._off += len(blob)
            self._entries.append(entry)
            self._obs["pack_seconds"] += time.perf_counter() - t0
            self._obs["levels"] += 1
            self._obs["bytes"] += len(blob)
        obsm.WRITER_LEVELS.inc()
        obsm.WRITER_BYTES.inc(len(blob))

    def obs_summary(self) -> dict:
        """This writer's stage totals as a plain dict: ``levels``,
        ``encode_seconds``, ``pack_seconds``, ``publish_seconds`` and
        ``bytes`` (the reference's keys).  A process-mode part worker
        returns it to the producer, which folds it into its registry."""
        return dict(self._obs)


def write(path: str, obj, *, eb: float | list[float] | None = None,
          frontier: frt.Frontier | None = None, **kwargs) -> str:
    """Write ``obj`` — an ``AMRCompressionResult`` (compressed with
    ``keep_artifacts=True``) or an ``AMRDataset`` (compressed here level by
    level; ``eb`` required, scalar or per level) — to ``path``.
    ``kwargs`` go to :class:`TACZWriter` (``device``, ``payload_codec``,
    ...).  Returns ``path``."""
    if isinstance(obj, AMRCompressionResult):
        with TACZWriter(path, **kwargs) as w:
            for lr in obj.levels:
                w.add_compressed(lr)
            if frontier is not None:
                w.set_frontier(frontier)
        return path
    if isinstance(obj, AMRDataset):
        if eb is None:
            raise ValueError("writing a raw AMRDataset needs eb=")
        ebs = eb if isinstance(eb, (list, tuple)) else [eb] * obj.n_levels
        if len(ebs) != obj.n_levels:
            raise ValueError("need one error bound per level")
        with TACZWriter(path, **kwargs) as w:
            for lvl, e in zip(obj.levels, ebs):
                w.add_level(lvl.data, lvl.mask, eb=float(e), ratio=lvl.ratio)
            if frontier is not None:
                w.set_frontier(frontier)
        return path
    raise TypeError(f"cannot write {type(obj).__name__} as TACZ")
