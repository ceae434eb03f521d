"""``repro_torch.io.parallel`` — multi-part TACZ snapshots: a parallel
writer and a reader over the parts.

* :class:`ParallelTACZWriter` — fans each level out to N part workers
  (threads on one card, or spawned processes).  The sub-block partition
  is computed once (:func:`repro_torch.core.hybrid.partition_level`) and
  the ``(level, sub_block)`` keys are split by the rendezvous hashing of
  :mod:`repro_torch.io.placement`, the rule the serving side's
  :class:`~repro_torch.serving.sharded.ShardMap` uses, so shard servers
  can align with part files.  Each worker compresses and streams its
  slice of every level into its own ``part-XXXX.tacz`` through a
  :class:`~repro_torch.io.writer.TACZWriter`; :meth:`~ParallelTACZWriter.
  close` then publishes a CRC'd ``manifest.json``
  (:mod:`repro_torch.io.manifest`) binding the parts into one snapshot.
  The batched compressor is per-brick independent, so every brick's codes,
  and every decoded value, equal the single writer's whatever the part
  count.  Part files and manifest equal the reference's
  (``repro.io.parallel``) byte for byte.
* :class:`MultiPartReader` — the parts as one
  :class:`~repro_torch.io.reader.TACZReader` (``read``, ``read_roi``,
  ``subblock_keys``, ``level_signature``, ...) over a merged index.  Part
  files open lazily, and every payload is decoded by the part that holds
  it: a level decodes with one launch of kernel 4 per part holding some
  of its payloads (codebooks are local to a part), then one batched
  reconstruction per (shape, branch) group across all parts.

On the card, ``mode="thread"`` runs each part worker under its own CUDA
stream; workers share nothing but host arrays.  ``mode="process"`` always
spawns (CUDA does not survive a fork): tasks cross the queues as numpy
arrays and plain dicts, and the producer builds the kernels before it
starts a worker, so that workers only load them.

Crash consistency: parts finish at ``<part>.tmp`` and are renamed only
once every worker has reported success; the manifest publishes last.  A
killed writer leaves ``part-*.tacz.tmp`` litter
(:func:`repro_torch.io.manifest.stale_parts`) and the previous snapshot
intact; a re-run truncates the litter and converges.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import multiprocessing
import os
import queue
import threading

import numpy as np
import torch

from ..core import entropy
from ..core.amr import AMRDataset
from ..core.blocks import extract_subblock
from ..core.hybrid import (AMRCompressionResult, LevelArtifacts,
                           LevelResult, compress_level, partition_level)
from ..core.she import check_engine_names, she_encode
from ..device import resolve_device
from ..kernels import build, ops
from ..obs import metrics as obsm
from . import frontier as frt
from . import manifest as mfst
from . import placement
from .reader import WHOLE_LEVEL, TACZReader
from .writer import TACZWriter, resolve_payload_codec

__all__ = ["MultiPartReader", "ParallelTACZWriter", "fork_safe",
           "write_multipart"]

#: Strategy names whose levels carry per-sub-block payloads (the key
#: universe is per-brick); everything else is a single whole-level payload.
_SHE_STRATEGY_NAMES = ("opst", "akdtree", "nast")

_ABORT = "__abort__"


def fork_safe() -> bool:
    """Whether process workers may fork this interpreter: never.  A
    forked child cannot use the parent's CUDA context, and the port's
    workers may run on the card, so process mode always spawns (each
    worker then imports torch afresh).  Kept for the reference's API."""
    return False


# --------------------------------------------------------------------------
# worker side
# --------------------------------------------------------------------------


def _empty_recon() -> torch.Tensor:
    return torch.empty((0, 0, 0), dtype=torch.float32)


def _unpack_mask(head: dict) -> np.ndarray:
    """Rebuild the level's bool mask from the packed task head."""
    shape = tuple(head["orig_shape"])
    packed = head["mask_packed"]
    if packed is None:
        return np.ones(shape, dtype=bool)
    bits = np.unpackbits(np.frombuffer(packed, dtype=np.uint8),
                         count=int(np.prod(shape)))
    return bits.astype(bool).reshape(shape)


def _map_results(lr: LevelResult, fn, recon) -> LevelResult:
    """A copy of ``lr`` whose results' codes and betas went through
    ``fn``, with ``recon`` in place of every reconstruction."""
    art = copy.copy(lr.artifacts)
    results = []
    for r in art.results:
        extras = dict(r.extras or {})
        if "betas" in extras:
            extras["betas"] = fn(extras["betas"])
        results.append(dataclasses.replace(r, codes=fn(r.codes),
                                           recon=recon, extras=extras))
    art.results = results
    lr2 = copy.copy(lr)
    lr2.artifacts = art
    lr2.recon = recon
    return lr2


def _host_level(lr: LevelResult) -> LevelResult:
    """``lr`` with numpy codes and betas and no reconstruction, for a
    spawned worker's queue."""
    return _map_results(
        lr, lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else t,
        np.empty((0, 0, 0), dtype=np.float32))


def _device_level(lr: LevelResult, device: torch.device) -> LevelResult:
    """Inverse of :func:`_host_level` on ``device``."""
    return _map_results(
        lr, lambda a: (torch.from_numpy(a).to(device)
                       if isinstance(a, np.ndarray) else a), _empty_recon())


def _task_to_level(task: dict, device: torch.device) -> LevelResult:
    """Materialize one queued task into a packable :class:`LevelResult`.

    Task kinds:

      * ``"packed"`` — an already-compressed slice (shared codebook);
        its codes move to ``device`` if they arrived as numpy arrays.
      * ``"she"`` — this part's bricks of one SHE level: the batched SHE
        pipeline over just them on ``device`` (per-brick codes equal the
        full-level run's; the codebook is the part's own).
      * ``"gsp"`` — the whole single-payload level (this part owns its
        ``WHOLE_LEVEL`` key): ``compress_level`` on ``device``.
      * ``"stub"`` — this part owns nothing of the level: head + mask
        only, so every part records every level at the same index.
    """
    kind = task["kind"]
    if kind == "packed":
        return _device_level(task["lr"], device) if task["host"] \
            else task["lr"]
    head = task["head"]
    mask = _unpack_mask(head)
    if kind == "stub":
        art = LevelArtifacts(mask=mask, orig_shape=tuple(head["orig_shape"]),
                             grid_shape=tuple(head["grid_shape"]),
                             unit=head["unit"], sz_block=head["sz_block"],
                             subblocks=[], results=[], codebook=None)
        return LevelResult(strategy=head["strategy"],
                           algorithm=head["algorithm"], she=False,
                           payload_bits=0, codebook_bits=0, meta_bits=0,
                           recon=_empty_recon(), n_values=head["n_values"],
                           density=head["density"], eb=head["eb"],
                           ratio=head["ratio"], artifacts=art)
    if kind == "gsp":
        return compress_level(task["data"], mask, eb=head["eb"],
                              unit=head["unit"],
                              algorithm=head["algorithm"], she=False,
                              strategy="gsp", sz_block=head["sz_block"],
                              batched=head["batched"], ratio=head["ratio"],
                              keep_artifacts=True, device=device)
    if kind == "she":
        enc = she_encode(task["bricks"], head["eb"],
                         block=head["sz_block"], shared=True,
                         batched=head["batched"], device=device)
        art = LevelArtifacts(mask=mask, orig_shape=tuple(head["orig_shape"]),
                             grid_shape=tuple(head["grid_shape"]),
                             unit=head["unit"], sz_block=head["sz_block"],
                             subblocks=list(task["subblocks"]),
                             results=enc.results, codebook=enc.codebook)
        return LevelResult(strategy=head["strategy"],
                           algorithm=head["algorithm"], she=True,
                           payload_bits=enc.payload_bits,
                           codebook_bits=enc.codebook_bits,
                           meta_bits=enc.meta_bits, recon=_empty_recon(),
                           n_values=head["n_values"],
                           density=head["density"], eb=head["eb"],
                           n_subblocks=len(task["subblocks"]),
                           ratio=head["ratio"], artifacts=art)
    raise ValueError(f"unknown task kind {kind!r}")


def _part_worker(pi: int, part_path: str, payload_codec: str,
                 device: str, task_q, result_q, *, own_stream: bool = False,
                 spawned: bool = False) -> None:
    """One part's worker loop (thread or spawned-process body).

    Streams tasks into this part's own :class:`TACZWriter` until the close
    sentinel (``None``: finish the part's tmp file, report its identity)
    or the abort sentinel (drop the tmp).  Any failure aborts the part and
    reports the error; the producer then never publishes a manifest.  A
    thread worker on the card (``own_stream``) runs on a stream of its
    own, which waits on each task's ``"ready"`` event: the producer
    records it on the stream that made the task's tensors.  A
    ``spawned`` worker's ``"ok"`` report carries its process's kernel
    launch counts; a thread worker's launches are already counted in the
    producer's process.
    """
    w = None
    try:
        dev = torch.device(device)
        side = torch.cuda.Stream(dev) if own_stream else None
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            # background=False: this loop is the worker
            w = TACZWriter(part_path, payload_codec=payload_codec,
                           background=False, device=dev)
            while True:
                task = task_q.get()
                if task is None:
                    break
                if isinstance(task, str) and task == _ABORT:
                    w.abort()
                    result_q.put(("aborted", pi, None, None, None, None))
                    return
                if side is not None:
                    side.wait_event(task["ready"])
                w.add_compressed(_task_to_level(task, dev))
            # two-phase commit, phase 1: finish and fsync the tmp, no
            # rename; the producer renames every part once all reported
            tmp = w.close(publish=False)
        result_q.put(("ok", pi, w.index_crc, os.path.getsize(tmp),
                      w.obs_summary(),
                      dict(ops.launches) if spawned else None))
    except BaseException as exc:  # report, never hang the producer
        if w is not None:
            try:
                w.abort()
            except Exception:   # pragma: no cover - secondary failure
                pass
        try:
            result_q.put(("err", pi, f"{type(exc).__name__}: {exc}",
                          None, None, None))
        except Exception:       # pragma: no cover - broken pipe on crash
            pass


# --------------------------------------------------------------------------
# producer side
# --------------------------------------------------------------------------


class ParallelTACZWriter:
    """Streaming multi-part TACZ writer with N part workers.

    ``add_level(data, mask)`` partitions the level once, then hands each
    worker the bricks its part owns — compression, entropy coding, the
    lossless byte pass and file I/O all run per part, concurrently.
    ``add_compressed(lr)`` skips compression and fans out payload *slices*
    of an existing result (every part then shares the level's
    compress-time codebook, so part payload bytes equal the single-file
    container's).  ``close()`` publishes every part, then the manifest —
    the snapshot's atomic commit point.  Levels go to every part in
    arrival order, so part files stay level-aligned (a part that owns
    nothing of a level records a head-plus-mask stub).

    :param path: snapshot *directory* (created if missing); parts are
        ``part-0000.tacz`` ... inside it.
    :param parts: worker/part count (≥ 1).
    :param seed: rendezvous placement salt, recorded in the manifest: a
        :class:`~repro_torch.serving.sharded.ShardMap` built from the
        manifest's ``partition`` assigns each shard exactly one part's
        keys.
    :param mode: ``"thread"`` (default: one stream per worker on the
        card) or ``"process"`` (spawned workers).
    :param eb: default absolute error bound for :meth:`add_level`.
    :param unit: finest-level unit-block edge (level units follow the
        ``compress_amr`` rule).
    :param algorithm: prediction algorithm (``"lor_reg"`` etc.).
    :param she: per-sub-block payloads (required for non-gsp levels).
    :param strategy: partitioning strategy override.
    :param sz_block: Lor/Reg regression block edge.
    :param batched: run SHE bricks in same-shape batches in workers.
    :param lorenzo_engine: the reference's Lorenzo engine names, validated
        only (every name runs the same kernels).
    :param payload_codec: lossless byte pass, as in ``TACZWriter``.
    :param entropy_engine: the reference's entropy engine names, validated
        only; output bytes do not depend on it.
    :param queue_depth: per-part task queue bound (backpressure).
    :param device: where workers compress and pack (default ``"cuda"``).
    :raises ValueError: on bad ``parts``/``mode``/codec/engine names.
    :raises RuntimeError: for ``device="cuda"`` without a card, or if the
        kernels fail to build.
    :raises OSError: if the snapshot directory cannot be created.
    """

    def __init__(self, path, *, parts: int = 2, seed: int = 0,
                 mode: str = "thread", eb: float | None = None,
                 unit: int = 8, algorithm: str = "lor_reg",
                 she: bool = True, strategy: str | None = None,
                 sz_block: int = 6, batched: bool = True,
                 lorenzo_engine: str = "auto", payload_codec: str = "auto",
                 entropy_engine: str = "auto", queue_depth: int = 2,
                 device: str | torch.device = "cuda"):
        if parts < 1:
            raise ValueError("need at least one part")
        if mode not in ("thread", "process"):
            raise ValueError(f"unknown worker mode {mode!r}")
        resolve_payload_codec(payload_codec)   # fail fast on bad names
        check_engine_names(lorenzo_engine=lorenzo_engine,
                           entropy_engine=entropy_engine)
        self.device = resolve_device(device)
        self.path = os.fspath(path)
        self.parts = int(parts)
        self.seed = int(seed)
        self.mode = mode
        self._defaults = dict(eb=eb, unit=unit, algorithm=algorithm, she=she,
                              strategy=strategy, sz_block=sz_block,
                              batched=batched)
        self._part_ids = [mfst.part_stem(i) for i in range(self.parts)]
        self._frontier: frt.Frontier | None = None
        self._n_levels = 0
        self._subblocks_per_level: list[int] = []
        self._part_levels: list[list[list[int]]] = [[] for _ in
                                                    range(self.parts)]
        self._finalized = False
        self._aborted = False
        os.makedirs(self.path, exist_ok=True)
        if self.device.type == "cuda":
            # every worker finds the kernels built: spawned workers only
            # load them (the build lock guards threads, not processes)
            build.build_all()
        depth = max(1, int(queue_depth))
        dev = str(self.device)
        # thread workers on the card run on streams of their own
        self._own_streams = mode == "thread" and self.device.type == "cuda"
        if mode == "process":
            ctx = multiprocessing.get_context("spawn")
            self._result_q = ctx.Queue()
            self._task_qs = [ctx.Queue(maxsize=depth)
                             for _ in range(self.parts)]
            self._workers = [
                ctx.Process(target=_part_worker,
                            args=(pi, self._part_path(pi), payload_codec,
                                  dev, self._task_qs[pi], self._result_q),
                            kwargs={"spawned": True}, daemon=True)
                for pi in range(self.parts)]
        else:
            self._result_q = queue.Queue()
            self._task_qs = [queue.Queue(maxsize=depth)
                             for _ in range(self.parts)]
            self._workers = [
                threading.Thread(target=_part_worker,
                                 args=(pi, self._part_path(pi),
                                       payload_codec, dev,
                                       self._task_qs[pi], self._result_q),
                                 kwargs={"own_stream": self._own_streams},
                                 daemon=True)
                for pi in range(self.parts)]
        self._results: dict[int, tuple] = {}
        #: per-part writer obs summaries, filled in by :meth:`close`
        #: (``{part_index: {levels, encode_seconds, pack_seconds,
        #: publish_seconds, bytes}}``)
        self.worker_obs: dict[int, dict] = {}
        #: per-part kernel launch counts that each spawned worker reported
        #: at its close (``mode="process"`` only; filled in by
        #: :meth:`close`).  They are the workers' own counts and are not
        #: added to this process's :data:`repro_torch.kernels.ops.launches`.
        self.worker_launches: dict[int, dict] = {}
        for w in self._workers:
            w.start()

    # ------------------------------ plumbing -------------------------------

    def _part_path(self, pi: int) -> str:
        return os.path.join(self.path, mfst.part_name(pi))

    def _worker_alive(self, pi: int) -> bool:
        return self._workers[pi].is_alive()

    def _drain_results(self) -> None:
        while True:
            try:
                msg = self._result_q.get_nowait()
            except (queue.Empty, OSError, ValueError):
                return             # empty, or already released at shutdown
            self._results[msg[1]] = msg

    def _check_failures(self) -> None:
        self._drain_results()
        errs = [f"{mfst.part_name(pi)}: {msg[2]}"
                for pi, msg in sorted(self._results.items())
                if msg[0] == "err"]
        dead = [mfst.part_name(pi) for pi in range(self.parts)
                if not self._worker_alive(pi) and pi not in self._results]
        if dead:
            errs.append(f"worker(s) died without reporting: "
                        f"{', '.join(dead)}")
        if errs:
            raise RuntimeError("parallel TACZ write failed — manifest not "
                               "published: " + "; ".join(errs))

    def _dispatch(self, pi: int, task, check: bool = True) -> None:
        """Enqueue one task, never blocking forever on a dead worker.
        ``check=False`` (shutdown) watches only worker ``pi``: a sibling's
        failure must not keep this worker from its sentinel.  A task for a
        thread worker on the card carries a ``"ready"`` event recorded on
        the caller's current stream, which the worker waits on."""
        if self._own_streams and isinstance(task, dict):
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            task = dict(task, ready=ready)
        q = self._task_qs[pi]
        while True:
            try:
                q.put(task, timeout=0.2)
                return
            except queue.Full:
                if check:
                    self._check_failures()
                if not self._worker_alive(pi):
                    raise RuntimeError(
                        f"part writer {mfst.part_name(pi)} died mid-stream")

    def _check_live(self) -> None:
        if self._finalized or self._aborted:
            raise ValueError("writer is closed")
        self._check_failures()

    def _owners(self, keys: list[tuple[int, tuple[int, int]]],
                ) -> list[list[int]]:
        """Per part: the sorted global sub-block indices it owns of one
        level (``[0]``/``[]`` for single-payload levels)."""
        by_part: list[list[int]] = [[] for _ in range(self.parts)]
        pos = {pid: pi for pi, pid in enumerate(self._part_ids)}
        for gsbi, key in keys:
            owner = placement.owner(self._part_ids, self.seed, key)
            by_part[pos[owner]].append(gsbi)
        return by_part

    def _record_level(self, n_subblocks: int,
                      by_part: list[list[int]]) -> None:
        self._n_levels += 1
        self._subblocks_per_level.append(int(n_subblocks))
        for pi in range(self.parts):
            self._part_levels[pi].append(by_part[pi])

    # ------------------------------ producer -------------------------------

    def add_level(self, data: np.ndarray, mask: np.ndarray | None = None, *,
                  eb: float | None = None, ratio: int = 1,
                  unit: int | None = None) -> None:
        """Partition one raw level and fan its bricks out to the workers.

        Semantics match :meth:`TACZWriter.add_level` (snapshot taken now,
        the same eb/unit defaults); each worker compresses the bricks its
        part owns, against the one partition computed here.

        :raises ValueError: if no error bound is available, or the
            configured strategy has no per-sub-block payloads
            (``she=False`` with a non-gsp strategy is not indexable).
        """
        self._check_live()
        d = self._defaults
        eb = d["eb"] if eb is None else eb
        if eb is None:
            raise ValueError("no error bound: pass eb= here or to the writer")
        if unit is None:
            unit = max(2, int(d["unit"]) // max(int(ratio), 1))
        data = np.array(data, dtype=np.float32, copy=True)
        mask = (data != 0) if mask is None else np.array(mask, dtype=bool,
                                                         copy=True)
        grid, strategy, density, subblocks = partition_level(
            data, mask, unit=unit, algorithm=d["algorithm"], she=d["she"],
            strategy=d["strategy"])
        if strategy != "gsp" and not (d["she"]
                                      and d["algorithm"] == "lor_reg"):
            raise ValueError(
                "the merged-4D non-SHE path is not indexable; compress "
                "with she=True (TAC+) or strategy='gsp'")
        li = self._n_levels
        # GSP pads the same unit-block grid: its shape is the grid's
        head = dict(strategy=strategy, algorithm=d["algorithm"],
                    eb=float(eb), ratio=int(ratio), unit=int(unit),
                    sz_block=int(d["sz_block"]),
                    orig_shape=tuple(data.shape),
                    grid_shape=tuple(grid.data.shape),
                    density=float(density), n_values=int(mask.sum()),
                    batched=bool(d["batched"]),
                    mask_packed=(None if mask.all()
                                 else np.packbits(mask.ravel()).tobytes()))
        if strategy == "gsp":
            by_part = self._owners([(0, (li, WHOLE_LEVEL))])
            for pi in range(self.parts):
                if by_part[pi]:
                    self._dispatch(pi, {"kind": "gsp", "head": head,
                                        "data": data})
                else:
                    self._dispatch(pi, {"kind": "stub", "head": head})
            self._record_level(1, by_part)
            return
        by_part = self._owners([(i, (li, i)) for i in range(len(subblocks))])
        for pi in range(self.parts):
            idxs = by_part[pi]
            if not idxs:
                self._dispatch(pi, {"kind": "stub", "head": head})
                continue
            owned = [subblocks[i] for i in idxs]
            bricks = [np.ascontiguousarray(extract_subblock(grid, sb))
                      for sb in owned]
            self._dispatch(pi, {"kind": "she", "head": head,
                                "subblocks": owned, "bricks": bricks})
        self._record_level(len(subblocks), by_part)

    def add_compressed(self, lr: LevelResult) -> None:
        """Fan an already-compressed level's payload slices out to the
        parts (shared codebook: part payload bytes equal the single-file
        container's, and so does ``level_signature``).

        :raises ValueError: if ``lr`` has no serialization artifacts.
        """
        self._check_live()
        art = lr.artifacts
        if art is None:
            raise ValueError(
                "LevelResult has no serialization artifacts — the merged-4D "
                "non-SHE path is not indexable (compress with she=True or "
                "strategy='gsp'), and compression must run with "
                "keep_artifacts=True")
        li = self._n_levels
        if lr.strategy in _SHE_STRATEGY_NAMES and art.subblocks:
            n = len(art.subblocks)
            keys = [(i, (li, i)) for i in range(n)]
        else:
            n = 1
            keys = [(0, (li, WHOLE_LEVEL))]
        by_part = self._owners(keys)
        host = self.mode == "process"
        for pi in range(self.parts):
            part = _slice_level(lr, by_part[pi])
            self._dispatch(pi, {"kind": "packed", "host": host,
                                "lr": _host_level(part) if host else part})
        self._record_level(n, by_part)

    def set_frontier(self, frontier: frt.Frontier | None) -> None:
        """Attach a rate–distortion frontier, recorded under the
        manifest's optional ``"frontier"`` key (the manifest CRC covers
        it)."""
        self._check_live()
        self._frontier = frontier

    # ------------------------------ lifecycle ------------------------------

    def close(self) -> str:
        """Publish every part, then the manifest (the commit point).

        Two-phase: workers only *finish* their tmp files; the renames
        happen here, after every worker reported success, followed by the
        manifest.  A worker failure before the rename loop therefore
        leaves a previously published snapshot in the directory intact
        (its tmps become stale litter a re-run truncates).  A spawned
        worker's stage totals are added to this process's registry; its
        launch counts go to :attr:`worker_launches`.

        :returns: the snapshot directory path.
        :raises RuntimeError: if any part worker failed or was killed; the
            manifest is then not published and no part file is replaced.
        """
        if self._finalized:
            return self.path
        if self._aborted:
            raise ValueError("writer was aborted")
        # a worker already known dead or failed must not let the others
        # finish; abort them instead
        self._drain_results()
        healthy = all(self._worker_alive(pi) or self._results.get(
            pi, ("",))[0] == "ok" for pi in range(self.parts))
        self._shutdown(None if healthy else _ABORT)
        self._check_failures()
        missing = [mfst.part_name(pi) for pi in range(self.parts)
                   if self._results.get(pi, ("",))[0] != "ok"]
        if missing:
            raise RuntimeError(
                "parallel TACZ write failed — manifest not published: no "
                "result from " + ", ".join(missing))
        # phase 2: every part finished — rename them all into place
        for pi in range(self.parts):
            final = self._part_path(pi)
            os.replace(final + ".tmp", final)
        parts = []
        for pi in range(self.parts):
            _, _, index_crc, size, obs_sum, launched = self._results[pi]
            parts.append({"name": mfst.part_name(pi), "size": int(size),
                          "index_crc": int(index_crc) & 0xFFFFFFFF,
                          "levels": self._part_levels[pi]})
            self.worker_obs[pi] = obs_sum or {}
            if self.mode == "process":
                # a spawned worker recorded into its own registry and
                # counted its own launches: keep its counts apart and fold
                # its stage totals in here (one observation per part and
                # stage)
                self.worker_launches[pi] = launched or {}
                if obs_sum:
                    for stage in ("encode", "pack", "publish"):
                        sec = obs_sum.get(f"{stage}_seconds", 0.0)
                        if sec:
                            obsm.WRITER_LEVEL_SECONDS.labels(stage).observe(
                                sec)
                    obsm.WRITER_LEVELS.inc(obs_sum.get("levels", 0))
                    obsm.WRITER_BYTES.inc(obs_sum.get("bytes", 0))
        body = {"magic": mfst.MANIFEST_MAGIC,
                "version": mfst.MANIFEST_VERSION,
                "n_levels": self._n_levels,
                "subblocks": self._subblocks_per_level,
                "partition": {"algorithm": placement.ALGORITHM,
                              "seed": self.seed,
                              "shards": list(self._part_ids)},
                "parts": parts}
        if self._frontier is not None:
            body["frontier"] = self._frontier.to_dict()
        mfst.write_atomic(self.path, body)
        self._clean_stale({p["name"] for p in parts})
        self._finalized = True
        return self.path

    def abort(self) -> None:
        """Drop every part's tmp file; never publishes a manifest."""
        if self._finalized or self._aborted:
            self._aborted = True
            return
        self._aborted = True
        self._shutdown(_ABORT)

    def _shutdown(self, sentinel) -> None:
        for pi in range(self.parts):
            if self._worker_alive(pi):
                try:
                    self._dispatch(pi, sentinel, check=False)
                except RuntimeError:   # died while we queued — close() sees it
                    pass
        for w in self._workers:
            w.join()
        self._drain_results()
        if self.mode == "process":
            # a dead worker leaves its queue's feeder thread blocked on a
            # full pipe; cancel it or interpreter exit hangs on join
            for q in self._task_qs:
                q.close()
                q.cancel_join_thread()
            self._result_q.close()
            self._result_q.cancel_join_thread()

    def _clean_stale(self, keep: set) -> None:
        """After a successful publish: drop tmp litter and part files the
        new manifest no longer references (a re-publish with fewer
        parts)."""
        for name in mfst.stale_parts(self.path):
            try:
                os.remove(os.path.join(self.path, name))
            except OSError:     # pragma: no cover - already gone
                pass
        for name in os.listdir(self.path):
            if (name not in keep and name.endswith(".tacz")
                    and mfst._PART_RE.match(name)):
                try:
                    os.remove(os.path.join(self.path, name))
                except OSError:  # pragma: no cover - already gone
                    pass

    def __enter__(self) -> "ParallelTACZWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


def _slice_level(lr: LevelResult, idxs: list[int]) -> LevelResult:
    """A shallow per-part copy of ``lr`` holding only the payloads in
    ``idxs`` (global sub-block indices; ``[0]`` keeps a single-payload
    level, ``[]`` makes a stub).  Codebook, mask and head fields are
    shared, and the recon is dropped (workers never need it)."""
    art = lr.artifacts
    a2 = copy.copy(art)
    if art.subblocks:
        a2.subblocks = [art.subblocks[i] for i in idxs]
        a2.results = [art.results[i] for i in idxs]
    elif not idxs:
        a2.subblocks, a2.results, a2.codebook = [], [], None
    lr2 = copy.copy(lr)
    lr2.artifacts = a2
    lr2.recon = _empty_recon()
    return lr2


def write_multipart(path, obj, *, parts: int = 2, seed: int = 0,
                    mode: str = "thread", eb=None,
                    frontier: frt.Frontier | None = None, **kwargs) -> str:
    """One-shot multi-part mirror of :func:`repro_torch.io.write`.

    ``obj`` is an :class:`AMRCompressionResult` (payload slices fan out;
    compression already happened) or an :class:`AMRDataset` (each part
    worker compresses its slice of every level; ``eb`` required, scalar
    or per level).  ``frontier`` attaches an optional rate–distortion
    frontier to the manifest; ``kwargs`` go to
    :class:`ParallelTACZWriter` (``device``, ``payload_codec``, ...).

    :returns: the snapshot directory path.
    """
    if isinstance(obj, AMRCompressionResult):
        with ParallelTACZWriter(path, parts=parts, seed=seed, mode=mode,
                                **kwargs) as w:
            for lr in obj.levels:
                w.add_compressed(lr)
            if frontier is not None:
                w.set_frontier(frontier)
        return w.path
    if isinstance(obj, AMRDataset):
        if eb is None:
            raise ValueError("writing a raw AMRDataset needs eb=")
        ebs = eb if isinstance(eb, (list, tuple)) else [eb] * obj.n_levels
        if len(ebs) != obj.n_levels:
            raise ValueError("need one error bound per level")
        with ParallelTACZWriter(path, parts=parts, seed=seed, mode=mode,
                                **kwargs) as w:
            for lvl, e in zip(obj.levels, ebs):
                w.add_level(lvl.data, lvl.mask, eb=float(e), ratio=lvl.ratio)
            if frontier is not None:
                w.set_frontier(frontier)
        return w.path
    raise TypeError(f"cannot write {type(obj).__name__} as multi-part TACZ")


# --------------------------------------------------------------------------
# reader side
# --------------------------------------------------------------------------


class MultiPartReader(TACZReader):
    """One logical :class:`TACZReader` over a multi-part snapshot.

    The constructor validates the manifest (magic, version, body CRC),
    parses every part's CRC'd index, checks it against the manifest's
    ``index_crc``, and merges the parts' sub-block records into one index
    at their *global* positions, so ``subblock_keys``, geometry and
    ``level_signature`` equal the single-file reader's.

    Part files then open lazily: a payload decode opens only the part
    that holds the payload, and a level's mask is read from an already
    open part (every part stores a copy).  A shard server aligned with its
    part therefore never opens other parts (see :attr:`open_parts`).
    Each part decodes its share of a batch in one launch of kernel 4 on
    ``device``; the inherited routes then reconstruct each (shape, branch)
    group of the whole batch in one launch of kernel 2.

    ``index_crc`` is the manifest CRC: the generation identity the
    serving layer's hot-swap checks compare (``probe_index_crc`` returns
    the same value for the directory).

    :param src: snapshot directory or its ``manifest.json`` path.
    :param entropy_engine: the reference's engine names, validated only.
    :param device: where payloads decode (default ``"cuda"``).
    :raises ValueError: on a missing/corrupt manifest, a part whose bytes
        do not match the manifest (stale or torn republish), or
        inconsistent level heads across parts.
    :raises OSError: if the manifest or a part cannot be read.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """

    def __init__(self, src, *, entropy_engine: str = "auto",
                 device: str | torch.device = "cuda"):
        entropy.check_engine_name(entropy_engine)
        self.device = resolve_device(device)
        src = os.fspath(src)
        self._dir = (os.path.dirname(src)
                     if os.path.basename(src) == mfst.MANIFEST_NAME
                     else src)
        self.manifest = mfst.load(src)
        self.index_crc = int(self.manifest["crc32"]) & 0xFFFFFFFF
        # the manifest's optional frontier mirrors the single-file TACF
        # section; a malformed body degrades to None, never a raise
        self.frontier: frt.Frontier | None = None
        self.frontier_error: str | None = None
        if "frontier" in self.manifest:
            try:
                self.frontier = frt.Frontier.from_dict(
                    self.manifest["frontier"])
            except (ValueError, KeyError, TypeError) as exc:
                self.frontier_error = str(exc)
        self._part_names = mfst.referenced_parts(self.manifest)
        if not self._part_names:
            raise ValueError("multi-part manifest references no parts")
        n_levels = int(self.manifest["n_levels"])
        counts = [int(c) for c in self.manifest["subblocks"]]
        if len(counts) != n_levels:
            raise ValueError("corrupt manifest: level count mismatch")

        part_levels, versions = [], []
        for p in self.manifest["parts"]:
            rd = TACZReader(os.path.join(self._dir, p["name"]),
                            device=self.device)
            try:
                if rd.index_crc != (int(p["index_crc"]) & 0xFFFFFFFF):
                    raise ValueError(
                        f"part {p['name']} does not match the manifest "
                        f"(index CRC mismatch — torn or stale republish)")
                if len(rd.levels) != n_levels:
                    raise ValueError(
                        f"part {p['name']} holds {len(rd.levels)} levels, "
                        f"manifest says {n_levels}")
                part_levels.append(rd.levels)
                versions.append(rd.version)
            finally:
                rd.close()
        self.version = max(versions)

        self.levels = []
        self._where: dict[tuple[int, int], tuple[int, int]] = {}
        self._sbmap: dict[int, tuple[int, int]] = {}
        self._home: list[int] = []
        for li in range(n_levels):
            heads = [self._head_key(pl[li]) for pl in part_levels]
            if len(set(heads)) != 1:
                raise ValueError(
                    f"parts disagree on level {li}'s head — not slices of "
                    f"one snapshot")
            slots: list = [None] * counts[li]
            per_part_n = []
            for pi, pl in enumerate(part_levels):
                idxs = self.manifest["parts"][pi]["levels"][li]
                e = pl[li]
                if len(idxs) != len(e.subblocks):
                    raise ValueError(
                        f"part {self._part_names[pi]} level {li}: manifest "
                        f"lists {len(idxs)} payloads, index has "
                        f"{len(e.subblocks)}")
                per_part_n.append(len(idxs))
                for lsbi, gsbi in enumerate(idxs):
                    gsbi = int(gsbi)
                    if not 0 <= gsbi < counts[li] or slots[gsbi] is not None:
                        raise ValueError(
                            f"corrupt manifest: level {li} sub-block "
                            f"{gsbi} out of range or claimed twice")
                    sb = e.subblocks[lsbi]
                    slots[gsbi] = sb
                    self._where[(li, gsbi)] = (pi, lsbi)
                    self._sbmap[id(sb)] = (pi, lsbi)
            if any(s is None for s in slots):
                raise ValueError(
                    f"corrupt manifest: level {li} has unclaimed sub-blocks")
            home = max(range(len(part_levels)),
                       key=lambda pi: (per_part_n[pi], -pi))
            self._home.append(home)
            self.levels.append(dataclasses.replace(part_levels[home][li],
                                                   subblocks=slots))
        # base-class state the inherited read surface expects (payloads,
        # codebooks and file reads go through the parts)
        self._masks = {}
        self._extents = {}
        self._parts: list[TACZReader | None] = [None] * len(self._part_names)
        self._parts_lock = threading.Lock()

    @staticmethod
    def _head_key(e) -> tuple:
        return (e.shape, e.grid_shape, e.strategy, e.algorithm, e.unit,
                e.sz_block, e.ratio, e.eb, e.n_values, e.payload_compressor)

    # ------------------------------ plumbing -------------------------------

    @property
    def n_parts(self) -> int:
        """Number of part files the manifest binds."""
        return len(self._part_names)

    @property
    def part_names(self) -> list[str]:
        """Part file names, in part order."""
        return list(self._part_names)

    @property
    def partition(self) -> dict:
        """The manifest's placement config — feed it to
        ``ShardMap.from_dict`` to align shard servers with parts."""
        return dict(self.manifest["partition"])

    @property
    def open_parts(self) -> list[int]:
        """Indices of the parts whose files are open: the observable form
        of the locality guarantee."""
        with self._parts_lock:
            return [pi for pi, rd in enumerate(self._parts)
                    if rd is not None]

    def _part(self, pi: int) -> TACZReader:
        with self._parts_lock:
            rd = self._parts[pi]
            if rd is None:
                p = self.manifest["parts"][pi]
                rd = TACZReader(os.path.join(self._dir, p["name"]),
                                device=self.device)
                if rd.index_crc != (int(p["index_crc"]) & 0xFFFFFFFF):
                    rd.close()
                    raise ValueError(
                        f"part {p['name']} changed under the reader "
                        f"(index CRC mismatch)")
                self._parts[pi] = rd
            return rd

    def _meta_part(self, li: int) -> int:
        """Part to read level ``li``'s *mask* from: any open part (every
        part stores the same mask, stubs included), else the level's home
        part (the one holding most of its payloads).  Codebooks are not
        interchangeable so: they are local to a worker-compressed part
        and absent from stubs, which is why payload decode goes whole
        into the owning part."""
        with self._parts_lock:
            for pi, rd in enumerate(self._parts):
                if rd is not None:
                    return pi
        return self._home[li]

    def close(self) -> None:
        """Close every opened part file."""
        with self._parts_lock:
            for rd in self._parts:
                if rd is not None:
                    rd.close()
            self._parts = [None] * len(self._part_names)

    def _read_at(self, off: int, length: int) -> bytes:
        raise ValueError("MultiPartReader has no single backing file — "
                         "reads go through its parts")

    # ------------------------------ decoding -------------------------------

    def _codebook(self, li: int):
        # codebooks are part-local, so a merged level has none: decode
        # goes through the owning part
        raise ValueError(
            "multi-part codebooks are per part — decode sub-blocks via "
            "subblock_codes()/read_*, which route into the owning part")

    def _mask(self, li: int):
        if li not in self._masks:
            self._masks[li] = self._part(self._meta_part(li))._mask(li)
        return self._masks[li]

    def _decode_subblock(self, li: int, sb, shape, limit=None):
        pi, lsbi = self._sbmap[id(sb)]
        part = self._part(pi)
        return part._decode_subblock(li, part.levels[li].subblocks[lsbi],
                                     shape, limit=limit)

    def subblock_codes(self, li: int, sbi: int, limit: int | None = None):
        """(codes, betas) of global sub-block ``sbi``, decoded by the part
        that owns it (see :meth:`TACZReader.subblock_codes`)."""
        pi, lsbi = self._where[(li, int(sbi))]
        return self._part(pi).subblock_codes(li, lsbi, limit)

    def decode_subblocks(self, li: int, sbis, limits=None):
        """Batched :meth:`subblock_codes` over global indices: the batch is
        split by owning part, each part decodes its slice in one launch of
        kernel 4, and the results come back in input order."""
        sbis = [int(s) for s in sbis]
        by_part: dict[int, list[int]] = {}
        for pos, sbi in enumerate(sbis):
            pi, _ = self._where[(li, sbi)]
            by_part.setdefault(pi, []).append(pos)
        out: list = [None] * len(sbis)
        for pi, positions in by_part.items():
            local = [self._where[(li, sbis[p])][1] for p in positions]
            lims = (None if limits is None
                    else [limits[p] for p in positions])
            for p, pair in zip(positions,
                               self._part(pi).decode_subblocks(
                                   li, local, lims)):
                out[p] = pair
        return out

    def verify(self) -> bool:
        """Verify every part's sections and payloads (each part's index
        CRC was checked against the manifest at open).

        :raises IOError: at the first corrupt byte range.
        """
        for pi in range(self.n_parts):
            self._part(pi).verify()
        return True
