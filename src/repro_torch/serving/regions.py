"""``repro_torch.serving.regions`` — region serving over a TACZ container,
with the decoded bricks in device memory.

Many overlapping region queries against one compressed AMR snapshot are
the canonical read workload (AMReX visualization study,
arXiv:2309.16980); decoding each hot brick once and serving it from a
cache is what makes them cheap.  Three layers, as in the reference's
``repro.serving.regions``:

  * :class:`SubBlockCache` — byte-budgeted LRU over *decoded* bricks,
    keyed on (generation, level, sub-block index), with
    hit/miss/eviction counters.  The bricks are tensors on the server's
    device; each owns its storage.
  * :class:`DecodePlanner` — maps a batch of ROI boxes to the minimal set
    of *uncached* sub-blocks and decodes them per level: one launch of
    kernel 4 over the level's missing payloads, one batched
    reconstruction per (shape, branch) group (kernel 2 for Lorenzo
    bricks).  A whole-level key goes through ``read_level`` (kernel 6 for
    a global Lorenzo level).
  * :class:`RegionServer` — ``get_region(level, box)`` /
    ``get_regions(boxes)`` over one reader + cache + planner, with
    snapshot hot-swap keyed on the TACZ footer's index CRC.

Assembly is the reader's own code path
(:meth:`~repro_torch.io.reader.TACZReader.assemble_level_roi`), so every
served crop is bit-identical to ``read_roi``, cold or warm.  A served crop
never shares storage with a cache entry (a tensor cannot be made
read-only, so a caller may write to what it was served).
"""
from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..io import frontier as frt
from ..io.reader import (WHOLE_LEVEL, Box, ROILevel, TACZReader,
                         open_snapshot, probe_index_crc)
from ..obs import metrics as obsm

__all__ = ["CacheKey", "SubBlockCache", "DecodePlanner", "PlannedLevel",
           "RegionServer", "WHOLE_LEVEL", "resolve_single_target"]


def resolve_single_target(reader, target) -> str:
    """Validate a distortion target against a *single* snapshot: the
    request is admitted when the snapshot's recorded frontier point
    satisfies it.  A snapshot with no frontier is served as-is and counted
    in ``tacz_variant_fallbacks_total``.

    :param reader: an open snapshot reader (``frontier`` attribute
        optional).
    :param target: a :class:`repro_torch.io.frontier.Target` or its
        string form, e.g. ``"psnr>=60"``.
    :returns: the serving variant name — always ``"default"`` here.
    :raises ValueError: on a malformed target spec.
    :raises repro_torch.io.frontier.TargetUnsatisfiable: when the frontier
        is present and the snapshot's own point misses the target.
    """
    if isinstance(target, str):
        target = frt.parse_target(target)
    fr = getattr(reader, "frontier", None)
    point = fr.default_point if fr is not None else None
    if point is None:
        obsm.VARIANT_FALLBACKS.inc()
    elif not target.satisfies(point.metrics):
        obsm.VARIANT_UNSATISFIED.inc()
        raise frt.TargetUnsatisfiable(target, fr.best_value(target.metric))
    obsm.VARIANT_REQUESTS.labels("default").inc()
    return "default"


# planner key: (level index, sub-block index); WHOLE_LEVEL marks the full
# reconstruction of a gsp/global level.  In the cache itself keys carry a
# leading snapshot-CRC generation tag — see DecodePlanner.fetch.
CacheKey = tuple[int, int]


def _nbytes(brick: torch.Tensor) -> int:
    return brick.numel() * brick.element_size()


def _own_storage(brick: torch.Tensor) -> torch.Tensor:
    """``brick`` itself when it is contiguous and spans its whole storage,
    else a compact copy: a view into a stacked batch would keep the whole
    batch alive behind one cache entry's accounted bytes."""
    if (brick.is_contiguous() and brick.storage_offset() == 0
            and brick.untyped_storage().nbytes() == _nbytes(brick)):
        return brick
    return brick.clone(memory_format=torch.contiguous_format)


class SubBlockCache:
    """Thread-safe byte-budgeted LRU of decoded bricks.

    Keys are hashable tuples (the planner uses ``(snapshot_crc, level,
    sub-block index)``); values are float32 tensors, on any device, each
    accounted ``numel · element_size`` bytes.  A brick is stored owning
    its storage (a view is copied on insert).  The cache cannot make a
    tensor read-only: callers must not write to a brick they inserted or
    looked up.  Insertion evicts least-recently-used entries until the
    budget holds again; an entry larger than the whole budget is not
    inserted at all — it could never be held, and admitting it would
    flush the hot set.
    """

    def __init__(self, budget_bytes: int = 256 << 20):
        if budget_bytes <= 0:
            raise ValueError("cache budget must be positive")
        self.budget_bytes = int(budget_bytes)
        self._od: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple) -> torch.Tensor | None:
        """Look one brick up, counting a hit (entry becomes MRU) or miss.

        :returns: the cached tensor, or None on a miss.
        """
        with self._lock:
            arr = self._od.get(key)
            if arr is None:
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return arr

    def put(self, key: tuple, brick: torch.Tensor) -> torch.Tensor:
        """Insert (or replace) one decoded brick, evicting LRU entries
        until the byte budget holds.

        :returns: the tensor as stored (``brick``, or its compact copy
            when ``brick`` did not own its storage).  A brick larger than
            the whole budget is not inserted.
        """
        brick = _own_storage(brick)
        with self._lock:
            old = self._od.pop(key, None)
            if old is not None:
                self._bytes -= _nbytes(old)
            if _nbytes(brick) > self.budget_bytes:
                return brick   # can never be held — don't flush the hot set
            self._od[key] = brick
            self._bytes += _nbytes(brick)
            while self._bytes > self.budget_bytes and self._od:
                _, victim = self._od.popitem(last=False)
                self._bytes -= _nbytes(victim)
                self.evictions += 1
        return brick

    def peek(self, key: tuple) -> torch.Tensor | None:
        """Look one brick up *without* touching counters or LRU order (the
        cache-handoff exporter must not skew the statistics)."""
        with self._lock:
            return self._od.get(key)

    def drop(self, pred) -> int:
        """Remove every entry whose key matches ``pred(key)``.

        :returns: number of entries removed.
        """
        with self._lock:
            victims = [k for k in self._od if pred(k)]
            for k in victims:
                self._bytes -= _nbytes(self._od.pop(k))
            return len(victims)

    def clear(self) -> None:
        """Drop every entry (counters are kept — they are lifetime totals)."""
        with self._lock:
            self._od.clear()
            self._bytes = 0

    def swap_generation(self, old_gen: int, new_gen: int,
                        keep_levels: set) -> int:
        """Carry entries across a snapshot hot-swap, dropping the rest.

        Entries keyed ``(old_gen, level, sub_block)`` whose ``level`` is in
        ``keep_levels`` are re-tagged to ``new_gen`` (LRU order preserved);
        every other entry is dropped.  ``swap_generation(g, g', set())``
        is :meth:`clear`.

        :returns: number of entries carried over.
        """
        with self._lock:
            od: OrderedDict[tuple, torch.Tensor] = OrderedDict()
            nbytes = 0
            for key, arr in self._od.items():
                if (len(key) == 3 and key[0] == old_gen
                        and key[1] in keep_levels):
                    od[(new_gen, key[1], key[2])] = arr
                    nbytes += _nbytes(arr)
            kept = len(od)
            self._od = od
            self._bytes = nbytes
            return kept

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._od

    @property
    def nbytes(self) -> int:
        """Decoded bytes currently held (always ≤ ``budget_bytes``)."""
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        """Lifetime counters and current occupancy: ``hits``, ``misses``,
        ``evictions``, ``entries``, ``bytes``, ``budget_bytes``."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "entries": len(self._od),
                    "bytes": self._bytes,
                    "budget_bytes": self.budget_bytes}


@dataclass(frozen=True)
class PlannedLevel:
    """One (level, box) query resolved against the index: which sub-blocks
    the box touches, or whether the whole level must be materialized.

    On a shard-filtered server ``tasks`` holds only *owned* sub-blocks and
    ``owned`` is False for a whole-level plan whose key belongs to another
    shard — such a plan decodes nothing and assembles to zeros.
    """

    level: int
    lbox: Box
    tasks: tuple[tuple[int, Box], ...]   # (sub-block index, intersection)
    whole_level: bool                    # gsp/global single-payload level
    owned: bool = True                   # False → serve zeros (shard filter)

    def keys(self) -> list[CacheKey]:
        """Cache/placement keys this plan needs decoded:
        ``[(level, WHOLE_LEVEL)]`` for an owned whole-level plan, one
        ``(level, sub_block)`` key per task otherwise."""
        if self.whole_level:
            return [(self.level, WHOLE_LEVEL)] if self.owned else []
        return [(self.level, sbi) for sbi, _ in self.tasks]


class DecodePlanner:
    """Batch ROI queries into minimal, grouped decode work.

    ``plan`` resolves (level, box) queries against the reader's index;
    ``fetch`` dedupes the union of needed sub-blocks, consults the cache
    once per unique key and decodes only the misses: per level, one
    launch of kernel 4 over every missing payload and one batched
    reconstruction per (shape, branch) group.

    :param reader: the open :class:`~repro_torch.io.TACZReader` to plan
        against.
    :param owned: optional set of ``(level, sub_block)`` keys this planner
        may decode (a shard's slice of ``reader.subblock_keys()``); foreign
        sub-blocks are dropped from ``tasks`` and foreign whole-level
        plans are marked ``owned=False``.  ``None`` plans everything.
    """

    def __init__(self, reader: TACZReader,
                 owned: set[CacheKey] | None = None):
        self._rd = reader
        self._owned = owned

    def plan(self, queries: list[tuple[int, Box]]) -> list[PlannedLevel]:
        """Resolve ``(level, box)`` queries (finest-grid boxes) against the
        reader's index; one :class:`PlannedLevel` per query, in order.

        :raises ValueError: if a box is not three ``(lo, hi)`` ranges.
        :raises IndexError: if a level index is out of range.
        """
        rd, owned = self._rd, self._owned
        out: list[PlannedLevel] = []
        for li, box in queries:
            if len(box) != 3:
                raise ValueError("box must be ((x0,x1),(y0,y1),(z0,z1))")
            lbox = rd.level_box(li, box)
            if any(hi <= lo for lo, hi in lbox):
                out.append(PlannedLevel(li, lbox, (), False))
            elif rd.levels[li].strategy in TACZReader._SHE_STRATEGIES:
                tasks = rd.intersecting_subblocks(li, lbox)
                if owned is not None:
                    tasks = [t for t in tasks if (li, t[0]) in owned]
                out.append(PlannedLevel(li, lbox, tuple(tasks), False))
            else:
                out.append(PlannedLevel(
                    li, lbox, (), True,
                    owned=owned is None or (li, WHOLE_LEVEL) in owned))
        return out

    def fetch(self, plans: list[PlannedLevel], cache: SubBlockCache,
              ) -> dict[CacheKey, torch.Tensor]:
        """Bricks for every key the plans need, decoding only cache misses.

        Each unique key touches the cache exactly once per call.  Cache
        entries are tagged with the snapshot's index CRC, so a request
        that raced a hot-swap can only insert under the old generation,
        which no later request looks up.  Misses enter the cache in the
        reference planner's order (whole levels as met, then each
        (level, shape, branch) group), so both caches evict alike.

        :returns: ``{(level, sub_block): decoded brick}`` covering every
            key of every plan.
        :raises IOError: if a payload fails its CRC check.
        """
        rd = self._rd
        gen = rd.index_crc
        out: dict[CacheKey, torch.Tensor] = {}
        missing: list[CacheKey] = []
        missing_set: set[CacheKey] = set()
        for p in plans:
            for key in p.keys():
                if key in out or key in missing_set:
                    continue
                arr = cache.get((gen,) + key)
                if arr is None:
                    missing.append(key)
                    missing_set.add(key)
                else:
                    out[key] = arr
        obsm.PLANNER_SUBBLOCKS.labels("cached").inc(len(out))
        obsm.PLANNER_SUBBLOCKS.labels("decoded").inc(len(missing))
        decoded_bytes = 0
        with obsm.timed(obsm.PLANNER_DECODE_SECONDS.labels(), "decode"):
            groups: dict[tuple[int, tuple[int, ...], int], list[int]] = {}
            for li, sbi in missing:
                if sbi == WHOLE_LEVEL:
                    full = cache.put((gen, li, sbi), rd.read_level(li))
                    out[(li, sbi)] = full
                    decoded_bytes += _nbytes(full)
                else:
                    sb = rd.levels[li].subblocks[sbi]
                    groups.setdefault(
                        (li, rd.subblock_shape(li, sbi), sb.branch),
                        []).append(sbi)
            by_level: dict[int, list[int]] = {}
            for (li, _, _), sbis in groups.items():
                by_level.setdefault(li, []).extend(sbis)
            bricks: dict[CacheKey, torch.Tensor] = {}
            for li, sbis in by_level.items():
                recon = rd._decode_bricks(li, [(sbi, None) for sbi in sbis])
                bricks.update(((li, sbi), b) for sbi, b in zip(sbis, recon))
            for (li, _, _), sbis in groups.items():
                for sbi in sbis:
                    # the cache copies each brick out of its stacked batch
                    brick = cache.put((gen, li, sbi), bricks[(li, sbi)])
                    out[(li, sbi)] = brick
                    decoded_bytes += _nbytes(brick)
        obsm.PLANNER_DECODED_BYTES.inc(decoded_bytes)
        return out


class RegionServer:
    """Serve ROI queries from one TACZ snapshot with a device-resident
    sub-block cache.

    ``box`` semantics are exactly :meth:`TACZReader.read_roi`'s: half-open
    ranges in finest-grid cells, mapped through each level's coarsening
    ratio.  ``get_region(level, box)`` returns one level's
    :class:`~repro_torch.io.reader.ROILevel`; ``get_regions(boxes)`` plans
    a whole batch at once; ``get_roi(box)`` mirrors ``read_roi``.  Crops
    are float32 tensors on ``device`` and never alias a cache entry.

    Hot swap: :meth:`maybe_reload` re-reads the file's 20-byte footer and
    compares the index CRC with the serving snapshot's; on change the
    reader is reopened and cache entries of levels whose
    :meth:`~repro_torch.io.TACZReader.level_signature` is unchanged are
    carried over.  ``auto_reload=True`` runs the check before every batch.

    Sharding: ``shard_map``/``shard_id`` restrict the server to the
    sub-blocks the map assigns to that shard; foreign sub-blocks are never
    decoded or cached (crops cover them with zeros).

    :param path: path of the single-file ``.tacz`` snapshot to serve.
    :param cache_bytes: :class:`SubBlockCache` byte budget, in device
        memory (~25 % of the decoded level bytes suits overlapping
        workloads).
    :param auto_reload: run :meth:`maybe_reload` before every batch.
    :param shard_map: an object with ``owner(key) -> shard_id`` (normally
        :class:`repro_torch.serving.sharded.ShardMap`); requires
        ``shard_id``.
    :param shard_id: this server's shard in ``shard_map``.
    :param entropy_engine: one of the reference's engine names, accepted
        for signature parity and only validated: every one decodes through
        kernel 4 (the reference's engines are bit-identical).
    :param device: where bricks decode and stay (default ``"cuda"``).
    :raises ValueError: if only one of ``shard_map``/``shard_id`` is given,
        or the file fails TACZ validation.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    :raises NotImplementedError: for a multi-part snapshot directory.
    """

    def __init__(self, path, *, cache_bytes: int = 256 << 20,
                 auto_reload: bool = False, shard_map=None,
                 shard_id: str | None = None,
                 entropy_engine: str = "auto",
                 device: str | torch.device = "cuda"):
        if (shard_map is None) != (shard_id is None):
            raise ValueError("shard_map and shard_id go together")
        self.path = str(path)
        self.auto_reload = bool(auto_reload)
        self.shard_map = shard_map
        self.shard_id = shard_id
        #: optional zero-arg callable invoked at the top of every batch —
        #: a fault-injection point for tests; exceptions it raises surface
        #: as request failures.
        self.fault_hook = None
        self.cache = SubBlockCache(cache_bytes)
        self._lock = threading.Lock()
        # readers displaced by a hot swap, with in-flight request counts:
        # a retired reader closes as soon as its last request drains
        self._inflight: dict[int, int] = {}
        self._retired: dict[int, TACZReader] = {}
        self._reader = open_snapshot(self.path,
                                     entropy_engine=entropy_engine,
                                     device=device)
        self.device = self._reader.device
        self._owned = self._compute_owned(self._reader)
        self._planner = DecodePlanner(self._reader, self._owned)

    def _compute_owned(self, reader: TACZReader) -> set[CacheKey] | None:
        if self.shard_map is None:
            return None
        return {k for k in reader.subblock_keys()
                if self.shard_map.owner(k) == self.shard_id}

    # ------------------------------ lifecycle ------------------------------

    def close(self) -> None:
        """Close the current reader and any hot-swap-retired readers."""
        with self._lock:
            self._reader.close()
            for rd in self._retired.values():
                rd.close()
            self._retired.clear()
            self._inflight.clear()

    def __enter__(self) -> "RegionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def reader(self) -> TACZReader:
        """The reader of the snapshot currently being served."""
        return self._reader

    @property
    def n_levels(self) -> int:
        """Level count of the serving snapshot."""
        return self._reader.n_levels

    @property
    def snapshot_crc(self) -> int:
        """Index CRC of the snapshot currently being served."""
        return self._reader.index_crc

    def maybe_reload(self) -> bool:
        """Swap to a republished snapshot; True when a swap happened.

        Cheap (one footer read) and safe to call per request.  A missing
        or truncated file keeps the current snapshot serving.  Cache
        entries are carried over for every level whose content signature
        matches the new snapshot; entries for changed levels are dropped.
        """
        crc = probe_index_crc(self.path)
        if crc is None or crc == self.snapshot_crc:
            return False
        with self._lock:
            if crc == self.snapshot_crc:                  # raced reload
                return False
            try:
                reader = open_snapshot(self.path, device=self.device)
            except (OSError, ValueError):
                return False
            old = self._reader
            keep = {li for li in range(min(old.n_levels, reader.n_levels))
                    if old.level_signature(li) == reader.level_signature(li)}
            if self._inflight.get(id(old), 0) == 0:
                old.close()
            else:
                self._retired[id(old)] = old
            self._reader = reader
            self._owned = self._compute_owned(reader)
            self._planner = DecodePlanner(reader, self._owned)
            self.cache.swap_generation(old.index_crc, reader.index_crc,
                                       keep)
        return True

    # ------------------------------- queries -------------------------------

    def get_regions(self, boxes: list[Box],
                    levels: list[int] | None = None,
                    ) -> list[list[ROILevel]]:
        """Serve a batch of boxes; one list of per-level crops per box.

        The whole batch is planned as one unit: overlapping boxes decode
        each hot sub-block once.  On a shard-filtered server, cells of
        foreign sub-blocks come back as zeros.

        :param boxes: half-open boxes in finest-grid cells.
        :param levels: restrict crops to these level indices (default:
            every level, finest first).
        :returns: ``out[b][l]`` = crop of ``boxes[b]`` at ``levels[l]``.
        :raises ValueError: if a level is out of range or a box malformed.
        :raises IOError: if a payload fails its CRC check.
        """
        return self.get_regions_with_crc(boxes, levels)[1]

    def get_regions_with_crc(self, boxes: list[Box],
                             levels: list[int] | None = None,
                             ) -> tuple[int, list[list[ROILevel]]]:
        """:meth:`get_regions` plus the index CRC of the snapshot that
        actually served the batch (a hot-swap may land mid-batch).

        :returns: ``(index_crc_of_serving_snapshot, results)``.
        """
        if self.auto_reload:
            self.maybe_reload()
        with self._lock:
            rd, planner = self._reader, self._planner
            self._inflight[id(rd)] = self._inflight.get(id(rd), 0) + 1
        span = obs.trace("get_regions")
        span.__enter__()
        t0 = time.perf_counter()
        try:
            hook = self.fault_hook
            if hook is not None:
                hook()
            obsm.SERVER_REGIONS.inc(len(boxes))
            lis = list(range(rd.n_levels)) if levels is None else \
                [int(li) for li in levels]
            for li in lis:
                if not 0 <= li < rd.n_levels:
                    raise ValueError(f"level {li} out of range "
                                     f"(0..{rd.n_levels - 1})")
            queries = [(li, box) for box in boxes for li in lis]
            with obs.trace("plan"):
                plans = planner.plan(queries)
            bricks = planner.fetch(plans, self.cache)

            def fetch_bricks(li, jobs):
                return [bricks[(li, sbi)] for sbi, _ in jobs]

            def fetch_level(li):
                return bricks[(li, WHOLE_LEVEL)]

            out: list[list[ROILevel]] = []
            it = iter(plans)
            for _ in boxes:
                per_box: list[ROILevel] = []
                for li in lis:
                    p = next(it)
                    if not p.owned:   # foreign whole-level key: zeros
                        data = torch.zeros(tuple(max(hi - lo, 0)
                                                 for lo, hi in p.lbox),
                                           dtype=torch.float32,
                                           device=rd.device)
                    else:
                        data = rd.assemble_level_roi(p.level, p.lbox,
                                                     fetch_bricks,
                                                     fetch_level,
                                                     tasks=p.tasks)
                    per_box.append(ROILevel(
                        level=p.level,
                        ratio=max(int(rd.levels[p.level].ratio), 1),
                        box=p.lbox, data=data))
                out.append(per_box)
            return rd.index_crc, out
        finally:
            span.__exit__(None, None, None)
            obsm.SERVER_REQUEST_SECONDS.labels().observe(
                time.perf_counter() - t0)
            with self._lock:
                n = self._inflight.get(id(rd), 1) - 1
                if n:
                    self._inflight[id(rd)] = n
                else:
                    self._inflight.pop(id(rd), None)
                    retired = self._retired.pop(id(rd), None)
                    if retired is not None:   # last request drained
                        retired.close()

    def get_regions_ex(self, boxes: list[Box],
                       levels: list[int] | None = None, *,
                       target=None, variant: str | None = None,
                       ) -> tuple[int, str | None, list[list[ROILevel]]]:
        """:meth:`get_regions_with_crc` plus distortion-target admission
        (:func:`resolve_single_target`).

        :param target: optional distortion target, e.g. ``"psnr>=60"``.
        :param variant: optional explicit variant name — rejected here
            (a single snapshot has no named variants).
        :returns: ``(snapshot_crc, variant_name, results)`` —
            ``variant_name`` is None when no target/variant was given.
        :raises ValueError: on a malformed target or a ``variant`` name.
        :raises repro_torch.io.frontier.TargetUnsatisfiable: when the
            target cannot be met.
        """
        name = None
        if variant is not None:
            raise ValueError(
                f"unknown variant {variant!r}: this endpoint serves a "
                f"single snapshot, not a variant set")
        if target is not None:
            name = resolve_single_target(self._reader, target)
        crc, out = self.get_regions_with_crc(boxes, levels)
        return crc, name, out

    def get_region(self, level: int, box: Box) -> ROILevel:
        """One level's crop of ``box`` (finest-grid cells).

        :raises ValueError: if ``level`` is out of range or ``box``
            malformed.
        """
        return self.get_regions([box], levels=[level])[0][0]

    def get_roi(self, box: Box) -> list[ROILevel]:
        """All levels' crops — the cached mirror of ``read_roi(box)``."""
        return self.get_regions([box])[0]

    # --------------------------- cache handoff -----------------------------
    #
    # Live resharding moves sub-block ownership between shard servers: the
    # old owner serializes its decoded bricks for the moved keys
    # (`cache_export`), the new owner ingests them (`cache_import`), and
    # only then does the old owner adopt the new shard map (`reshard`).
    # The blob is the reference's byte for byte (u32 header length + JSON
    # header + raw <f4 frames), with a per-entry zlib.crc32 over the frame
    # bytes and the exporter's snapshot CRC as integrity gates.

    def cache_export(self, keys: list[CacheKey]) -> bytes:
        """Serialize cached decoded bricks for ``keys`` into a handoff blob
        (the reference's bytes for the same bricks).

        Keys not currently cached are omitted; lookups bypass the LRU and
        the hit/miss counters.  The bricks are copied to the host in one
        transfer.

        :returns: the blob — u32 header length, JSON header
            (``snapshot_crc`` + per-entry ``level/sub_block/shape/offset/
            nbytes/crc32``), then the concatenated ``<f4`` frames.
        """
        if self.auto_reload:
            self.maybe_reload()
        gen = self.snapshot_crc
        found = []
        for li, sbi in keys:
            arr = self.cache.peek((gen, int(li), int(sbi)))
            if arr is not None:
                found.append((int(li), int(sbi), arr))
        host = (torch.cat([a.reshape(-1) for _, _, a in found]).cpu().numpy()
                if found else np.zeros(0, dtype=np.float32))
        data = host.astype("<f4", copy=False).tobytes()
        entries = []
        total = 0
        for li, sbi, arr in found:
            n = _nbytes(arr)
            entries.append({"level": li, "sub_block": sbi,
                            "shape": list(arr.shape),
                            "offset": total, "nbytes": n,
                            "crc32": zlib.crc32(
                                memoryview(data)[total:total + n])
                            & 0xFFFFFFFF})
            total += n
        hdr = json.dumps({"snapshot_crc": gen, "entries": entries},
                         sort_keys=True).encode()
        obsm.HANDOFF_KEYS.labels("export").inc(len(entries))
        obsm.HANDOFF_BYTES.labels("export").inc(total)
        return struct.pack("<I", len(hdr)) + hdr + data

    def cache_import(self, blob: bytes) -> dict:
        """Ingest a :meth:`cache_export` blob (from either package) into
        this server's cache, on its device.

        Per-entry gates, in order: entries of a *different snapshot
        generation* are counted ``skipped_stale``; entries this server
        does not *own* under its shard map are counted
        ``skipped_foreign``; a truncated frame or a ``crc32`` mismatch
        raises.  Ingest is all-or-nothing: every frame is CRC-verified
        before the first one touches the cache.

        :returns: ``imported``, ``skipped_foreign``, ``skipped_stale``,
            ``bytes``, ``snapshot_crc``.
        :raises ValueError: malformed blob, truncated frame, or CRC
            mismatch.
        """
        if self.auto_reload:
            self.maybe_reload()
        if len(blob) < 4:
            raise ValueError("handoff blob shorter than its length prefix")
        hlen = struct.unpack_from("<I", blob)[0]
        if 4 + hlen > len(blob):
            raise ValueError("handoff blob truncated inside its header")
        try:
            head = json.loads(blob[4:4 + hlen])
            src_crc = int(head["snapshot_crc"])
            entries = head["entries"]
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"malformed handoff header: {exc}") from None
        gen = self.snapshot_crc
        stale = (src_crc & 0xFFFFFFFF) != (gen & 0xFFFFFFFF)
        base = 4 + hlen
        imported = skipped_foreign = skipped_stale = nbytes = 0
        owned = self._owned
        admitted = []                       # verified (key, frame, shape)
        for e in entries:
            li, sbi = int(e["level"]), int(e["sub_block"])
            if stale:
                skipped_stale += 1
                continue
            if owned is not None and (li, sbi) not in owned:
                skipped_foreign += 1
                continue
            off, n = base + int(e["offset"]), int(e["nbytes"])
            frame = blob[off:off + n]
            if len(frame) != n:
                raise ValueError(
                    f"handoff frame truncated for ({li}, {sbi})")
            if zlib.crc32(frame) & 0xFFFFFFFF != int(e["crc32"]):
                raise ValueError(
                    f"handoff CRC mismatch for ({li}, {sbi})")
            admitted.append(((gen, li, sbi), frame,
                             tuple(int(s) for s in e["shape"])))
        for key, frame, shape in admitted:
            arr = np.frombuffer(frame, dtype="<f4").reshape(shape)
            self.cache.put(key, torch.from_numpy(arr.copy()).to(self.device))
            imported += 1
            nbytes += len(frame)
        obsm.HANDOFF_KEYS.labels("import").inc(imported)
        obsm.HANDOFF_BYTES.labels("import").inc(nbytes)
        return {"imported": imported, "skipped_foreign": skipped_foreign,
                "skipped_stale": skipped_stale, "bytes": nbytes,
                "snapshot_crc": gen}

    def reshard(self, shard_map, shard_id: str | None = None) -> int:
        """Adopt a new shard map, dropping cache entries for keys this
        server no longer owns.

        :param shard_map: the new map (``owner(key) -> shard_id``).
        :param shard_id: this server's shard in the new map (defaults to
            its current ``shard_id``).
        :returns: number of cache entries dropped (now-foreign keys).
        """
        with self._lock:
            self.shard_map = shard_map
            if shard_id is not None:
                self.shard_id = shard_id
            self._owned = self._compute_owned(self._reader)
            self._planner = DecodePlanner(self._reader, self._owned)
            owned = self._owned
        if owned is None:
            return 0
        return self.cache.drop(
            lambda k: len(k) == 3 and (k[1], k[2]) not in owned)

    def stats(self) -> dict:
        """Cache counters plus snapshot identity (and shard info when
        shard-filtered).

        Also refreshes the ``tacz_cache_*`` gauges of the default obs
        registry and reports ``latency``: request count plus p50/p90/p99
        and mean estimates (milliseconds) from the process-wide
        ``tacz_server_request_seconds`` histogram.

        :returns: dict with ``hits/misses/evictions/entries/bytes/
            budget_bytes/snapshot_crc/n_levels/latency`` and, on a shard,
            ``shard`` = ``{shard_id, n_shards, owned_keys}``.
        """
        s = self.cache.stats()
        obsm.refresh_cache_gauges(s)
        s["snapshot_crc"] = self.snapshot_crc
        s["n_levels"] = self.n_levels
        hist = obsm.SERVER_REQUEST_SECONDS.labels()
        lat = {"count": hist.count}
        for q, key in ((0.5, "p50_ms"), (0.9, "p90_ms"), (0.99, "p99_ms")):
            est = hist.quantile(q)
            lat[key] = None if est is None else round(est * 1000.0, 3)
        mean = hist.mean()
        lat["mean_ms"] = None if mean is None else round(mean * 1000.0, 3)
        s["latency"] = lat
        if self.shard_map is not None:
            s["shard"] = {"shard_id": self.shard_id,
                          "n_shards": len(self.shard_map),
                          "owned_keys": len(self._owned or ())}
        return s

    def health(self) -> dict:
        """Liveness/readiness report: the ``snapshot`` check (footer CRC
        readable — else ``down`` — and equal to the serving snapshot —
        else ``degraded``), ``cache`` headroom, and on a shard-filtered
        server the ``shard`` identity and owned-key count.

        :returns: dict with ``status`` (``"ok"`` | ``"degraded"`` |
            ``"down"``), ``role``, ``snapshot_crc`` and per-check detail
            under ``checks``.  Never raises.
        """
        checks: dict = {}
        status = "ok"
        try:
            probe = probe_index_crc(self.path)
        except Exception:   # unreadable path: treat like a failed probe
            probe = None
        if probe is None:
            status = "down"
        elif probe != self.snapshot_crc:
            status = "degraded"
        checks["snapshot"] = {"ok": probe is not None,
                              "serving_crc": self.snapshot_crc,
                              "file_crc": probe,
                              "stale": (None if probe is None
                                        else probe != self.snapshot_crc)}
        cs = self.cache.stats()
        headroom = 1.0 - cs["bytes"] / cs["budget_bytes"]
        checks["cache"] = {"ok": True,
                           "budget_bytes": cs["budget_bytes"],
                           "bytes": cs["bytes"],
                           "headroom": round(headroom, 4)}
        if self.shard_map is not None:
            owned = len(self._owned or ())
            checks["shard"] = {"ok": owned > 0,
                               "shard_id": self.shard_id,
                               "n_shards": len(self.shard_map),
                               "owned_keys": owned}
        return {"status": status, "role": "server",
                "snapshot_crc": self.snapshot_crc, "checks": checks}
