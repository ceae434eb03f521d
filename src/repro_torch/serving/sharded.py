"""``repro_torch.serving.sharded`` — sharded region serving (the port
of ``repro.serving.sharded``).

One :class:`~repro_torch.serving.regions.RegionServer` caps the warm
working set at one server's cache budget.  This module spreads the
``(level, sub_block)`` key universe of a snapshot over N shard servers
and reassembles full crops on the way back:

  * :class:`ShardMap` — deterministic rendezvous (highest-random-weight)
    placement of ``(level, sub_block)`` keys onto named shards, by the
    rule of :mod:`repro_torch.io.placement`: stable under shard
    add/remove, independent of shard-list order and of
    ``PYTHONHASHSEED``, and serializable, so a router and its shard
    servers built from one config agree on every owner.
  * :class:`ShardedRegionRouter` — plans a batch with the same
    :class:`~repro_torch.serving.regions.DecodePlanner` box→sub-block
    mapping the servers use, scatter-gathers one ``POST /v1/regions``
    per (shard, level) group over the reference's wire format, pastes the
    returned crops, and falls back per group — replica endpoints first,
    then a decode on the router's own device — so one unreachable shard
    costs throughput, not availability or correctness.

Each shard runs the stock ``RegionServer``/``http_api`` stack with a
shard filter (``RegionServer(shard_map=..., shard_id=...)``): it decodes
and caches only owned sub-blocks, so N shards hold N disjoint cache
slices.  Crops are bit-identical to a single unsharded server's, because
every cell comes from exactly one owner through the reader's shared
assembly.  Snapshot hot swaps propagate through the footer ``index_crc``
(a directory's manifest CRC): the router revalidates its own snapshot per
batch, and a shard answering for another generation is treated as failed
for that batch.

On the router's side a batch's HTTP crops are pasted into one host
staging buffer (pinned for a CUDA router) and reach the router's device
in one copy; fallback crops are decoded and placed on the device, one
launch of kernel 4 a (shard, level) group and one of kernel 2 a shape
group.  The router's crops are tensors on its device, as a
``RegionServer``'s are, so ``http_api.serve`` mounts a router unchanged.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from .. import obs
from ..io import placement
from ..io import variants as vrt
from ..io.reader import (WHOLE_LEVEL, Box, ROILevel, TACZReader,
                         open_snapshot, probe_index_crc)
from ..obs import metrics as obsm
from .client import RegionAPIError, RegionClient
from .regions import CacheKey, DecodePlanner, resolve_single_target

__all__ = ["ShardMap", "ShardedRegionRouter"]


class ShardMap:
    """Deterministic rendezvous-hash placement of sub-block keys.

    Every ``(level, sub_block)`` key scores each shard with a keyed
    64-bit BLAKE2b of ``(seed, level, sub_block, shard_id)`` and is owned
    by the highest score.  Rendezvous hashing gives the two properties a
    serving fleet needs when resizing:

      * adding a shard moves only the keys whose new highest score is the
        added shard (~``1/(N+1)`` of them) — no key moves between two
        pre-existing shards;
      * removing a shard moves only the keys it owned.

    Ownership is a pure function of ``(shards, seed, key)``: it does not
    depend on shard-list order, process, platform, or ``PYTHONHASHSEED``,
    so a router and its shard servers agree as long as they were built
    from the same serialized config (:meth:`to_json`/:meth:`from_json`).

    The scoring function itself lives in :mod:`repro_torch.io.placement`:
    the same rule the multi-part writer (:mod:`repro_torch.io.parallel`)
    partitions part files with, so a map built from a multi-part
    manifest's ``partition`` config assigns each shard exactly the keys
    its part file holds.

    :param shards: shard identifiers (non-empty unique strings) — usually
        the names the deployment uses to look up endpoints.
    :param seed: placement salt; changing it reshuffles every key.
    :raises ValueError: on an empty/duplicate shard list or empty ids.
    """

    _ALGORITHM = placement.ALGORITHM

    def __init__(self, shards, *, seed: int = 0):
        shards = [str(s) for s in shards]
        if not shards:
            raise ValueError("ShardMap needs at least one shard")
        if any(not s for s in shards):
            raise ValueError("shard ids must be non-empty strings")
        if len(set(shards)) != len(shards):
            raise ValueError(f"duplicate shard ids in {shards!r}")
        self.shards: tuple[str, ...] = tuple(sorted(shards))
        self.seed = int(seed)

    # ------------------------------ placement ------------------------------

    def _score(self, shard: str, key: CacheKey) -> int:
        return placement.score(self.seed, key, shard)

    def owner(self, key: CacheKey) -> str:
        """The shard owning one ``(level, sub_block)`` key.

        :param key: ``(level_index, sub_block_index)``;
            ``sub_block_index`` is :data:`~repro_torch.io.reader.WHOLE_LEVEL`
            for single-payload levels.
        :returns: the owning shard id.
        """
        return placement.owner(self.shards, self.seed, key)

    def partition(self, keys) -> dict[str, list[CacheKey]]:
        """Group keys by owner.

        :param keys: iterable of ``(level, sub_block)`` keys.
        :returns: ``{shard_id: [keys it owns]}`` — only shards owning at
            least one key appear.
        """
        out: dict[str, list[CacheKey]] = {}
        for key in keys:
            out.setdefault(self.owner(key), []).append(key)
        return out

    # ------------------------------ resizing -------------------------------

    def with_shard(self, shard_id: str) -> "ShardMap":
        """A new map with ``shard_id`` added (same seed).

        :raises ValueError: if the shard already exists.
        """
        return ShardMap(self.shards + (str(shard_id),), seed=self.seed)

    def without_shard(self, shard_id: str) -> "ShardMap":
        """A new map with ``shard_id`` removed (same seed).

        :raises ValueError: if the shard is unknown, or it was the last.
        """
        if str(shard_id) not in self.shards:
            raise ValueError(f"unknown shard {shard_id!r}")
        return ShardMap([s for s in self.shards if s != str(shard_id)],
                        seed=self.seed)

    def grow(self, shard_id: str, keys,
             ) -> tuple["ShardMap", list[CacheKey]]:
        """The map with ``shard_id`` added, plus exactly which of
        ``keys`` change owner — the live-resharding work list.

        Rendezvous hashing guarantees every moved key's *new* owner is
        the added shard (no key moves between two pre-existing shards),
        and only ~``1/(N+1)`` of the keys move at all.  The moved list
        drives the cache handoff: each moved key's old owner exports its
        decoded brick, the new shard imports it, and the fleet serves
        warm through the transition.

        :param shard_id: the shard to add.
        :param keys: the key universe to diff ownership over (normally
            ``reader.subblock_keys()``).
        :returns: ``(new_map, moved_keys)``.
        :raises ValueError: if the shard already exists.
        """
        new = self.with_shard(shard_id)
        moved = [k for k in keys if self.owner(k) != new.owner(k)]
        return new, moved

    # ---------------------------- serialization ----------------------------

    def to_dict(self) -> dict:
        """JSON-safe config; :meth:`from_dict` rebuilds an equal map."""
        return {"algorithm": self._ALGORITHM, "seed": self.seed,
                "shards": list(self.shards)}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        """Inverse of :meth:`to_dict`.

        :raises ValueError: if the config names a different placement
            algorithm (a config from a future/incompatible version must
            fail loudly, not silently place keys elsewhere).
        """
        algo = d.get("algorithm", cls._ALGORITHM)
        if algo != cls._ALGORITHM:
            raise ValueError(f"unsupported shard-map algorithm {algo!r}")
        return cls(d["shards"], seed=int(d.get("seed", 0)))

    def to_json(self) -> str:
        """Canonical JSON form of :meth:`to_dict` (stable key order)."""
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ShardMap":
        """Inverse of :meth:`to_json`."""
        return cls.from_dict(json.loads(s))

    # ------------------------------- dunder --------------------------------

    def __len__(self) -> int:
        return len(self.shards)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ShardMap) and self.shards == other.shards
                and self.seed == other.seed)

    def __hash__(self) -> int:
        return hash((self.shards, self.seed))

    def __repr__(self) -> str:
        return f"ShardMap(shards={list(self.shards)!r}, seed={self.seed})"


class _Part:
    """One rectangle of one planned (box, level) query: where it comes
    from (level-cell intersection box, inside sub-block ``sbi`` or a
    whole level) and where it lands (plan index)."""

    __slots__ = ("plan_idx", "isect", "sbi")

    def __init__(self, plan_idx: int, isect: Box, sbi: int = WHOLE_LEVEL):
        self.plan_idx = plan_idx
        self.isect = isect
        self.sbi = sbi


class ShardedRegionRouter:
    """Scatter-gather region queries across shard-filtered region servers.

    The router plans a batch exactly like a single
    :class:`~repro_torch.serving.regions.RegionServer` (same
    :class:`~repro_torch.serving.regions.DecodePlanner` box→sub-block
    mapping against a local reader of the same snapshot), assigns every
    needed sub-block to its owner through the :class:`ShardMap`, and
    issues one batched ``POST /v1/regions`` per (shard, level) group —
    concurrently, over the reference's wire format.  Each returned crop
    covers the intersection of one query box with one owned sub-block (or
    a whole gsp/global level), and is pasted into the output at the
    offsets the single server's assembly would write, which is why the
    result is bit-identical to an unsharded ``get_regions``.

    Failure handling is per group: endpoints for a shard are tried in
    order (primary, then replicas); a connection error, HTTP error,
    malformed response, or a shard answering for a *different snapshot
    generation* (footer ``index_crc`` mismatch) moves to the next
    endpoint, and when all are exhausted the group is decoded from the
    local snapshot on the router's device — one fetch of the group's
    sub-blocks through the reader's batched prefix decode (one launch of
    kernel 4 and one of kernel 2 a shape group), each part cropped from
    its brick — unless ``local_fallback=False``, in which case the batch
    raises.

    Crops are float32 tensors on ``device``; the crops of one batch are
    disjoint views of one buffer the batch allocates (they alias no cache
    entry and nothing outside the batch).

    :param path: local path of the snapshot — a ``.tacz`` file, a
        multi-part snapshot directory, or a multi-variant set directory
        (``variants.json`` catalog; distortion-target batches then route
        per selected variant) — used for planning and for the fallback
        decode.
    :param shard_map: the :class:`ShardMap` the shard servers were
        configured with (same serialized config — ownership must agree).
    :param endpoints: ``{shard_id: url}`` or ``{shard_id: [url, ...]}``
        (first is primary, rest are replicas).  A shard missing from the
        dict is served through the local fallback.
    :param timeout: per-request socket timeout, seconds.
    :param local_fallback: decode groups locally when every endpoint of
        the owning shard failed (default True).
    :param auto_reload: revalidate the local snapshot (footer CRC) at the
        start of every batch, like the servers do per request.
    :param max_workers: concurrent shard requests per batch.
    :param load_balance: rotate read traffic across a shard's healthy
        endpoints (round-robin per request group) instead of always
        hitting the primary.  An endpoint that fails is demoted to last
        place until it next succeeds; correctness is unchanged either way.
    :param busy_retries: per request group, how many 429/503 +
        ``Retry-After`` rejections to wait out *on the same endpoint*
        before treating it as failed.  Busy is not down: these waits are
        counted as retries but never as endpoint failures, and never
        demote the endpoint.
    :param busy_backoff_cap: upper bound in seconds on each honored
        ``Retry-After`` sleep.
    :param device: where the crops land and the fallback decodes
        (default ``"cuda"``).
    :raises ValueError: if the snapshot fails validation.
    :raises OSError: if the snapshot cannot be opened.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """

    def __init__(self, path, shard_map: ShardMap,
                 endpoints: dict[str, str | list[str]], *,
                 timeout: float = 30.0, local_fallback: bool = True,
                 auto_reload: bool = True, max_workers: int = 8,
                 load_balance: bool = False, busy_retries: int = 2,
                 busy_backoff_cap: float = 2.0,
                 device: str | torch.device = "cuda"):
        self.path = str(path)
        self.shard_map = shard_map
        self.endpoints: dict[str, list[str]] = {
            str(sid): [urls] if isinstance(urls, str) else list(urls)
            for sid, urls in endpoints.items()}
        self.timeout = float(timeout)
        self.local_fallback = bool(local_fallback)
        self.auto_reload = bool(auto_reload)
        self.load_balance = bool(load_balance)
        self.busy_retries = max(0, int(busy_retries))
        self.busy_backoff_cap = float(busy_backoff_cap)
        self._rotation: dict[str, int] = {}      # per-shard round-robin
        self._unhealthy: set[str] = set()        # demoted endpoint urls
        self._clients: dict[str, RegionClient] = {}
        self._lock = threading.Lock()
        # a variant-set directory routes per selected eb variant: the
        # default variant is the always-open planning snapshot, the rest
        # open lazily on first request.  The sub-block partition depends
        # only on index geometry, which eb does not change, so one shard
        # map covers every variant.
        self._catalog = None
        self._default_variant: str | None = None
        self._variant_paths: dict[str, str] = {}
        self._var_readers: dict[str, tuple[TACZReader, DecodePlanner]] = {}
        self._probe_path = self.path
        if vrt.is_variant_set(self.path):
            self._catalog = vrt.load_catalog(self.path)
            set_dir = self.path
            if os.path.basename(set_dir) == vrt.VARIANTS_NAME:
                set_dir = os.path.dirname(set_dir)
            self._default_variant = str(self._catalog["default"])
            self._variant_paths = {
                str(v["name"]): os.path.join(set_dir, v["file"])
                for v in self._catalog["variants"]}
            self._probe_path = self._variant_paths[self._default_variant]
        self._reader = open_snapshot(self._probe_path, device=device)
        self.device = self._reader.device
        self._planner = DecodePlanner(self._reader)
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(max_workers)),
                                        thread_name_prefix="shard-router")
        # readers displaced by a reload, with per-reader in-flight counts:
        # each retired reader closes when *its* last batch finishes
        self._inflight: dict[int, int] = {}
        self._retired: dict[int, TACZReader] = {}
        self.counters = {"batches": 0, "shard_requests": 0,
                         "endpoint_failures": 0, "local_fallbacks": 0,
                         "retries": 0, "demotions": 0}

    # ------------------------------ lifecycle ------------------------------

    def close(self) -> None:
        """Release the thread pool and every reader (current + retired)."""
        self._pool.shutdown(wait=True)
        with self._lock:
            self._reader.close()
            for rd, _ in self._var_readers.values():
                rd.close()
            self._var_readers.clear()
            for rd in self._retired.values():
                rd.close()
            self._retired.clear()
            self._inflight.clear()

    def __enter__(self) -> "ShardedRegionRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def snapshot_crc(self) -> int:
        """Index CRC of the snapshot the router currently plans against."""
        return self._reader.index_crc

    @property
    def reader(self) -> TACZReader:
        """The local reader the router plans (and falls back) against —
        the property :class:`~repro_torch.serving.regions.RegionServer`
        exposes, so ``http_api.serve`` can mount a router unchanged."""
        return self._reader

    @property
    def n_levels(self) -> int:
        """Level count of the planning snapshot."""
        return self._reader.n_levels

    def maybe_reload(self) -> bool:
        """Adopt a republished local snapshot; True when a swap happened.

        One footer (or manifest) read; a missing, truncated or corrupt
        snapshot keeps the current one.  After a swap, shard responses
        carrying the old generation's CRC fail validation and fall back,
        so a batch never mixes generations.
        """
        crc = probe_index_crc(self._probe_path)
        if crc is None or crc == self.snapshot_crc:
            return False
        with self._lock:
            if crc == self.snapshot_crc:
                return False
            try:
                reader = open_snapshot(self._probe_path, device=self.device)
            except (OSError, ValueError):
                return False
            old = self._reader
            if self._inflight.get(id(old), 0) == 0:
                old.close()
            else:
                self._retired[id(old)] = old
            self._reader = reader
            self._planner = DecodePlanner(reader)
        return True

    # ------------------------------- scatter -------------------------------

    def _client(self, url: str) -> RegionClient:
        # busy_retries=0: the backpressure policy lives in _fetch_group
        with self._lock:
            cli = self._clients.get(url)
            if cli is None:
                cli = self._clients[url] = RegionClient(
                    url, timeout=self.timeout, busy_retries=0)
            return cli

    # router counters mirror into the process-wide obs registry so one
    # /v1/metrics scrape covers the fan-out series too
    _COUNTER_METRICS = {
        "batches": obsm.ROUTER_BATCHES,
        "shard_requests": obsm.ROUTER_SHARD_REQUESTS,
        "endpoint_failures": obsm.ROUTER_ENDPOINT_FAILURES,
        "local_fallbacks": obsm.ROUTER_LOCAL_FALLBACKS,
        "retries": obsm.ROUTER_RETRIES,
        "demotions": obsm.ROUTER_DEMOTIONS,
    }

    def _count(self, counter: str) -> None:
        with self._lock:   # += from pool threads is not atomic
            self.counters[counter] += 1
        self._COUNTER_METRICS[counter].inc()

    def _endpoint_order(self, shard: str) -> list[str]:
        """The order this request group walks the shard's endpoints:
        as configured (failover only), or with ``load_balance=True``
        round-robin per request group with demoted endpoints last."""
        urls = self.endpoints.get(shard, ())
        if not self.load_balance or len(urls) < 2:
            return list(urls)
        with self._lock:
            k = self._rotation[shard] = self._rotation.get(shard, -1) + 1
            unhealthy = set(self._unhealthy)
        k %= len(urls)
        rotated = list(urls[k:]) + list(urls[:k])
        return ([u for u in rotated if u not in unhealthy]
                + [u for u in rotated if u in unhealthy])

    def _mark_endpoint(self, url: str, healthy: bool) -> None:
        demoted = False
        with self._lock:
            if healthy:
                self._unhealthy.discard(url)
            else:
                demoted = url not in self._unhealthy
                self._unhealthy.add(url)
        if demoted:   # count transitions, not repeated failures
            self._count("demotions")

    def _fetch_group(self, rd: TACZReader, shard: str, li: int,
                     parts: list[_Part], request_id: str = "",
                     variant: str | None = None,
                     ) -> tuple[list, dict]:
        """Crops for one (shard, level) group, in ``parts`` order, plus a
        fan-out summary for the batch's response metadata.

        Tries the shard's endpoints (see :meth:`_endpoint_order`); every
        failure mode — unreachable, HTTP error, stale snapshot
        generation, mis-shaped response — moves on, and the local reader
        is the last resort.  A 429/503 carrying ``Retry-After`` means
        *busy*: the group waits out the hint (capped, up to
        ``busy_retries`` times) and retries the same endpoint without
        counting a failure or demoting it.  Attempts beyond the first
        count as retries; the group's wall time lands in
        ``tacz_router_shard_seconds{shard=...}``.

        A shard's crops are host arrays (the client's); the fallback's
        are tensors on the router's device (see :meth:`_local_crops`).
        The summary carries ``shard``, ``level``, ``ms``, the
        ``endpoint`` that served (``"local"`` on fallback), and the
        shard's ``trace`` span summary when it returned one.

        :raises RuntimeError: when every endpoint failed and
            ``local_fallback`` is off.
        """
        t0 = time.perf_counter()
        r = max(int(rd.levels[li].ratio), 1)
        boxes_f = [tuple((lo * r, hi * r) for lo, hi in p.isect)
                   for p in parts]
        want_crc = rd.index_crc
        errors: list[str] = []

        def _summary(endpoint: str, remote: dict | None) -> dict:
            dt = time.perf_counter() - t0
            obsm.ROUTER_SHARD_SECONDS.labels(shard).observe(dt)
            info = {"shard": shard, "level": li, "endpoint": endpoint,
                    "ms": round(dt * 1000.0, 3)}
            if remote:
                info["trace"] = remote
            return info

        attempts = 0
        for url in self._endpoint_order(shard):
            busy_left = self.busy_retries
            while True:
                try:
                    self._count("shard_requests")
                    if attempts:
                        self._count("retries")
                    attempts += 1
                    header, results = self._client(url).regions_ex(
                        boxes_f, levels=[li],
                        request_id=request_id or None, variant=variant)
                    crc = int(header["snapshot_crc"])
                    if (crc & 0xFFFFFFFF) != want_crc:
                        raise ValueError(
                            f"snapshot mismatch: shard serves {crc:#x}, "
                            f"router plans against {want_crc:#x}")
                    crops = []
                    for part, per_box in zip(parts, results):
                        roi = per_box[0]
                        if tuple(roi.box) != tuple(part.isect):
                            raise ValueError(
                                f"shard returned box {roi.box}, "
                                f"wanted {part.isect}")
                        crops.append(roi.data)
                    self._mark_endpoint(url, healthy=True)
                    return crops, _summary(url, header.get("trace"))
                except RegionAPIError as exc:
                    ra = (exc.headers.get("Retry-After")
                          if exc.headers else None)
                    if (exc.code in (429, 503) and ra is not None
                            and busy_left):
                        busy_left -= 1
                        try:
                            delay = float(ra)
                        except ValueError:
                            delay = 1.0
                        time.sleep(min(max(delay, 0.0),
                                       self.busy_backoff_cap))
                        continue
                    self._count("endpoint_failures")
                    self._mark_endpoint(url, healthy=False)
                    errors.append(f"{url}: {exc}")
                    break
                except Exception as exc:  # noqa: BLE001 — per endpoint
                    self._count("endpoint_failures")
                    self._mark_endpoint(url, healthy=False)
                    errors.append(f"{url}: {exc}")
                    break
        if not self.local_fallback:
            raise RuntimeError(
                f"shard {shard!r} unreachable for level {li} and local "
                f"fallback is disabled: {'; '.join(errors) or 'no endpoints'}")
        self._count("local_fallbacks")
        return self._local_crops(rd, li, parts), _summary("local", None)

    @staticmethod
    def _local_crops(rd: TACZReader, li: int,
                     parts: list[_Part]) -> list[torch.Tensor]:
        """The fallback: one group's crops decoded from the local
        snapshot on its device, each ``rd.read_level_box(li,
        part.isect)``.  Every sub-block the group touches decodes in one
        fetch through the reader's batched prefix decode, to the furthest
        corner any of its parts needs (one launch of kernel 4, one of
        kernel 2 a shape group); a whole-level group decodes its level
        once.  Each part is then assembled by the reader from its brick."""
        hi_max: dict[int, tuple[int, ...]] = {}
        subblocks = rd.levels[li].subblocks
        for p in parts:
            if p.sbi == WHOLE_LEVEL:
                continue
            hi = tuple(h - o for (_, h), o
                       in zip(p.isect, subblocks[p.sbi].origin))
            prev = hi_max.get(p.sbi)
            hi_max[p.sbi] = hi if prev is None else tuple(
                max(a, b) for a, b in zip(prev, hi))
        bricks = dict(zip(hi_max, rd._fetch_bricks_prefix(
            li, list(hi_max.items())))) if hi_max else {}
        level: list[torch.Tensor] = []

        def fetch_bricks(li, jobs):
            return [bricks[sbi] for sbi, _ in jobs]

        def fetch_level(li):
            if not level:
                level.append(rd.read_level(li))
            return level[0]

        return [rd.assemble_level_roi(
                    li, p.isect, fetch_bricks, fetch_level,
                    tasks=None if p.sbi == WHOLE_LEVEL else [(p.sbi, p.isect)])
                for p in parts]

    # ------------------------------- queries -------------------------------

    def get_regions(self, boxes: list[Box],
                    levels: list[int] | None = None,
                    ) -> list[list[ROILevel]]:
        """Serve a batch of boxes across the shard fleet.

        Bit-identical to a single unsharded
        ``RegionServer.get_regions(boxes, levels)`` on the same snapshot,
        including when shards are unreachable (fallback path).

        :param boxes: half-open boxes in finest-grid cells.
        :param levels: restrict crops to these level indices (default:
            every level, finest first).
        :returns: ``out[b][l]`` = crop of ``boxes[b]`` at ``levels[l]``.
        :raises ValueError: if a level is out of range or a box malformed.
        :raises RuntimeError: if a shard is unreachable and
            ``local_fallback`` is disabled.
        """
        return self.get_regions_meta(boxes, levels)[0]

    def _resolve_variant(self, target, variant) -> str | None:
        """The variant name a batch's ``target``/``variant`` binds to:
        over a single snapshot the target is checked against the local
        reader's frontier; over a variant set the catalog picks the
        cheapest satisfying variant *locally*, so every shard of the
        batch is pinned to the same choice.

        :raises ValueError: unknown variant name / malformed target.
        :raises repro_torch.io.frontier.TargetUnsatisfiable: no variant
            satisfies the target.
        """
        if self._catalog is None:
            if variant is not None:
                raise ValueError(
                    f"unknown variant {variant!r}: this router serves a "
                    f"single snapshot, not a variant set")
            if target is None:
                return None
            return resolve_single_target(self._reader, target)
        if variant is None and target is None:
            return None
        if variant is not None:
            name = str(variant)
            if name not in self._variant_paths:
                raise ValueError(
                    f"unknown variant {variant!r} (catalog has: "
                    f"{', '.join(sorted(self._variant_paths))})")
        else:
            try:
                name = str(vrt.select_variant(self._catalog,
                                              target)["name"])
            except vrt.TargetUnsatisfiable:
                obsm.VARIANT_UNSATISFIED.inc()
                raise
        obsm.VARIANT_REQUESTS.labels(name).inc()
        return name

    def _rd_planner_locked(self, name: str | None,
                           ) -> tuple[TACZReader, DecodePlanner]:
        """Reader+planner for one resolved variant (caller holds the
        lock).  The default variant *is* the hot-swappable planning
        snapshot; other variants open lazily and live until close."""
        if (name is None or self._catalog is None
                or name == self._default_variant):
            return self._reader, self._planner
        pair = self._var_readers.get(name)
        if pair is None:
            rd = open_snapshot(self._variant_paths[name], device=self.device)
            pair = (rd, DecodePlanner(rd))
            self._var_readers[name] = pair
        return pair

    def get_regions_ex(self, boxes: list[Box],
                       levels: list[int] | None = None, *,
                       target=None, variant: str | None = None,
                       ) -> tuple[int, str | None, list[list[ROILevel]]]:
        """Distortion-aware batch — the router-side mirror of
        :meth:`RegionServer.get_regions_ex` /
        :meth:`repro_torch.serving.variants.VariantServer.get_regions_ex`.
        The variant is resolved locally, stamped into every shard request
        of the batch, and each shard's response must carry that variant's
        snapshot CRC, so a batch never mixes variants.

        :returns: ``(snapshot_crc, variant_name, results)``.
        :raises ValueError: unknown variant name / malformed target.
        :raises repro_torch.io.frontier.TargetUnsatisfiable: no variant
            satisfies the target (HTTP layer maps it to a 400).
        """
        out, meta = self.get_regions_meta(boxes, levels, target=target,
                                          variant=variant)
        return int(meta["snapshot_crc"]), meta.get("variant"), out

    def get_regions_meta(self, boxes: list[Box],
                         levels: list[int] | None = None, *,
                         target=None, variant: str | None = None,
                         ) -> tuple[list[list[ROILevel]], dict]:
        """:meth:`get_regions` plus the batch's fan-out metadata.

        One request ID per batch is stamped on every shard request
        (``X-Repro-Request-Id``).  The metadata aggregates each (shard,
        level) group's outcome — endpoint served, wall milliseconds, and
        the shard's own span summary when it returned one.

        :param target: optional distortion target (``"psnr>=60"``).
        :param variant: optional explicit variant name.
        :returns: ``(out, meta)`` where ``meta`` has ``request_id``,
            ``snapshot_crc`` (the generation that served the batch),
            ``variant`` (the resolved variant name, or None), ``ms``
            (whole-batch wall time), and ``shards`` — one summary dict
            per fan-out group, slowest first.
        """
        rid = obs.new_request_id()
        t_batch = time.perf_counter()
        name = self._resolve_variant(target, variant)
        # only variant-set deployments understand the wire field; a
        # single-snapshot target was fully validated locally above
        wire_variant = name if self._catalog is not None else None
        if self.auto_reload:
            self.maybe_reload()
        with self._lock:
            rd, planner = self._rd_planner_locked(name)
            self._inflight[id(rd)] = self._inflight.get(id(rd), 0) + 1
            # pin the shard map for the whole batch: a concurrent
            # apply_shard_map must not re-owner keys mid-scatter
            smap = self.shard_map
        try:
            lis = list(range(rd.n_levels)) if levels is None else \
                [int(li) for li in levels]
            for li in lis:
                if not 0 <= li < rd.n_levels:
                    raise ValueError(f"level {li} out of range "
                                     f"(0..{rd.n_levels - 1})")
            self._count("batches")
            plans = planner.plan([(li, box) for box in boxes for li in lis])

            # scatter: group every needed rectangle by (owner shard, level)
            groups: dict[tuple[str, int], list[_Part]] = {}
            for pi, p in enumerate(plans):
                if p.whole_level:
                    owner = smap.owner((p.level, WHOLE_LEVEL))
                    groups.setdefault((owner, p.level), []).append(
                        _Part(pi, p.lbox))
                else:
                    for sbi, isect in p.tasks:
                        owner = smap.owner((p.level, sbi))
                        groups.setdefault((owner, p.level), []).append(
                            _Part(pi, isect, sbi))

            futures = {gk: self._pool.submit(self._fetch_group, rd,
                                             gk[0], gk[1], parts, rid,
                                             wire_variant)
                       for gk, parts in groups.items()}
            # settle every group before consuming any result: a raising
            # group must not leave siblings still decoding from a reader
            # the finally block may let a hot swap close
            wait(list(futures.values()))
            results = {gk: fut.result() for gk, fut in futures.items()}
            datas = self._gather(plans, groups, results)

            out: list[list[ROILevel]] = []
            it = iter(range(len(plans)))
            for _ in boxes:
                per_box: list[ROILevel] = []
                for li in lis:
                    pi = next(it)
                    p = plans[pi]
                    per_box.append(ROILevel(
                        level=p.level,
                        ratio=max(int(rd.levels[p.level].ratio), 1),
                        box=p.lbox, data=datas[pi]))
                out.append(per_box)
            shard_infos = sorted((info for _, info in results.values()),
                                 key=lambda i: i["ms"], reverse=True)
            dt = time.perf_counter() - t_batch
            obsm.ROUTER_BATCH_SECONDS.labels().observe(dt)
            meta = {"request_id": rid,
                    "snapshot_crc": rd.index_crc,
                    "variant": name,
                    "ms": round(dt * 1000.0, 3),
                    "shards": shard_infos}
            return out, meta
        finally:
            with self._lock:
                n = self._inflight.get(id(rd), 1) - 1
                if n:
                    self._inflight[id(rd)] = n
                else:
                    self._inflight.pop(id(rd), None)
                    retired = self._retired.pop(id(rd), None)
                    if retired is not None:   # last batch on it drained
                        retired.close()

    def _gather(self, plans, groups: dict, results: dict,
                ) -> list[torch.Tensor]:
        """Paste every group's crops at the offsets the single server's
        assembly writes (``isect`` relative to the plan's ``lbox``), into
        one zeroed buffer holding every plan's crop.  The shards' host
        crops are pasted into a host staging buffer (pinned for a CUDA
        router) that reaches the device in one copy; the fallback's
        device crops are pasted after it, on the device."""
        shapes = [tuple(max(hi - lo, 0) for lo, hi in p.lbox) for p in plans]
        offs = [0]
        for shape in shapes:
            offs.append(offs[-1] + int(np.prod(shape, dtype=np.int64)))
        total = max(offs[-1], 1)
        host_parts, dev_parts = [], []
        for gk, (crops, _) in results.items():
            for part, crop in zip(groups[gk], crops):
                (dev_parts if isinstance(crop, torch.Tensor)
                 else host_parts).append((part, crop))

        def dst(part: _Part) -> tuple[slice, ...]:
            lbox = plans[part.plan_idx].lbox
            return tuple(slice(lo - b0, hi - b0)
                         for (lo, hi), (b0, _) in zip(part.isect, lbox))

        if host_parts:
            host = torch.zeros(total, dtype=torch.float32,
                               pin_memory=self.device.type == "cuda")
            flat = host.numpy()
            for part, crop in host_parts:
                pi = part.plan_idx
                flat[offs[pi]:offs[pi + 1]].reshape(shapes[pi])[
                    dst(part)] = crop
            buf = host.to(self.device, non_blocking=True)
        else:
            buf = torch.zeros(total, dtype=torch.float32, device=self.device)
        views = [buf[offs[i]:offs[i + 1]].view(shapes[i])
                 for i in range(len(plans))]
        for part, crop in dev_parts:
            views[part.plan_idx][dst(part)] = crop
        return views

    def apply_shard_map(self, shard_map: ShardMap,
                        endpoints: dict | None = None) -> None:
        """Atomically adopt a new shard map (live resharding).

        In-flight batches finish against the map they started with;
        batches started after this call route by the new one.  The new
        shard's server must be up (and its moved bricks imported) before
        the router adopts the map, and old owners drop moved keys only
        after (:meth:`RegionServer.reshard`).

        :param shard_map: the new :class:`ShardMap`.
        :param endpoints: optional replacement endpoint dict
            (``{shard_id: url | [urls]}``); None keeps the current one.
        """
        with self._lock:
            self.shard_map = shard_map
            if endpoints is not None:
                self.endpoints = {
                    str(sid): [urls] if isinstance(urls, str)
                    else list(urls)
                    for sid, urls in endpoints.items()}

    def get_region(self, level: int, box: Box) -> ROILevel:
        """One level's crop of ``box`` (finest-grid cells).

        :raises ValueError: if ``level`` is out of range.
        """
        return self.get_regions([box], levels=[level])[0][0]

    def get_roi(self, box: Box) -> list[ROILevel]:
        """All levels' crops of one box, finest first (the sharded mirror
        of ``read_roi``)."""
        return self.get_regions([box])[0]

    def get_regions_with_crc(self, boxes: list[Box],
                             levels: list[int] | None = None,
                             ) -> tuple[int, list[list[ROILevel]]]:
        """:meth:`get_regions` plus the serving snapshot's identity — the
        contract :meth:`RegionServer.get_regions_with_crc` has, so
        ``http_api`` serves a router behind the same routes.

        :returns: ``(index_crc_of_serving_snapshot, results)``.
        """
        out, meta = self.get_regions_meta(boxes, levels)
        return int(meta["snapshot_crc"]), out

    def stats(self) -> dict:
        """Router counters plus the planning snapshot's identity, the
        shard-map config, batch ``latency`` (count and p50/p90/p99/mean
        ms from ``tacz_router_batch_seconds``, nulls before the first
        batch) and, with ``load_balance``, the demoted endpoints."""
        s = dict(self.counters)
        s["snapshot_crc"] = self.snapshot_crc
        s["shard_map"] = self.shard_map.to_dict()
        s["load_balance"] = self.load_balance
        if self._catalog is not None:
            with self._lock:
                opened = sorted(self._var_readers)
            s["variants"] = {"default": self._default_variant,
                             "names": sorted(self._variant_paths),
                             "opened": opened}
        hist = obsm.ROUTER_BATCH_SECONDS.labels()
        lat = {"count": hist.count}
        for q, key in ((0.5, "p50_ms"), (0.9, "p90_ms"), (0.99, "p99_ms")):
            est = hist.quantile(q)
            lat[key] = None if est is None else round(est * 1000.0, 3)
        mean = hist.mean()
        lat["mean_ms"] = None if mean is None else round(mean * 1000.0, 3)
        s["latency"] = lat
        if self.load_balance:
            with self._lock:
                s["unhealthy_endpoints"] = sorted(self._unhealthy)
        return s

    def health(self) -> dict:
        """Liveness/readiness report (the body of ``GET /v1/health``).

        Checks the local planning snapshot (footer CRC) and shard
        reachability: one ``GET /v1/health`` probe per configured
        endpoint; a shard is reachable when one of its endpoints answers
        with a status other than ``down``.  ``ok`` when the snapshot is
        current and every shard reachable; ``degraded`` when the snapshot
        is stale, or a shard is unreachable and the local fallback covers
        it; ``down`` when a shard is unreachable without fallback, or the
        snapshot probe fails.  Never raises.

        :returns: dict with ``status``, ``role``, ``snapshot_crc`` and
            per-check detail under ``checks`` (``checks["shards"]`` maps
            shard id → ``{reachable, endpoints: {url: status}}``).
        """
        checks: dict = {}
        status = "ok"
        try:
            probe = probe_index_crc(self._probe_path)
        except Exception:
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
        shards: dict[str, dict] = {}
        unreachable = 0
        for sid in self.shard_map.shards:
            statuses: dict[str, str] = {}
            reachable = False
            for url in self.endpoints.get(sid, ()):
                try:
                    h = self._client(url).health()
                    statuses[url] = str(h.get("status", "ok"))
                except Exception as exc:   # noqa: BLE001 — per endpoint
                    statuses[url] = f"unreachable: {exc}"
                    continue
                if statuses[url] != "down":
                    reachable = True
            if not reachable:
                unreachable += 1
            shards[sid] = {"reachable": reachable, "endpoints": statuses}
        checks["shards"] = shards
        if unreachable:
            if self.local_fallback and status != "down":
                status = "degraded"
            else:
                status = "down"
        return {"status": status, "role": "router",
                "snapshot_crc": self.snapshot_crc, "checks": checks}
