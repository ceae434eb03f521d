"""``repro_torch.obs.metrics`` — the default registry and the metric catalog.

Every instrumented component records into one module-level
:class:`~repro_torch.obs.registry.MetricsRegistry`.  That is deliberate:

  * Lifetime totals must survive a ``RegionServer`` hot swap (the server
    object is rebuilt; the registry is not) — the same property the
    sub-block cache's hit/miss counters already have.
  * One ``GET /v1/metrics`` scrape covers everything in the process: a
    shard's cache + planner + server latency, and — when a router runs
    in the same process — the router's fan-out series too.

The catalog below holds every family of the reference's catalog
(``repro.obs.metrics``) under the same names, help texts, labels and
buckets, so a scrape of either package parses to the same family set and
either package's fleet collector and SLO engine read both.  Bucket
choices: request/stage latencies share :data:`~repro_torch.obs.registry.
DEFAULT_TIME_BUCKETS` (100 µs–10 s) so quantiles are comparable across
stages.
"""
from __future__ import annotations

import time

from .registry import DEFAULT_TIME_BUCKETS, MetricsRegistry
from .trace import trace as _trace

__all__ = [
    "REGISTRY", "set_enabled", "is_enabled", "timed",
    "COMPRESS_STAGE_SECONDS", "COMPRESS_LEVEL_SECONDS",
    "WRITER_LEVEL_SECONDS", "WRITER_BYTES", "WRITER_LEVELS",
    "PLANNER_SUBBLOCKS", "PLANNER_DECODE_SECONDS", "PLANNER_DECODED_BYTES",
    "ENTROPY_DECODE_SECONDS",
    "SERVER_REQUEST_SECONDS", "SERVER_REGIONS",
    "SERVER_BACKPRESSURE", "SERVER_DECODE_UNITS", "SERVER_QUEUE_DEPTH",
    "CACHE_HITS", "CACHE_MISSES", "CACHE_EVICTIONS",
    "CACHE_ENTRIES", "CACHE_BYTES", "CACHE_BUDGET_BYTES",
    "HANDOFF_KEYS", "HANDOFF_BYTES",
    "ROUTER_SHARD_SECONDS", "ROUTER_BATCHES", "ROUTER_SHARD_REQUESTS",
    "ROUTER_ENDPOINT_FAILURES", "ROUTER_LOCAL_FALLBACKS",
    "ROUTER_RETRIES", "ROUTER_DEMOTIONS", "ROUTER_BATCH_SECONDS",
    "HTTP_REQUESTS", "HTTP_REQUEST_SECONDS",
    "VARIANT_REQUESTS", "VARIANT_FALLBACKS", "VARIANT_UNSATISFIED",
    "VARIANT_LABEL_BUDGET",
    "SLO_FIRING", "SLO_STATE", "SLO_VALUE",
]

#: The process-wide default registry.  Components import this; tests
#: that need isolation construct their own ``MetricsRegistry``.
REGISTRY = MetricsRegistry()


def set_enabled(on: bool) -> None:
    """Master switch for the default registry (and thus all built-in
    instrumentation), for measuring the uninstrumented baseline."""
    REGISTRY.enabled = bool(on)


def is_enabled() -> bool:
    return REGISTRY.enabled


class timed:
    """Time a region into a histogram child — and, when a root span is
    active on this thread, into a same-named trace span too.

    ``with timed(PLANNER_DECODE_SECONDS.labels(), "decode"): ...``
    is the one instrumentation idiom the hot paths use: the metric feeds
    the scrape surface, the span feeds per-request response metadata.
    The trace half is the shared no-op outside a root span, and the
    histogram's ``observe`` is a no-op when the registry is disabled.

    ``sync`` names the device whose work the region launches.  Kernels
    run asynchronously, so on a CUDA device the clock would stop at the
    last launch, not at the end of the work: with ``sync`` the current
    stream is synchronized before the clock is read — only while the
    histogram's registry is enabled and no exception is in flight, so a
    disabled registry adds no synchronize.  Regions that already end in
    a host wait (a ``.cpu()``, ``.item()`` or ``.tolist()``) pass none.
    """

    __slots__ = ("_hist", "_span", "_t0", "_sync")

    def __init__(self, hist_child, span_name: str | None = None, *,
                 sync=None):
        self._hist = hist_child
        self._span = _trace(span_name) if span_name else None
        self._t0 = 0.0
        self._sync = sync

    def __enter__(self) -> "timed":
        if self._span is not None:
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dev = self._sync
        if (dev is not None and exc[0] is None
                and getattr(dev, "type", None) == "cuda"
                and self._hist._reg.enabled):
            import torch
            torch.cuda.current_stream(dev).synchronize()
        self._hist.observe(time.perf_counter() - self._t0)
        if self._span is not None:
            self._span.__exit__(*exc)


# --------------------------- compression ---------------------------------

COMPRESS_STAGE_SECONDS = REGISTRY.histogram(
    "tacz_compress_stage_seconds",
    "Per-stage wall time inside compress_level "
    "(stage: prequant | branch_score | entropy).",
    labels=("stage",))

COMPRESS_LEVEL_SECONDS = REGISTRY.histogram(
    "tacz_compress_level_seconds",
    "End-to-end compress_level wall time, labeled by the resolved "
    "strategy (gsp | opst | akdtree | nast).",
    labels=("strategy",))

# ------------------------------ writers ----------------------------------

WRITER_LEVEL_SECONDS = REGISTRY.histogram(
    "tacz_writer_level_seconds",
    "TACZWriter per-level stage wall time "
    "(stage: encode | pack | publish).",
    labels=("stage",))

WRITER_BYTES = REGISTRY.counter(
    "tacz_writer_bytes_total",
    "Compressed bytes appended to .tacz files (payload sections).")

WRITER_LEVELS = REGISTRY.counter(
    "tacz_writer_levels_total",
    "AMR levels encoded and appended by writers.")

# ------------------------------ planner ----------------------------------

PLANNER_SUBBLOCKS = REGISTRY.counter(
    "tacz_planner_subblocks_total",
    "Sub-blocks resolved by DecodePlanner.fetch "
    "(outcome: cached | decoded).",
    labels=("outcome",))

PLANNER_DECODE_SECONDS = REGISTRY.histogram(
    "tacz_planner_decode_seconds",
    "Wall time of the batched entropy-decode launches inside "
    "DecodePlanner.fetch.")

PLANNER_DECODED_BYTES = REGISTRY.counter(
    "tacz_planner_decoded_bytes_total",
    "Decoded float32 bytes produced by DecodePlanner.fetch "
    "(cache-miss path only).")

ENTROPY_DECODE_SECONDS = REGISTRY.histogram(
    "tacz_entropy_decode_seconds",
    "Wall time of EntropyEngine payload-decode launches inside "
    "TACZReader.decode_subblocks.")

# ------------------------------- server ----------------------------------

SERVER_REQUEST_SECONDS = REGISTRY.histogram(
    "tacz_server_request_seconds",
    "End-to-end RegionServer.get_regions latency per batch.")

SERVER_REGIONS = REGISTRY.counter(
    "tacz_server_regions_total",
    "Region boxes served by RegionServer.get_regions.")

# Admission control (repro_torch.serving.core.AsyncServingCore): decode
# work is bounded; what the bound rejects or queues must be visible.

SERVER_BACKPRESSURE = REGISTRY.counter(
    "tacz_server_backpressure_total",
    "Batches rejected by decode admission control "
    "(reason: queue_full | draining).",
    labels=("reason",))

SERVER_DECODE_UNITS = REGISTRY.counter(
    "tacz_server_decode_units_total",
    "Per-level decode units executed by the AsyncServingCore worker "
    "pool (an oversized batch splits into one unit per level).")

SERVER_QUEUE_DEPTH = REGISTRY.gauge(
    "tacz_server_queue_depth",
    "Decode units currently admitted (queued + running) in the "
    "AsyncServingCore.")

# Cache gauges are refreshed from SubBlockCache.stats() at scrape/stat
# time (the cache keeps its own lifetime counters across hot swaps).
CACHE_HITS = REGISTRY.gauge(
    "tacz_cache_hits", "SubBlockCache lifetime hit count.")
CACHE_MISSES = REGISTRY.gauge(
    "tacz_cache_misses", "SubBlockCache lifetime miss count.")
CACHE_EVICTIONS = REGISTRY.gauge(
    "tacz_cache_evictions", "SubBlockCache lifetime eviction count.")
CACHE_ENTRIES = REGISTRY.gauge(
    "tacz_cache_entries", "Decoded bricks currently resident.")
CACHE_BYTES = REGISTRY.gauge(
    "tacz_cache_bytes", "Bytes of decoded bricks currently resident.")
CACHE_BUDGET_BYTES = REGISTRY.gauge(
    "tacz_cache_budget_bytes", "Configured cache byte budget.")


def refresh_cache_gauges(cache_stats: dict) -> None:
    """Copy a ``SubBlockCache.stats()`` dict into the cache gauges."""
    if not REGISTRY.enabled:
        return
    CACHE_HITS.labels().set(cache_stats.get("hits", 0))
    CACHE_MISSES.labels().set(cache_stats.get("misses", 0))
    CACHE_EVICTIONS.labels().set(cache_stats.get("evictions", 0))
    CACHE_ENTRIES.labels().set(cache_stats.get("entries", 0))
    CACHE_BYTES.labels().set(cache_stats.get("bytes", 0))
    CACHE_BUDGET_BYTES.labels().set(cache_stats.get("budget_bytes", 0))


# Cache handoff (live resharding): decoded bricks moved between shards
# so a grown fleet serves warm instead of cold-starting.

HANDOFF_KEYS = REGISTRY.counter(
    "tacz_cache_handoff_keys_total",
    "Decoded bricks moved by the cache-handoff protocol "
    "(direction: export | import).",
    labels=("direction",))

HANDOFF_BYTES = REGISTRY.counter(
    "tacz_cache_handoff_bytes_total",
    "Decoded-brick payload bytes moved by the cache-handoff protocol "
    "(direction: export | import).",
    labels=("direction",))


# ------------------------------- router ----------------------------------

ROUTER_SHARD_SECONDS = REGISTRY.histogram(
    "tacz_router_shard_seconds",
    "Per-shard fan-out wall time inside ShardedRegionRouter.get_regions "
    "(one observation per (shard, level) group).",
    labels=("shard",))

ROUTER_BATCHES = REGISTRY.counter(
    "tacz_router_batches_total",
    "Batches routed by ShardedRegionRouter.get_regions.")

ROUTER_SHARD_REQUESTS = REGISTRY.counter(
    "tacz_router_shard_requests_total",
    "Shard-group fetches issued by the router.")

ROUTER_ENDPOINT_FAILURES = REGISTRY.counter(
    "tacz_router_endpoint_failures_total",
    "Endpoint attempts that raised (before any retry/fallback).")

ROUTER_LOCAL_FALLBACKS = REGISTRY.counter(
    "tacz_router_local_fallbacks_total",
    "Shard groups served by the router's local reader fallback.")

ROUTER_RETRIES = REGISTRY.counter(
    "tacz_router_retries_total",
    "Endpoint attempts beyond the first within one shard group.")

ROUTER_DEMOTIONS = REGISTRY.counter(
    "tacz_router_endpoint_demotions_total",
    "healthy-to-unhealthy endpoint transitions recorded by the router.")

ROUTER_BATCH_SECONDS = REGISTRY.histogram(
    "tacz_router_batch_seconds",
    "End-to-end ShardedRegionRouter.get_regions latency per batch "
    "(scatter + gather + paste).")

# -------------------------------- http -----------------------------------

HTTP_REQUESTS = REGISTRY.counter(
    "tacz_http_requests_total",
    "HTTP requests served, by route and status code.",
    labels=("route", "status"))

HTTP_REQUEST_SECONDS = REGISTRY.histogram(
    "tacz_http_request_seconds",
    "HTTP request handling wall time, by route.",
    labels=("route",))


# ------------------------------- variants ---------------------------------
# Distortion-aware serving: which eb variants actually serve traffic,
# and how often the frontier machinery degrades (fallback) or refuses
# (unsatisfiable target).

#: Cardinality budget for the ``variant`` label: a fleet mixing many
#: variant sets cannot blow up a scrape — the 65th and later distinct
#: variant names collapse into ``variant="__other__"``.
VARIANT_LABEL_BUDGET = 64

VARIANT_REQUESTS = REGISTRY.counter(
    "tacz_variant_requests_total",
    "Region batches served per selected eb variant (label is the "
    "variant name; 'default' for single-snapshot servers; names beyond "
    "the cardinality budget collapse into '__other__').",
    labels=("variant",), max_series=VARIANT_LABEL_BUDGET)

VARIANT_FALLBACKS = REGISTRY.counter(
    "tacz_variant_fallbacks_total",
    "Distortion-target requests served by the default variant because "
    "the frontier section was missing or corrupt.")

VARIANT_UNSATISFIED = REGISTRY.counter(
    "tacz_variant_unsatisfied_total",
    "Distortion-target requests rejected because no variant satisfies "
    "the target (HTTP 400).")

# --------------------------------- slo ------------------------------------
# The SLO engine (repro_torch.obs.slo) exports its alert state back into the
# registry, so the alert plane is itself scrapable.

SLO_FIRING = REGISTRY.gauge(
    "tacz_slo_firing",
    "1 while the named SLO rule is firing, else 0.",
    labels=("rule",))

SLO_STATE = REGISTRY.gauge(
    "tacz_slo_state",
    "Alert state of the named SLO rule "
    "(0=ok 1=pending 2=firing 3=resolved).",
    labels=("rule",))

SLO_VALUE = REGISTRY.gauge(
    "tacz_slo_value",
    "Last evaluated value of the named SLO rule's expression.",
    labels=("rule",))
