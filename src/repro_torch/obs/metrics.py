"""``repro_torch.obs.metrics`` — the default registry and the metric catalog.

Every instrumented component records into one module-level
:class:`~repro_torch.obs.registry.MetricsRegistry`.  That is deliberate:

  * Lifetime totals must survive a ``RegionServer`` hot swap (the server
    object is rebuilt; the registry is not) — the same property the
    sub-block cache's hit/miss counters already have.
  * One scrape covers everything in the process: a shard's cache,
    planner, handoff and server latency.

The catalog below holds the families the region server and the TACZ
writers record, under the reference's names (``repro.obs.metrics``), so
a scrape of either package reads alike; the compression, router, HTTP
and SLO families arrive with the modules that record them.  Bucket
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
    "WRITER_LEVEL_SECONDS", "WRITER_BYTES", "WRITER_LEVELS",
    "PLANNER_SUBBLOCKS", "PLANNER_DECODE_SECONDS", "PLANNER_DECODED_BYTES",
    "SERVER_REQUEST_SECONDS", "SERVER_REGIONS",
    "CACHE_HITS", "CACHE_MISSES", "CACHE_EVICTIONS",
    "CACHE_ENTRIES", "CACHE_BYTES", "CACHE_BUDGET_BYTES",
    "HANDOFF_KEYS", "HANDOFF_BYTES",
    "VARIANT_REQUESTS", "VARIANT_FALLBACKS", "VARIANT_UNSATISFIED",
    "VARIANT_LABEL_BUDGET",
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
    """

    __slots__ = ("_hist", "_span", "_t0")

    def __init__(self, hist_child, span_name: str | None = None):
        self._hist = hist_child
        self._span = _trace(span_name) if span_name else None
        self._t0 = 0.0

    def __enter__(self) -> "timed":
        if self._span is not None:
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.perf_counter() - self._t0)
        if self._span is not None:
            self._span.__exit__(*exc)


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

# ------------------------------- server ----------------------------------

SERVER_REQUEST_SECONDS = REGISTRY.histogram(
    "tacz_server_request_seconds",
    "End-to-end RegionServer.get_regions latency per batch.")

SERVER_REGIONS = REGISTRY.counter(
    "tacz_server_regions_total",
    "Region boxes served by RegionServer.get_regions.")

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
    "the target (TargetUnsatisfiable).")
