"""``repro_torch.obs`` — dependency-free observability, copied from the
reference's ``repro.obs``: a thread-safe metrics registry with Prometheus
text exposition (:mod:`.registry`), nested timing spans and request IDs
(:mod:`.trace`), the process-wide default registry with the metric
catalog (:mod:`.metrics`), the exposition parser (:mod:`.expo`), the
fleet collector that polls endpoints into windowed series
(:mod:`.collect`) and the SLO rule engine over it (:mod:`.slo`).  The
compressor's stage timers, the reader, the region server, the router,
its async core and HTTP endpoint record into them.
"""
from . import expo, metrics
from .collect import FleetCollector, Scrape
from .expo import ParsedFamily, ParsedHistogram
from .metrics import REGISTRY, is_enabled, set_enabled, timed
from .registry import (DEFAULT_TIME_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, quantile_from_buckets)
from .slo import RULE_TYPES, SLOEngine, SLORule
from .trace import (REQUEST_ID_HEADER, Span, current_span, new_request_id,
                    root_span, trace)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_TIME_BUCKETS", "quantile_from_buckets",
    "Span", "trace", "root_span", "current_span",
    "new_request_id", "REQUEST_ID_HEADER",
    "REGISTRY", "metrics", "set_enabled", "is_enabled", "timed",
    "expo", "ParsedFamily", "ParsedHistogram",
    "FleetCollector", "Scrape",
    "SLOEngine", "SLORule", "RULE_TYPES",
]
