"""``repro_torch.obs.registry`` — a dependency-free, thread-safe metrics registry.

Prometheus' data model, stdlib-only: a :class:`MetricsRegistry` holds
metric *families* (one name + help text + label names each); a family
holds *children* (one per label-value tuple); children are the objects
the hot paths touch — :class:`Counter` (monotonic), :class:`Gauge`
(set/inc/dec), and :class:`Histogram` (fixed cumulative buckets with
``sum``/``count``, plus quantile estimation for the ``/v1/stats``
surface).

Design points that matter for the serving fleet:

  * **Thread safety with exact totals.**  Every mutation takes the
    family's lock — 8 threads incrementing one counter 10k times each
    yield exactly 80k (test-asserted).  The lock is per family, so
    unrelated metrics never contend.
  * **Lifetime totals.**  Children live in the registry, not in the
    components that record to them — a :class:`~repro_torch.serving.regions.
    RegionServer` hot-swapping its snapshot (or being rebuilt) keeps
    accumulating into the same series, exactly like the sub-block
    cache's hit/miss counters.
  * **A kill switch with negligible overhead.**  ``registry.enabled =
    False`` turns every ``inc``/``set``/``observe`` into one attribute
    check + return; the instrumentation overhead benchmark gates the
    *enabled* path at ≥0.95× the disabled throughput.
  * **Prometheus text exposition** (:meth:`MetricsRegistry.render`) in
    the ``text/plain; version=0.0.4`` format — ``# HELP``/``# TYPE``
    lines, escaped label values, ``_bucket{le=...}``/``_sum``/``_count``
    histogram series — servable straight from ``GET /v1/metrics``.
"""
from __future__ import annotations

import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS", "OVERFLOW_LABEL",
           "quantile_from_buckets"]

#: Default latency buckets (seconds): 100 µs … 10 s, roughly 1-2.5-5 per
#: decade — wide enough for a cold multi-level decode, fine enough to
#: resolve warm cache hits.
DEFAULT_TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                        0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                        10.0)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str, what: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid {what} name {name!r}")
    return name


def _escape(value: str) -> str:
    """Escape one label value for the text exposition format."""
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    """Escape a ``# HELP`` line's text (backslash and newline only —
    quotes are legal in help text, per the exposition spec)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def quantile_from_buckets(bounds, counts, q: float) -> float | None:
    """Estimate the ``q``-quantile of a fixed-bucket histogram.

    The shared estimator behind :meth:`Histogram.quantile` and the
    windowed fleet quantiles of the reference's collector: linear
    interpolation inside the bucket the rank falls into, with the
    overflow (+Inf) bucket clamped to the largest finite bound.

    :param bounds: finite ascending bucket upper bounds.
    :param counts: **non-cumulative** per-bucket counts; one longer than
        ``bounds`` (the last entry is the +Inf overflow bucket).
    :param q: quantile in ``[0, 1]``.
    :returns: the estimate, or None when the histogram holds no samples.
    :raises ValueError: if ``q`` is outside ``[0, 1]``.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError("quantile must be in [0, 1]")
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, c in enumerate(counts[:-1]):
        hi = bounds[i]
        if cum + c >= rank and c > 0:
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
        lo = hi
    return bounds[-1] if len(bounds) else 0.0


def _fmt(v: float) -> str:
    """Render one sample value (integers without a trailing ``.0``)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(names: tuple[str, ...], values: tuple[str, ...],
                 extra: str = "") -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Child:
    """Base of one labeled series; mutations lock the family's lock."""

    __slots__ = ("_lock", "_reg")

    def __init__(self, lock: threading.Lock, reg: "MetricsRegistry"):
        self._lock = lock
        self._reg = reg


class Counter(_Child):
    """Monotonically increasing series (``rate()``-able in Prometheus)."""

    __slots__ = ("_value",)

    def __init__(self, lock, reg):
        super().__init__(lock, reg)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` (must be ≥ 0) to the series."""
        if not self._reg.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    """A value that can go up and down (occupancy, budget, in-flight)."""

    __slots__ = ("_value",)

    def __init__(self, lock, reg):
        super().__init__(lock, reg)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    """Fixed-bucket cumulative histogram (Prometheus semantics).

    ``observe(v)`` increments every bucket whose upper bound is ≥ v —
    stored non-cumulatively here and accumulated at render time, so one
    observation is one index lookup + three adds.  ``quantile(q)``
    estimates a quantile by linear interpolation inside the bucket the
    rank falls into — the same estimate ``histogram_quantile()`` would
    compute server-side, available locally for ``/v1/stats``.
    """

    __slots__ = ("_bounds", "_counts", "_sum", "_count")

    def __init__(self, lock, reg, bounds: tuple[float, ...]):
        super().__init__(lock, reg)
        self._bounds = bounds                    # finite, ascending
        self._counts = [0] * (len(bounds) + 1)   # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        """Record one sample."""
        if not self._reg.enabled:
            return
        v = float(value)
        # linear scan: bucket lists are short (≤ ~16) and almost every
        # latency sample lands in the first few buckets — cheaper than
        # bisect's function-call overhead at this size
        i = 0
        bounds = self._bounds
        n = len(bounds)
        while i < n and v > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> tuple[list[int], float, int]:
        """(non-cumulative bucket counts, sum, count) — one consistent view."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> float | None:
        """Estimated ``q``-quantile (0 ≤ q ≤ 1), or None with no samples.

        Linear interpolation within the bucket containing the rank; the
        overflow (+Inf) bucket clamps to the largest finite bound — the
        estimate is bucket-resolution coarse, by construction.
        """
        counts, _, _ = self.snapshot()
        return quantile_from_buckets(self._bounds, counts, q)

    def mean(self) -> float | None:
        """Mean of all observations, or None with no samples (never NaN
        — a just-started endpoint's stats surface must serve clean
        nulls, not ``0/0``)."""
        with self._lock:
            if self._count == 0:
                return None
            return self._sum / self._count


#: Label value every over-budget series collapses into (see
#: ``_Family.max_series``) — one bounded bucket instead of a scrape that
#: grows with every distinct label value a client invents.
OVERFLOW_LABEL = "__other__"


class _Family:
    """One metric name: help text, label names, and labeled children."""

    __slots__ = ("name", "help", "kind", "label_names", "_children",
                 "_lock", "_reg", "_bounds", "max_series", "_overflow")

    def __init__(self, reg, name, help_text, kind, label_names,
                 bounds=None, max_series=None):
        self.name = _check_name(name, "metric")
        self.help = str(help_text)
        self.kind = kind
        self.label_names = tuple(_check_name(n, "label")
                                 for n in label_names)
        if max_series is not None:
            max_series = int(max_series)
            if max_series < 1:
                raise ValueError("max_series must be >= 1")
            if not self.label_names:
                raise ValueError(
                    "max_series only applies to labeled families")
        self.max_series = max_series
        self._overflow = (OVERFLOW_LABEL,) * len(self.label_names)
        self._children: dict[tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        self._reg = reg
        self._bounds = bounds

    def labels(self, *values) -> _Child:
        """The child series for one label-value tuple (created on first
        use).  A family with no labels has a single anonymous child.

        With ``max_series`` set, a *new* label tuple arriving once the
        family already holds that many distinct series is routed to the
        ``__other__`` overflow child instead — the cardinality budget
        that keeps one scrape bounded no matter how many distinct label
        values (e.g. eb-variant names across a fleet) show up.
        """
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {len(values)} value(s)")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if (child is None and self.max_series is not None
                    and key != self._overflow
                    and sum(k != self._overflow
                            for k in self._children) >= self.max_series):
                key = self._overflow
                child = self._children.get(key)
            if child is None:
                if self.kind == "counter":
                    child = Counter(self._lock, self._reg)
                elif self.kind == "gauge":
                    child = Gauge(self._lock, self._reg)
                else:
                    child = Histogram(self._lock, self._reg, self._bounds)
                self._children[key] = child
            return child

    def children(self) -> dict[tuple[str, ...], _Child]:
        with self._lock:
            return dict(self._children)

    # -- no-label conveniences: delegate to the anonymous child ------------
    # (raise, via labels(), when the family actually declares labels)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    @property
    def value(self) -> float:
        return self.labels().value

    @property
    def count(self) -> int:
        return self.labels().count

    @property
    def sum(self) -> float:
        return self.labels().sum

    def quantile(self, q: float):
        return self.labels().quantile(q)

    def mean(self):
        return self.labels().mean()

    # ----------------------------- rendering ------------------------------

    def render(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for key, child in sorted(self.children().items()):
            if self.kind == "histogram":
                counts, total, n = child.snapshot()
                cum = 0
                for bound, c in zip(self._bounds + (math.inf,), counts):
                    cum += c
                    lt = _labels_text(self.label_names, key,
                                      f'le="{_fmt(bound)}"')
                    out.append(f"{self.name}_bucket{lt} {cum}")
                lt = _labels_text(self.label_names, key)
                out.append(f"{self.name}_sum{lt} {_fmt(total)}")
                out.append(f"{self.name}_count{lt} {n}")
            else:
                lt = _labels_text(self.label_names, key)
                out.append(f"{self.name}{lt} {_fmt(child.value)}")


class MetricsRegistry:
    """A named collection of metric families with Prometheus exposition.

    Families are get-or-create: asking twice for the same name returns
    the same family (and raises if the kind/labels/help disagree — two
    call sites silently describing one series differently is a bug).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        #: master switch — ``False`` turns every mutation into a no-op
        #: (reads and rendering still work; see the overhead benchmark)
        self.enabled: bool = True

    # ----------------------------- families -------------------------------

    def _family(self, name, help_text, kind, label_names, bounds=None,
                max_series=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (fam.kind != kind
                        or fam.label_names != tuple(label_names)
                        or (bounds is not None and fam._bounds != bounds)
                        or (max_series is not None
                            and fam.max_series != max_series)):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"kind/labels/buckets/max_series")
                return fam
            fam = _Family(self, name, help_text, kind, label_names, bounds,
                          max_series)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str,
                labels: tuple[str, ...] = (),
                max_series: int | None = None) -> _Family:
        """Get or create a counter family.  ``max_series`` caps the
        number of distinct label tuples; later new tuples collapse into
        the ``__other__`` overflow series (see :data:`OVERFLOW_LABEL`)."""
        return self._family(name, help_text, "counter", labels,
                            max_series=max_series)

    def gauge(self, name: str, help_text: str,
              labels: tuple[str, ...] = (),
              max_series: int | None = None) -> _Family:
        """Get or create a gauge family (``max_series`` as in
        :meth:`counter`)."""
        return self._family(name, help_text, "gauge", labels,
                            max_series=max_series)

    def histogram(self, name: str, help_text: str,
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
                  max_series: int | None = None,
                  ) -> _Family:
        """Get or create a histogram family with fixed ``buckets``
        (finite ascending upper bounds; ``+Inf`` is implicit;
        ``max_series`` as in :meth:`counter`)."""
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)) or any(
                math.isinf(b) for b in bounds):
            raise ValueError("buckets must be finite, ascending, unique")
        return self._family(name, help_text, "histogram", labels, bounds,
                            max_series=max_series)

    def families(self) -> list[_Family]:
        with self._lock:
            return list(self._families.values())

    # ----------------------------- exposition -----------------------------

    def render(self) -> str:
        """The whole registry in Prometheus text exposition format."""
        out: list[str] = []
        for fam in self.families():
            fam.render(out)
        return "\n".join(out) + "\n" if out else ""

    def snapshot(self) -> dict:
        """JSON-friendly dump: ``{name: {labels_repr: value_or_hist}}``."""
        out: dict = {}
        for fam in self.families():
            series = {}
            for key, child in fam.children().items():
                k = ",".join(f"{n}={v}" for n, v in
                             zip(fam.label_names, key)) or "_"
                if fam.kind == "histogram":
                    counts, total, n = child.snapshot()
                    series[k] = {"count": n, "sum": total,
                                 "buckets": counts}
                else:
                    series[k] = child.value
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out
