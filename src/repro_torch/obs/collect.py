"""``repro_torch.obs.collect`` — fleet-wide metric collection over the
scrape surface (the port of ``repro.obs.collect``).

A :class:`FleetCollector` polls N region endpoints (shards + router) on
an interval, parses each ``GET /v1/metrics`` body through
:mod:`repro_torch.obs.expo`, and keeps a bounded ring buffer of scrapes per
endpoint.  On top of that buffer it computes what a one-endpoint scrape
cannot:

  * **up/down** — an endpoint is *up* when its last poll succeeded and
    its ``GET /v1/health`` body (when the endpoint serves one) reports
    ``status != "down"``;
  * **counter deltas and rates** across scrapes, with counter-reset
    handling (a restarted endpoint's counters drop to ~0; the delta
    treats the post-reset value as the increment instead of going
    negative);
  * **windowed histogram deltas** — the bucket-count difference between
    the newest scrape and the oldest scrape inside the window, which is
    what windowed quantiles (``p99 over the last 30 s``) are computed
    from (the SLO engine's latency rules ride this, so a firing rule can
    *resolve* once recent traffic is fast again — lifetime histograms
    never forget);
  * **fleet aggregation** — per-endpoint series merged by label key:
    counters and histogram buckets *sum*, gauges report *max* and *min*
    (summing a ``budget_bytes`` gauge across shards is meaningful,
    summing a ``p50`` is not — the caller picks);
  * **machine-readable JSON snapshots** (:meth:`snapshot`,
    :meth:`dump_json`) — per-endpoint state plus the fleet aggregate,
    the artifact the load-generator benchmark uploads.

The collector is transport-agnostic: pass ``fetch=`` to scrape anything
that can produce an exposition body (the tests inject fakes; the default
uses :class:`repro_torch.serving.client.RegionClient`; the port's parser
splits lines at ``"\n"`` only, where the reference's also splits at the
other line separators ``str.splitlines()`` knows).  Polling can be driven
manually (:meth:`poll` — deterministic, what tests do) or on a
background thread (:meth:`start`/:meth:`stop`).
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from . import expo

__all__ = ["Scrape", "FleetCollector"]


@dataclass
class Scrape:
    """One poll of one endpoint."""

    ts: float
    ok: bool
    families: dict[str, expo.ParsedFamily] = field(default_factory=dict)
    health: dict | None = None
    error: str = ""


def _default_fetch(url: str, timeout: float):
    """Scrape one endpoint over HTTP: metrics body + optional health."""
    from ..serving.client import RegionClient
    cli = RegionClient(url, timeout=timeout)
    text = cli.metrics_text()
    try:
        health = cli.health()
    except Exception:        # health endpoint absent or failing: metrics
        health = None        # alone still make the endpoint scrapable
    return text, health


def _series_value(fam: expo.ParsedFamily | None, pairs) :
    if fam is None:
        return None
    return fam.series.get(tuple(pairs))


def _label_pairs(fam: expo.ParsedFamily, labels: dict) -> tuple:
    """Order a labels dict by the family's label order."""
    names = fam.label_names or tuple(labels)
    return tuple((n, str(labels[n])) for n in names if n in labels)


class FleetCollector:
    """Poll a fleet of scrape endpoints into ring-buffer time series.

    :param endpoints: ``{name: base_url}`` — shard servers, routers,
        anything serving ``GET /v1/metrics``.
    :param window: ring-buffer depth per endpoint (scrapes, not
        seconds); the oldest scrape bounds the largest usable
        rate/quantile window.
    :param timeout: per-scrape socket timeout, seconds.
    :param fetch: ``fetch(url, timeout) -> (metrics_text, health_dict)``
        override for tests/other transports.
    :param clock: timestamp source for scrape ``ts`` (monotonic).
    """

    def __init__(self, endpoints: dict[str, str], *, window: int = 120,
                 timeout: float = 5.0, fetch=None, clock=time.monotonic):
        if not endpoints:
            raise ValueError("FleetCollector needs at least one endpoint")
        self.endpoints = {str(k): str(v) for k, v in endpoints.items()}
        self.timeout = float(timeout)
        self._fetch = fetch or _default_fetch
        self._clock = clock
        self._buffers: dict[str, deque[Scrape]] = {
            name: deque(maxlen=int(window)) for name in self.endpoints}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.polls = 0

    # ------------------------------ polling --------------------------------

    def poll(self) -> dict[str, Scrape]:
        """Scrape every endpoint once (concurrently — one slow endpoint
        must not stall the fleet's sampling cadence).

        :returns: ``{endpoint_name: Scrape}`` for this round; failures
            come back as ``ok=False`` scrapes with the error text, they
            never raise.
        """
        results: dict[str, Scrape] = {}

        def one(name: str, url: str) -> None:
            ts = self._clock()
            try:
                text, health = self._fetch(url, self.timeout)
                results[name] = Scrape(ts, True, expo.parse(text), health)
            except Exception as exc:   # noqa: BLE001 — isolate endpoints
                results[name] = Scrape(ts, False, error=str(exc))

        threads = [threading.Thread(target=one, args=item, daemon=True)
                   for item in self.endpoints.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._lock:
            for name, scrape in results.items():
                self._buffers[name].append(scrape)
            self.polls += 1
        return results

    def start(self, interval: float = 5.0) -> None:
        """Poll on a daemon thread every ``interval`` seconds until
        :meth:`stop` (idempotent — a running collector is left alone)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                self.poll()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-collector")
        self._thread.start()

    def stop(self) -> None:
        """Stop the background polling thread (if any) and join it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # ------------------------------ reading --------------------------------

    def scrapes(self, endpoint: str) -> list[Scrape]:
        """This endpoint's buffered scrapes, oldest first."""
        with self._lock:
            return list(self._buffers[endpoint])

    def latest(self, endpoint: str) -> Scrape | None:
        """The newest scrape of one endpoint (successful or not)."""
        with self._lock:
            buf = self._buffers[endpoint]
            return buf[-1] if buf else None

    def up(self, endpoint: str) -> bool:
        """True when the endpoint's last poll succeeded and its health
        body (when present) does not report ``status: "down"``."""
        s = self.latest(endpoint)
        if s is None or not s.ok:
            return False
        if s.health is not None and s.health.get("status") == "down":
            return False
        return True

    def up_fraction(self) -> float:
        """Fraction of endpoints currently up (0..1)."""
        names = list(self.endpoints)
        return sum(self.up(n) for n in names) / len(names)

    def _window_pair(self, endpoint: str, window: float | None,
                     ) -> tuple[Scrape, Scrape] | None:
        """(baseline, newest) successful scrapes spanning ≤ ``window``
        seconds — baseline is the oldest successful scrape still inside
        the window.  None without two successful scrapes."""
        oks = [s for s in self.scrapes(endpoint) if s.ok]
        if len(oks) < 2:
            return None
        newest = oks[-1]
        cutoff = -math.inf if window is None else newest.ts - window
        base = None
        for s in oks[:-1]:
            if s.ts >= cutoff:
                base = s
                break
        if base is None:
            return None
        return base, newest

    # ----------------------------- counters --------------------------------

    def counter_delta(self, metric: str, labels: dict | None = None, *,
                      window: float | None = None,
                      endpoint: str | None = None) -> float | None:
        """Counter increase over the window (fleet-summed by default).

        Reset-safe: when the newest value is below the baseline (an
        endpoint restarted), the post-reset value itself is the
        increment.  ``endpoint=None`` sums the per-endpoint deltas over
        *up* endpoints.

        :returns: the delta, or None when no endpoint has two
            successful scrapes covering the window.
        """
        if endpoint is not None:
            names = [endpoint]
        else:
            names = [n for n in self.endpoints if self.up(n)]
        total, seen = 0.0, False
        for name in names:
            pair = self._window_pair(name, window)
            if pair is None:
                continue
            base, newest = pair
            fam_new = newest.families.get(metric)
            if fam_new is None:
                continue
            fam_old = base.families.get(metric)
            for pairs, v_new in fam_new.series.items():
                if labels is not None and tuple(
                        _label_pairs(fam_new, labels)) != pairs:
                    continue
                if isinstance(v_new, expo.ParsedHistogram):
                    continue
                v_old = _series_value(fam_old, pairs)
                if v_old is None or not isinstance(v_old, float):
                    v_old = 0.0
                total += v_new if v_new < v_old else v_new - v_old
                seen = True
        return total if seen else None

    def counter_deltas_by_series(self, metric: str, *,
                                 window: float | None = None,
                                 ) -> dict[tuple, float] | None:
        """Per-label-series counter deltas over the window, fleet-summed.

        Same reset handling as :meth:`counter_delta`, but keyed by label
        pairs instead of collapsed — what the SLO engine's ``error_rate``
        rule uses to split ``tacz_http_requests_total`` increments by
        their ``status`` label.

        :returns: ``{label_pairs: delta}`` or None when no endpoint has
            two successful scrapes covering the window.
        """
        out: dict[tuple, float] = {}
        seen = False
        for name in self.endpoints:
            if not self.up(name):
                continue
            pair = self._window_pair(name, window)
            if pair is None:
                continue
            base, newest = pair
            fam_new = newest.families.get(metric)
            if fam_new is None:
                continue
            fam_old = base.families.get(metric)
            for pairs, v_new in fam_new.series.items():
                if isinstance(v_new, expo.ParsedHistogram):
                    continue
                v_old = _series_value(fam_old, pairs)
                if v_old is None or not isinstance(v_old, float):
                    v_old = 0.0
                inc = v_new if v_new < v_old else v_new - v_old
                out[pairs] = out.get(pairs, 0.0) + inc
                seen = True
        return out if seen else None

    def counter_rate(self, metric: str, labels: dict | None = None, *,
                     window: float | None = None,
                     endpoint: str | None = None) -> float | None:
        """Per-second counter rate over the window (delta / elapsed).

        Elapsed time is measured from the scrape timestamps actually
        used, not the nominal window.
        """
        if endpoint is not None:
            names = [endpoint]
        else:
            names = [n for n in self.endpoints if self.up(n)]
        total, elapsed = 0.0, 0.0
        for name in names:
            pair = self._window_pair(name, window)
            if pair is None:
                continue
            d = self.counter_delta(metric, labels, window=window,
                                   endpoint=name)
            if d is None:
                continue
            total += d
            elapsed = max(elapsed, pair[1].ts - pair[0].ts)
        if elapsed <= 0:
            return None
        return total / elapsed

    # ----------------------------- histograms ------------------------------

    def histogram_delta(self, metric: str, labels: dict | None = None, *,
                        window: float | None = None,
                        endpoint: str | None = None,
                        ) -> expo.ParsedHistogram | None:
        """Windowed, fleet-summed histogram increase.

        The newest scrape's buckets minus the baseline scrape's, merged
        (bucket-wise sum) across matching series and across up
        endpoints.  A count drop (endpoint restart) falls back to the
        newest scrape's absolute buckets for that series.

        :returns: a :class:`~repro_torch.obs.expo.ParsedHistogram` holding the
            window's observations only, or None when no data covers the
            window or bucket bounds disagree across series.
        """
        if endpoint is not None:
            names = [endpoint]
        else:
            names = [n for n in self.endpoints if self.up(n)]
        bounds: tuple[float, ...] | None = None
        counts: list[int] = []
        total_sum, total_count, seen = 0.0, 0, False
        for name in names:
            pair = self._window_pair(name, window)
            if pair is None:
                continue
            base, newest = pair
            fam_new = newest.families.get(metric)
            if fam_new is None or fam_new.kind != "histogram":
                continue
            fam_old = base.families.get(metric)
            for pairs, h_new in fam_new.series.items():
                if labels is not None and tuple(
                        _label_pairs(fam_new, labels)) != pairs:
                    continue
                if not isinstance(h_new, expo.ParsedHistogram):
                    continue
                h_old = _series_value(fam_old, pairs)
                if (isinstance(h_old, expo.ParsedHistogram)
                        and h_old.count <= h_new.count
                        and h_old.bounds == h_new.bounds):
                    d_counts = [a - b for a, b in
                                zip(h_new.counts, h_old.counts)]
                    d_sum = h_new.sum - h_old.sum
                    d_count = h_new.count - h_old.count
                    if any(c < 0 for c in d_counts):
                        continue          # corrupt pair: skip the series
                else:                     # reset or first sight
                    d_counts = list(h_new.counts)
                    d_sum, d_count = h_new.sum, h_new.count
                if bounds is None:
                    bounds = h_new.bounds
                    counts = [0] * len(d_counts)
                elif bounds != h_new.bounds:
                    return None           # incomparable bucket layouts
                counts = [a + b for a, b in zip(counts, d_counts)]
                total_sum += d_sum
                total_count += d_count
                seen = True
        if not seen or bounds is None:
            return None
        out = expo.ParsedHistogram(bounds=bounds, counts=counts,
                                   sum=total_sum, count=total_count)
        return out

    def quantile(self, metric: str, q: float,
                 labels: dict | None = None, *,
                 window: float | None = None,
                 endpoint: str | None = None) -> float | None:
        """Windowed fleet quantile from histogram bucket deltas.

        ``None`` means *no observations in the window* — callers (the
        SLO engine, ``/v1/stats`` consumers) must treat that as "no
        data", never as zero.
        """
        h = self.histogram_delta(metric, labels, window=window,
                                 endpoint=endpoint)
        if h is None or h.count == 0:
            return None
        return h.quantile(q)

    # ------------------------------ gauges ---------------------------------

    def gauge(self, metric: str, labels: dict | None = None, *,
              agg: str = "max",
              endpoint: str | None = None) -> float | None:
        """Latest gauge value aggregated across up endpoints.

        :param agg: ``"max"``, ``"min"``, or ``"sum"`` — gauges do not
            have one universally correct fleet aggregation, so the
            caller chooses (the fleet snapshot reports max and min).
        """
        if agg not in ("max", "min", "sum"):
            raise ValueError(f"unknown gauge aggregation {agg!r}")
        if endpoint is not None:
            names = [endpoint]
        else:
            names = [n for n in self.endpoints if self.up(n)]
        values: list[float] = []
        for name in names:
            s = self.latest(name)
            if s is None or not s.ok:
                continue
            fam = s.families.get(metric)
            if fam is None:
                continue
            for pairs, v in fam.series.items():
                if labels is not None and tuple(
                        _label_pairs(fam, labels)) != pairs:
                    continue
                if isinstance(v, expo.ParsedHistogram):
                    continue
                values.append(v)
        if not values:
            return None
        if agg == "max":
            return max(values)
        if agg == "min":
            return min(values)
        return sum(values)

    # ---------------------------- aggregation ------------------------------

    def fleet_families(self) -> dict[str, dict]:
        """Latest scrapes aggregated across up endpoints.

        Counters and histogram buckets/sums/counts are summed per label
        key; gauges report ``{"max": ..., "min": ...}``.  The result is
        JSON-safe (histogram series carry their ``bounds``).

        :returns: ``{metric: {"type", "help", "series": {label_key:
            value}}}`` with label keys in the registry snapshot's
            ``"k=v,..."``/``"_"`` encoding.
        """
        agg: dict[str, dict] = {}
        for name in self.endpoints:
            if not self.up(name):
                continue
            s = self.latest(name)
            for fname, fam in s.families.items():
                out = agg.setdefault(fname, {"type": fam.kind,
                                             "help": fam.help,
                                             "series": {}})
                for pairs, v in fam.series.items():
                    key = ",".join(f"{n}={val}" for n, val in pairs) or "_"
                    if isinstance(v, expo.ParsedHistogram):
                        cur = out["series"].get(key)
                        if cur is None:
                            out["series"][key] = {
                                "count": v.count, "sum": v.sum,
                                "bounds": list(v.bounds),
                                "buckets": list(v.counts)}
                        elif cur.get("bounds") == list(v.bounds):
                            cur["count"] += v.count
                            cur["sum"] += v.sum
                            cur["buckets"] = [
                                a + b for a, b in zip(cur["buckets"],
                                                      v.counts)]
                    elif fam.kind == "gauge":
                        cur = out["series"].get(key)
                        if cur is None:
                            out["series"][key] = {"max": v, "min": v}
                        else:
                            cur["max"] = max(cur["max"], v)
                            cur["min"] = min(cur["min"], v)
                    else:                  # counter / untyped: sum
                        out["series"][key] = \
                            out["series"].get(key, 0.0) + v
        return agg

    def snapshot(self) -> dict:
        """Machine-readable fleet state: per-endpoint status + latest
        per-endpoint snapshot + the fleet aggregate.

        This is the JSON artifact the load-generator benchmark dumps
        (:meth:`dump_json`) and CI uploads.
        """
        endpoints: dict[str, dict] = {}
        for name, url in self.endpoints.items():
            s = self.latest(name)
            endpoints[name] = {
                "url": url,
                "up": self.up(name),
                "scrapes": len(self.scrapes(name)),
                "last_ts": None if s is None else s.ts,
                "error": "" if s is None else s.error,
                "health": None if s is None else s.health,
                "metrics": (expo.to_snapshot(s.families)
                            if s is not None and s.ok else None),
            }
        return {"polls": self.polls,
                "up_fraction": self.up_fraction(),
                "endpoints": endpoints,
                "fleet": self.fleet_families()}

    def dump_json(self, path: str) -> str:
        """Write :meth:`snapshot` to ``path`` (atomic tmp + replace).

        :returns: the path written.
        """
        import os
        snap = self.snapshot()
        tmp = str(path) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, str(path))
        return str(path)
