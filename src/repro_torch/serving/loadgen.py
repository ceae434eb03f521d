"""``repro_torch.serving.loadgen`` — an honest, open-loop traffic
generator for the region-serving fleet (the port of
``repro.serving.loadgen``; pure Python, the same draws for the same
seed).

The workload shape comes from the AMReX visualization study (PAPERS.md):
interactive viewers issue *many small, skewed* ROI queries — a handful
of hot regions absorb most of the traffic, with a long tail of one-off
boxes.  :class:`ZipfWorkload` models that as a fixed population of
(box, level) queries whose request probability follows a Zipf law over
popularity rank, drawn from three ROI size classes (≈1/8, 1/4, 1/2 of
the level extent per axis) so a request mix stresses both the cache
(small hot boxes) and the batched decode path (large cold ones).

:class:`LoadGenerator` drives a fetch function with that workload
**open-loop**: request *i* is due at ``t0 + i/rate`` regardless of how
fast earlier requests completed.  This is the honest way to measure a
service — a closed loop (send next after previous returns) lets a slow
server throttle its own load and hides saturation entirely.  Here, when
the fleet falls behind, due requests queue and ``achieved_rate <
offered_rate`` in the report *is* the saturation signal; client-side
per-request latency (which then includes queueing) is recorded for
exact p50/p99 — not bucket estimates.

Responses are sampled for **bit-identity** against a local reader
(``read_level_box`` on the same snapshot, on any device): both sides
come to the host and must be equal float32 for float32, so a load test
doubles as a correctness check — a fleet that got fast by corrupting
crops fails the run.  The SLO engine (:mod:`repro_torch.obs.slo`)
renders the pass/fail verdict on top of a
:class:`~repro_torch.obs.collect.FleetCollector` watching the fleet
during the run.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Query", "ZipfWorkload", "LoadGenerator", "LoadReport",
           "client_fetch"]


@dataclass(frozen=True)
class Query:
    """One request of the workload population."""

    box: tuple            # half-open finest-grid box, three (lo, hi)
    levels: tuple[int, ...]
    rank: int             # popularity rank (0 = hottest)


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    """Exact nearest-rank-interpolated percentile of a sorted list."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class ZipfWorkload:
    """A Zipf-popularity population of mixed-size ROI queries.

    :param shape: the finest level's extent (finest-grid cells) queries
        are drawn inside.
    :param levels: level indices each query asks for (default ``(0,)`` —
        the finest level, the expensive one).
    :param population: number of distinct queries; popularity rank *r*
        (0-based) is requested with probability ∝ ``1/(r+1)**s``.
    :param s: Zipf exponent (≈1.1 matches measured web/viewer traffic:
        skewed but heavy-tailed).
    :param size_fracs: per-axis box extents as fractions of ``shape``,
        cycled over the population — the default mixes ≈1/8, 1/4, and
        1/2-extent boxes.
    :param seed: RNG seed; the same seed reproduces the same population
        *and* the same request sequence.
    """

    def __init__(self, shape, *, levels=(0,), population: int = 64,
                 s: float = 1.1, size_fracs=(0.125, 0.25, 0.5),
                 seed: int = 0):
        if population <= 0:
            raise ValueError("population must be positive")
        self.shape = tuple(int(d) for d in shape)
        self.levels = tuple(int(li) for li in levels)
        self.s = float(s)
        rng = random.Random(seed)
        self.queries: list[Query] = []
        for rank in range(int(population)):
            frac = size_fracs[rank % len(size_fracs)]
            box = []
            for dim in self.shape:
                ext = max(1, min(dim, int(round(dim * frac))))
                lo = rng.randrange(0, max(1, dim - ext + 1))
                box.append((lo, lo + ext))
            self.queries.append(Query(box=tuple(box), levels=self.levels,
                                      rank=rank))
        weights = [1.0 / (r + 1) ** self.s for r in range(population)]
        total = sum(weights)
        self._weights = [w / total for w in weights]
        self._rng = random.Random(seed + 1)
        self._lock = threading.Lock()

    def sample(self) -> Query:
        """Draw one query, Zipf-weighted by popularity rank."""
        with self._lock:
            return self._rng.choices(self.queries, self._weights)[0]

    def sequence(self, n: int) -> list[Query]:
        """The next ``n`` draws (deterministic for a fixed seed +
        call history)."""
        return [self.sample() for _ in range(n)]


@dataclass
class LoadReport:
    """Client-side result of one :meth:`LoadGenerator.run`.

    Latencies are exact (sorted client-side samples, seconds), not
    bucket estimates; ``saturated`` means the open-loop generator could
    not sustain the offered rate — the fleet's capacity is below it.
    """

    offered_rate: float
    achieved_rate: float
    duration_s: float
    requests: int
    errors: int
    verified: int
    mismatches: int
    p50_s: float | None
    p90_s: float | None
    p99_s: float | None
    mean_s: float | None
    max_s: float | None
    max_lag_s: float         # worst send-time slip behind schedule
    error_messages: list[str] = field(default_factory=list)

    @property
    def saturated(self) -> bool:
        """True when achieved throughput fell >10 % under offered."""
        return self.achieved_rate < 0.9 * self.offered_rate

    def to_dict(self) -> dict:
        """JSON-safe summary (what the bench merges into its rows)."""
        return {
            "offered_rate": self.offered_rate,
            "achieved_rate": round(self.achieved_rate, 3),
            "duration_s": round(self.duration_s, 4),
            "requests": self.requests,
            "errors": self.errors,
            "verified": self.verified,
            "mismatches": self.mismatches,
            "saturated": self.saturated,
            "p50_ms": None if self.p50_s is None
            else round(self.p50_s * 1000.0, 3),
            "p90_ms": None if self.p90_s is None
            else round(self.p90_s * 1000.0, 3),
            "p99_ms": None if self.p99_s is None
            else round(self.p99_s * 1000.0, 3),
            "mean_ms": None if self.mean_s is None
            else round(self.mean_s * 1000.0, 3),
            "max_ms": None if self.max_s is None
            else round(self.max_s * 1000.0, 3),
            "max_lag_ms": round(self.max_lag_s * 1000.0, 3),
        }


def _host(data) -> np.ndarray:
    """A crop as a host array: a tensor (a reader's or a router's, on any
    device) comes to the host; a client's array is taken as is."""
    if hasattr(data, "detach"):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def client_fetch(client):
    """Adapt a :class:`~repro_torch.serving.client.RegionClient` (or anything
    with ``regions(boxes, levels)``) into the ``fetch(query)`` callable
    :class:`LoadGenerator` drives.

    :returns: ``fetch(query) -> list[ROILevel]`` (the per-level crops of
        the query's single box).
    """
    def fetch(query: Query):
        return client.regions([query.box], levels=list(query.levels))[0]
    return fetch


class LoadGenerator:
    """Open-loop load driver with bounded concurrency and sampled
    bit-identity verification.

    :param fetch: ``fetch(query) -> list[ROILevel]`` — issues one
        request (see :func:`client_fetch`).  Exceptions count as errors;
        they never abort the run.
    :param workload: the :class:`ZipfWorkload` to draw queries from.
    :param rate: offered request rate, requests/second.  The schedule is
        fixed up front (request *i* due at ``i/rate``); a fleet that
        cannot keep up shows ``achieved_rate < rate``.
    :param concurrency: worker threads — the client-side in-flight
        bound.  Open-loop semantics hold as long as workers are
        available; when all are busy past a request's due time, the
        request is sent late and the slip is reported as ``max_lag_s``.
    :param verify_reader: optional local reader (``read_level_box(level,
        box)`` on the same snapshot) for bit-identity sampling.
    :param verify_fraction: fraction of requests to verify (0 disables).
    :param seed: RNG seed for the verify-sampling decisions.
    """

    def __init__(self, fetch, workload: ZipfWorkload, *,
                 rate: float = 50.0, concurrency: int = 4,
                 verify_reader=None, verify_fraction: float = 0.1,
                 seed: int = 0):
        if rate <= 0:
            raise ValueError("rate must be positive")
        if concurrency <= 0:
            raise ValueError("concurrency must be positive")
        self.fetch = fetch
        self.workload = workload
        self.rate = float(rate)
        self.concurrency = int(concurrency)
        self.verify_reader = verify_reader
        self.verify_fraction = float(verify_fraction)
        self._seed = int(seed)

    def _verify(self, query: Query, rois) -> bool:
        """Bit-identity of one response against the local reader: both
        crops on the host, equal float32 for float32 (no tolerance)."""
        rd = self.verify_reader
        for roi in rois:
            local = _host(rd.read_level_box(roi.level, roi.box))
            got = _host(roi.data)
            if got.dtype != local.dtype or not np.array_equal(got, local):
                return False
        return True

    def run(self, n_requests: int, *,
            actions: dict | None = None) -> LoadReport:
        """Drive ``n_requests`` through the fleet and report.

        Blocks until every request completed (or errored).  Thread-safe
        against the fetch function only to the extent the underlying
        client is — :class:`~repro_torch.serving.client.RegionClient` keeps
        one keep-alive connection per thread, so the default stack is
        safe at any concurrency.

        :param actions: optional ``{request_index: callable}`` — the
            worker that claims index *i* runs ``actions[i]()`` once,
            inline, before waiting for the request's due time.  This is
            how a benchmark injects a mid-run control-plane event (e.g.
            a live reshard) at a deterministic point in the request
            stream.  An action that raises is recorded as an error
            (tagged ``action@i``), so a zero-errors gate catches it.
        :returns: the :class:`LoadReport` (exact client-side
            percentiles, error/mismatch counts, saturation).
        """
        n = int(n_requests)
        actions = dict(actions or {})
        queries = self.workload.sequence(n)
        rng = random.Random(self._seed)
        verify_mask = [self.verify_reader is not None
                       and rng.random() < self.verify_fraction
                       for _ in range(n)]
        latencies: list[float] = []
        errors: list[str] = []
        verified = mismatches = 0
        max_lag = 0.0
        lock = threading.Lock()
        next_idx = [0]
        t0 = time.perf_counter()

        def worker() -> None:
            nonlocal verified, mismatches, max_lag
            while True:
                with lock:
                    i = next_idx[0]
                    if i >= n:
                        return
                    next_idx[0] += 1
                action = actions.pop(i, None) if actions else None
                if action is not None:
                    try:
                        action()
                    except Exception as exc:  # noqa: BLE001 — record
                        with lock:
                            if len(errors) < 20:
                                errors.append(
                                    f"action@{i} "
                                    f"{type(exc).__name__}: {exc}")
                            else:
                                errors.append("")
                due = i / self.rate
                now = time.perf_counter() - t0
                if now < due:
                    time.sleep(due - now)
                    lag = 0.0
                else:
                    lag = now - due       # behind schedule: send late,
                t_send = time.perf_counter()  # report the slip honestly
                try:
                    rois = self.fetch(queries[i])
                    dt = time.perf_counter() - t_send
                    ok = None
                    if verify_mask[i]:
                        ok = self._verify(queries[i], rois)
                except Exception as exc:   # noqa: BLE001 — count, go on
                    dt = time.perf_counter() - t_send
                    with lock:
                        latencies.append(dt)
                        if len(errors) < 20:
                            errors.append(f"{type(exc).__name__}: {exc}")
                        else:
                            errors.append("")
                        max_lag = max(max_lag, lag)
                    continue
                with lock:
                    latencies.append(dt)
                    max_lag = max(max_lag, lag)
                    if ok is not None:
                        verified += 1
                        if not ok:
                            mismatches += 1

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"loadgen-{k}")
                   for k in range(self.concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        lats = sorted(latencies)
        n_err = len(errors)
        return LoadReport(
            offered_rate=self.rate,
            achieved_rate=(n / wall) if wall > 0 else 0.0,
            duration_s=wall,
            requests=n,
            errors=n_err,
            verified=verified,
            mismatches=mismatches,
            p50_s=_percentile(lats, 0.50),
            p90_s=_percentile(lats, 0.90),
            p99_s=_percentile(lats, 0.99),
            mean_s=(sum(lats) / len(lats)) if lats else None,
            max_s=lats[-1] if lats else None,
            max_lag_s=max_lag,
            error_messages=[e for e in errors if e][:20],
        )
