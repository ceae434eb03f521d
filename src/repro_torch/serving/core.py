"""``repro_torch.serving.core`` — the admission-controlled decode engine
(the port of ``repro.serving.core``).

The stdlib ``ThreadingHTTPServer`` model the region endpoint started
with spawns one unbounded thread per connection and decodes inline: one
fat ``POST /v1/regions`` (say, every level of a large snapshot) holds a
thread for its whole decode, and enough of them starve the host —
exactly the pipeline stall AMRIC (PAPERS.md) warns makes hot-path
compression a net loss.  :class:`AsyncServingCore` bounds that work:

  * a fixed decode pool of ``decode_workers`` threads is the only place
    region decodes run — the semaphore that caps decode concurrency is
    the pool size itself;
  * a batch is split into **per-level decode units** before admission,
    so an oversized multi-level batch interleaves with everyone else's
    units instead of monopolizing a worker for its full duration;
  * admission is bounded at ``decode_workers + queue_depth`` in-flight
    units — beyond that the batch is rejected *immediately* with
    :class:`ServerBusy` (HTTP 429 with ``Retry-After``), counted in
    ``tacz_server_backpressure_total{reason="queue_full"}``.  A closed
    (draining) core rejects with 503, ``reason="draining"``.

Splitting is transparent on the wire: unit results are re-merged into
the exact per-box × per-level layout an unsplit
``get_regions_with_crc`` returns, and a snapshot hot-swap landing
*between* units (units would disagree on the serving CRC) retries the
whole batch once against the new generation — a batch never mixes
generations.  Trace spans recorded inside pool threads are grafted back
into the caller's root span, so response ``trace`` metadata is unchanged.

Decode units run on the pool's threads against one card: the region
server underneath is thread-safe, and its decodes go to the device it
was built for.
"""
from __future__ import annotations

import math
import threading
from concurrent.futures import ThreadPoolExecutor

from .. import obs
from ..obs import metrics as obsm

__all__ = ["AsyncServingCore", "ServerBusy"]


class ServerBusy(RuntimeError):
    """Admission control rejected a batch; carries the HTTP semantics.

    ``status`` is 429 for ``reason="queue_full"`` (transient — the
    client should retry after ``retry_after`` seconds) and 503 for
    ``reason="draining"`` (the core is shutting down; retry against
    another endpoint).  Both responses carry a ``Retry-After`` header,
    which is how a well-behaved client/router distinguishes *busy* from
    *down*: busy endpoints are retried with backoff, never demoted.
    """

    def __init__(self, reason: str, retry_after_s: float,
                 pending: int, capacity: int):
        self.reason = str(reason)
        self.status = 429 if self.reason == "queue_full" else 503
        #: integer seconds for the ``Retry-After`` header (HTTP requires
        #: a non-negative integer; sub-second hints round up to 1)
        self.retry_after = max(1, int(math.ceil(float(retry_after_s))))
        self.pending = int(pending)
        self.capacity = int(capacity)
        super().__init__(
            f"server busy ({self.reason}): {self.pending}/{self.capacity} "
            f"decode units in flight; retry after {self.retry_after}s")


class AsyncServingCore:
    """Bounded-concurrency execution front for one region server.

    :param server: the object to execute against — a
        :class:`~repro_torch.serving.regions.RegionServer`, a
        :class:`~repro_torch.serving.variants.VariantServer`, or any
        other object with the serving surface (``get_regions_with_crc``;
        ``get_regions_ex`` for distortion-aware requests).
    :param decode_workers: decode pool size — the hard cap on concurrent
        region decodes.
    :param queue_depth: admitted-but-not-running unit budget on top of
        the workers; ``0`` means a unit is only admitted when a worker
        is free.
    :param retry_after_s: the ``Retry-After`` hint rejected requests
        carry (rounded up to whole seconds on the wire).
    """

    def __init__(self, server, *, decode_workers: int = 4,
                 queue_depth: int = 16, retry_after_s: float = 1.0):
        self.server = server
        self.decode_workers = max(1, int(decode_workers))
        self.queue_depth = max(0, int(queue_depth))
        #: admission bound: units in flight (queued + running)
        self.capacity = self.decode_workers + self.queue_depth
        self.retry_after_s = float(retry_after_s)
        self._pool = ThreadPoolExecutor(max_workers=self.decode_workers,
                                        thread_name_prefix="decode-worker")
        self._lock = threading.Lock()
        self._pending = 0
        self._closed = False

    # ------------------------------ lifecycle ------------------------------

    def close(self) -> None:
        """Stop admitting, then wait for in-flight units to finish."""
        with self._lock:
            self._closed = True
        self._pool.shutdown(wait=True)

    @property
    def pending(self) -> int:
        """Units currently admitted (queued + running)."""
        with self._lock:
            return self._pending

    def stats(self) -> dict:
        """Admission-control configuration and occupancy."""
        with self._lock:
            return {"decode_workers": self.decode_workers,
                    "queue_depth": self.queue_depth,
                    "capacity": self.capacity,
                    "pending": self._pending,
                    "draining": self._closed}

    # ------------------------------ admission ------------------------------

    def _reject(self, reason: str) -> None:
        obsm.SERVER_BACKPRESSURE.labels(reason).inc()
        raise ServerBusy(reason, self.retry_after_s, self._pending,
                         self.capacity)

    def _admit(self, n_units: int) -> None:
        with self._lock:
            if self._closed:
                self._reject("draining")
            if self._pending + n_units > self.capacity:
                self._reject("queue_full")
            self._pending += n_units
            obsm.SERVER_QUEUE_DEPTH.set(self._pending)

    def _release(self, n_units: int) -> None:
        with self._lock:
            self._pending = max(0, self._pending - n_units)
            obsm.SERVER_QUEUE_DEPTH.set(self._pending)

    # ------------------------------ execution ------------------------------

    def _unit_levels(self, levels, target, variant) -> list:
        """The per-unit level lists one batch splits into.

        Distortion-aware batches stay whole (variant resolution must be
        atomic per batch); plain batches split one unit per level so a
        fat multi-level request cannot monopolize the decode pool.
        """
        if target is not None or variant is not None:
            return [levels]
        if levels is None:
            n = getattr(self.server, "n_levels", 0)
            levels = list(range(int(n)))
            if not levels:
                return [None]
        levels = [int(li) for li in levels]
        if len(levels) <= 1:
            return [levels]
        return [[li] for li in levels]

    def _run_unit(self, boxes, levels, target, variant):
        """One decode unit on a pool thread.  Returns ``(crc, variant,
        results, spans)`` with the unit's finished trace spans collected
        for grafting (pool threads do not inherit the caller's root)."""
        obsm.SERVER_DECODE_UNITS.inc()
        with obs.root_span("decode_unit") as root:
            if target is None and variant is None:
                crc, results = self.server.get_regions_with_crc(
                    boxes, levels=levels)
                vname = None
            else:
                ex = getattr(self.server, "get_regions_ex", None)
                if ex is None:
                    raise ValueError(
                        "endpoint does not support distortion targets")
                crc, vname, results = ex(boxes, levels=levels,
                                         target=target, variant=variant)
        return crc, vname, results, list(root.children)

    def execute(self, boxes, levels=None, *, target=None, variant=None):
        """Serve one batch through the bounded pool.

        :returns: ``(snapshot_crc, variant_name_or_None, results)`` —
            the :meth:`RegionServer.get_regions_ex` contract, with
            ``results[b][l]`` in the caller's requested level order.
        :raises ServerBusy: admission rejected the batch (429/503).
        :raises IOError: a snapshot hot-swap raced the split batch on
            both attempts (pathological republish churn).
        """
        for attempt in (0, 1):
            units = self._unit_levels(levels, target, variant)
            self._admit(len(units))
            futs = []
            try:
                try:
                    for u in units:
                        futs.append(self._pool.submit(
                            self._run_unit, boxes, u, target, variant))
                except RuntimeError:   # pool shut down after admission
                    self._reject("draining")
                outs = [f.result() for f in futs]
            finally:
                self._release(len(units))
            if len({crc for crc, _, _, _ in outs}) == 1:
                return self._merge(outs)
            # a hot swap landed between units: units disagree on the
            # serving generation — retry the whole batch once against
            # the new snapshot rather than mixing generations
            if attempt:
                raise IOError(
                    "snapshot hot-swap raced the batch on both attempts")
        raise AssertionError("unreachable")  # pragma: no cover

    @staticmethod
    def _graft_merged(parent, span_lists) -> None:
        """Graft unit trace spans into ``parent``, merging same-name
        spans across units into one aggregate span each — so a split
        batch reports the same stage names an unsplit one does.  An
        aggregate's duration is the *sum* over units (decode work, not
        wall time — units run concurrently) and it carries a ``units``
        count; children merge recursively the same way."""
        order: list[str] = []
        groups: dict[str, list] = {}
        for spans in span_lists:
            for sp in spans:
                if sp.name not in groups:
                    order.append(sp.name)
                    groups[sp.name] = []
                groups[sp.name].append(sp)
        for name in order:
            members = groups[name]
            if len(members) == 1:
                parent.add_child(members[0])
                continue
            agg = obs.Span(name)
            agg.duration = sum(m.duration for m in members)
            agg.meta = {"units": len(members)}
            AsyncServingCore._graft_merged(
                agg, [m.children for m in members])
            parent.add_child(agg)

    def _merge(self, outs):
        """Re-merge per-unit results into the unsplit response layout,
        grafting unit trace spans into the caller's root span."""
        parent = obs.current_span()
        if parent is not None:
            self._graft_merged(parent, [spans for _, _, _, spans in outs])
        crc, vname, first, _ = outs[0]
        if len(outs) == 1:
            return crc, vname, first
        results = []
        for b in range(len(first)):
            row = []
            for _, _, unit_results, _ in outs:
                row.extend(unit_results[b])
            results.append(row)
        return crc, vname, results
