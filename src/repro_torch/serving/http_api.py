"""Thin stdlib HTTP endpoint over
:class:`repro_torch.serving.regions.RegionServer` (the port of
``repro.serving.http_api``; the wire bytes are the reference's).

JSON for metadata, raw little-endian float32 for region payloads — no
framework, no third-party deps (``http.server`` + ``ThreadingHTTPServer``).
Crops are decoded on the server's device; a batch's crops come to the
host in one copy before they are framed.

Routes::

    GET  /v1/meta                 snapshot + level metadata + cache stats
    GET  /v1/stats                cache counters + latency quantiles
    GET  /v1/metrics              Prometheus text exposition of the
                                  process-wide repro_torch.obs registry
    GET  /v1/health               liveness/readiness: snapshot CRC, cache
                                  headroom, shard reachability (router);
                                  200 ok/degraded, 503 down (with body)
    GET  /v1/region?level=L&box=x0:x1,y0:y1,z0:z1
                                  one level's crop; body = C-order <f4 bytes,
                                  shape/box/ratio travel in X-TACZ-* headers;
                                  optional &target=psnr>=60 / &variant=NAME
                                  (distortion-aware serving — the selected
                                  variant returns in X-TACZ-Variant)
    POST /v1/regions              batched: JSON {"boxes": [...], "levels":
                                  [...]?, "target": "psnr>=60"?, "variant":
                                  NAME?} in; u32 header length + JSON header
                                  + concatenated <f4 payloads out
    POST /v1/cache/export         JSON {"keys": [[level, sub_block], ...]}
                                  in; CRC-checked handoff blob of this
                                  shard's decoded bricks out (resharding)
    POST /v1/cache/import         handoff blob in; JSON import summary out
                                  (imported / skipped_foreign /
                                  skipped_stale counts)

The batched response header is ``{"snapshot_crc", "request_id", "trace",
"variant", "results"}`` where ``results[b][l]`` holds ``{level, ratio,
box, shape, offset, nbytes}`` and ``offset`` indexes into the payload
section that follows the header; ``variant`` is the eb variant that
served (null without a target); ``trace`` is the request's span-tree
summary and ``request_id`` echoes the caller's ``X-Repro-Request-Id``
header (minted here when absent) — the ID the sharded router stamps on a
batch so one slow request is greppable across every shard's access log.
A ``target`` no variant satisfies is a clean 400 whose JSON body names
the target and the best achievable value (never a 500).
Every request first runs the server's footer-CRC hot-swap check (when the
server was built with ``auto_reload=True``), so an atomically republished
snapshot is picked up without restarting the endpoint.

Concurrency model: the old one-unbounded-thread-per-connection
``ThreadingHTTPServer`` behavior is gone.  Connections are handled by a
fixed accept/parse pool (``accept_workers``), and every region decode
goes through the server's
:class:`~repro_torch.serving.core.AsyncServingCore`
— a bounded decode pool with admission control.  When the decode queue
is full the endpoint answers **429** (503 while draining) with a
``Retry-After`` header and a JSON body naming the reason; rejections are
counted in ``tacz_server_backpressure_total``.  Idle keep-alive
connections time out after ``keepalive_timeout`` seconds so they cannot
pin accept-pool workers (clients transparently reconnect).  Binary
payloads go to the socket from that host copy, a batch's in one write.

Access logging: one structured record per request (method, path, status,
duration_ms, request_id) through the ``repro_torch.serving.http`` logger at
DEBUG — quiet by default, and ``serve(..., verbose=True)`` raises it to
INFO.  The old behavior (unconditional stderr spam from
``BaseHTTPRequestHandler``) is gone either way.
"""
from __future__ import annotations

import json
import logging
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import obs
from ..io import format as fmt
from ..io import variants as vrt
from ..io.frontier import TargetUnsatisfiable
from ..obs import metrics as obsm

from .core import AsyncServingCore, ServerBusy
from .regions import RegionServer
from .variants import VariantServer

__all__ = ["RegionHTTPServer", "RegionRequestHandler", "serve",
           "format_box", "parse_box"]

#: Structured access/error log for every region endpoint in the process.
#: Quiet by default: records go out at DEBUG (INFO with ``verbose=True``)
#: and propagate to whatever handlers the host application configured.
access_log = logging.getLogger("repro_torch.serving.http")

# bounded route-label set for the HTTP metrics (an arbitrary 404 path
# must not mint an unbounded number of label values)
_KNOWN_ROUTES = ("/v1/meta", "/v1/stats", "/v1/metrics", "/v1/health",
                 "/v1/region", "/v1/regions",
                 "/v1/cache/export", "/v1/cache/import")


def format_box(box) -> str:
    """((x0,x1),(y0,y1),(z0,z1)) → ``"x0:x1,y0:y1,z0:z1"``."""
    return ",".join(f"{int(lo)}:{int(hi)}" for lo, hi in box)


def parse_box(s: str):
    """Inverse of :func:`format_box`; raises ValueError on malformed input."""
    dims = s.split(",")
    if len(dims) != 3:
        raise ValueError("box must have three x0:x1 ranges")
    box = []
    for d in dims:
        lo, _, hi = d.partition(":")
        box.append((int(lo), int(hi)))
    return tuple(box)


def _host_payload(crops) -> tuple[memoryview, list[int]]:
    """The crops' C-order ``<f4`` bytes back to back (the wire's payload
    section), after one device-to-host copy of the whole batch, and each
    crop's byte count."""
    sizes = [4 * c.numel() for c in crops]
    if not sum(sizes):         # memoryview cannot cast an empty array
        return memoryview(b""), sizes
    flat = torch.cat([c.reshape(-1) if c.dtype == torch.float32
                      else c.reshape(-1).float() for c in crops])
    host = np.ascontiguousarray(flat.cpu().numpy(), dtype="<f4")
    return memoryview(host).cast("B"), sizes


class RegionRequestHandler(BaseHTTPRequestHandler):
    """Routes ``/v1/meta|stats|region|regions`` onto one RegionServer."""

    server_version = "taczserve/1"
    protocol_version = "HTTP/1.1"

    #: set per request by :meth:`_handle`; echoed on every response
    _request_id: str = ""
    _status: int = 0

    def setup(self) -> None:
        """Idle keep-alive connections time out after the server's
        ``keepalive_timeout`` so they cannot pin a fixed-pool worker
        forever; clients re-open transparently (the region client
        already retries a dropped keep-alive connection once)."""
        self.timeout = getattr(self.server, "keepalive_timeout", 30.0)
        super().setup()

    def log_message(self, format: str, *args) -> None:
        """Base-class messages (errors, malformed requests) go through the
        structured logger instead of raw stderr — quiet by default."""
        access_log.debug("%s " + format, self.address_string(), *args)

    def log_request(self, code="-", size="-") -> None:
        """Suppressed: :meth:`_handle` emits one structured record per
        request with duration and request ID instead."""

    @property
    def rs(self) -> RegionServer:
        """The :class:`RegionServer` this endpoint serves."""
        return self.server.region_server

    # ------------------------------ plumbing -------------------------------

    def send_response(self, code: int, message: str | None = None) -> None:
        """Every response carries the request's ID back to the caller."""
        super().send_response(code, message)
        self._status = int(code)
        if self._request_id:
            self.send_header(obs.REQUEST_ID_HEADER, self._request_id)

    def _send_json(self, obj, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, status: int, msg: str) -> None:
        self._send_json({"error": msg}, status=status)

    def _busy(self, exc: ServerBusy) -> None:
        """Admission control rejected the request: 429 (queue full) or
        503 (draining), always with a ``Retry-After`` header — the
        signal that this endpoint is *busy*, not *down*."""
        body = json.dumps({"error": str(exc), "reason": exc.reason,
                           "retry_after_s": exc.retry_after}).encode()
        self.send_response(exc.status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", str(exc.retry_after))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _unsatisfiable(self, exc: TargetUnsatisfiable) -> None:
        """A distortion target no variant meets: a clean 400 whose body
        names the target and the best achievable value — an operator
        mistake, not a server failure (never a 500)."""
        self._send_json({"error": str(exc),
                         "target": str(exc.target),
                         "best": exc.best}, status=400)

    def _meta(self) -> dict:
        rd = self.rs.reader
        levels = []
        for li, e in enumerate(rd.levels):
            levels.append({
                "level": li, "shape": list(e.shape),
                "ratio": max(int(e.ratio), 1), "eb": e.eb,
                "strategy": fmt.STRATEGY_NAMES.get(e.strategy, "?"),
                "algorithm": fmt.ALGO_NAMES.get(e.algorithm, "?"),
                "n_subblocks": len(e.subblocks),
            })
        meta = {"snapshot_crc": self.rs.snapshot_crc,
                "version": rd.version, "levels": levels}
        cache = getattr(self.rs, "cache", None)
        if cache is not None:     # a mounted router has no decode cache
            meta["cache"] = cache.stats()
        if self.rs.shard_map is not None:
            shard = {"n_shards": len(self.rs.shard_map),
                     "shard_map": self.rs.shard_map.to_dict()}
            sid = getattr(self.rs, "shard_id", None)
            if sid is not None:
                shard["shard_id"] = sid
            meta["shard"] = shard
        vm = getattr(self.rs, "variants_meta", None)
        if vm is not None:   # a VariantServer advertises its catalog
            meta["variants"] = vm()
        return meta

    def _serve_batch(self, boxes, levels, target, variant):
        """Serve one batch, distortion-aware when the request asks.

        :returns: ``(snapshot_crc, variant_name_or_None, results)``.
        :raises TargetUnsatisfiable: no variant meets ``target`` (the
            caller maps it to a 400 with an explanatory body).
        :raises ValueError: malformed target / unknown variant / an
            endpoint with no distortion-target support.
        :raises ServerBusy: decode admission control rejected the batch.
        """
        core = getattr(self.server, "core", None)
        if core is not None:
            return core.execute(boxes, levels=levels, target=target,
                                variant=variant)
        # no core mounted (bare handler reuse): direct, unbounded path
        if target is None and variant is None:
            crc, results = self.rs.get_regions_with_crc(boxes,
                                                        levels=levels)
            return crc, None, results
        ex = getattr(self.rs, "get_regions_ex", None)
        if ex is None:
            raise ValueError(
                "endpoint does not support distortion targets")
        return ex(boxes, levels=levels, target=target, variant=variant)

    # ------------------------------- routes --------------------------------

    def _handle(self, method: str) -> None:
        """Per-request envelope: request-ID adoption, HTTP metrics, and
        one structured access-log record (method, path, status,
        duration_ms, request_id)."""
        url = urlparse(self.path)
        rid = self.headers.get(obs.REQUEST_ID_HEADER, "").strip()
        self._request_id = rid or obs.new_request_id()
        self._status = 0
        route = url.path if url.path in _KNOWN_ROUTES else "other"
        t0 = time.perf_counter()
        try:
            if method == "GET":
                self._route_get(url)
            else:
                self._route_post(url)
        finally:
            dt = time.perf_counter() - t0
            obsm.HTTP_REQUESTS.labels(route, str(self._status or 500)).inc()
            obsm.HTTP_REQUEST_SECONDS.labels(route).observe(dt)
            level = (logging.INFO if getattr(self.server, "verbose", False)
                     else logging.DEBUG)
            if getattr(self.server, "log_json", False):
                access_log.log(level, "%s", json.dumps(
                    {"method": method, "path": self.path,
                     "status": self._status or 500,
                     "duration_ms": round(dt * 1000.0, 3),
                     "request_id": self._request_id}, sort_keys=True))
            else:
                access_log.log(
                    level, "%s %s %d %.2fms rid=%s", method, self.path,
                    self._status or 500, dt * 1000.0, self._request_id)

    def do_GET(self) -> None:
        """Dispatch ``/v1/meta``, ``/v1/stats``, ``/v1/metrics``,
        ``/v1/region``."""
        self._handle("GET")

    def do_POST(self) -> None:
        """Dispatch ``/v1/regions`` (batched fetch)."""
        self._handle("POST")

    def _route_get(self, url) -> None:
        if url.path == "/v1/meta":
            # data routes hot-swap inside get_regions (auto_reload);
            # metadata routes run the footer check themselves
            if self.rs.auto_reload:
                self.rs.maybe_reload()
            return self._send_json(self._meta())
        if url.path == "/v1/stats":
            if self.rs.auto_reload:
                self.rs.maybe_reload()
            return self._send_json(self.rs.stats())
        if url.path == "/v1/health":
            if self.rs.auto_reload:
                self.rs.maybe_reload()
            h = self.rs.health()
            # liveness (process answers) is the 200; readiness failure is
            # a 503 *with* the body, so probes can read why
            return self._send_json(
                h, status=503 if h.get("status") == "down" else 200)
        if url.path == "/v1/metrics":
            # scrape surface: the process-wide registry covers this
            # server's cache/planner/latency series and, when a router or
            # sibling shard servers share the process, theirs too
            cache = getattr(self.rs, "cache", None)
            if cache is not None:
                obsm.refresh_cache_gauges(cache.stats())
            body = obs.REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/v1/region":
            return self._get_region(parse_qs(url.query))
        return self._fail(404, f"unknown path {url.path!r}")

    def _get_region(self, q: dict) -> None:
        try:
            level = int(q["level"][0])
            box = parse_box(q["box"][0])
            if not 0 <= level < self.rs.n_levels:
                raise ValueError(f"level {level} out of range")
        except (KeyError, IndexError, ValueError) as exc:
            return self._fail(400, f"bad region query: {exc}")
        target = (q.get("target") or [None])[0]
        variant = (q.get("variant") or [None])[0]
        try:
            crc, vname, results = self._serve_batch([box], [level],
                                                    target, variant)
            roi = results[0][0]
        except TargetUnsatisfiable as exc:
            return self._unsatisfiable(exc)
        except ServerBusy as exc:
            return self._busy(exc)
        except ValueError as exc:      # e.g. hot-swap shrank the level count
            return self._fail(400, f"bad region query: {exc}")
        except Exception as exc:       # corrupt payload, missing codec, ...
            return self._fail(500, f"region decode failed: {exc}")
        # the crop comes to the host once and goes to the socket as is
        # (wfile is unbuffered, so write() is a direct sendall)
        body, _ = _host_payload([roi.data])
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-TACZ-Level", str(roi.level))
        self.send_header("X-TACZ-Ratio", str(roi.ratio))
        self.send_header("X-TACZ-Box", format_box(roi.box))
        self.send_header("X-TACZ-Shape",
                         ",".join(str(s) for s in roi.shape))
        self.send_header("X-TACZ-Dtype", "<f4")
        self.send_header("X-TACZ-Snapshot-CRC", str(crc))
        if vname is not None:
            self.send_header("X-TACZ-Variant", str(vname))
        self.end_headers()
        self.wfile.write(body)

    def _route_post(self, url) -> None:
        if url.path == "/v1/cache/export":
            return self._cache_export()
        if url.path == "/v1/cache/import":
            return self._cache_import()
        if url.path != "/v1/regions":
            return self._fail(404, f"unknown path {url.path!r}")
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            boxes = [tuple((int(lo), int(hi)) for lo, hi in box)
                     for box in req["boxes"]]
            for box in boxes:
                if len(box) != 3:
                    raise ValueError("each box needs three (lo, hi) ranges")
            levels = req.get("levels")
            if levels is not None:
                levels = [int(li) for li in levels]
                for li in levels:
                    if not 0 <= li < self.rs.n_levels:
                        raise ValueError(f"level {li} out of range")
            target = req.get("target")
            target = None if target is None else str(target)
            variant = req.get("variant")
            variant = None if variant is None else str(variant)
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as exc:
            return self._fail(400, f"bad regions request: {exc}")
        try:
            # the CRC must name the snapshot that *served this batch* —
            # a hot-swap racing the decode must not stamp the new
            # generation on old data (the sharded router trusts this).
            # The root span makes every trace() below it (plan, fetch,
            # decode) collect into one tree this response carries back.
            with obs.root_span("regions") as span:
                crc, vname, results = self._serve_batch(boxes, levels,
                                                        target, variant)
        except TargetUnsatisfiable as exc:
            return self._unsatisfiable(exc)
        except ServerBusy as exc:
            return self._busy(exc)
        except ValueError as exc:      # e.g. hot-swap shrank the level count
            return self._fail(400, f"bad regions request: {exc}")
        except Exception as exc:       # corrupt payload, missing codec, ...
            return self._fail(500, f"region decode failed: {exc}")
        # payload section: the batch's crops come to the host in one copy,
        # which goes to the socket in one write
        payload, sizes = _host_payload([roi.data for per_box in results
                                        for roi in per_box])
        it = iter(sizes)
        total = 0
        header: dict = {"snapshot_crc": crc,
                        "request_id": self._request_id,
                        "variant": vname,
                        "trace": span.summary(), "results": []}
        for per_box in results:
            rows = []
            for roi in per_box:
                nbytes = next(it)
                rows.append({"level": roi.level, "ratio": roi.ratio,
                             "box": [list(r) for r in roi.box],
                             "shape": list(roi.shape),
                             "offset": total, "nbytes": nbytes})
                total += nbytes
            header["results"].append(rows)
        hdr = json.dumps(header).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(4 + len(hdr) + total))
        self.end_headers()
        self.wfile.write(struct.pack("<I", len(hdr)))
        self.wfile.write(hdr)
        self.wfile.write(payload)

    # --------------------------- cache handoff ----------------------------

    def _cache_export(self) -> None:
        """``POST /v1/cache/export`` — serialize the requested decoded
        bricks into a CRC-checked handoff blob (live resharding)."""
        fn = getattr(self.rs, "cache_export", None)
        if fn is None:
            return self._fail(400, "endpoint has no sub-block cache")
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            keys = [(int(li), int(sbi)) for li, sbi in req.get("keys", [])]
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as exc:
            return self._fail(400, f"bad cache export request: {exc}")
        try:
            blob = fn(keys)
        except Exception as exc:
            return self._fail(500, f"cache export failed: {exc}")
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def _cache_import(self) -> None:
        """``POST /v1/cache/import`` — ingest a handoff blob; responds
        with the import summary (a corrupt blob is a clean 400)."""
        fn = getattr(self.rs, "cache_import", None)
        if fn is None:
            return self._fail(400, "endpoint has no sub-block cache")
        try:
            n = int(self.headers.get("Content-Length", 0))
            summary = fn(self.rfile.read(n))
        except ValueError as exc:      # truncated frame / CRC mismatch
            return self._fail(400, f"bad cache handoff blob: {exc}")
        except Exception as exc:
            return self._fail(500, f"cache import failed: {exc}")
        return self._send_json(summary)


class RegionHTTPServer(ThreadingHTTPServer):
    """Worker-pooled HTTP server bound to one :class:`RegionServer` (or
    a router exposing the same serving surface).

    Unlike the ``ThreadingHTTPServer`` it subclasses, connections are
    NOT given a fresh unbounded thread each: :meth:`process_request` is
    overridden to hand every accepted socket to a fixed
    ``accept_workers``-sized pool, and all region decodes flow through
    :attr:`core` — an :class:`~repro_torch.serving.core.AsyncServingCore`
    whose admission control turns overload into fast 429s instead of an
    unbounded thread pile-up.
    """

    daemon_threads = True

    def __init__(self, addr, region_server: RegionServer, *,
                 verbose: bool = False, log_json: bool = False,
                 accept_workers: int = 32, decode_workers: int = 4,
                 queue_depth: int = 16, retry_after_s: float = 1.0,
                 keepalive_timeout: float = 30.0):
        super().__init__(addr, RegionRequestHandler)
        self.region_server = region_server
        self.verbose = verbose
        self.log_json = log_json
        self.keepalive_timeout = float(keepalive_timeout)
        self.core = AsyncServingCore(region_server,
                                     decode_workers=decode_workers,
                                     queue_depth=queue_depth,
                                     retry_after_s=retry_after_s)
        self._accept_pool = ThreadPoolExecutor(
            max_workers=max(1, int(accept_workers)),
            thread_name_prefix="http-worker")

    def process_request(self, request, client_address) -> None:
        """Hand the accepted connection to the fixed accept pool
        (replaces ThreadingMixIn's thread-per-connection)."""
        self._accept_pool.submit(self._work, request, client_address)

    def _work(self, request, client_address) -> None:
        try:
            self.finish_request(request, client_address)
        except Exception:
            self.handle_error(request, client_address)
        finally:
            self.shutdown_request(request)

    def server_close(self) -> None:
        super().server_close()
        self._accept_pool.shutdown(wait=False)
        self.core.close()


def serve(src, host: str = "127.0.0.1", port: int = 8765, *,
          cache_bytes: int = 256 << 20, auto_reload: bool = True,
          shard_map=None, shard_id: str | None = None,
          verbose: bool = False, log_json: bool = False,
          accept_workers: int = 32, decode_workers: int = 4,
          queue_depth: int = 16, retry_after_s: float = 1.0,
          keepalive_timeout: float = 30.0,
          device: str | torch.device = "cuda",
          ) -> RegionHTTPServer:
    """Build a region endpoint from a snapshot path, a RegionServer, or
    any object with the serving surface.

    :param src: a ``.tacz`` path or a multi-part snapshot directory (a
        :class:`RegionServer` is built for it), a variant-set directory
        (a :class:`repro_torch.serving.variants.VariantServer` is built —
        the endpoint then honors ``target``/``variant`` request fields),
        an already-configured :class:`RegionServer` or
        :class:`~repro_torch.serving.variants.VariantServer`, or any
        other object with their serving surface
        (``get_regions_with_crc``, ``reader``, ``n_levels``, ...), such as
        a sharded router: it serves the same routes
        (``/v1/meta|stats|metrics|health|region|regions``).
    :param host: bind address.
    :param port: bind port; ``0`` binds an ephemeral port — read it back
        from ``server_address``.
    :param cache_bytes: sub-block cache budget (path form only).
    :param auto_reload: run the footer-CRC hot-swap check per request
        (path form only).
    :param shard_map: optional :class:`repro_torch.serving.sharded.ShardMap` —
        with ``shard_id``, the endpoint serves (and caches) only the
        sub-blocks that shard owns (path form only).
    :param shard_id: this endpoint's shard in ``shard_map``.
    :param verbose: emit the structured access log at INFO instead of
        DEBUG (the ``repro_torch.serving.http`` logger; quiet by default).
    :param log_json: emit each access-log record as one JSON object
        (``method``, ``path``, ``status``, ``duration_ms``,
        ``request_id``) instead of the plain-text line — machine-parsable
        fleet logs; the plain-text format is the unchanged default.
    :param accept_workers: fixed connection-handling pool size (replaces
        the old unbounded thread-per-connection model).
    :param decode_workers: decode pool size — the hard cap on concurrent
        region decodes.
    :param queue_depth: admitted-but-waiting decode-unit budget beyond
        the workers; a batch that would exceed
        ``decode_workers + queue_depth`` in-flight units is rejected
        with 429 + ``Retry-After``.
    :param retry_after_s: the ``Retry-After`` hint on rejections.
    :param keepalive_timeout: idle keep-alive connections are closed
        after this many seconds so they cannot pin accept-pool workers.
    :param device: where a server built here decodes and caches
        (default ``"cuda"``; path forms only).
    :returns: the (not yet running) HTTP server; call ``serve_forever()``
        (typically on a thread) and ``shutdown()`` to stop.
    :raises ValueError: if only one of ``shard_map``/``shard_id`` is
        given, or the file fails TACZ validation.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """
    if not hasattr(src, "get_regions_with_crc"):
        if vrt.is_variant_set(src):
            src = VariantServer(src, cache_bytes=cache_bytes,
                                auto_reload=auto_reload,
                                shard_map=shard_map, shard_id=shard_id,
                                device=device)
        else:
            src = RegionServer(src, cache_bytes=cache_bytes,
                               auto_reload=auto_reload,
                               shard_map=shard_map, shard_id=shard_id,
                               device=device)
    return RegionHTTPServer((host, port), src, verbose=verbose,
                            log_json=log_json,
                            accept_workers=accept_workers,
                            decode_workers=decode_workers,
                            queue_depth=queue_depth,
                            retry_after_s=retry_after_s,
                            keepalive_timeout=keepalive_timeout)
