"""``repro_torch.serving.client`` — stdlib client for the region endpoint
(the port of ``repro.serving.client``).

Mirrors the server's wire format (``repro_torch.serving.http_api``, the
reference's bytes): metadata as JSON, region payloads as raw
little-endian float32 reassembled into
:class:`~repro_torch.io.reader.ROILevel` objects whose ``data`` is a
numpy array, as the reference's client returns: a remote fetch lands on
the host.  It talks to the reference's endpoints and the port's alike.
"""
from __future__ import annotations

import http.client
import io
import json
import struct
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

from .. import obs
from ..io.reader import ROILevel

from .http_api import format_box, parse_box

__all__ = ["RegionClient", "RegionAPIError"]


class RegionAPIError(urllib.error.HTTPError):
    """An HTTP error response from a region endpoint, with context.

    Subclasses ``urllib.error.HTTPError`` (existing ``except`` clauses
    keep working) but the message carries everything a fleet operator
    needs to attribute the failure: the URL, the HTTP status + reason,
    an excerpt of the response body (the server's JSON ``error``
    message), and the server's request ID — greppable in the shard's
    access log via ``rid=<id>``.
    """

    def __init__(self, url: str, status: int, reason: str,
                 headers, body: bytes):
        super().__init__(url, status, reason, headers, io.BytesIO(body))
        self.request_id = (headers.get(obs.REQUEST_ID_HEADER, "")
                           if headers else "") or ""
        try:
            excerpt = body[:200].decode("utf-8", "replace")
        except Exception:   # pragma: no cover - bytes always decode here
            excerpt = repr(body[:200])
        self.body_excerpt = excerpt

    def __str__(self) -> str:
        rid = f" request_id={self.request_id}" if self.request_id else ""
        body = f": {self.body_excerpt}" if self.body_excerpt else ""
        return (f"HTTP {self.code} {self.reason} from {self.url}"
                f"{rid}{body}")


class RegionClient:
    """Client for one region endpoint (``http://host:port``).

    Backpressure: a 429/503 response carrying a ``Retry-After`` header
    means the endpoint is *busy*, not down — admission control rejected
    the request because its decode queue is full.  The client honors the
    hint transparently: it sleeps ``min(Retry-After, busy_backoff_cap)``
    and retries, up to ``busy_retries`` times, before surfacing the
    :class:`RegionAPIError`.  (A 503 *without* ``Retry-After`` — e.g. a
    health readiness failure — is never retried.)

    :param base_url: endpoint root, e.g. ``"http://127.0.0.1:8765"``
        (trailing slash tolerated).
    :param timeout: per-request socket timeout in seconds.
    :param busy_retries: how many 429/503 + ``Retry-After`` rejections to
        wait out per request before raising (0 disables).
    :param busy_backoff_cap: upper bound in seconds on each honored
        ``Retry-After`` sleep.
    """

    def __init__(self, base_url: str, *, timeout: float = 30.0,
                 busy_retries: int = 2, busy_backoff_cap: float = 2.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)
        self.busy_retries = max(0, int(busy_retries))
        self.busy_backoff_cap = float(busy_backoff_cap)
        split = urllib.parse.urlsplit(self.base_url)
        if split.scheme not in ("http", "https") or not split.hostname:
            raise ValueError(
                f"base_url must be http(s)://host[:port][/prefix], "
                f"got {base_url!r}")
        self._conn_cls = (http.client.HTTPSConnection
                          if split.scheme == "https"
                          else http.client.HTTPConnection)
        self._host = split.hostname
        self._port = split.port   # None → the scheme's default port
        self._prefix = split.path.rstrip("/")   # e.g. a reverse-proxy root
        self._local = threading.local()   # one keep-alive conn per thread

    def _busy_delay(self, retry_after: str) -> float:
        """The (capped) sleep a ``Retry-After`` hint asks for."""
        try:
            delay = float(retry_after)
        except (TypeError, ValueError):
            delay = 1.0
        return min(max(delay, 0.0), self.busy_backoff_cap)

    def _get(self, path: str):
        """``GET`` with contextual errors: a 4xx/5xx response raises
        :class:`RegionAPIError` (status + body excerpt + the server's
        request ID) instead of a bare ``HTTPError``.  A 429/503 with a
        ``Retry-After`` header is waited out up to ``busy_retries``
        times first (server busy, not down)."""
        busy_left = self.busy_retries
        while True:
            try:
                return urllib.request.urlopen(self.base_url + path,
                                              timeout=self.timeout)
            except urllib.error.HTTPError as exc:
                body = b""
                try:
                    body = exc.read()
                except Exception:  # pragma: no cover - unreadable body
                    pass
                ra = (exc.headers.get("Retry-After")
                      if exc.headers else None)
                if exc.code in (429, 503) and ra is not None and busy_left:
                    busy_left -= 1
                    time.sleep(self._busy_delay(ra))
                    continue
                raise RegionAPIError(self.base_url + path, exc.code,
                                     exc.reason, exc.headers,
                                     body) from exc

    def _post(self, path: str, body: bytes,
              headers: dict | None = None) -> tuple[dict, bytes]:
        """``POST`` over a per-thread persistent HTTP/1.1 connection.

        The batched-regions route is the hot path of the sharded router
        (several POSTs per batch per shard); reusing the connection avoids
        a TCP handshake per request.  A dropped/stale connection is
        retried once on a fresh one; HTTP errors surface as
        :class:`RegionAPIError` (an ``urllib.error.HTTPError`` subclass,
        same contract as the GET routes).
        """
        send_headers = {"Content-Type": "application/json"}
        if headers:
            send_headers.update(headers)
        drop_left, busy_left = 1, self.busy_retries
        while True:
            conn = getattr(self._local, "conn", None)
            try:
                if conn is None:
                    conn = self._conn_cls(self._host, self._port,
                                          timeout=self.timeout)
                    self._local.conn = conn
                conn.request("POST", self._prefix + path, body=body,
                             headers=send_headers)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as exc:
                self._local.conn = None
                if conn is not None:
                    conn.close()
                if not drop_left:
                    raise urllib.error.URLError(exc) from exc
                drop_left -= 1
                continue
            if resp.status in (429, 503):
                # busy, not down: honor the Retry-After hint and retry
                ra = resp.headers.get("Retry-After")
                if ra is not None and busy_left:
                    busy_left -= 1
                    if resp.will_close:
                        self._local.conn = None
                        conn.close()
                    time.sleep(self._busy_delay(ra))
                    continue
            if resp.status >= 400:
                self._local.conn = None
                conn.close()
                raise RegionAPIError(self.base_url + path, resp.status,
                                     resp.reason, resp.headers, data)
            if resp.will_close:
                self._local.conn = None
                conn.close()
            return dict(resp.headers), data

    def meta(self) -> dict:
        """Snapshot + level metadata + cache stats (``GET /v1/meta``).

        :returns: dict with ``snapshot_crc``, ``version``, per-level
            ``levels`` rows, ``cache`` counters, and ``shard`` info when
            the endpoint is shard-filtered.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        with self._get("/v1/meta") as resp:
            return json.loads(resp.read())

    def stats(self) -> dict:
        """Cache/serving counters only (``GET /v1/stats``).

        :returns: the server's :meth:`RegionServer.stats` dict.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        with self._get("/v1/stats") as resp:
            return json.loads(resp.read())

    def region(self, level: int, box, *, target=None,
               variant=None) -> ROILevel:
        """One level's crop of ``box`` (finest-grid cells).

        :param level: level index on the serving snapshot.
        :param box: three half-open ``(lo, hi)`` ranges in finest cells.
        :param target: optional distortion target (``"psnr>=60"``) — the
            endpoint serves the cheapest satisfying eb variant.
        :param variant: optional explicit variant name.
        :returns: the crop, reassembled from the raw ``<f4`` body and the
            ``X-TACZ-*`` headers.
        :raises urllib.error.HTTPError: on a 4xx/5xx response (including
            a 400 for an unsatisfiable target).
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        path = f"/v1/region?level={int(level)}&box={format_box(box)}"
        if target is not None:
            path += "&target=" + urllib.parse.quote(str(target))
        if variant is not None:
            path += "&variant=" + urllib.parse.quote(str(variant))
        with self._get(path) as resp:
            raw = resp.read()
            shape = tuple(int(s) for s in
                          resp.headers["X-TACZ-Shape"].split(",")
                          if s != "")
            lbox = parse_box(resp.headers["X-TACZ-Box"])
            data = np.frombuffer(raw, dtype="<f4").reshape(shape)
            return ROILevel(level=int(resp.headers["X-TACZ-Level"]),
                            ratio=int(resp.headers["X-TACZ-Ratio"]),
                            box=lbox, data=data)

    def regions(self, boxes, levels=None, *, target=None,
                variant=None) -> list[list[ROILevel]]:
        """Batched fetch — one list of per-level crops per box.

        :param boxes: half-open boxes in finest-grid cells.
        :param levels: optional level-index filter applied to every box.
        :param target: optional distortion target (``"psnr>=60"``).
        :param variant: optional explicit variant name.
        :returns: ``out[b][l]`` = crop of ``boxes[b]`` at the l-th
            requested level.
        :raises urllib.error.HTTPError: on a 4xx/5xx response.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        return self.regions_meta(boxes, levels, target=target,
                                 variant=variant)[1]

    def regions_meta(self, boxes, levels=None, *, request_id=None,
                     target=None, variant=None,
                     ) -> tuple[int, list[list[ROILevel]]]:
        """Batched fetch that also returns the serving snapshot identity.

        Same wire call as :meth:`regions`, but the footer index CRC the
        endpoint reported alongside the payload is surfaced — the sharded
        router compares it with its own snapshot to detect a shard that
        has not yet picked up a republish.

        :returns: ``(snapshot_crc, results)`` with ``results`` as in
            :meth:`regions`.
        :raises RegionAPIError: on a 4xx/5xx response.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        header, out = self.regions_ex(boxes, levels,
                                      request_id=request_id,
                                      target=target, variant=variant)
        return int(header["snapshot_crc"]), out

    def regions_ex(self, boxes, levels=None, *, request_id=None,
                   target=None, variant=None,
                   ) -> tuple[dict, list[list[ROILevel]]]:
        """Batched fetch returning the full response header.

        The header carries ``snapshot_crc``, the server's ``request_id``
        (equal to ``request_id`` when one was sent — the fleet-tracing
        contract), ``variant`` — the eb variant that served the batch
        (null unless the endpoint is distortion-aware and a ``target``/
        ``variant`` was sent) — and ``trace`` — the server's span-tree
        summary for this batch (stage timings in milliseconds).

        :param request_id: optional caller-minted ID propagated via the
            ``X-Repro-Request-Id`` header (the sharded router stamps one
            per batch so every shard logs the same ID).
        :param target: optional distortion target (``"psnr>=60"``) — an
            unsatisfiable one is a :class:`RegionAPIError` with code 400
            whose body names the best achievable value.
        :param variant: optional explicit variant name.
        :returns: ``(response_header_dict, results)``.
        :raises RegionAPIError: on a 4xx/5xx response.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        req = {"boxes": [[list(r) for r in box] for box in boxes]}
        if levels is not None:
            req["levels"] = [int(li) for li in levels]
        if target is not None:
            req["target"] = str(target)
        if variant is not None:
            req["variant"] = str(variant)
        body = json.dumps(req).encode()
        extra = ({obs.REQUEST_ID_HEADER: str(request_id)}
                 if request_id else None)
        _, blob = self._post("/v1/regions", body, extra)
        (hdr_len,) = struct.unpack_from("<I", blob, 0)
        header = json.loads(blob[4:4 + hdr_len])
        payload = blob[4 + hdr_len:]
        out: list[list[ROILevel]] = []
        for rows in header["results"]:
            per_box: list[ROILevel] = []
            for r in rows:
                shape = tuple(r["shape"])
                data = np.frombuffer(
                    payload, dtype="<f4", offset=r["offset"],
                    count=int(np.prod(shape, dtype=np.int64)),
                ).reshape(shape)
                per_box.append(ROILevel(
                    level=r["level"], ratio=r["ratio"],
                    box=tuple(tuple(v) for v in r["box"]), data=data))
            out.append(per_box)
        return header, out

    def metrics(self) -> dict:
        """The endpoint's metrics, scraped and parsed
        (``GET /v1/metrics`` through :func:`repro_torch.obs.expo.parse`).

        :returns: ``{family_name:``
            :class:`repro_torch.obs.expo.ParsedFamily`
            ``}`` — counters/gauges as floats, histograms as
            :class:`~repro_torch.obs.expo.ParsedHistogram` with bucket bounds
            and quantile estimation.  Use :meth:`metrics_text` for the
            raw exposition body.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        :raises ValueError: if the scrape body is malformed.
        """
        from ..obs import expo
        return expo.parse(self.metrics_text())

    def metrics_text(self) -> str:
        """The endpoint's raw Prometheus text exposition
        (``GET /v1/metrics``).

        :returns: the scrape body as text.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        with self._get("/v1/metrics") as resp:
            return resp.read().decode("utf-8")

    def health(self) -> dict:
        """The endpoint's liveness/readiness report
        (``GET /v1/health``).

        :returns: the health dict — ``status`` (``"ok"`` | ``"degraded"``
            | ``"down"``), ``snapshot_crc``, ``checks`` — from
            :meth:`RegionServer.health` or the router's fleet view.  A
            503 (readiness failure) still returns the body rather than
            raising, so callers can read *why* the endpoint is not ready.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        try:
            with self._get("/v1/health") as resp:
                return json.loads(resp.read())
        except RegionAPIError as exc:
            if exc.code == 503:
                try:
                    return json.loads(exc.read())
                except ValueError:
                    pass
            raise

    def cache_export(self, keys) -> bytes:
        """Pull a CRC-checked handoff blob of the endpoint's decoded
        bricks for ``keys`` (``POST /v1/cache/export``).

        Used during live resharding: the old owner of moved keys exports
        its warm bricks so the new owner can start warm (see
        :meth:`RegionServer.cache_export` for the wire format).

        :param keys: ``(level, sub_block)`` pairs to export.
        :returns: the handoff blob (feed to a peer's
            :meth:`cache_import`).
        :raises RegionAPIError: e.g. 400 from an endpoint with no cache.
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        body = json.dumps(
            {"keys": [[int(li), int(sbi)] for li, sbi in keys]}).encode()
        _, blob = self._post("/v1/cache/export", body)
        return blob

    def cache_import(self, blob: bytes) -> dict:
        """Push a handoff blob into the endpoint's cache
        (``POST /v1/cache/import``).

        :param blob: bytes from a peer's :meth:`cache_export`.
        :returns: the import summary — ``imported``, ``skipped_foreign``,
            ``skipped_stale``, ``bytes``, ``snapshot_crc``.
        :raises RegionAPIError: 400 on a corrupt blob (CRC mismatch).
        :raises urllib.error.URLError: if the endpoint is unreachable.
        """
        _, data = self._post("/v1/cache/import", bytes(blob),
                             {"Content-Type": "application/octet-stream"})
        return json.loads(data)
