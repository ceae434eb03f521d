"""``repro_torch.serving.variants`` — distortion-aware serving of variant
sets on the device (the port of ``repro.serving.variants``).

A :class:`VariantServer` mounts a multi-variant snapshot set (a
directory the autotuner's :func:`repro_torch.tuning.write_variant_set`
published: N eb-variant snapshots of the same dataset under one CRC'd
``variants.json`` catalog — :mod:`repro_torch.io.variants`) behind the
exact serving surface :class:`~repro_torch.serving.regions.RegionServer`
exposes.
``http_api.serve`` therefore mounts either interchangeably, and the
wire protocol grows only two optional request fields:

  * ``target`` — a distortion target (``"psnr>=60"``); the catalog's
    cheapest satisfying variant serves the batch, its name travels back
    in the response metadata, and the choice lands in
    ``tacz_variant_requests_total{variant=...}``.
  * ``variant`` — an explicit variant name, bypassing selection (the
    sharded router uses this to pin every shard of a batch to the
    variant it resolved locally).

No target selects the catalog's default variant.  An unsatisfiable
target raises :class:`repro_torch.io.frontier.TargetUnsatisfiable` — a clean
HTTP 400 upstream, counted in ``tacz_variant_unsatisfied_total``.
Inner per-variant servers are built lazily (first request to a variant
opens its reader and its own cache slice) and share the server's shard
filter, ``fault_hook`` and device.
"""
from __future__ import annotations

import os
import threading

import torch

from ..device import resolve_device
from ..io import variants as vrt
from ..io.reader import Box, ROILevel
from ..obs import metrics as obsm

from .regions import RegionServer

__all__ = ["VariantServer"]


class VariantServer:
    """Serve region queries from a variant set, selecting per request.

    Construction reads and validates the catalog once; each variant's
    :class:`~repro_torch.serving.regions.RegionServer` (reader +
    device sub-block cache + planner) is created on first use and kept
    hot after.  All
    ``RegionServer`` constructor knobs apply per variant; ``cache_bytes``
    is a *per-variant* budget (variants hold different payload bytes, so
    their decoded bricks cannot share entries anyway).

    :param path: the variant-set directory (or its ``variants.json``).
    :param cache_bytes: per-variant :class:`SubBlockCache` byte budget.
    :param auto_reload: per-variant footer-CRC hot-swap check per batch.
    :param shard_map: optional shard filter, shared by every variant —
        sub-block partition is eb-independent (same index geometry), so
        one map covers the whole set.
    :param shard_id: this server's shard in ``shard_map``.
    :param entropy_engine: payload-decode engine for every variant.
    :param device: where every variant decodes and caches (default
        ``"cuda"``).
    :raises ValueError: if the catalog fails validation.
    :raises OSError: if the catalog cannot be read.
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """

    def __init__(self, path, *, cache_bytes: int = 256 << 20,
                 auto_reload: bool = False, shard_map=None,
                 shard_id: str | None = None,
                 entropy_engine: str = "auto",
                 device: str | torch.device = "cuda"):
        self.path = str(path)
        if os.path.basename(self.path) == vrt.VARIANTS_NAME:
            self.path = os.path.dirname(self.path)
        self.catalog = vrt.load_catalog(self.path)
        self.auto_reload = bool(auto_reload)
        self.shard_map = shard_map
        self.shard_id = shard_id
        self._kwargs = {"cache_bytes": int(cache_bytes),
                        "auto_reload": bool(auto_reload),
                        "shard_map": shard_map, "shard_id": shard_id,
                        "entropy_engine": entropy_engine,
                        "device": resolve_device(device)}
        self._fault_hook = None
        self._servers: dict[str, RegionServer] = {}
        self._lock = threading.Lock()

    # ----------------------------- selection -------------------------------

    @property
    def default_variant(self) -> str:
        """The catalog's default variant name (served when no target)."""
        return str(self.catalog["default"])

    def variant_names(self) -> list[str]:
        """Variant names the catalog binds, in catalog order."""
        return vrt.variant_names(self.catalog)

    def variants_meta(self) -> dict:
        """Catalog summary for ``GET /v1/meta``: default, names, and
        each variant's target/bits/metrics (not the eb vectors)."""
        return {"default": self.default_variant,
                "names": self.variant_names(),
                "variants": [{"name": str(v["name"]),
                              "target": v.get("target"),
                              "bits": int(v.get("bits", 0)),
                              "metrics": dict(v.get("metrics", {}))}
                             for v in self.catalog["variants"]]}

    def resolve(self, target=None, variant: str | None = None) -> str:
        """The variant name a request's ``target``/``variant`` binds to.

        :raises ValueError: on an unknown ``variant`` name or malformed
            target spec.
        :raises repro_torch.io.frontier.TargetUnsatisfiable: when no variant
            satisfies ``target``.
        """
        if variant is not None:
            if str(variant) not in self.variant_names():
                raise ValueError(
                    f"unknown variant {variant!r} (catalog has: "
                    f"{', '.join(self.variant_names())})")
            return str(variant)
        try:
            return str(vrt.select_variant(self.catalog, target)["name"])
        except vrt.TargetUnsatisfiable:
            obsm.VARIANT_UNSATISFIED.inc()
            raise

    def server(self, name: str) -> RegionServer:
        """The (lazily built) inner server for one variant name."""
        with self._lock:
            rs = self._servers.get(name)
            if rs is None:
                entry = next(v for v in self.catalog["variants"]
                             if str(v["name"]) == name)
                rs = RegionServer(os.path.join(self.path, entry["file"]),
                                  **self._kwargs)
                rs.fault_hook = self._fault_hook
                self._servers[name] = rs
            return rs

    # ------------------------------ lifecycle ------------------------------

    def close(self) -> None:
        """Close every inner server built so far."""
        with self._lock:
            for rs in self._servers.values():
                rs.close()
            self._servers.clear()

    def __enter__(self) -> "VariantServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def fault_hook(self):
        """Zero-arg fault-injection callable, forwarded to every inner
        server (existing and future) — same contract as
        :attr:`RegionServer.fault_hook`."""
        return self._fault_hook

    @fault_hook.setter
    def fault_hook(self, hook) -> None:
        with self._lock:
            self._fault_hook = hook
            for rs in self._servers.values():
                rs.fault_hook = hook

    # --------------- RegionServer surface (default variant) ----------------

    @property
    def reader(self):
        """The default variant's reader (``/v1/meta`` describes it)."""
        return self.server(self.default_variant).reader

    @property
    def cache(self):
        """The default variant's sub-block cache."""
        return self.server(self.default_variant).cache

    @property
    def n_levels(self) -> int:
        """Level count of the default variant."""
        return self.server(self.default_variant).n_levels

    @property
    def snapshot_crc(self) -> int:
        """Index CRC of the default variant's snapshot."""
        return self.server(self.default_variant).snapshot_crc

    def maybe_reload(self) -> bool:
        """Run the hot-swap check on every built variant server.

        :returns: True when any variant adopted a republished snapshot.
        """
        with self._lock:
            servers = list(self._servers.values())
        swapped = False
        for rs in servers:
            swapped = rs.maybe_reload() or swapped
        return swapped

    # ------------------------------- queries -------------------------------

    def get_regions_ex(self, boxes: list[Box],
                       levels: list[int] | None = None, *,
                       target=None, variant: str | None = None,
                       ) -> tuple[int, str | None, list[list[ROILevel]]]:
        """Serve a batch from the variant the request resolves to.

        :returns: ``(snapshot_crc_of_serving_variant, variant_name,
            results)`` — the CRC names the *variant's* snapshot, so the
            sharded router's generation check works per variant.
        :raises ValueError: on an unknown variant / malformed target.
        :raises repro_torch.io.frontier.TargetUnsatisfiable: when no variant
            satisfies the target.
        """
        name = self.resolve(target, variant)
        obsm.VARIANT_REQUESTS.labels(name).inc()
        crc, out = self.server(name).get_regions_with_crc(boxes, levels)
        return crc, name, out

    def get_regions_with_crc(self, boxes: list[Box],
                             levels: list[int] | None = None,
                             ) -> tuple[int, list[list[ROILevel]]]:
        """Target-less batch against the default variant — the plain
        :meth:`RegionServer.get_regions_with_crc` contract."""
        return self.server(self.default_variant).get_regions_with_crc(
            boxes, levels)

    def get_regions(self, boxes: list[Box],
                    levels: list[int] | None = None,
                    ) -> list[list[ROILevel]]:
        """Target-less batch against the default variant."""
        return self.get_regions_with_crc(boxes, levels)[1]

    def get_region(self, level: int, box: Box) -> ROILevel:
        """One level's crop from the default variant."""
        return self.get_regions([box], levels=[level])[0][0]

    def get_roi(self, box: Box) -> list[ROILevel]:
        """All levels' crops from the default variant, finest first."""
        return self.get_regions([box])[0]

    # ----------------------------- introspection ---------------------------

    def stats(self) -> dict:
        """The default variant's stats plus per-variant cache summaries
        under ``variants`` (only variants that have served appear)."""
        s = self.server(self.default_variant).stats()
        with self._lock:
            built = dict(self._servers)
        s["variants"] = {"default": self.default_variant,
                         "names": self.variant_names(),
                         "built": sorted(built),
                         "caches": {n: rs.cache.stats()
                                    for n, rs in built.items()}}
        return s

    def health(self) -> dict:
        """Default variant's health, re-labeled ``role="variant-server"``
        with the catalog summary under ``checks["variants"]``.

        A missing default snapshot is ``down`` exactly as on a single
        server; unbuilt variants are not probed (first use will surface
        their failures as request errors).
        """
        try:
            h = self.server(self.default_variant).health()
        except Exception as exc:   # default variant unopenable
            h = {"status": "down", "snapshot_crc": None,
                 "checks": {"snapshot": {"ok": False,
                                         "error": str(exc)}}}
        h["role"] = "variant-server"
        h["checks"]["variants"] = {"ok": True,
                                   "default": self.default_variant,
                                   "names": self.variant_names()}
        return h
