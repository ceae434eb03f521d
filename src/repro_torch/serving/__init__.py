"""Serving: region serving over TACZ snapshots (:class:`RegionServer`,
its :class:`DecodePlanner` and device-resident :class:`SubBlockCache`),
sharded serving (:class:`ShardMap` placement and the scatter-gather
:class:`ShardedRegionRouter`), open-loop Zipf load generation
(:class:`LoadGenerator`, :class:`ZipfWorkload`, :func:`client_fetch`),
distortion-aware serving of variant sets (:class:`VariantServer`), the
admission-controlled decode pool (:class:`AsyncServingCore`), the HTTP
endpoint (:func:`serve`, :class:`RegionHTTPServer`) and its client
(:class:`RegionClient`), and LM serving (the int8 KV-cache conversions,
kernels 7 and 8, and the batched prefill/decode engine)."""
from .client import RegionAPIError, RegionClient
from .core import AsyncServingCore, ServerBusy
from .engine import ServingEngine, make_prefill_step, make_serve_step
from .http_api import RegionHTTPServer, serve
from .kv_cache import dequantize_kv, quantize_kv, quantize_prefill_cache
from .loadgen import LoadGenerator, LoadReport, ZipfWorkload, client_fetch
from .regions import DecodePlanner, RegionServer, SubBlockCache
from .sharded import ShardedRegionRouter, ShardMap
from .variants import VariantServer

__all__ = ["AsyncServingCore", "DecodePlanner", "LoadGenerator",
           "LoadReport", "RegionAPIError", "RegionClient",
           "RegionHTTPServer", "RegionServer", "ServerBusy", "ServingEngine",
           "ShardMap", "ShardedRegionRouter", "SubBlockCache",
           "VariantServer", "ZipfWorkload", "client_fetch",
           "dequantize_kv", "make_prefill_step", "make_serve_step",
           "quantize_kv", "quantize_prefill_cache", "serve"]
