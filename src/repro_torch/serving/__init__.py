"""Serving: region serving over TACZ snapshots (:class:`RegionServer`,
its :class:`DecodePlanner` and device-resident :class:`SubBlockCache`,
the :class:`ShardMap` of sharded serving), distortion-aware serving of
variant sets (:class:`VariantServer`), the admission-controlled decode
pool (:class:`AsyncServingCore`), the HTTP endpoint (:func:`serve`,
:class:`RegionHTTPServer`) and its client (:class:`RegionClient`), and
LM serving (the int8 KV-cache conversions, kernels 7 and 8, and the
batched prefill/decode engine).  The sharded router and the load
generator are not yet ported."""
from .client import RegionAPIError, RegionClient  # noqa: F401
from .core import AsyncServingCore, ServerBusy  # noqa: F401
from .engine import ServingEngine, make_prefill_step, make_serve_step  # noqa: F401
from .http_api import RegionHTTPServer, serve  # noqa: F401
from .kv_cache import dequantize_kv, quantize_kv, quantize_prefill_cache  # noqa: F401
from .regions import DecodePlanner, RegionServer, SubBlockCache  # noqa: F401
from .sharded import ShardMap  # noqa: F401
from .variants import VariantServer  # noqa: F401
