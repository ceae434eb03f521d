"""Serving: region serving over TACZ snapshots (:class:`RegionServer`,
its :class:`DecodePlanner` and device-resident :class:`SubBlockCache`,
the :class:`ShardMap` of sharded serving), and LM serving (the int8
KV-cache conversions, kernels 7 and 8, and the batched prefill/decode
engine)."""
from .engine import ServingEngine, make_prefill_step, make_serve_step  # noqa: F401
from .kv_cache import dequantize_kv, quantize_kv, quantize_prefill_cache  # noqa: F401
from .regions import DecodePlanner, RegionServer, SubBlockCache  # noqa: F401
from .sharded import ShardMap  # noqa: F401
