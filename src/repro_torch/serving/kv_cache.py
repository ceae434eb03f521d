"""KV-cache compression: int8 codes with one float32 scale per (token,
head) vector.

Each (token, head) vector is a unit block with its own scale, as TAC
gives each block its own error bound.  ``quantize_kv`` (kernel 7) and
``dequantize_kv`` (kernel 8, then a cast) are the reference's names for
:func:`~repro_torch.models.attention.quantize_heads` and
:func:`~repro_torch.models.attention.dequantize_heads`, which also
quantize each decode step's new K/V.
"""
from __future__ import annotations

from ..models.attention import dequantize_heads as dequantize_kv
from ..models.attention import quantize_heads as quantize_kv
from ..models.model import check_ported

__all__ = ["quantize_kv", "dequantize_kv", "quantize_prefill_cache"]


def quantize_prefill_cache(cfg, state: dict) -> dict:
    """Convert a prefill-produced bf16 cache stack to the int8 layout:
    one kernel-7 launch for the K stack and one for the V stack."""
    check_ported(cfg)
    kq, ks = quantize_kv(state["k"])
    vq, vs = quantize_kv(state["v"])
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
