"""GQA attention with RoPE, KV caches and a blocked online softmax.

Modes, as in the reference:

* train/prefill — causal self-attention over the whole sequence by
  :func:`flash_attention`, an online softmax over (q-chunk × kv-chunk)
  blocks (plain torch products; the reference's is a ``lax.scan``, not a
  Pallas kernel).  Prefill also returns the layer's K/V.
* decode — the new tokens against a KV cache by :func:`decode_attention`,
  one masked softmax over the valid entries.

An int8 cache stores codes and one float32 scale per (token, head):
:func:`quantize_heads` is kernel 7 with ``group = head_dim`` and
:func:`dequantize_heads` kernel 8 followed by a cast (the reference's
``_quantize_heads``/``_dequantize_heads``).  A decode step quantizes its
K and V and writes them into the cache in one kernel-7 launch
(``ops.quantize_kv_into``).

Products whose reference asks for float32 results
(``preferred_element_type``) multiply float32 copies of their operands:
bf16 values are exact in float32, and on the card these products must
not run as TF32 (:func:`repro_torch.models.model.forward` checks).
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .layers import (ParamSpec, apply_rope, linear, rmsnorm, rope_freqs,
                     shard)

__all__ = ["attn_specs", "init_kv_cache", "quantize_heads",
           "dequantize_heads", "flash_attention", "decode_attention",
           "attention"]

def attn_specs(cfg) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, h * hd), ("embed", "heads"), cfg.dtype),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), cfg.dtype),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), cfg.dtype),
        "wo": ParamSpec((h * hd, d), ("heads", "embed"), cfg.dtype),
        "ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h * hd,), ("heads",), cfg.dtype, init="zeros")
        specs["bk"] = ParamSpec((hkv * hd,), ("kv_heads",), cfg.dtype,
                                init="zeros")
        specs["bv"] = ParamSpec((hkv * hd,), ("kv_heads",), cfg.dtype,
                                init="zeros")
    return specs


def init_kv_cache(cfg, batch: int, capacity: int, *,
                  device: torch.device, dtype=torch.bfloat16,
                  quantized: bool = False, n_layers: int | None = None
                  ) -> dict:
    """Zeroed KV cache ``(batch, capacity, Hkv, hd)`` per leaf, with a
    leading layers axis when ``n_layers`` is given.  ``quantized=True``
    stores int8 codes and float32 scales ``(…, capacity, Hkv)``."""
    lead = (batch, capacity, cfg.n_kv_heads)
    if n_layers is not None:
        lead = (n_layers,) + lead
    hd = cfg.head_dim
    if quantized:
        return {
            "k": torch.zeros(lead + (hd,), dtype=torch.int8, device=device),
            "v": torch.zeros(lead + (hd,), dtype=torch.int8, device=device),
            "k_scale": torch.zeros(lead, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(lead, dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(lead + (hd,), dtype=dtype, device=device),
            "v": torch.zeros(lead + (hd,), dtype=dtype, device=device)}


def quantize_heads(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 of ``(…, hd)`` float32 or bf16:
    kernel 7 with ``group = hd``.  Returns (int8 codes of ``x``'s shape,
    float32 scales of its shape without the last dim); an all-zero
    vector gets scale 1, so it dequantizes exactly."""
    hd = x.shape[-1]
    q, s = ops.group_quant(x.reshape(-1, hd).contiguous(), hd)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def dequantize_heads(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_heads`: ``q · scale`` in float32
    (kernel 8), then a cast to ``dtype`` (bf16 by default, the attention
    compute dtype)."""
    hd = q.shape[-1]
    out = ops.group_dequant(q.reshape(-1, hd).contiguous(),
                            scale.reshape(-1, 1).contiguous(), hd)
    return out.reshape(q.shape).to(dtype)


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 results from float32 copies of both
    operands (the reference's ``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_valid_len: int | None = None, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Blocked online-softmax attention (GQA-aware).

    q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D); H % Hkv == 0.  ``q_offset``
    is the absolute position of q[0]; ``kv_valid_len`` the number of
    valid K/V entries (None = all).  The chunking, the masks, the float32
    running max/sum and the rounding of the weights to V's dtype before
    the pv product are the reference's.  An int8 cache is attended by
    :func:`decode_attention`; nothing calls this on int8 K/V.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    valid = Sk if kv_valid_len is None else kv_valid_len
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, D)
    # the reference's triangular schedule: a q chunk skips the kv chunks
    # wholly after it
    triangular = causal and q_offset == 0 and nq > 1
    outs = []
    for qi in range(nq):
        q0 = qi * q_chunk
        qc = qg[:, q0:q0 + q_chunk]
        n_q = qc.shape[1]
        # ragged last chunks stay short: the reference pads them and cuts
        # the padded rows again, and its padded K/V entries are masked
        qpos = q_offset + q0 + torch.arange(n_q, device=dev)
        nk_i = (min(nk, -(-((qi + 1) * q_chunk) // kv_chunk)) if triangular
                else nk)
        m = torch.full((B, Hkv, G, n_q), -torch.inf, device=dev)
        l = torch.zeros((B, Hkv, G, n_q), device=dev)
        acc = torch.zeros((B, Hkv, G, n_q, D), device=dev)
        for ki in range(nk_i):
            k0 = ki * kv_chunk
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kpos = k0 + torch.arange(kc.shape[1], device=dev)
            s = _f32_einsum("bqhgd,bchd->bhgqc", qc, kc.to(qc.dtype)) * scale
            mask = (kpos < valid)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         -torch.inf))
            l = l * corr + p.sum(dim=-1)
            pv = _f32_einsum("bhgqc,bchd->bhgqd", p.to(vc.dtype), vc)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        # (B, Hkv, G, q, D) → (B, q, Hkv, G, D)
        outs.append(out.permute(0, 3, 1, 2, 4))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     valid_len: int, k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One masked softmax of a few new queries over the cache.

    q: (B, Sq, H, D); k/v: (B, S, Hkv, D), of which the first
    ``valid_len`` entries are valid (the rest are left out: masked, they
    would add exact zeros).  An int8 cache is not dequantized: the scores
    of the int8 product are scaled by ``k_scale`` (constant over the
    contracted head dim), and ``p · v_scale`` meets the codes in float32,
    the reference's order of operations.
    """
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    k, v = k[:, :valid_len], v[:, :valid_len]
    qg = q.reshape(B, Sq, Hkv, G, D)
    # int8 codes are exact in float32: the reference's cast of them to
    # q's dtype changes no value and is left out
    kq = k if k_scale is not None else k.to(qg.dtype)
    s = _f32_einsum("bqhgd,bshd->bhgqs", qg, kq) * D ** -0.5
    if k_scale is not None:
        s = s * k_scale[:, :valid_len].transpose(1, 2)[:, :, None, None, :]
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    if v_scale is not None:
        w = p * v_scale[:, :valid_len].transpose(1, 2)[:, :, None, None, :]
        pv = _f32_einsum("bhgqs,bshd->bhgqd", w, v)
    else:
        pv = _f32_einsum("bhgqs,bshd->bhgqd", p.to(v.dtype), v)
    out = pv / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention(params: dict, x: torch.Tensor, cfg, *, mode: str,
              positions: torch.Tensor, cache: dict | None = None,
              cache_len: int | None = None, q_chunk: int = 512,
              kv_chunk: int = 1024) -> tuple[torch.Tensor, dict | None]:
    """Pre-norm attention block body (the caller adds the residual).

    Returns ``(out, kv)``.  Prefill returns this layer's K/V; decode
    writes this step's K/V into ``cache`` at ``cache_len`` **in place**
    (for an int8 cache, quantized and written by one kernel-7 launch: a
    copy of a multi-GB cache per step is what the reference's functional
    update costs and the port avoids) and attends over ``cache_len + Sq``
    entries.
    """
    B, Sq, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    q = linear(xn, params["wq"], params.get("bq")).reshape(B, Sq, h, hd)
    k = linear(xn, params["wk"], params.get("bk")).reshape(B, Sq, hkv, hd)
    v = linear(xn, params["wv"], params.get("bv")).reshape(B, Sq, hkv, hd)
    cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)

    kv = None
    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and cache_len")
        end = cache_len + Sq
        if end > cache["k"].shape[1]:
            raise ValueError(f"cache holds {cache['k'].shape[1]} entries, "
                             f"decode needs {end}")
        if "k_scale" in cache:
            ops.quantize_kv_into(k.contiguous(), v.contiguous(), cache,
                                 cache_len)
            out = decode_attention(q, cache["k"], cache["v"], valid_len=end,
                                   k_scale=cache["k_scale"],
                                   v_scale=cache["v_scale"])
        else:
            cache["k"][:, cache_len:end] = k.to(cache["k"].dtype)
            cache["v"][:, cache_len:end] = v.to(cache["v"].dtype)
            out = decode_attention(q, cache["k"], cache["v"], valid_len=end)
        kv = cache
    else:
        out = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        if mode == "prefill":
            kv = {"k": k, "v": v}
    out = out.reshape(B, Sq, h * hd)
    return linear(out, params["wo"]), kv
