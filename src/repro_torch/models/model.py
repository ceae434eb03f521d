"""Decoder-stack assembly of the LM plane: the dense family.

Pre-norm attention + MLP blocks over stacked layer parameters, run by a
Python loop over the layers (the reference's ``lax.scan``).  The
reference's other families — MoE, RWKV (ssm), Mamba2 hybrid, and the
vlm/audio decoders fed by frontend embeddings — raise
``NotImplementedError`` (ROADMAP.md, queue 1, item 9).

``mode``: train | prefill | decode.  Prefill returns the bf16 KV cache
stack ``(L, B, S, Hkv, hd)`` and only the last position's logits; decode
writes into the cache stack it is given, in place.
"""
from __future__ import annotations

import torch

from .attention import attention, attn_specs, init_kv_cache
from .layers import ParamSpec, rmsnorm
from .moe import mlp_apply, mlp_specs

__all__ = ["model_specs", "init_decode_state", "forward", "check_ported"]


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run."""
    if cfg.family != "dense" or cfg.n_experts or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (experts={cfg.n_experts}, "
            f"input={cfg.input_mode}) is not ported yet; the port runs dense "
            "token-input decoders (ROADMAP.md, queue 1, item 9)")


def _stack_specs(specs: dict, n: int) -> dict:
    """Add a leading stacked-layers axis to every ParamSpec in a tree."""
    return {k: (ParamSpec((n,) + v.shape, ("layers",) + v.axes, v.dtype,
                          v.init, v.scale) if isinstance(v, ParamSpec)
                else _stack_specs(v, n)) for k, v in specs.items()}


def model_specs(cfg) -> dict:
    """The spec tree of the reference's ``model_specs`` for a dense
    token-input config."""
    check_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "final_ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab"), cfg.dtype),
        "embed": ParamSpec((v, d), ("vocab", "embed"), cfg.dtype),
        "layers": _stack_specs({"attn": attn_specs(cfg),
                                "mlp": mlp_specs(cfg)}, cfg.n_layers),
    }


def init_decode_state(cfg, batch: int, capacity: int, *,
                      device: torch.device, quantized: bool = False) -> dict:
    """Zeroed serve-time KV cache stack for ``capacity`` positions:
    bf16 ``(L, B, S, Hkv, hd)`` leaves, or int8 codes with float32
    ``(L, B, S, Hkv)`` scales.  The cache is bf16 whatever the model's
    dtype, as in the reference."""
    check_ported(cfg)
    return init_kv_cache(cfg, batch, capacity, device=device,
                         quantized=quantized, n_layers=cfg.n_layers)


def _require_exact_f32_products(x: torch.Tensor) -> None:
    if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 products would run as TF32 on the card: call "
            "torch.set_float32_matmul_precision('highest') first")


def forward(params: dict, cfg, *, tokens: torch.Tensor, mode: str = "train",
            state: dict | None = None, cache_len: int | None = None,
            q_chunk: int = 512, kv_chunk: int = 1024
            ) -> tuple[torch.Tensor, dict]:
    """Returns ``(logits, aux)`` with ``aux = {"state": …, "moe_aux": 0}``.

    ``tokens``: (B, S) int64 ids on the parameters' device.  Train
    returns all positions' logits and no state; prefill the last
    position's logits and the bf16 cache stack of its S positions;
    decode (``state`` and ``cache_len`` given) attends the S new tokens at
    positions ``cache_len…`` and writes their K/V into ``state`` in place.
    """
    check_ported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = params["embed"][tokens]
    _require_exact_f32_products(x)
    B, S = x.shape[:2]
    dev = x.device
    if mode == "decode":
        if state is None or cache_len is None:
            raise ValueError("decode needs a serve-time state and cache_len")
        positions = cache_len + torch.arange(S, dtype=torch.int32, device=dev)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=dev)
    if mode == "prefill":
        state = init_decode_state(cfg, B, S, device=dev)

    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {blk: {k: v[i] for k, v in layers[blk].items()}
              for blk in ("attn", "mlp")}
        l_kv = ({k: v[i] for k, v in state.items()} if mode == "decode"
                else None)
        a_out, new_kv = attention(lp["attn"], x, cfg, mode=mode,
                                  positions=positions, cache=l_kv,
                                  cache_len=cache_len, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
        if mode == "prefill":
            state["k"][i] = new_kv["k"]
            state["v"][i] = new_kv["v"]
        x = x + a_out
        x = x + mlp_apply(lp["mlp"], x, cfg)

    if mode == "prefill":
        # serving needs only the last position's logits
        x = x[:, -1:]
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=dev),
           "state": state if mode != "train" else None}
    return logits, aux
