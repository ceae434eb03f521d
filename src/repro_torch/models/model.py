"""Decoder-stack assembly of the LM plane, one code path per family, run
by Python loops over the stacked layer parameters (the reference's
``lax.scan``):

* dense / moe — pre-norm attention + (MLP | MoE) blocks;
* ssm (rwkv6) — RWKV6 time-mix + channel-mix blocks, whose recurrent
  state is threaded through every mode;
* hybrid (zamba2) — groups of ``shared_attn_every`` Mamba2 layers, each
  group followed by one application of a *shared* attention block and a
  shared MLP (one parameter set, one KV cache slot per group).

The reference's vlm/audio decoders, fed by frontend embeddings, raise
``NotImplementedError`` (ROADMAP.md, queue 1, item 2.4).

``mode``: train | prefill | decode.  Prefill returns the serve-time state
of its S positions (``init_decode_state``'s layout) and only the last
position's logits; decode writes into the state it is given, in place.
The MoE layers' load-balance loss comes back as ``aux["moe_aux"]``, the
mean over the layers, in every mode (0 for the other families).
"""
from __future__ import annotations

import math

import torch

from .attention import attention, attn_specs, init_kv_cache
from .layers import ParamSpec, _leaves, require_exact_f32_products, rmsnorm
from .moe import mlp_apply, mlp_specs, moe_apply, moe_specs
from .rwkv import init_rwkv_state, rwkv6_apply, rwkv6_specs
from .ssm import init_mamba_state, mamba2_apply, mamba2_specs

__all__ = ["model_specs", "init_decode_state", "forward", "param_counts",
           "check_ported"]


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the port does not run."""
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid")
            or cfg.input_mode != "tokens"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (experts={cfg.n_experts}, "
            f"input={cfg.input_mode}) is not ported yet; the port runs "
            "token-input decoders, dense, MoE, ssm or hybrid (ROADMAP.md, "
            "queue 1, item 2.4)")


def _stack_specs(specs: dict, n: int) -> dict:
    """Add a leading stacked-layers axis to every ParamSpec in a tree."""
    return {k: (ParamSpec((n,) + v.shape, ("layers",) + v.axes, v.dtype,
                          v.init, v.scale) if isinstance(v, ParamSpec)
                else _stack_specs(v, n)) for k, v in specs.items()}


def _layer_specs(cfg) -> dict:
    if cfg.family == "ssm":
        return rwkv6_specs(cfg)
    if cfg.family == "hybrid":
        return mamba2_specs(cfg)
    return {"attn": attn_specs(cfg),
            "mlp": moe_specs(cfg) if cfg.n_experts else mlp_specs(cfg)}


def _groups(cfg) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def model_specs(cfg) -> dict:
    """The spec tree of the reference's ``model_specs`` for a token-input
    config.  A hybrid's Mamba2 leaves are stacked twice, ``(groups,
    shared_attn_every, …)``, beside the unstacked ``shared_attn`` and
    ``shared_mlp``."""
    check_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "final_ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab"), cfg.dtype),
        "embed": ParamSpec((v, d), ("vocab", "embed"), cfg.dtype),
    }
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        per_group = _stack_specs(_layer_specs(cfg), cfg.shared_attn_every)
        specs["layers"] = _stack_specs(per_group, _groups(cfg))
        specs["shared_attn"] = attn_specs(cfg)
        specs["shared_mlp"] = mlp_specs(cfg)
    else:
        specs["layers"] = _stack_specs(_layer_specs(cfg), cfg.n_layers)
    return specs


def param_counts(cfg) -> tuple[int, int]:
    """(total params, active-per-token params) from the spec tree, by the
    reference's rule: an expert leaf counts ``experts_per_token /
    n_experts`` of its size as active."""
    total = active = 0
    for path, spec in _leaves(model_specs(cfg)):
        key = "/" + "/".join(path)
        n = math.prod(spec.shape)
        total += n
        if cfg.n_experts and ("/w_up" in key or "/w_gate" in key
                              or "/w_down" in key) and "shared" not in key:
            n = n * cfg.experts_per_token // cfg.n_experts
        active += n
    return total, active


def _stacked(tree: dict, lead: tuple[int, ...]) -> dict:
    """Zeroed copies of a state tree's leaves with leading axes ``lead``."""
    return {k: v.new_zeros(lead + tuple(v.shape)) for k, v in tree.items()}


def init_decode_state(cfg, batch: int, capacity: int, *,
                      device: torch.device, quantized: bool = False) -> dict:
    """Zeroed serve-time state for ``capacity`` positions.

    * dense / moe: the KV cache stack, bf16 ``(L, B, S, Hkv, hd)`` leaves,
      or int8 codes with float32 ``(L, B, S, Hkv)`` scales;
    * ssm: the RWKV state with a leading ``n_layers`` axis (no cache:
      ``capacity`` and ``quantized`` do not apply);
    * hybrid: ``{"mamba": (groups, shared_attn_every, …) Mamba2 states,
      "kv": the shared attention's cache, one slot a group}``.

    The cache is bf16 whatever the model's dtype, as in the reference,
    and so is the Mamba2 conv state."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return _stacked(init_rwkv_state(cfg, batch, device=device),
                        (cfg.n_layers,))
    if cfg.family == "hybrid":
        groups = _groups(cfg)
        return {"mamba": _stacked(init_mamba_state(cfg, batch, device=device),
                                  (groups, cfg.shared_attn_every)),
                "kv": init_kv_cache(cfg, batch, capacity, device=device,
                                    quantized=quantized, n_layers=groups)}
    return init_kv_cache(cfg, batch, capacity, device=device,
                         quantized=quantized, n_layers=cfg.n_layers)


def _put(stack: dict, index: tuple, new: dict) -> None:
    """Write a layer's new state into the stack at ``index``, in place
    (cast to the stack's dtype: the Mamba2 conv state rounds to bf16)."""
    for k, v in new.items():
        stack[k][index] = v


def forward(params: dict, cfg, *, tokens: torch.Tensor, mode: str = "train",
            state: dict | None = None, cache_len: int | None = None,
            q_chunk: int = 512, kv_chunk: int = 1024
            ) -> tuple[torch.Tensor, dict]:
    """Returns ``(logits, aux)`` with ``aux = {"state": …, "moe_aux": …}``;
    ``moe_aux`` is the MoE layers' load-balance loss summed over the
    layers and divided by ``n_layers`` (0 for the other families).

    ``tokens``: (B, S) int64 ids on the parameters' device.  Train
    returns all positions' logits and no state; prefill the last
    position's logits and the state of its S positions (the bf16 cache
    stack, the recurrent states); decode (``state`` and ``cache_len``
    given) runs the S new tokens at positions ``cache_len…`` and writes
    their K/V and the new recurrent states into ``state`` in place.  The
    RWKV state is threaded in every mode, from zeros in train and
    prefill; RWKV chunks by 32 and Mamba2 by 256, the reference's.
    """
    check_ported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = params["embed"][tokens]
    require_exact_f32_products(x)
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
    keep = mode != "train"          # train threads zero states, keeps none

    moe_aux = torch.zeros((), dtype=torch.float32, device=dev)
    layers = params["layers"]
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            lst = {k: v[i] for k, v in state.items()} if keep else None
            x, new = rwkv6_apply({k: v[i] for k, v in layers.items()}, x,
                                 cfg, mode=mode, state=lst, chunk=32)
            if keep:
                _put(state, (i,), new)
    elif cfg.family == "hybrid":
        for g in range(_groups(cfg)):
            for j in range(cfg.shared_attn_every):
                lst = ({k: v[g, j] for k, v in state["mamba"].items()}
                       if keep else None)
                delta, new = mamba2_apply(
                    {k: v[g, j] for k, v in layers.items()}, x, cfg,
                    mode=mode, state=lst)
                x = x + delta
                if keep:
                    _put(state["mamba"], (g, j), new)
            g_kv = ({k: v[g] for k, v in state["kv"].items()}
                    if mode == "decode" else None)
            a_out, new_kv = attention(params["shared_attn"], x, cfg,
                                      mode=mode, positions=positions,
                                      cache=g_kv, cache_len=cache_len,
                                      q_chunk=q_chunk, kv_chunk=kv_chunk)
            if mode == "prefill":
                _put(state["kv"], (g,), new_kv)
            x = x + a_out
            x = x + mlp_apply(params["shared_mlp"], x, cfg)
    else:
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
                _put(state, (i,), new_kv)
            x = x + a_out
            if cfg.n_experts:
                m_out, m_aux = moe_apply(lp["mlp"], x, cfg)
                moe_aux = moe_aux + m_aux
            else:
                m_out = mlp_apply(lp["mlp"], x, cfg)
            x = x + m_out

    if mode == "prefill":
        # serving needs only the last position's logits
        x = x[:, -1:]
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    aux = {"moe_aux": moe_aux / max(cfg.n_layers, 1),
           "state": state if keep else None}
    return logits, aux
