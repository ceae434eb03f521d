"""Decoder-stack assembly of the LM plane, one code path per family, run
by Python loops over the stacked layer parameters (the reference's
``lax.scan``):

* dense / moe — pre-norm attention + (MLP | MoE) blocks;
* ssm (rwkv6) — RWKV6 time-mix + channel-mix blocks, whose recurrent
  state is threaded through every mode;
* hybrid (zamba2) — groups of ``shared_attn_every`` Mamba2 layers, each
  group followed by one application of a *shared* attention block and a
  shared MLP (one parameter set, one KV cache slot per group);
* vlm / audio (internvl2, musicgen) — the dense stack, fed by frontend
  embeddings (``input_mode="embeddings"``: no ``embed`` table; the
  embeddings are cast to the model's dtype before the first block).

``mode``: train | prefill | decode.  Prefill returns the serve-time state
of its S positions (``init_decode_state``'s layout) and only the last
position's logits; decode writes into the state it is given, in place.
The MoE layers' load-balance loss comes back as ``aux["moe_aux"]``, the
mean over the layers, in every mode (0 for the other families).  Train
mode writes no state, so autograd sees no tensor written in place; with
``remat=True`` each layer (and each Mamba2 layer inside a hybrid group)
runs under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attention, attn_specs, init_kv_cache
from .layers import (DTYPES, ParamSpec, _leaves, require_exact_f32_products,
                     rmsnorm, shard)
from .moe import mlp_apply, mlp_specs, moe_apply, moe_specs
from .rwkv import init_rwkv_state, rwkv6_apply, rwkv6_specs
from .ssm import init_mamba_state, mamba2_apply, mamba2_specs

__all__ = ["model_specs", "init_decode_state", "forward", "param_counts",
           "check_ported", "input_key"]


#: The reference's families: the dense stack (dense, moe, and the
#: embedding-fed vlm and audio), ssm (RWKV6) and hybrid (Mamba2 + shared
#: attention).
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
INPUT_MODES = ("tokens", "embeddings")


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the port does not run:
    a family or an input mode the reference does not have."""
    if cfg.family not in FAMILIES or cfg.input_mode not in INPUT_MODES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (input={cfg.input_mode}) "
            f"is not one of the reference's {FAMILIES} (inputs "
            f"{INPUT_MODES})")


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
    """The spec tree of the reference's ``model_specs``.  A hybrid's
    Mamba2 leaves are stacked twice, ``(groups, shared_attn_every, …)``,
    beside the unstacked ``shared_attn`` and ``shared_mlp``; an
    embedding-input config has no ``embed`` table."""
    check_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "final_ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab"), cfg.dtype),
    }
    if cfg.input_mode == "tokens":
        specs["embed"] = ParamSpec((v, d), ("vocab", "embed"), cfg.dtype)
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


def _checkpointed(fn, on: bool):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when
    ``on``: backward recomputes it instead of keeping its internals."""
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def input_key(cfg) -> str:
    """The batch key, and :func:`forward`'s input keyword, of ``cfg``:
    ``"tokens"``, or ``"embeds"`` for an embedding-input config."""
    return "tokens" if cfg.input_mode == "tokens" else "embeds"


def _inputs(params: dict, cfg, tokens, embeds) -> torch.Tensor:
    """The first block's input: the token embeddings, or the frontend
    embeddings cast to the model's dtype (the reference's cast)."""
    if input_key(cfg) == "tokens":
        if tokens is None or embeds is not None:
            raise ValueError(f"{cfg.name} takes token ids (tokens=)")
        return params["embed"][tokens]
    if embeds is None or tokens is not None:
        raise ValueError(f"{cfg.name} takes frontend embeddings (embeds=)")
    if embeds.dim() != 3 or embeds.shape[-1] != cfg.d_model:
        raise ValueError(f"embeds {tuple(embeds.shape)}: expected (B, S, "
                         f"{cfg.d_model})")
    return embeds.to(DTYPES[cfg.dtype])


def forward(params: dict, cfg, *, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, mode: str = "train",
            state: dict | None = None, cache_len: int | None = None,
            q_chunk: int = 512, kv_chunk: int = 1024, remat: bool = False,
            global_tokens: int | None = None) -> tuple[torch.Tensor, dict]:
    """Returns ``(logits, aux)`` with ``aux = {"state": …, "moe_aux": …}``;
    ``moe_aux`` is the MoE layers' load-balance loss summed over the
    layers and divided by ``n_layers`` (0 for the other families).

    Input: ``tokens`` (B, S) int64 ids for a token-input config, or
    ``embeds`` (B, S, d_model) frontend embeddings (any float dtype) for
    an embedding-input one, on the parameters' device.  Train returns
    all positions' logits and no state; prefill the last position's
    logits and the state of its S positions (the bf16 cache stack, the
    recurrent states); decode (``state`` and ``cache_len`` given) runs
    the S new positions at ``cache_len…`` and writes their K/V and the
    new recurrent states into ``state`` in place.  The RWKV state is
    threaded in every mode, from zeros in train and prefill; RWKV chunks
    by 32 and Mamba2 by 256, the reference's.  ``remat`` checkpoints each
    layer in train mode (a hybrid: each group, and each Mamba2 layer in
    it); the gradients are the same with it on or off.  ``global_tokens``:
    on a mesh, the token count of the global batch whose rows ``tokens`` /
    ``embeds`` are (:func:`~repro_torch.models.moe.moe_apply`).

    The activations pass the reference's ``shard`` constraints, which are
    the identity outside a ``mesh_context`` and on plain tensors.
    """
    check_ported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = shard(_inputs(params, cfg, tokens, embeds), "batch", "seq", None)
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
    remat = remat and mode == "train"

    moe_aux = torch.zeros((), dtype=torch.float32, device=dev)
    layers = params["layers"]
    if cfg.family == "ssm":
        def rwkv_layer(h, i):
            lst = {k: v[i] for k, v in state.items()} if keep else None
            h, new = rwkv6_apply({k: v[i] for k, v in layers.items()}, h,
                                 cfg, mode=mode, state=lst, chunk=32)
            if keep:
                _put(state, (i,), new)
            return shard(h, "batch", "seq", None)

        layer = _checkpointed(rwkv_layer, remat)
        for i in range(cfg.n_layers):
            x = layer(x, i)
    elif cfg.family == "hybrid":
        def mamba_layer(h, g, j):
            lst = ({k: v[g, j] for k, v in state["mamba"].items()}
                   if keep else None)
            delta, new = mamba2_apply({k: v[g, j] for k, v in layers.items()},
                                      h, cfg, mode=mode, state=lst)
            if keep:
                _put(state["mamba"], (g, j), new)
            return h + delta

        mamba = _checkpointed(mamba_layer, remat)

        def group(h, g):
            for j in range(cfg.shared_attn_every):
                h = shard(mamba(h, g, j), "batch", "seq", None)
            g_kv = ({k: v[g] for k, v in state["kv"].items()}
                    if mode == "decode" else None)
            a_out, new_kv = attention(params["shared_attn"], h, cfg,
                                      mode=mode, positions=positions,
                                      cache=g_kv, cache_len=cache_len,
                                      q_chunk=q_chunk, kv_chunk=kv_chunk)
            if mode == "prefill":
                _put(state["kv"], (g,), new_kv)
            h = h + a_out
            h = h + mlp_apply(params["shared_mlp"], h, cfg)
            return shard(h, "batch", "seq", None)

        group_r = _checkpointed(group, remat)
        for g in range(_groups(cfg)):
            x = group_r(x, g)
    else:
        def block(h, i):
            lp = {blk: {k: v[i] for k, v in layers[blk].items()}
                  for blk in ("attn", "mlp")}
            l_kv = ({k: v[i] for k, v in state.items()} if mode == "decode"
                    else None)
            a_out, new_kv = attention(lp["attn"], h, cfg, mode=mode,
                                      positions=positions, cache=l_kv,
                                      cache_len=cache_len, q_chunk=q_chunk,
                                      kv_chunk=kv_chunk)
            if mode == "prefill":
                _put(state, (i,), new_kv)
            h = shard(h + a_out, "batch", "seq", None)
            if cfg.n_experts:
                m_out, m_aux = moe_apply(lp["mlp"], h, cfg,
                                         global_tokens=global_tokens)
            else:
                m_out, m_aux = mlp_apply(lp["mlp"], h, cfg), None
            return shard(h + m_out, "batch", "seq", None), m_aux

        block_r = _checkpointed(block, remat)
        for i in range(cfg.n_layers):
            x, m_aux = block_r(x, i)
            if m_aux is not None:
                moe_aux = moe_aux + m_aux

    if mode == "prefill":
        # serving needs only the last position's logits
        x = x[:, -1:]
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = shard(torch.matmul(x, params["lm_head"].to(x.dtype)), "batch",
                   None, "vocab")
    aux = {"moe_aux": moe_aux / max(cfg.n_layers, 1),
           "state": state if keep else None}
    return logits, aux
