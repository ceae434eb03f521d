"""The MLP blocks of the LM plane: the dense MLP (SwiGLU or GELU) and the
mixture-of-experts layer.

The MoE layer is the reference's: a float32 router with top-k routing,
the Switch auxiliary load-balancing loss, and capacity-bounded dispatch
per token group (GShard's group semantics: capacity is provisioned per
group, so routing hot spots drop locally).  Dispatch scatters each kept
(token, choice) into its expert's slot of an ``(e · capacity + 1, d)``
buffer whose last row takes the dropped ones; the expert products are
batched matrix products over the experts.  The reference's expert
products and dispatch run outside any Pallas kernel, and so do the
port's: no kernel of ``kernels/`` is on this layer's path.

The port has no expert sharding yet (the ``shard`` constraints on the
expert buffers are wired, and are the identity on plain tensors), and
its group loop is a Python loop (the reference's ``lax.scan``), so it
needs no ``unroll`` switch either.  On a data-parallel mesh a rank routes
its own rows, in groups sized by the global batch's token count
(``moe_apply(global_tokens=)``), each group whole within the rank.
"""
from __future__ import annotations

import math

import torch

from .layers import (ParamSpec, linear, require_exact_f32_products, rmsnorm,
                     shard)

__all__ = ["moe_specs", "moe_apply", "group_tokens", "mlp_specs", "mlp_apply",
           "silu", "gelu_tanh"]


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), cfg.dtype),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), cfg.dtype),
    }
    if cfg.act == "swiglu":
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"), cfg.dtype)
    return specs


def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · 1/(1 + exp(−x))``, rounded to ``x``'s dtype after every
    operation as ``jax.nn.silu`` is (``torch.nn.functional.silu`` rounds
    once, which differs in bf16 in about a third of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh approximation as it computes it: every
    operation rounded to ``x``'s dtype, the constants too."""
    inner = x + _const(0.044715, x) * (x * x * x)
    cdf = _const(0.5, x) * (1 + torch.tanh(
        _const(math.sqrt(2 / math.pi), x) * inner))
    return x * cdf


def mlp_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Pre-norm MLP body (the caller adds the residual)."""
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    up = linear(xn, params["w_up"])
    if cfg.act == "swiglu":
        up = silu(linear(xn, params["w_gate"])) * up
    else:
        up = gelu_tanh(up)
    up = shard(up, "batch", None, "mlp")
    return linear(up, params["w_down"])


def moe_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "router": ParamSpec((d, e), ("embed", None), "float32"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp"), cfg.dtype),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "mlp"), cfg.dtype),
        "w_down": ParamSpec((e, f, d), ("experts", "mlp", "embed"), cfg.dtype),
    }


def _route(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(probs, k)``: the k largest per row, ties to the
    lower expert index (a stable descending sort; ``torch.topk`` does not
    promise that order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _routing(params: dict, groups: torch.Tensor, cfg):
    """The routing of ``G`` token groups of ``g`` tokens, ``(G, g, d)``:
    ``(sel (G, g, k), keep (G·g·k,), dest (G·g·k,), gate_keep (G·g·k,),
    capacity, aux (G,))``.

    Each group has its own ``capacity`` slots an expert.  Slots are
    ranked by a stable sort of the flattened (group, expert) keys, so an
    expert keeps a group's first ``capacity`` assignments in (token,
    choice) order; a dropped one goes to the trash row ``G · e ·
    capacity`` with a zero gate.
    """
    G, g_tokens, _ = groups.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    dev = groups.device

    logits = torch.matmul(groups.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                          # (G, g, e)
    gate_vals, sel = _route(probs.reshape(G * g_tokens, e), k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch): e · Σ_e fraction_tokens · router_prob
    flat_sel = sel.reshape(G, g_tokens * k)
    counts = torch.zeros((G, e), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, flat_sel, torch.ones_like(flat_sel,
                                                     dtype=torch.float32))
    frac = counts / (g_tokens * k)
    aux = e * torch.sum(frac * probs.mean(1), dim=-1)

    capacity = max(int(cfg.capacity_factor * g_tokens * k / e), 4)
    key = (flat_sel + e * torch.arange(G, device=dev)[:, None]).reshape(-1)
    nk = key.shape[0]
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    starts = torch.searchsorted(key_sorted,
                                torch.arange(G * e, device=dev), side="left")
    pos_sorted = torch.arange(nk, device=dev) - starts[key_sorted]
    pos_in_expert = torch.empty_like(pos_sorted).index_copy_(
        0, order, pos_sorted)
    keep = pos_in_expert < capacity
    gate_keep = (gate_vals.reshape(-1) * keep).to(groups.dtype)
    dest = torch.where(keep, key * capacity + pos_in_expert,
                       G * e * capacity)
    return (sel.reshape(G, g_tokens, k), keep, dest, gate_keep, capacity,
            aux)


def _moe_groups(params: dict, groups: torch.Tensor, cfg
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, expert products and combine for ``G`` token groups
    ``(G, g, d)`` at once, each group with its own capacity.  Returns
    ``(out (G, g, d), aux (G,))``."""
    G, g_tokens, d = groups.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    _, keep, dest, gate_keep, capacity, aux = _routing(params, groups, cfg)

    # each kept slot takes exactly one token, so the sum is that token;
    # only the trash row (dropped assignments, zeroed) takes collisions
    tokens = groups.reshape(G * g_tokens, d)
    tok_rep = torch.repeat_interleave(tokens, k, dim=0)          # (G·g·k, d)
    buf = tokens.new_zeros((G * e * capacity + 1, d))
    buf.index_add_(0, dest, tok_rep * keep[:, None].to(tokens.dtype))
    # (G, e, c, d) → (e, G·c, d): one batched product an expert
    expert_in = buf[:-1].reshape(G, e, capacity, d).transpose(0, 1) \
        .reshape(e, G * capacity, d)
    expert_in = shard(expert_in, "experts", None, None)

    h = torch.bmm(expert_in, params["w_up"].to(expert_in.dtype))
    gt = torch.bmm(expert_in, params["w_gate"].to(expert_in.dtype))
    h = silu(gt) * h
    expert_out = torch.bmm(h, params["w_down"].to(h.dtype))
    expert_out = shard(expert_out, "experts", None, None)
    expert_out = expert_out.reshape(e, G, capacity, d).transpose(0, 1) \
        .reshape(G * e * capacity, d)

    out_flat = torch.cat([expert_out, expert_out.new_zeros((1, d))])[dest]
    out = (out_flat * gate_keep[:, None]).reshape(G, g_tokens, k, d).sum(2)
    return out, aux


def _moe_group(params: dict, tokens: torch.Tensor, cfg
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, expert products and combine for one token group
    ``(g, d)``.  Returns ``(out (g, d), aux)``."""
    out, aux = _moe_groups(params, tokens[None], cfg)
    return out[0], aux[0]


def group_tokens(n: int, group_size: int = 4096) -> int:
    """The token group of ``n`` tokens: ``min(group_size, n)``, halved
    until it divides ``n``."""
    gs = min(group_size, n)
    while n % gs:
        gs //= 2
    return gs


def moe_apply(params: dict, x: torch.Tensor, cfg, *, group_size: int = 4096,
              global_tokens: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE body (the caller adds the residual).  Returns
    ``(out, aux_loss)`` for ``x`` (B, S, d).

    Tokens are routed in groups of :func:`group_tokens` ``(B·S)``.
    Capacity is provisioned per group, and ``aux`` is the mean over the
    groups.  The groups go through in passes of at most ``group_size``
    tokens (one group, or many small ones at once), so a pass's buffers
    stay those of one full group.

    ``global_tokens``: ``x`` is a rank's rows of a global batch of that
    many tokens; the groups are the global batch's, and ``aux`` is this
    rank's groups' sum over the global group count, so that the ranks'
    terms add up to the global mean.

    :raises ValueError: if a global group would span ranks (``B·S`` is
        not a whole number of groups).
    """
    require_exact_f32_products(x)
    B, S, d = x.shape
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    tokens = xn.reshape(B * S, d)
    n = tokens.shape[0]
    n_global = n if global_tokens is None else global_tokens
    gs = group_tokens(n_global, group_size)
    if n % gs:
        raise ValueError(f"a token group of {gs} (of {n_global} tokens) "
                         f"spans ranks holding {n} tokens each")
    per_pass = max(group_size // gs, 1) * gs
    outs = []
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for chunk in tokens.split(per_pass):
        out, aux = _moe_groups(params, chunk.reshape(-1, gs, d), cfg)
        outs.append(out.reshape(-1, d))
        aux_sum = aux_sum + aux.sum()
    return torch.cat(outs).reshape(B, S, d), aux_sum / (n_global // gs)
