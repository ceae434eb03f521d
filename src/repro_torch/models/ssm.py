"""Mamba2 (SSD) block, the state-space half of the Zamba2 hybrid.

As the reference computes it: a fused input projection, a depthwise
causal convolution (kernel 4) in the input's dtype, then the scalar-decay
recurrence per head in float32.  Train and prefill use the chunked SSD
form (Mamba2 paper §6): within a chunk the recurrence is a masked
quadratic term (inclusive lower mask), across chunks the carried
``(heads, d_head, d_state)`` state; a Python loop over the chunks
replaces the reference's ``lax.scan``.  Decode is the exact one-step
recurrence.

The state: ``ssm`` float32 ``(B, nh, hd, ns)`` and ``conv`` the last
three convolution inputs ``(B, 3, din + 2·ns)``, **bf16 whatever the
model's dtype**, as the reference keeps it (ROADMAP.md, queue 3: in a
float32 model the decode step reads a rounded ``x_{t-1..t-3}``).  The
block runs outside any Pallas kernel in the reference and outside any
kernel of ``kernels/`` here.
"""
from __future__ import annotations

import torch

from .layers import ParamSpec, linear, rmsnorm, shard
from .moe import silu

__all__ = ["mamba2_specs", "mamba2_apply", "init_mamba_state"]

_CONV_K = 4


def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head
    ns = cfg.ssm_state
    return {
        "ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        # fused input projection: [x_in, z (gate), B, C, dt]
        "w_in": ParamSpec((d, 2 * din + 2 * ns + nh), ("embed", "heads"),
                          cfg.dtype),
        "conv_w": ParamSpec((_CONV_K, din + 2 * ns), (None, "heads"),
                            cfg.dtype, scale=0.5),
        "a_log": ParamSpec((nh,), ("heads",), "float32", init="zeros"),
        "dt_bias": ParamSpec((nh,), ("heads",), "float32", init="zeros"),
        "d_skip": ParamSpec((nh,), ("heads",), "float32", init="ones"),
        "w_out": ParamSpec((din, d), ("heads", "embed"), cfg.dtype),
        "out_ln": ParamSpec((din,), ("heads",), cfg.dtype, init="ones"),
    }


def init_mamba_state(cfg, batch: int, *, device: torch.device) -> dict:
    """Zeroed state of one block: ``ssm`` float32, ``conv`` bf16."""
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head
    return {
        "ssm": torch.zeros((batch, nh, cfg.ssm_head, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, din + 2 * cfg.ssm_state),
                            dtype=torch.bfloat16, device=device),
    }


def _split_proj(proj: torch.Tensor, din: int, ns: int, nh: int):
    """``(x_in, z, B, C, dt)`` views of the fused projection."""
    return (proj[..., :din], proj[..., din:2 * din],
            proj[..., 2 * din:2 * din + ns],
            proj[..., 2 * din + ns:2 * din + 2 * ns],
            proj[..., 2 * din + 2 * ns:])


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv of ``u (B, S, C)`` with ``w (K, C)`` in
    ``u``'s dtype, each product and sum rounded to it in the reference's
    order; returns ``(silu(out), the last K-1 inputs)``."""
    if state is None:
        pad = u.new_zeros((u.shape[0], _CONV_K - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = ext[:, 0:S] * w[0].to(u.dtype)
    for i in range(1, _CONV_K):
        out = out + ext[:, i:i + S] * w[i].to(u.dtype)
    return silu(out), ext[:, -(_CONV_K - 1):]


def _ssd_chunked(xdt, la, Bf, Cf, h, chunk: int):
    """The chunked SSD over float32 ``xdt (B, S, nh, hd)``, ``la (B, S,
    nh)``, ``Bf``/``Cf (B, S, ns)`` from state ``h (B, nh, hd, ns)``:
    returns ``(y (B, S, nh, hd), final state)``.  Zero padding to whole
    chunks adds a zero log-decay and zero inputs, which leave the state
    as it is."""
    B_, S, nh, hd = xdt.shape
    pad = (-S) % chunk
    if pad:
        xdt = torch.nn.functional.pad(xdt, (0, 0, 0, 0, 0, pad))
        la, Bf, Cf = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                      for a in (la, Bf, Cf))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xdt.device))
    ys = []
    for c0 in range(0, S + pad, chunk):
        xk, lak, Bk, Ck = (a[:, c0:c0 + chunk] for a in (xdt, la, Bf, Cf))
        cum = torch.cumsum(lak, dim=1)                  # (B, c, nh)
        total = cum[:, -1]                              # (B, nh)
        # intra-chunk quadratic term: a masked decay kernel
        decay_ij = torch.exp(torch.clamp(
            cum[:, :, None, :] - cum[:, None, :, :], -60.0, 0.0))
        scores = (torch.einsum("bin,bjn->bij", Ck, Bk)[:, :, :, None]
                  * decay_ij * mask[None, :, :, None])
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xk)
        # the carried state's share, the reference's three-operand
        # "bhpn,bin,bih->bihp": (h · C) first, one batched product over b,
        # then scaled by exp(cum) per (b, i, h)
        y_inter = (torch.einsum("bhpn,bin->bihp", h, Ck)
                   * torch.exp(cum)[..., None])
        # the state to the chunk's end, the reference's "bjhp,bjn,bjh->
        # bhpn": the weights fold into x first, so that one product over
        # j runs per b (left to right, torch would first build a
        # (b, j, h, p, n) tensor: 2.7 GB a chunk at zamba2's width)
        wj = torch.exp(torch.clamp(total[:, None] - cum, -60.0, 0.0))
        h = (h * torch.exp(total)[..., None, None]
             + torch.einsum("bjhp,bjn->bhpn", xk * wj[..., None], Bk))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba2_apply(params: dict, x: torch.Tensor, cfg, *, mode: str,
                 state: dict | None = None, chunk: int = 256
                 ) -> tuple[torch.Tensor, dict]:
    """The Mamba2 block body on ``x (B, S, d)`` (the caller adds the
    residual).  Returns ``(out, new state)``; the new ``conv`` state is
    in ``x``'s dtype (the caller's state stack keeps it bf16).  Decode
    needs ``state``; train and prefill start from zeros without one.
    ``state`` is read, never written."""
    B_, S, d = x.shape
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head
    hd = cfg.ssm_head
    ns = cfg.ssm_state

    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    proj = linear(xn, params["w_in"])
    xin, z, Bm, Cm, dt = _split_proj(proj, din, ns, nh)
    conv_out, conv_state = _causal_conv(
        torch.cat([xin, Bm, Cm], dim=-1), params["conv_w"],
        None if state is None else state["conv"])
    xin, Bm, Cm = (conv_out[..., :din], conv_out[..., din:din + ns],
                   conv_out[..., din + ns:])
    xh = xin.reshape(B_, S, nh, hd)
    dt = dt.float() + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros((), device=dt.device))  # softplus
    a = -torch.exp(params["a_log"].float())             # (nh,) < 0
    la = dt * a                                         # log-decay ≤ 0
    xdt = xh.float() * dt[..., None]                    # dt-weighted input
    Bf, Cf = Bm.float(), Cm.float()

    if mode == "decode":
        if state is None:
            raise ValueError("decode needs a state")
        h = (state["ssm"] * torch.exp(la)[:, 0, :, None, None]
             + torch.einsum("bhp,bn->bhpn", xdt[:, 0], Bf[:, 0]))
        y = torch.einsum("bhpn,bn->bhp", h, Cf[:, 0])[:, None]
    else:
        h0 = (torch.zeros((B_, nh, hd, ns), dtype=torch.float32,
                          device=x.device)
              if state is None else state["ssm"])
        y, h = _ssd_chunked(xdt, la, Bf, Cf, h0, chunk)

    y = y + params["d_skip"][:, None] * xh.float()
    y = rmsnorm(y.reshape(B_, S, din).to(x.dtype), params["out_ln"],
                cfg.norm_eps)
    y = y * silu(z)
    y = shard(y, "batch", None, "heads")
    return linear(y, params["w_out"]), {"ssm": h, "conv": conv_state}
