"""RWKV6 "Finch" block: data-dependent per-channel decay (arXiv:2404.05892).

Time mix with a LoRA-produced dynamic decay ``w_t`` and token-shift
mixing, the WKV6 linear recurrence over (head, d_head × d_head) matrix
states, and the squared-ReLU channel mix, as the reference computes them:

* the whole block runs in float32 (every floating parameter cast first)
  and rounds to the model's dtype once, at its output;
* train and prefill use the chunked form (chunk 32 from ``forward``):
  within a chunk a strictly lower-triangular score matrix plus the
  same-step bonus term, across chunks the carried state decayed to each
  chunk's end; a Python loop over the chunks replaces the reference's
  ``lax.scan``;
* decode is the exact one-step recurrence ``y = r·(S + u ⊙ k⊗v)``,
  ``S' = diag(w)·S + k⊗v``.

The state is float32: ``wkv (B, nh, hd, hd)``, ``shift_t (B, d)`` and
``shift_c (B, d)``, the last normalised inputs of the two token shifts.
The reference computes the block outside any Pallas kernel, and so does
the port: its products are ``torch.matmul``/``einsum`` in float32.

Under tensor parallelism (:func:`~.layers.model_parallel`) a ``model``
rank holds its heads' columns of ``wr``/``wk``/``wv``/``wg``/``wB``, their
slices of ``w0``/``u_bonus``/``gn`` and rows of ``wo``, and its columns of
the channel mix's ``ck`` and rows of ``cv``; the norms' gains, the mixes
``mu_*``, the LoRA's ``wA`` and the gate ``cr`` are whole on every rank.
The split is entered *after* each whole leaf has been applied (the four
mixed inputs of ``wr``/``wk``/``wv``/``wg``, the LoRA's hidden, the
channel mix's ``ck`` input), so that a whole leaf's gradient is whole on
every rank; the group norm is
:func:`~.layers.split_rmsnorm` over the whole width; ``wo``'s and
``cv``'s partial products are summed over ``model`` before the residual
and before ``cr``'s gate multiplies them.  Only train mode runs there
(``forward`` raises for the serve-time states).
"""
from __future__ import annotations

import torch

from .layers import (ParamSpec, into_split, linear, model_group,
                     out_of_split, rmsnorm, shard, split_rmsnorm)
from .moe import silu

__all__ = ["rwkv6_specs", "rwkv6_apply", "init_rwkv_state"]

_LORA_R = 64


def rwkv6_specs(cfg) -> dict:
    d = cfg.d_model
    f = cfg.d_ff
    return {
        "ln_t": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "mu_r": ParamSpec((d,), (None,), cfg.dtype, init="zeros"),
        "mu_k": ParamSpec((d,), (None,), cfg.dtype, init="zeros"),
        "mu_v": ParamSpec((d,), (None,), cfg.dtype, init="zeros"),
        "mu_w": ParamSpec((d,), (None,), cfg.dtype, init="zeros"),
        "mu_g": ParamSpec((d,), (None,), cfg.dtype, init="zeros"),
        "wr": ParamSpec((d, d), ("embed", "heads"), cfg.dtype),
        "wk": ParamSpec((d, d), ("embed", "heads"), cfg.dtype),
        "wv": ParamSpec((d, d), ("embed", "heads"), cfg.dtype),
        "wg": ParamSpec((d, d), ("embed", "heads"), cfg.dtype),
        "wo": ParamSpec((d, d), ("heads", "embed"), cfg.dtype),
        # dynamic decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": ParamSpec((d,), ("heads",), "float32", init="zeros"),
        "wA": ParamSpec((d, _LORA_R), ("embed", None), cfg.dtype),
        "wB": ParamSpec((_LORA_R, d), (None, "heads"), cfg.dtype),
        "u_bonus": ParamSpec((d,), ("heads",), "float32", init="zeros"),
        "gn": ParamSpec((d,), ("heads",), cfg.dtype, init="ones"),
        # channel mix
        "ln_c": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "mu_c": ParamSpec((d,), (None,), cfg.dtype, init="zeros"),
        "ck": ParamSpec((d, f), ("embed", "mlp"), cfg.dtype),
        "cv": ParamSpec((f, d), ("mlp", "embed"), cfg.dtype),
        "cr": ParamSpec((d, d), ("embed", None), cfg.dtype),
    }


def init_rwkv_state(cfg, batch: int, *, device: torch.device,
                    heads: int | None = None) -> dict:
    """Zeroed float32 state of one block: a bf16 hand-off would make the
    decode step see a rounded ``x_{t-1}`` the train path never saw.
    ``heads``: the WKV state's head count (default all of them; a
    ``model`` rank's own under tensor parallelism)."""
    d = cfg.d_model
    nh, hd = heads or d // cfg.rwkv_head, cfg.rwkv_head
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"wkv": z(batch, nh, hd, hd), "shift_t": z(batch, d),
            "shift_c": z(batch, d)}


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The ``x_{t-1}`` stream: shift right by one, ``prev`` in at t = 0."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xprev: torch.Tensor, mu: torch.Tensor
         ) -> torch.Tensor:
    return x + (xprev - x) * mu.to(x.dtype)


def _wkv_chunked(rh, kh, vh, lw, u, S0, chunk: int):
    """The chunked WKV6 over (B, S, nh, hd) float32 streams from state
    ``S0``: returns ``(y (B, S, nh, hd), final state)``.  The sequence is
    padded with zeros to whole chunks (a zero log-decay and zero keys
    leave the state as it is)."""
    B, S, nh, hd = rh.shape
    pad = (-S) % chunk
    if pad:
        rh, kh, vh, lw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (rh, kh, vh, lw))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=rh.device), diagonal=-1)
    Sc = S0
    ys = []
    for c0 in range(0, S + pad, chunk):
        rk, kk, vk, lk = (a[:, c0:c0 + chunk] for a in (rh, kh, vh, lw))
        cum = torch.cumsum(lk, dim=1)                   # ≤ 0, decreasing
        total = cum[:, -1]                              # (B, nh, hd)
        # r_i decayed to the chunk's start: decay *before* t
        rdec = rk * torch.exp(cum - lk)
        y_inter = torch.einsum("bihk,bhkv->bihv", rdec, Sc)
        # scores_ij = Σ_k r_i w^(i-1..j) k_j for j < i
        b_j = kk * torch.exp(-cum)
        scores = torch.einsum("bihk,bjhk->bhij", rdec, b_j) * mask
        y_intra = torch.einsum("bhij,bjhv->bihv", scores, vk)
        # the same-step bonus: (Σ_k r·u·k) v
        y_diag = (rk * u * kk).sum(-1, keepdim=True) * vk
        # the state to the chunk's end
        kdec = kk * torch.exp(total[:, None] - cum)
        Sc = (torch.exp(total)[..., None] * Sc
              + torch.einsum("bjhk,bjhv->bhkv", kdec, vk))
        ys.append(y_inter + y_intra + y_diag)
    return torch.cat(ys, dim=1)[:, :S], Sc


def rwkv6_apply(params: dict, x: torch.Tensor, cfg, *, mode: str,
                state: dict | None = None, chunk: int = 32
                ) -> tuple[torch.Tensor, dict]:
    """The whole RWKV6 block (time mix + channel mix, residuals included)
    on ``x (B, S, d)``.  Returns ``(out, new state)``; ``out`` has
    ``x``'s dtype.  ``state`` (zeros when None) is read, never written."""
    B, S, d = x.shape
    hd = cfg.rwkv_head
    dl = params["wr"].shape[-1]              # this rank's heads' width
    nh = dl // hd
    st = state if state else init_rwkv_state(cfg, B, device=x.device,
                                             heads=nh)
    out_dtype = x.dtype
    x = x.float()
    p = {k: v.float() if v.is_floating_point() else v
         for k, v in params.items()}

    # ---------------- time mix ----------------
    xn = rmsnorm(x, p["ln_t"], cfg.norm_eps)
    xprev = _token_shift(xn, st["shift_t"].to(xn.dtype))
    mixed = [_mix(xn, xprev, p[f"mu_{c}"]) for c in "rkvg"]
    if model_group() is not None:
        # one entry for the four mixed inputs: one gradient sum
        mixed = into_split(torch.stack(mixed)).unbind(0)
    r, k, v, g = (linear(a, p[f"w{c}"]) for a, c in zip(mixed, "rkvg"))
    xw = _mix(xn, xprev, p["mu_w"])
    logw = p["w0"] + linear(into_split(torch.tanh(linear(xw, p["wA"]))),
                            p["wB"])
    # -log w_t, clipped to [1e-4, 2.5] so that the chunked form's
    # exp(±Σ) factors stay finite in float32
    neg_decay = torch.clamp(torch.exp(logw), 1e-4, 2.5)
    rh, kh, vh = (a.reshape(B, S, nh, hd) for a in (r, k, v))
    lw = -neg_decay.reshape(B, S, nh, hd)                # log w_t ≤ 0
    u = p["u_bonus"].reshape(nh, hd)

    if mode == "decode":
        Swkv = st["wkv"]
        kv = torch.einsum("bhi,bhj->bhij", kh[:, 0], vh[:, 0])
        y = torch.einsum("bhi,bhij->bhj", rh[:, 0],
                         Swkv + u[None, :, :, None] * kv)[:, None]
        new_wkv = torch.exp(lw[:, 0])[..., None] * Swkv + kv
    else:
        y, new_wkv = _wkv_chunked(rh, kh, vh, lw, u, st["wkv"], chunk)

    y = y.reshape(B, S, dl)
    # the group-norm stand-in, over the whole width
    y = split_rmsnorm(y, p["gn"], d, cfg.norm_eps)
    y = y * silu(g)
    y = shard(y, "batch", None, "heads")
    x = x + out_of_split(linear(y, p["wo"]))

    # ---------------- channel mix ----------------
    xc = rmsnorm(x, p["ln_c"], cfg.norm_eps)
    xm = _mix(xc, _token_shift(xc, st["shift_c"].to(xc.dtype)), p["mu_c"])
    kk = torch.square(torch.relu(linear(into_split(xm), p["ck"])))
    kk = shard(kk, "batch", None, "mlp")
    cm = (out_of_split(linear(kk, p["cv"]))
          * torch.sigmoid(linear(xm, p["cr"])))
    out = (x + cm).to(out_dtype)
    return out, {"wkv": new_wkv, "shift_t": xn[:, -1].float(),
                 "shift_c": xc[:, -1].float()}
