"""Adafactor (Shazeer & Stern, arXiv:1804.04235): factored second
moments, on dicts of tensors — the reference's update.

A leaf whose last two axes both exceed 1 keeps its second moment as a
row vector and a column vector over those two axes (a stacked ``(L, d,
f)`` leaf per layer, a hybrid's ``(groups, k, d, f)`` per Mamba2 layer);
any other leaf keeps it whole.  Second moments are float32; the first
moment exists only when ``beta1 > 0`` and is stored in
``moments_dtype``.  ``beta2 = 1 − t^(−decay)`` and the schedule are
float32, computed on the host as :mod:`repro_torch.optim.adamw` computes
its scalars; means divide their sums by a tensor.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.layers import DTYPES
from .adamw import AdamWConfig, f32, global_norm, lr_schedule
from .tree import leaves, local, tree_map

__all__ = ["AdafactorConfig", "adafactor_init", "adafactor_update",
           "adafactor_update_", "adafactor_beta2"]


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 3e-4
    decay: float = 0.8            # v decay exponent: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0   # update RMS clip (Adafactor §6)
    weight_decay: float = 0.0
    beta1: float = 0.0            # 0 → no first moment stored
    moments_dtype: str = "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10_000

    # mirror AdamWConfig's schedule interface
    @property
    def b1(self):
        return self.beta1


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params, cfg: AdafactorConfig) -> dict:
    """Zeroed float32 second moments (``{"vr", "vc"}`` for a factored
    leaf, ``{"v"}`` otherwise), a first moment ``mu`` in
    ``moments_dtype`` when ``beta1 > 0``, and ``step``, an int32 0-dim
    tensor on the host."""
    f = torch.float32

    def v_state(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=f, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f,
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=f, device=p.device)}

    state = {"v": {}, "step": torch.zeros((), dtype=torch.int32)}
    for path, p in leaves(params):
        node = state["v"]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v_state(p)
    if cfg.beta1 > 0:
        dt = DTYPES[cfg.moments_dtype]
        state["mu"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
    return state


def adafactor_beta2(cfg: AdafactorConfig, step) -> torch.Tensor:
    """``1 − t^(−decay)`` at ``step`` t, float32 on the host."""
    t = torch.as_tensor(step).to("cpu", torch.float32)
    return 1.0 - t ** (-cfg.decay)


def _mean(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """The mean as the reference takes it: the sum divided by the count."""
    return x.sum(dim, keepdim=keepdim) / f32(x.shape[dim], x.device)


def _leaf_update(p, g, v: dict, m, beta2, lr, cfg: AdafactorConfig) -> None:
    eps = cfg.eps
    g = g.float()
    g2 = g * g + eps
    if _factored(p.shape):
        vr = v["vr"] * beta2 + _mean(g2, -1) * (1 - beta2)
        vc = v["vc"] * beta2 + _mean(g2, -2) * (1 - beta2)
        del g2
        denom = ((vr / torch.clamp(_mean(vr, -1, True), min=eps))[..., None]
                 * vc[..., None, :])
        u = g * torch.rsqrt(torch.clamp(denom, min=eps))
        del denom
        v["vr"].copy_(vr)
        v["vc"].copy_(vc)
    else:
        nv = v["v"] * beta2 + g2 * (1 - beta2)
        u = g * torch.rsqrt(torch.clamp(nv, min=eps))
        v["v"].copy_(nv)
    del g
    # RMS clip
    rms = torch.sqrt(u.square().sum() / f32(u.numel(), u.device) + eps)
    u = u / torch.clamp(rms / f32(cfg.clip_threshold, u.device), min=1.0)
    if m is not None:
        u = m.float() * cfg.beta1 + u * (1 - cfg.beta1)
        m.copy_(u)
    u = u + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * u)


@torch.no_grad()
def adafactor_update_(params, grads, opt_state, cfg: AdafactorConfig, *,
                      group=None) -> dict:
    """One Adafactor step written into ``params`` and ``opt_state`` in
    place; returns the stats ``{"grad_norm", "lr"}`` (the norm is only
    reported: Adafactor clips each leaf's update by its RMS).  On a mesh
    (the ranks' ``group``) the leaves are replicated DTensors, and each
    rank updates its local copy; the factored moments would reduce over
    a sharded dim, so the trees must not be sharded."""
    step = opt_state["step"].add_(1)
    beta2 = adafactor_beta2(cfg, step)
    lr = lr_schedule(AdamWConfig(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                                 total_steps=cfg.total_steps), step)
    gnorm = global_norm(grads, group=group)
    dev = gnorm.device
    beta2_d, lr_d = beta2.to(dev), lr.to(dev)
    g_of, v_of = (dict(leaves(tree_map(local, t)))
                  for t in (grads, opt_state["v"]))
    m_of = (dict(leaves(tree_map(local, opt_state["mu"])))
            if "mu" in opt_state else {})
    for path, p in leaves(tree_map(local, params)):
        v = {k: v_of[path + (k,)] for k in (("vr", "vc") if _factored(
            p.shape) else ("v",))}
        _leaf_update(p, g_of[path], v, m_of.get(path), beta2_d, lr_d, cfg)
    return {"grad_norm": gnorm, "lr": lr}


def adafactor_update(params, grads, opt_state, cfg: AdafactorConfig):
    """The reference's ``adafactor_update``: ``(new params, new state,
    stats)``, the inputs left as they are."""
    params, opt_state = tree_map(torch.clone, params), tree_map(
        torch.clone, opt_state)
    stats = adafactor_update_(params, grads, opt_state, cfg)
    return params, opt_state, stats
