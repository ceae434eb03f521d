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

On a data-parallel mesh a leaf may be split on one dim over the ranks
(``fsdp``, the ``embed`` axis).  The update then reads the leaf's whole
shape, and a sum over the split dim (a factored mean over the last two
axes, the mean of a split ``vr``, the RMS clip's sum over the leaf)
adds the ranks' partial sums in rank order before it divides by the
whole extent: every rank gets the same bits, and a moment reduced over
the split dim comes out replicated, as ``opt_shardings`` places it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models.layers import DTYPES
from .adamw import AdamWConfig, f32, global_norm, lr_schedule
from .tree import leaves, local, shard_dim, tree_map

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


def _ranks_sum(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor of ``xs`` summed over the ranks of ``group``: one
    ``all_gather_into_tensor`` of them all, flattened, and the ranks'
    parts added in rank order, so that every rank gets the same bits."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    n = dist.get_world_size(group)
    parts = flat.new_empty((n * flat.numel(),))
    dist.all_gather_into_tensor(parts, flat, group=group)
    parts = parts.view(n, -1)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return [t.view(x.shape) for t, x in zip(
        total.split([x.numel() for x in xs]), xs)]


def _leaf_update(p, g, v: dict, m, beta2, lr, cfg: AdafactorConfig,
                 shape: tuple, split: int | None = None,
                 group=None) -> None:
    """One leaf's update on this rank's local tensors; ``shape`` is the
    leaf's whole shape, ``split`` the (negative) dim that the ranks of
    ``group`` split it on, or ``None``."""
    eps = cfg.eps
    dev = p.device
    g = g.float()
    g2 = g * g + eps
    if _factored(shape):
        # the means over the last two axes; over the split dim the ranks'
        # partial sums are added first
        r_sum, c_sum = g2.sum(-1), g2.sum(-2)
        del g2
        if split == -1:
            r_sum, = _ranks_sum([r_sum], group)
        vr = v["vr"] * beta2 + r_sum / f32(shape[-1], dev) * (1 - beta2)
        vr_sum = vr.sum(-1, keepdim=True)
        if split == -2:
            c_sum, vr_sum = _ranks_sum([c_sum, vr_sum], group)
        vc = v["vc"] * beta2 + c_sum / f32(shape[-2], dev) * (1 - beta2)
        del r_sum, c_sum
        denom = ((vr / torch.clamp(vr_sum / f32(shape[-2], dev), min=eps))
                 [..., None] * vc[..., None, :])
        u = g * torch.rsqrt(torch.clamp(denom, min=eps))
        del denom
        v["vr"].copy_(vr)
        v["vc"].copy_(vc)
    else:
        nv = v["v"] * beta2 + g2 * (1 - beta2)
        u = g * torch.rsqrt(torch.clamp(nv, min=eps))
        v["v"].copy_(nv)
    del g
    # RMS clip, over the whole leaf
    sq = u.square().sum()
    if split is not None:
        sq, = _ranks_sum([sq], group)
    rms = torch.sqrt(sq / f32(math.prod(shape), dev) + eps)
    u = u / torch.clamp(rms / f32(cfg.clip_threshold, dev), min=1.0)
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
    (the ranks' ``group``) the leaves are DTensors, placed alike in
    ``params`` and ``grads`` and by ``opt_shardings`` in ``opt_state``,
    and each rank updates its local shards: a leaf split over the ranks
    (``optim.tree.shard_dim``) takes its whole shape's layout and means,
    its sums over the split dim added across the ranks (the module
    docstring)."""
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
    for path, p in leaves(params):
        shape = tuple(p.shape)
        d = None if group is None else shard_dim(p)
        v = {k: v_of[path + (k,)] for k in (("vr", "vc") if _factored(
            shape) else ("v",))}
        _leaf_update(local(p), g_of[path], v, m_of.get(path), beta2_d, lr_d,
                     cfg, shape, None if d is None else d - len(shape),
                     group)
    return {"grad_norm": gnorm, "lr": lr}


def adafactor_update(params, grads, opt_state, cfg: AdafactorConfig):
    """The reference's ``adafactor_update``: ``(new params, new state,
    stats)``, the inputs left as they are."""
    params, opt_state = tree_map(torch.clone, params), tree_map(
        torch.clone, opt_state)
    stats = adafactor_update_(params, grads, opt_state, cfg)
    return params, opt_state, stats
