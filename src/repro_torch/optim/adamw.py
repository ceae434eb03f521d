"""AdamW with decoupled weight decay, global-norm clipping and a warmup +
cosine schedule, on dicts of tensors: the reference's update.

Moments are kept in ``moments_dtype``; the update computes in float32
and rounds the new parameters to their dtype once.  The schedule and
the bias corrections are float32, as the reference computes them, and
are computed on the host from the step counter (an int32 tensor kept on
the CPU), so the card and the CPU use the same bits; only ``cos`` and
``pow`` may differ from XLA's in the last bit.  Products with Python
numbers stay products; every division divides by a tensor (on the card
PyTorch turns a division by a Python number into a product with its
reciprocal).

On a data-parallel mesh the trees' leaves are DTensors and the update
runs on each rank's local shards; the clipping norm is the whole
gradient's (:func:`global_norm` with the ranks' ``group``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models.layers import DTYPES
from .tree import leaves, local, sharded, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "lr_schedule", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moments_dtype: str = "float32"


def f32(v, device=None) -> torch.Tensor:
    """A float32 0-dim tensor (a divisor that divides exactly)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def lr_schedule(cfg, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or int32 tensor), a float32
    0-dim tensor on the host: linear warmup to ``cfg.lr`` over
    ``warmup_steps``, then a cosine down to a tenth of it at
    ``total_steps``."""
    step = torch.as_tensor(step).to("cpu", torch.float32)
    warm = torch.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    t = torch.clamp((step - cfg.warmup_steps)
                    / f32(max(cfg.total_steps - cfg.warmup_steps, 1)), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree, *, group=None) -> torch.Tensor:
    """√(Σ x²) over every leaf in float32, the leaves summed in the
    reference's order.

    With a process ``group`` (a data-parallel mesh's ranks) the leaves
    may be DTensors: the ranks exchange their leaves' local sums of
    squares in one all-gather; a :func:`~.tree.sharded` leaf's sum is
    its shards' sums added in rank order, a replicated leaf's is rank
    0's, counted once.  Every rank gets the same bits."""
    pairs = leaves(tree)
    if group is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for _, x in pairs))
    sq = torch.stack([torch.sum(torch.square(local(x).float()))
                      for _, x in pairs]).cpu()
    parts = [torch.empty_like(sq) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, sq, group=group)
    total = 0
    for i, (_, x) in enumerate(pairs):
        s = parts[0][i]
        if sharded(x):
            for p in parts[1:]:
                s = s + p[i]
        total = total + s
    return torch.sqrt(total).to(local(pairs[0][1]).device)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zeroed moments ``mu``, ``nu`` (``moments_dtype``, on each leaf's
    device) and ``step``, an int32 0-dim tensor on the host."""
    dt = DTYPES[cfg.moments_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update_(params, grads, opt_state, cfg: AdamWConfig, *,
                  group=None) -> dict:
    """One AdamW step written into ``params`` and ``opt_state`` in place
    (the reference's jitted step donates them); returns the stats
    ``{"grad_norm", "lr"}``.  Each new value is the reference's: the
    gradient scaled by ``min(1, clip_norm / ‖g‖)``, float32 moments,
    bias-corrected, ``weight_decay · p`` added, ``p − lr · delta``
    rounded to the parameter's dtype.  On a mesh (DTensor leaves placed
    alike in the three trees, and the ranks' ``group``) each rank updates
    its local shards, clipped by the whole gradient's norm."""
    step = opt_state["step"].add_(1)
    gnorm = global_norm(grads, group=group)
    dev = gnorm.device
    scale = torch.minimum(f32(1.0, dev), f32(cfg.clip_norm, dev)
                          / torch.maximum(gnorm, f32(1e-9, dev)))
    lr = lr_schedule(cfg, step)
    t = step.float()
    bc1, bc2 = ((1 - b ** t).to(dev) for b in (cfg.b1, cfg.b2))
    lr_d = lr.to(dev)
    b1, b2 = cfg.b1, cfg.b2
    g_of, m_of, v_of = (dict(leaves(tree_map(local, t_))) for t_ in
                        (grads, opt_state["mu"], opt_state["nu"]))
    for path, p in leaves(tree_map(local, params)):
        g = g_of[path].float() * scale
        m, v = m_of[path], v_of[path]
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        del g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr_d * delta)
    return {"grad_norm": gnorm, "lr": lr}


def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """The reference's ``adamw_update``: ``(new params, new state,
    stats)``, the inputs left as they are."""
    params, opt_state = tree_map(torch.clone, params), tree_map(
        torch.clone, opt_state)
    stats = adamw_update_(params, grads, opt_state, cfg)
    return params, opt_state, stats
