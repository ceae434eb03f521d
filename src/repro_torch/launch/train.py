"""Train-step construction on one card: the loss, microbatching, remat,
the optimizer update, and the replicated step whose gradients cross
between replicas as int8 codes.

Two step builders, as in the reference:

* :func:`make_train_step` — forward and backward on the whole batch
  (in ``run.microbatches`` slices, their gradients accumulated in
  ``run.grad_accum_dtype``), then the optimizer update;
* :func:`make_train_step_compressed` — data-parallel replicas: params,
  optimizer state and error feedback carry a leading ``(n_pods, …)``
  replica axis; each replica computes gradients on its own slice of the
  batch, the gradients are exchanged as int8 codes with error feedback
  (:mod:`repro_torch.optim.grad_compress`: kernels 7 and 8, one launch of
  each a leaf and step), and every replica applies the same update.  On
  one card the replicas run one after another and the all-gather is the
  identity; the arithmetic is the reference's.

Both steps write the new parameters and optimizer state into the trees
they are given, in place (the reference's training loop donates them to
its jitted step), and return them.  The reference's mesh, sharding,
data pipeline and resilient loop (``batch_spec``, ``train_loop``) are not
ported here.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, RunConfig
from ..device import resolve_device
from ..kernels.ref import true_divide
from ..models import model as M
from ..models.layers import DTYPES, init_from_specs
from ..optim.adafactor import (AdafactorConfig, adafactor_init,
                               adafactor_update, adafactor_update_)
from ..optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                           adamw_update_, f32)
from ..optim.grad_compress import compress_pod_reduce, init_error_feedback
from ..optim.tree import leaves, replica, tree_map, unflatten

__all__ = ["make_optimizer", "loss_fn", "make_train_step",
           "make_train_step_compressed", "init_train_state",
           "init_replica_state"]

_MOE_AUX_W = 0.01
#: the in-place update of each optimizer config type
_UPDATE_ = {AdamWConfig: adamw_update_, AdafactorConfig: adafactor_update_}


def make_optimizer(run: RunConfig, opt_cfg=None):
    """``(opt_cfg, init_fn, update_fn)`` for ``run.optimizer``; the update
    is the functional one (the steps use its in-place form)."""
    if run.optimizer == "adafactor":
        cfg = opt_cfg if isinstance(opt_cfg, AdafactorConfig) \
            else AdafactorConfig(moments_dtype=run.optimizer_dtype)
        return cfg, adafactor_init, adafactor_update
    cfg = opt_cfg if isinstance(opt_cfg, AdamWConfig) \
        else AdamWConfig(moments_dtype=run.optimizer_dtype)
    return cfg, adamw_init, adamw_update


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, run: RunConfig, *,
            q_chunk: int = 512, kv_chunk: int = 1024):
    """Next-token cross-entropy plus ``0.01 · moe_aux``: ``(loss,
    {"ce", "moe_aux"})``.  ``batch``: ``tokens`` (B, S) or ``embeds`` (B,
    S, d_model), and ``labels`` (B, S), of which only those ``>= 0``
    count; logits in float32 when ``run.logits_fp32``."""
    key = M.input_key(cfg)
    logits, aux = M.forward(params, cfg, mode="train",
                            remat=run.remat != "none", q_chunk=q_chunk,
                            kv_chunk=kv_chunk, **{key: batch[key]})
    if run.logits_fp32:
        logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    # a negative label indexes from the end, as the reference's gather
    # does; its term is masked out
    idx = torch.where(labels < 0, labels + logits.shape[-1], labels)
    gold = torch.gather(logits, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = (torch.sum((logz - gold) * mask)
          / torch.clamp(mask.sum(), min=1.0))
    loss = ce + _MOE_AUX_W * aux["moe_aux"]
    return loss, {"ce": ce, "moe_aux": aux["moe_aux"]}


def value_and_grad(params: dict, batch: dict, cfg: ModelConfig,
                   run: RunConfig, **kw):
    """``(loss, metrics, grads)`` of :func:`loss_fn`; each gradient has
    its parameter's dtype, and ``params`` is left as it is."""
    pairs = leaves(params)
    xs = [p.detach().requires_grad_() for _, p in pairs]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(
            (path, x) for (path, _), x in zip(pairs, xs)), batch, cfg, run,
            **kw)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = unflatten((path, torch.zeros_like(x) if g is None else g)
                      for (path, _), x, g in zip(pairs, xs, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _microbatched_grads(params: dict, batch: dict, cfg: ModelConfig,
                        run: RunConfig, **kw):
    """Gradient accumulation over ``run.microbatches`` equal slices of the
    batch, in ``run.grad_accum_dtype``: ``(mean loss, the last slice's
    metrics, mean gradients)``."""
    mb = max(run.microbatches, 1)
    if mb == 1:
        return value_and_grad(params, batch, cfg, run, **kw)
    split = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    acc_dt = DTYPES[run.grad_accum_dtype]
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                         device=p.device), params)
    loss_sum = None
    for i in range(mb):
        loss, metrics, grads = value_and_grad(
            params, {k: v[i] for k, v in split.items()}, cfg, run, **kw)
        g_of = dict(leaves(grads))
        for path, a in leaves(acc):
            a.add_(g_of[path].to(a.dtype))
        del grads, g_of
        loss_sum = loss if loss_sum is None else loss_sum + loss
    for _, a in leaves(acc):
        a.copy_(true_divide(a, mb))
    return true_divide(loss_sum, mb), metrics, acc


def make_train_step(cfg: ModelConfig, run: RunConfig, opt_cfg=None, *,
                    q_chunk: int = 512, kv_chunk: int = 1024):
    """``(step, opt_cfg)``: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, the new values written in place; ``metrics``:
    ``loss``, ``ce``, ``moe_aux``, ``grad_norm``, ``lr``."""
    opt_cfg, _, _ = make_optimizer(run, opt_cfg)
    update_ = _UPDATE_[type(opt_cfg)]

    def step(params, opt_state, batch):
        loss, metrics, grads = _microbatched_grads(
            params, batch, cfg, run, q_chunk=q_chunk, kv_chunk=kv_chunk)
        stats = update_(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **stats}

    return step, opt_cfg


def make_train_step_compressed(cfg: ModelConfig, run: RunConfig,
                               n_pods: int, opt_cfg=None, *,
                               q_chunk: int = 512, kv_chunk: int = 1024):
    """``(step, opt_cfg)`` of the replicated step with int8 gradient
    exchange: ``step(params_r, opt_r, ef_r, batch) -> (params_r, opt_r,
    ef_r, metrics)`` on ``(n_pods, …)`` trees (:func:`init_replica_state`),
    written in place.  The batch's leading axis is split into ``n_pods``
    equal slices, one a replica; each leaf's gradients are then exchanged
    (kernel 7 once, kernel 8 once; with one replica, not at all) and each
    replica takes the optimizer step with the mean.  ``metrics``: the
    replicas' mean loss, ``ce`` and ``moe_aux``, replica 0's
    ``grad_norm`` and ``lr``."""
    if n_pods < 1:
        raise ValueError(f"n_pods must be at least 1, got {n_pods}")
    opt_cfg, _, _ = make_optimizer(run, opt_cfg)
    update_ = _UPDATE_[type(opt_cfg)]

    def step(params_r, opt_r, ef_r, batch):
        pod_batch = {k: v.reshape((n_pods, v.shape[0] // n_pods)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
        grads = tree_map(lambda p: torch.empty_like(p), params_r)
        runs = []
        for r in range(n_pods):
            loss, metrics, g = value_and_grad(
                replica(params_r, r), {k: v[r] for k, v in pod_batch.items()},
                cfg, run, q_chunk=q_chunk, kv_chunk=kv_chunk)
            g_of = dict(leaves(g))
            for path, stack in leaves(grads):
                stack[r].copy_(g_of[path])
            del g, g_of
            runs.append({"loss": loss, **metrics})
        compress_pod_reduce(grads, ef_r, n_pods=n_pods)
        stats = [update_(replica(params_r, r), replica(grads, r),
                         replica(opt_r, r), opt_cfg) for r in range(n_pods)]
        n = f32(n_pods)
        out = {k: torch.stack([m[k].cpu() for m in runs]).sum() / n
               for k in runs[0]}
        out.update(stats[0])
        return params_r, opt_r, ef_r, out

    return step, opt_cfg


def init_train_state(cfg: ModelConfig, run: RunConfig,
                     generator: torch.Generator, opt_cfg=None, *,
                     device: str | torch.device = "cuda"):
    """``(params, opt_state)``: parameters drawn from ``generator`` by
    :func:`~repro_torch.models.layers.init_from_specs` on ``device``, and
    the optimizer's zeroed state."""
    device = resolve_device(device)
    params = init_from_specs(M.model_specs(cfg), generator, device=device)
    opt_cfg, opt_init, _ = make_optimizer(run, opt_cfg)
    return params, opt_init(params, opt_cfg)


def _replicate(tree: dict, n: int) -> dict:
    """``tree`` with each leaf copied ``n`` times along a new leading
    axis, the source leaves released one at a time (``tree`` is emptied),
    so that the copies take only ``n`` times the tree's memory."""
    out = {}
    for k in sorted(tree):
        v = tree.pop(k)
        out[k] = (_replicate(v, n) if isinstance(v, dict)
                  else v[None].expand((n,) + tuple(v.shape)).clone())
        del v
    return out


def init_replica_state(cfg: ModelConfig, run: RunConfig, n_pods: int,
                       generator: torch.Generator, opt_cfg=None, *,
                       device: str | torch.device = "cuda"):
    """``(params_r, opt_r, ef_r)`` for :func:`make_train_step_compressed`:
    :func:`init_train_state`'s values, each leaf copied ``n_pods`` times
    along a new leading axis (the step counter too, on the host), and
    zeroed error feedback of that shape."""
    params, opt_state = init_train_state(cfg, run, generator, opt_cfg,
                                         device=device)
    params_r = _replicate(params, n_pods)
    opt_r = _replicate(opt_state, n_pods)
    return params_r, opt_r, init_error_feedback(params_r)
