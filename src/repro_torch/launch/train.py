"""Train-step construction: the loss, microbatching, remat, the
optimizer update, the replicated step whose gradients cross between
replicas as int8 codes, and the placements of a global batch on a mesh
(:func:`batch_spec`).

Two step builders, as in the reference:

* :func:`make_train_step` — forward and backward on the whole batch
  (in ``run.microbatches`` slices, their gradients accumulated in
  ``run.grad_accum_dtype``), then the optimizer update, on one device;
  or, on a ``DeviceMesh``, data-parallel over its batch axes (``data``,
  or ``pod`` × ``data``): each rank takes its rows of every global
  microbatch, and with ``RunConfig.fsdp`` the parameters and optimizer
  state are sharded ZeRO-3 style on the ``embed`` axis (gathered whole
  for the forward, the gradients reduce-scattered into the shards);
* :func:`make_train_step_compressed` — data-parallel replicas: params,
  optimizer state and error feedback carry a leading replica axis; each
  replica computes gradients on its own slice of the batch, the
  gradients are exchanged as int8 codes with error feedback
  (:mod:`repro_torch.optim.grad_compress`: kernels 7 and 8, one launch of
  each a leaf and step), and every replica applies the same update.  In
  one process the axis holds all ``n_pods`` replicas, which run one after
  another, and the all-gather is the identity; on a mesh with a ``pod``
  axis each rank holds one replica (an axis of 1), takes its slice of the
  global batch by :func:`batch_spec`'s placement, and the codes cross
  between ranks.  The two forms give the same bits.

Both steps write the new parameters and optimizer state into the trees
they are given, in place (the reference's training loop donates them to
its jitted step), and return them.

:func:`train_loop` is the reference's resilient loop on one card:
checkpoints (:mod:`repro_torch.checkpoint`), auto-resume, preemption
handling and a step watchdog (:mod:`repro_torch.runtime`), unsharded;
its mesh form is still to come.

The mesh step's collectives are ``torch.distributed``'s own (all-gather,
reduce-scatter, all-reduce), called on the DTensors' local tensors:
with gloo on CUDA tensors, the functional collectives that
``DTensor.full_tensor`` and ``redistribute`` call crash (torch 2.11),
and the plain ones work.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..configs.base import ModelConfig, RunConfig
from ..device import resolve_device
from ..kernels.ref import true_divide
from ..models import model as M
from ..models.layers import (DTYPES, ShapeDtypeStruct, init_from_specs,
                             mesh_context)
from ..optim.adafactor import (AdafactorConfig, adafactor_init,
                               adafactor_update, adafactor_update_)
from ..optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                           adamw_update_, f32)
from ..optim.grad_compress import compress_pod_reduce, init_error_feedback
from ..optim.tree import leaves, local, replica, sharded, tree_map, unflatten
from .mesh import axis_sizes
from .sharding import (local_slice, opt_shardings, param_shardings,
                       placements, rules_for)

__all__ = ["make_optimizer", "loss_fn", "batch_spec", "make_train_step",
           "make_train_step_compressed", "init_train_state",
           "init_replica_state", "train_loop"]

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
            q_chunk: int = 512, kv_chunk: int = 1024,
            label_count: torch.Tensor | None = None,
            global_tokens: int | None = None):
    """Next-token cross-entropy plus ``0.01 · moe_aux``: ``(loss,
    {"ce", "moe_aux"})``.  ``batch``: ``tokens`` (B, S) or ``embeds`` (B,
    S, d_model), and ``labels`` (B, S), of which only those ``>= 0``
    count; logits in float32 when ``run.logits_fp32``.

    On a mesh ``batch`` is a rank's rows of a global batch: the masked sum
    is divided by ``label_count``, the global batch's count of labels
    ``>= 0`` (default: this batch's), and ``global_tokens`` (its token
    count) sizes the MoE token groups, so that the ranks' losses add up
    to the global batch's."""
    key = M.input_key(cfg)
    logits, aux = M.forward(params, cfg, mode="train",
                            remat=run.remat != "none", q_chunk=q_chunk,
                            kv_chunk=kv_chunk, global_tokens=global_tokens,
                            **{key: batch[key]})
    if run.logits_fp32:
        logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    # a negative label indexes from the end, as the reference's gather
    # does; its term is masked out
    idx = torch.where(labels < 0, labels + logits.shape[-1], labels)
    gold = torch.gather(logits, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum() if label_count is None else label_count.to(mask)
    ce = torch.sum((logz - gold) * mask) / torch.clamp(count, min=1.0)
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


def batch_spec(cfg: ModelConfig, shape, mesh, rules) -> dict:
    """:class:`~repro_torch.models.layers.ShapeDtypeStruct` with placements
    for one global batch of ``shape.global_batch`` × ``shape.seq_len``:
    int32 ``labels`` and ``tokens`` placed by ``("batch", None)``, or
    bfloat16 ``embeds`` ``(B, S, d_model)`` placed by ``("batch", None,
    None)`` (resolved without its shape, as the reference resolves it)."""
    B, S = shape.global_batch, shape.seq_len
    pl = placements(rules.partition_spec(("batch", None), shape=(B, S),
                                         mesh=mesh), mesh)
    out = {"labels": ShapeDtypeStruct((B, S), torch.int32, pl)}
    if cfg.input_mode == "tokens":
        out["tokens"] = ShapeDtypeStruct((B, S), torch.int32, pl)
    else:
        out["embeds"] = ShapeDtypeStruct(
            (B, S, cfg.d_model), torch.bfloat16, placements(
                rules.partition_spec(("batch", None, None), mesh=mesh),
                mesh))
    return out


def _local_batch(batch: dict, cfg: ModelConfig, mesh, rules) -> dict:
    """This rank's slice of a global batch, by :func:`batch_spec`'s
    placements."""
    B, S = batch["labels"].shape
    spec = batch_spec(cfg, SimpleNamespace(global_batch=B, seq_len=S), mesh,
                      rules)
    coord = mesh.get_coordinate()
    return {k: local_slice(v, mesh, spec[k].placements, coord)
            for k, v in batch.items()}


def _gathered(run: dict, mesh) -> list[dict]:
    """Every pod rank's ``run`` (a dict of 0-dim tensors), in pod order,
    on the host."""
    group = mesh.get_group("pod")
    out = [{} for _ in range(dist.get_world_size(group))]
    for k, v in run.items():
        v = v.cpu()
        parts = [torch.empty_like(v) for _ in out]
        dist.all_gather(parts, v, group=group)
        for m, p in zip(out, parts):
            m[k] = p
    return out


def _mesh_pods(run: RunConfig, n_pods: int | None, mesh) -> int:
    """The replica count of the compressed step: ``n_pods`` in one
    process, the ``pod`` axis's size on a mesh.

    :raises ValueError: with ``run.fsdp``, for a mesh axis other than
        ``pod`` wider than 1, or for an ``n_pods`` the mesh contradicts.
    """
    if run.fsdp:
        raise ValueError("the compressed step requires fsdp=False")
    if mesh is None:
        if n_pods is None or n_pods < 1:
            raise ValueError(f"n_pods must be at least 1, got {n_pods}")
        return n_pods
    sizes = axis_sizes(mesh)
    wide = {a: n for a, n in sizes.items() if a != "pod" and n > 1}
    if wide:
        raise ValueError(f"the compressed step shards only over 'pod'; the "
                         f"mesh has {wide}")
    pods = sizes.get("pod", 1)
    if n_pods is not None and n_pods != pods:
        raise ValueError(f"n_pods={n_pods}, but the mesh has {pods} pods")
    return pods


def _mesh_group(run: RunConfig, opt_cfg, mesh):
    """The process group of a data-parallel mesh's batch axes: the whole
    process group, whose ranks the mesh holds in rank order (its ``model``
    axis is 1).

    :raises ValueError: for axes other than ``("data", "model")`` or
        ``("pod", "data", "model")``; for a ``model`` axis wider than 1
        (tensor parallelism, ROADMAP item 2.6b-4); for Adafactor with
        ``fsdp`` (ROADMAP item 2.6b-5: its factored moments reduce over
        the sharded ``embed`` dim); for a mesh that does not hold every
        rank in rank order.
    """
    sizes = axis_sizes(mesh)
    if tuple(sizes) not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"the step needs a ('data', 'model') or ('pod', "
                         f"'data', 'model') mesh, not {tuple(sizes)}")
    if sizes["model"] > 1:
        raise ValueError(f"a model axis of {sizes['model']} (tensor "
                         f"parallelism) is ROADMAP item 2.6b-4; the step "
                         f"is data-parallel only")
    if run.fsdp and isinstance(opt_cfg, AdafactorConfig):
        raise ValueError("Adafactor with fsdp is ROADMAP item 2.6b-5: its "
                         "factored moments reduce over the sharded dim")
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh holds ranks {ranks}, not every rank of "
                         f"the process group in rank order")
    return dist.group.WORLD


def _shard_dim(p) -> int | None:
    """The tensor dim that leaf ``p`` is split on over the batch axes, or
    ``None`` for a replicated leaf or a plain tensor.

    :raises ValueError: for a leaf split on two dims, or split on some
        batch axes and replicated on others.
    """
    if not sharded(p):
        return None
    dims = {q.dim if isinstance(q, Shard) else None
            for q, n in zip(p.placements, p.device_mesh.shape) if n > 1}
    if len(dims) > 1:
        raise ValueError(f"placements {p.placements}: a leaf must be split "
                         f"on one dim over every batch axis, or on none")
    return dims.pop()


def _gather_params(params: dict, group) -> dict:
    """Each leaf whole, as a plain tensor: a sharded leaf all-gathered over
    ``group`` (its shards in rank order, which is the mesh's, along its
    split dim), a replicated one its local tensor, not gathered."""
    n = dist.get_world_size(group)

    def whole(p):
        d, x = _shard_dim(p), local(p)
        if d is None:
            return x
        x = x.movedim(d, 0).contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, d).contiguous()
    return tree_map(whole, params)


def _reduce_grads(grads: dict, params: dict, group, mb: int) -> dict:
    """The ranks' gradient sums added over ``group`` (one collective a
    leaf), each into its parameter's placement: reduce-scattered into a
    sharded leaf's shard, all-reduced for a replicated one; then the mean
    over the ``mb`` microbatches (in the accumulation dtype), or with one
    microbatch the parameter's dtype, as ``_microbatched_grads`` returns
    them.  DTensors for DTensor parameters."""
    n = dist.get_world_size(group)
    p_of = dict(leaves(params))

    def one(path, g):
        p = p_of[path]
        d = _shard_dim(p)
        if d is None:
            dist.all_reduce(g, group=group)
        else:
            x = g.movedim(d, 0).contiguous()
            g = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(g, x, group=group)
            g = g.movedim(0, d).contiguous()
        g = true_divide(g, mb) if mb > 1 else g.to(p.dtype)
        if not isinstance(p, DTensor):
            return g
        return DTensor.from_local(g, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    return unflatten((path, one(path, g)) for path, g in leaves(grads))


def _mesh_grads(params: dict, batch: dict, cfg: ModelConfig, run: RunConfig,
                mesh, rules, group, **kw):
    """This rank's share of ``_microbatched_grads`` on a global batch:
    global microbatch ``i`` is rows ``[i·B/mb, (i+1)·B/mb)``, of which the
    rank takes its :func:`batch_spec` rows; each microbatch's loss divides
    by its global count of labels (all-reduced first) and routes MoE
    tokens in the global microbatch's groups.  Returns ``(the local
    losses (mb,), the last microbatch's local metrics, the local gradients
    summed over the microbatches in run.grad_accum_dtype)``.

    :raises ValueError: for a batch whose rows the microbatches and ranks
        do not divide.
    """
    mb = max(run.microbatches, 1)
    B, S = batch["labels"].shape
    n = dist.get_world_size(group)
    if B % (mb * n):
        raise ValueError(f"a batch of {B} rows does not split into {mb} "
                         f"microbatches over {n} ranks")
    rows = B // mb
    micro = [_local_batch({k: v[i * rows:(i + 1) * rows]
                           for k, v in batch.items()}, cfg, mesh, rules)
             for i in range(mb)]
    counts = torch.stack([(m["labels"] >= 0).sum().cpu() for m in micro])
    dist.all_reduce(counts, group=group)
    acc_dt = DTYPES[run.grad_accum_dtype]
    acc, losses = None, []
    for i, b in enumerate(micro):
        loss, metrics, grads = value_and_grad(
            params, b, cfg, run, label_count=counts[i],
            global_tokens=rows * S, **kw)
        if acc is None:
            acc = tree_map(lambda g: g.to(acc_dt), grads)
        else:
            g_of = dict(leaves(grads))
            for path, a in leaves(acc):
                a.add_(g_of[path].to(a.dtype))
        del grads
        losses.append(loss)
    return torch.stack(losses), metrics, acc


def _mesh_train_step(cfg: ModelConfig, run: RunConfig, opt_cfg, mesh, **kw):
    """:func:`make_train_step`'s step on a data-parallel mesh."""
    group = _mesh_group(run, opt_cfg, mesh)
    rules = rules_for(mesh, run)
    update_ = _UPDATE_[type(opt_cfg)]
    mb = max(run.microbatches, 1)

    def step(params, opt_state, batch):
        with mesh_context(mesh, rules):
            full = _gather_params(params, group)
            losses, metrics, grads = _mesh_grads(full, batch, cfg, run, mesh,
                                                 rules, group, **kw)
        del full
        grads = _reduce_grads(grads, params, group, mb)
        stats = update_(params, grads, opt_state, opt_cfg, group=group)
        # the global values, added over the ranks in rank order: the same
        # bits on every rank
        mine = torch.cat([losses.float().cpu(), torch.stack(
            [metrics["ce"], metrics["moe_aux"]]).float().cpu()])
        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, mine, group=group)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        loss = total[0]
        for i in range(1, mb):
            loss = loss + total[i]
        if mb > 1:
            loss = true_divide(loss, mb)
        return params, opt_state, {"loss": loss, "ce": total[mb],
                                   "moe_aux": total[mb + 1], **stats}

    return step


def make_train_step(cfg: ModelConfig, run: RunConfig, opt_cfg=None, *,
                    mesh=None, q_chunk: int = 512, kv_chunk: int = 1024):
    """``(step, opt_cfg)``: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, the new values written in place; ``metrics``:
    ``loss``, ``ce``, ``moe_aux``, ``grad_norm``, ``lr``.

    On ``mesh`` (a ``("data", "model")`` or ``("pod", "data", "model")``
    ``DeviceMesh`` with a ``model`` axis of 1) the step is data-parallel
    over the batch axes.  It takes :func:`init_train_state`'s ``mesh=``
    trees (DTensors) and, on every rank, the global batch; it gathers
    each sharded parameter whole, runs the forward and backward on this
    rank's rows of each global microbatch inside ``mesh_context`` (the
    loss over the global count of labels), sums the gradients over the
    ranks in one collective a leaf (a reduce-scatter into a sharded
    leaf's shard, an all-reduce of a replicated one), and updates each
    rank's local shards, clipped by the whole gradient's norm.  The
    metrics are the global batch's, the same on every rank.

    :raises ValueError: as :func:`_mesh_group` says; at the step, for a
        batch the microbatches and ranks do not divide, and for an MoE
        token group that would span ranks.
    """
    opt_cfg, _, _ = make_optimizer(run, opt_cfg)
    update_ = _UPDATE_[type(opt_cfg)]
    if mesh is not None:
        return _mesh_train_step(cfg, run, opt_cfg, mesh, q_chunk=q_chunk,
                                kv_chunk=kv_chunk), opt_cfg

    def step(params, opt_state, batch):
        loss, metrics, grads = _microbatched_grads(
            params, batch, cfg, run, q_chunk=q_chunk, kv_chunk=kv_chunk)
        stats = update_(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **stats}

    return step, opt_cfg


def make_train_step_compressed(cfg: ModelConfig, run: RunConfig,
                               n_pods: int | None = None, opt_cfg=None, *,
                               mesh=None, q_chunk: int = 512,
                               kv_chunk: int = 1024):
    """``(step, opt_cfg)`` of the replicated step with int8 gradient
    exchange: ``step(params_r, opt_r, ef_r, batch) -> (params_r, opt_r,
    ef_r, metrics)`` on the trees of :func:`init_replica_state`, written
    in place.

    In one process (no ``mesh``) the trees' leading axis holds ``n_pods``
    replicas and the batch's leading axis is split into ``n_pods`` equal
    slices, one a replica.  On ``mesh`` (a ``DeviceMesh`` whose ``pod``
    axis holds one replica a rank) ``n_pods`` is the pod axis's size, the
    leading axis is 1, every rank is given the global batch and takes its
    slice (replica ``r`` rows ``[r·B/n, (r+1)·B/n)``, as in one process).
    Each leaf's gradients are then exchanged (kernel 7 once, kernel 8 once
    a rank; with one replica, not at all) and each replica takes the
    optimizer step with the mean.  ``metrics``: the replicas' mean loss,
    ``ce`` and ``moe_aux`` (each summed in replica order over float32
    ``n``), replica 0's ``grad_norm`` and ``lr`` (every replica's are the
    same).

    :raises ValueError: as :func:`_mesh_pods` says; and at the step, on a
        mesh, for a batch the pods do not divide.
    """
    n_pods = _mesh_pods(run, n_pods, mesh)
    rules = None if mesh is None else rules_for(mesh, run)
    opt_cfg, _, _ = make_optimizer(run, opt_cfg)
    update_ = _UPDATE_[type(opt_cfg)]

    def step(params_r, opt_r, ef_r, batch):
        if mesh is None:
            split = {k: v.reshape((n_pods, v.shape[0] // n_pods)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            slices = [{k: v[r] for k, v in split.items()}
                      for r in range(n_pods)]
        else:
            if batch["labels"].shape[0] % n_pods:
                raise ValueError(f"a batch of {batch['labels'].shape[0]} "
                                 f"rows does not split into {n_pods} pods")
            slices = [_local_batch(batch, cfg, mesh, rules)]
        grads = tree_map(lambda p: torch.empty_like(p), params_r)
        runs = []
        for r, b in enumerate(slices):
            loss, metrics, g = value_and_grad(
                replica(params_r, r), b, cfg, run, q_chunk=q_chunk,
                kv_chunk=kv_chunk)
            g_of = dict(leaves(g))
            for path, stack in leaves(grads):
                stack[r].copy_(g_of[path])
            del g, g_of
            runs.append({"loss": loss, **metrics})
        compress_pod_reduce(grads, ef_r, n_pods=n_pods, mesh=mesh)
        stats = [update_(replica(params_r, r), replica(grads, r),
                         replica(opt_r, r), opt_cfg)
                 for r in range(len(slices))]
        if mesh is not None and n_pods > 1:
            runs = _gathered(runs[0], mesh)
        n = f32(n_pods)
        out = {k: torch.stack([m[k].cpu() for m in runs]).sum() / n
               for k in runs[0]}
        out.update(stats[0])
        return params_r, opt_r, ef_r, out

    return step, opt_cfg


def _placed(tree: dict, shardings: dict, mesh, coord) -> dict:
    """``tree`` with each leaf a DTensor of this rank's slice (a copy where
    it is split) by ``shardings``' placements, the whole leaves released
    one at a time (``tree`` is emptied)."""
    out = {}
    for k in sorted(tree):
        v = tree.pop(k)
        if isinstance(v, dict):
            out[k] = _placed(v, shardings[k], mesh, coord)
            continue
        mine = local_slice(v, mesh, shardings[k], coord)
        if mine.shape != v.shape:
            mine = mine.clone(memory_format=torch.contiguous_format)
        out[k] = DTensor.from_local(mine, mesh, shardings[k], run_check=False,
                                    shape=v.shape, stride=v.stride())
        del v, mine
    return out


def init_train_state(cfg: ModelConfig, run: RunConfig,
                     generator: torch.Generator, opt_cfg=None, *, mesh=None,
                     device: str | torch.device = "cuda"):
    """``(params, opt_state)``: parameters drawn from ``generator`` by
    :func:`~repro_torch.models.layers.init_from_specs` on ``device``, and
    the optimizer's zeroed state.

    On ``mesh`` every rank draws the same whole values (from a generator
    seeded alike) and keeps its slice: each parameter is a DTensor placed
    by :func:`~.sharding.param_shardings` (as the elastic restore places
    it), each optimizer leaf a DTensor of its local zeros placed by
    :func:`~.sharding.opt_shardings`; the step counter stays on the host.
    No collective runs."""
    device = resolve_device(device)
    specs = M.model_specs(cfg)
    params = init_from_specs(specs, generator, device=device)
    opt_cfg, opt_init, _ = make_optimizer(run, opt_cfg)
    if mesh is None:
        return params, opt_init(params, opt_cfg)
    rules = rules_for(mesh, run)
    psh = param_shardings(specs, mesh, rules)
    coord = mesh.get_coordinate()
    params = _placed(params, psh, mesh, coord)
    # the optimizer state's whole shapes, allocated nowhere
    whole = opt_init(tree_map(lambda p: torch.empty(
        p.shape, dtype=p.dtype, device="meta"), params), opt_cfg)
    osh = dict(leaves(opt_shardings(opt_cfg, specs, psh, mesh, rules)))

    def place(path, w):
        if not w.is_meta:
            return w                      # the host step counter
        mine = local_slice(w, mesh, osh[path], coord)
        return DTensor.from_local(
            torch.zeros(mine.shape, dtype=w.dtype, device=device), mesh,
            osh[path], run_check=False, shape=w.shape, stride=w.stride())
    return params, unflatten((path, place(path, w))
                             for path, w in leaves(whole))


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


def init_replica_state(cfg: ModelConfig, run: RunConfig,
                       n_pods: int | None, generator: torch.Generator,
                       opt_cfg=None, *, mesh=None,
                       device: str | torch.device = "cuda"):
    """``(params_r, opt_r, ef_r)`` for :func:`make_train_step_compressed`:
    :func:`init_train_state`'s values, each leaf copied along a new
    leading axis (the step counter too, on the host), and zeroed error
    feedback of that shape.  The axis holds ``n_pods`` replicas in one
    process, and this rank's one replica on ``mesh`` (every rank draws
    the same values from a generator seeded alike)."""
    n_pods = _mesh_pods(run, n_pods, mesh)
    n = 1 if mesh is not None else n_pods
    params, opt_state = init_train_state(cfg, run, generator, opt_cfg,
                                         device=device)
    params_r = _replicate(params, n)
    opt_r = _replicate(opt_state, n)
    return params_r, opt_r, init_error_feedback(params_r)


def train_loop(cfg: ModelConfig, run: RunConfig, data_iter, *, steps: int,
               opt_cfg=None, checkpoint_dir: str | None = None,
               checkpoint_every: int = 50, resume: bool = True,
               generator: torch.Generator | None = None,
               watchdog_timeout: float = 0.0, log_every: int = 10,
               device: str | torch.device = "cuda"):
    """Resilient training loop: ``(params, opt_state, history)``.

    The reference's loop, step for step: initialize (from ``generator``,
    default seed 0 on ``device``), then restore the latest checkpoint of
    ``checkpoint_dir`` if ``resume``; take steps ``start .. steps - 1``,
    each on ``next(data_iter)`` (from the iterator's current position: a
    resumed run must be given a stream advanced to its start) inside the
    watchdog, recording ``(step, loss)`` in ``history`` every
    ``log_every`` steps and at the last; save every ``checkpoint_every``
    steps, and save and stop after a preemption signal; wait for the
    last write."""
    from ..checkpoint.manager import CheckpointManager
    from ..runtime.resilience import PreemptionGuard, StepWatchdog

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    opt_cfg = opt_cfg or AdamWConfig(moments_dtype=run.optimizer_dtype)
    step_fn, opt_cfg = make_train_step(cfg, run, opt_cfg)
    params, opt_state = init_train_state(cfg, run, generator, opt_cfg,
                                         device=device)

    start = 0
    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, device=device)
        if resume:
            restored = mgr.restore_latest()
            if restored is not None:
                params, opt_state, start = restored

    guard = PreemptionGuard()
    watchdog = StepWatchdog(timeout=watchdog_timeout)
    history = []
    for step in range(start, steps):
        batch = next(data_iter)
        with watchdog.step(step):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
        if mgr and (step + 1) % checkpoint_every == 0:
            mgr.save(step + 1, params, opt_state)
        if guard.should_stop:
            if mgr:
                mgr.save(step + 1, params, opt_state)
            break
    if mgr:
        mgr.wait()
    return params, opt_state, history
