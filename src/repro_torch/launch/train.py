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
  for the forward, the gradients reduce-scattered into the shards); and
  tensor-parallel over a ``model`` axis wider than 1 for the dense
  attention and MLP, MoE, RWKV6 and Mamba2-hybrid families with AdamW:
  each ``model`` rank computes its slice of the heads, the ffn (query
  heads and ffn columns in balanced ranges where the axis does not
  divide them) or the experts (expert parallelism) and of a vocabulary
  the axis divides (one it does not divide stays whole), with explicit
  collectives over the ``model`` group
  (:func:`~repro_torch.models.layers.model_parallel`) and a
  vocab-parallel cross-entropy on a split vocabulary;
* :func:`make_train_step_compressed` — data-parallel replicas: params,
  optimizer state and error feedback carry a leading replica axis; each
  replica computes gradients on its own slice of the batch, the
  gradients are exchanged as int8 codes with error feedback
  (:mod:`repro_torch.optim.grad_compress`: kernels 7 and 8, one launch of
  each a leaf and step), and every replica applies the same update.  In
  one process the axis holds all ``n_pods`` replicas, which run one after
  another, and the all-gather is the identity; on a mesh each rank holds
  its pod's replica (an axis of 1) and takes its slice of the global
  batch by :func:`batch_spec`'s placement, the data ranks of a pod sum
  their gradients (float32, one all-reduce a leaf), and the codes cross
  between the pods' ranks.  With one data rank a pod the two forms give
  the same bits.

Both steps write the new parameters and optimizer state into the trees
they are given, in place (the reference's training loop donates them to
its jitted step), and return them.

:func:`train_loop` is the reference's resilient loop: checkpoints
(:mod:`repro_torch.checkpoint`), auto-resume, preemption handling and a
step watchdog (:mod:`repro_torch.runtime`), on one device or on a
data-parallel mesh (the sharded state saved whole by rank 0, the
restore placed on each rank's slices, the stop flag agreed across the
ranks).

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
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig, RunConfig
from ..device import resolve_device
from ..kernels.ref import true_divide
from ..models import model as M
from ..models.layers import (DTYPES, ShapeDtypeStruct, init_from_specs,
                             mesh_context, model_group, model_parallel)
from ..optim.adafactor import (AdafactorConfig, adafactor_init,
                               adafactor_update, adafactor_update_)
from ..optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                           adamw_update_, f32)
from ..optim.grad_compress import compress_pod_reduce, init_error_feedback
from ..optim.tree import (leaves, replica, shard_dim, tree_map, unflatten,
                          whole)
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


class _VocabParallelCE(torch.autograd.Function):
    """``logsumexp(logits) − logits[idx]`` a position, on a ``model``
    rank's slice of the vocabulary: the local max all-reduced (MAX), the
    local sum of exponentials all-reduced (SUM), the gold logit taken on
    the rank that holds it and all-reduced (SUM); float32 inside, the
    result in the logits' dtype.  The gradient is the local softmax less
    the local one-hot, times the incoming gradient."""

    @staticmethod
    def forward(ctx, logits, idx, group):
        n = logits.shape[-1]
        x = logits.float()
        m = x.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.exp(x - m[..., None]).sum(dim=-1)
        dist.all_reduce(s, group=group)
        logz = torch.log(s) + m
        mine = idx - dist.get_rank(group) * n
        inside = (mine >= 0) & (mine < n)
        mine = mine.clamp(0, n - 1)
        gold = torch.gather(x, -1, mine[..., None])[..., 0]
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, logz, mine, inside)
        return (logz - gold).to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        logits, logz, mine, inside = ctx.saved_tensors
        g = g.float()
        grad = torch.exp(logits.float() - logz[..., None]) * g[..., None]
        grad.scatter_add_(-1, mine[..., None],
                          -torch.where(inside, g, torch.zeros_like(g))[
                              ..., None])
        return grad.to(logits.dtype), None, None


def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              vocab_size: int) -> torch.Tensor:
    """``logsumexp − gold logit`` at each position, over a vocabulary of
    ``vocab_size``; a negative label indexes from the end, as the
    reference's gather does (its term is masked out by the caller).
    Where ``logits`` is a ``model`` rank's slice of the vocabulary
    (:func:`~repro_torch.models.model.vocab_split`) the cross-entropy is
    vocab-parallel (:class:`_VocabParallelCE`); whole logits, inside a
    ``model`` group too, take the plain path."""
    idx = torch.where(labels < 0, labels + vocab_size, labels)
    if M.vocab_split(logits.shape[-1], vocab_size):
        return _VocabParallelCE.apply(logits, idx, model_group())
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, idx[..., None])[..., 0]


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
    to the global batch's.  Inside a
    :func:`~repro_torch.models.layers.model_parallel` block the parameters
    are a ``model`` rank's slices, and the cross-entropy is computed on
    the rank's slice of the vocabulary (``_VocabParallelCE``) where the
    axis divides it, on the whole logits where it does not."""
    key = M.input_key(cfg)
    logits, aux = M.forward(params, cfg, mode="train",
                            remat=run.remat != "none", q_chunk=q_chunk,
                            kv_chunk=kv_chunk, global_tokens=global_tokens,
                            **{key: batch[key]})
    if run.logits_fp32:
        logits = logits.float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    count = mask.sum() if label_count is None else label_count.to(mask)
    ce = torch.sum(_token_ce(logits, labels, cfg.vocab_size) * mask) \
        / torch.clamp(count, min=1.0)
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


def _gathered(run: dict, mesh, axis: str = "pod") -> list[dict]:
    """Every rank's ``run`` (a dict of 0-dim tensors) of this rank's
    ``axis`` group of ``mesh``, in the axis's order, on the host."""
    group = mesh.get_group(axis)
    out = [{} for _ in range(dist.get_world_size(group))]
    for k, v in run.items():
        v = v.cpu()
        parts = [torch.empty_like(v) for _ in out]
        dist.all_gather(parts, v, group=group)
        for m, p in zip(out, parts):
            m[k] = p
    return out


def _mesh_axes(mesh) -> dict[str, int]:
    """The axis sizes of a train mesh: ``("data", "model")`` or ``("pod",
    "data", "model")``, which (a ``DeviceMesh``) holds every rank of the
    process group in rank order.

    :raises ValueError: for other axes; for a ``DeviceMesh`` that does not
        hold every rank in rank order.
    """
    sizes = axis_sizes(mesh)
    if tuple(sizes) not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"the step needs a ('data', 'model') or ('pod', "
                         f"'data', 'model') mesh, not {tuple(sizes)}")
    if isinstance(mesh, DeviceMesh):
        ranks = mesh.mesh.flatten().tolist()
        if ranks != list(range(dist.get_world_size())):
            raise ValueError(f"the mesh holds ranks {ranks}, not every rank "
                             f"of the process group in rank order")
    return sizes


def _check_model_axis(cfg: ModelConfig, run: RunConfig, opt_cfg,
                      mesh) -> None:
    """Check that :func:`make_train_step` runs ``cfg``, ``run`` and
    ``opt_cfg`` on ``mesh``: a ``model`` axis of 1 runs everything the
    data-parallel step does; a wider one, with AdamW, the dense attention
    and MLP families (token or embedding input), the MoE family whose
    experts it divides (expert parallelism), the RWKV6 family whose heads
    and ffn it divides, and the hybrid family whose Mamba2 heads and
    fused ``w_in`` and ``conv_w`` widths it divides (which the rules would
    otherwise leave whole on ``model``, their gradients partial there).
    The attention and dense MLP blocks (and the MoE family's attention,
    the hybrid's shared block) take a balanced range of the query heads
    and ffn columns where the axis does not divide them
    (:func:`~repro_torch.models.layers.rank_units`), as long as every rank
    holds at least one.  A vocabulary the axis does not divide stays whole
    on every ``model`` rank.

    :raises ValueError: as :func:`_mesh_axes` says; above 1, for an axis
        wider than the query heads or the ffn, a split inside the experts,
        or RWKV6's heads or ffn, Mamba2's heads or fused widths that the
        axis does not divide (ROADMAP item 2.6b-4b-3b), ``run.seq_shard``
        (2.6b-4b-4) and Adafactor (2.6b-4b-5).
    """
    n = _mesh_axes(mesh)["model"]
    if n == 1:
        return
    why, item = None, "2.6b-4b-3b"
    if run.seq_shard:
        why, item = "sequence sharding (seq_shard=True)", "2.6b-4b-4"
    elif isinstance(opt_cfg, AdafactorConfig):
        why, item = "Adafactor", "2.6b-4b-5"
    elif cfg.family == "ssm":
        heads = cfg.d_model // cfg.rwkv_head
        if heads % n or cfg.d_ff % n:
            why = (f"{heads} RWKV6 heads and an ffn of {cfg.d_ff} split {n} "
                   f"ways")
    else:
        if cfg.family == "hybrid":
            din, ns = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
            heads = din // cfg.ssm_head
            widths = (heads, 2 * din + 2 * ns + heads, din + 2 * ns)
            if any(w % n for w in widths):
                why = (f"{heads} Mamba2 heads and w_in/conv_w widths of "
                       f"{widths[1]}/{widths[2]} split {n} ways")
        elif cfg.n_experts and cfg.n_experts % n:
            why = f"{cfg.n_experts} experts split {n} ways"
        ffn = 0 if cfg.n_experts else cfg.d_ff
        if why is None and (cfg.n_heads < n or ffn and ffn < n):
            why = (f"{cfg.n_heads} query heads"
                   + (f" and an ffn of {ffn}" if ffn else "")
                   + " (a rank would hold none)")
    if why:
        raise ValueError(f"{cfg.name}: {why} on a model axis of {n} is "
                         f"ROADMAP item {item}")


def _mesh_pods(run: RunConfig, n_pods: int | None, mesh) -> int:
    """The replica count of the compressed step: ``n_pods`` in one
    process; on a mesh (:func:`_mesh_axes`: ``("data", "model")`` or
    ``("pod", "data", "model")``, any ``data`` size) the ``pod`` axis's
    size, or 1 without a ``pod`` axis.

    :raises ValueError: with ``run.fsdp`` (as the reference: the
        replicas hold whole state); as :func:`_mesh_axes` says; for a
        ``model`` axis wider than 1 (ROADMAP item 2.6b-4d); for an
        ``n_pods`` the mesh contradicts, or below 1 in one process.
    """
    if run.fsdp:
        raise ValueError("the compressed step requires fsdp=False")
    if mesh is None:
        if n_pods is None or n_pods < 1:
            raise ValueError(f"n_pods must be at least 1, got {n_pods}")
        return n_pods
    sizes = _mesh_axes(mesh)
    if sizes["model"] > 1:
        raise ValueError(f"the compressed step on a model axis of "
                         f"{sizes['model']} is ROADMAP item 2.6b-4d")
    pods = sizes.get("pod", 1)
    if n_pods is not None and n_pods != pods:
        raise ValueError(f"n_pods={n_pods}, but the mesh has {pods} pods")
    return pods


def _batch_axes(mesh) -> tuple[str, ...]:
    """The mesh's batch axes: ``("pod", "data")``, or ``("data",)``."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _mesh_groups(mesh):
    """``(batch group, model group)`` of this rank on a train mesh: the
    process group of the ranks at its ``model`` coordinate (the whole
    process group when the ``model`` axis is 1), and the mesh's ``model``
    group (``None`` when it is 1).  Each group lists its ranks in the
    mesh's order.

    :raises ValueError: as :func:`_mesh_axes` says.
    """
    sizes = _mesh_axes(mesh)
    if sizes["model"] == 1:
        return dist.group.WORLD, None
    wide = [a for a in _batch_axes(mesh) if sizes[a] > 1]
    if len(wide) < 2:
        batch = mesh.get_group(wide[0] if wide else "data")
    else:
        # pod × data: one new group a model coordinate, made by every rank
        for m in range(sizes["model"]):
            ranks = mesh.mesh[..., m].flatten().tolist()
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                batch = g
    return batch, mesh.get_group("model")


def _partial_over_model(specs: dict, psh: dict, mesh) -> frozenset:
    """The paths of the leaves whose gradients are partial on each
    ``model`` rank: a leaf with a ``heads``, ``kv_heads`` or ``mlp`` dim
    placed whole on the ``model`` axis (the rules' divisibility fallback)
    of which each rank consumes a slice: the attention's query heads and
    the dense MLP's ffn columns that the rank takes
    (:func:`~repro_torch.models.layers.rank_units`), and the kv heads its
    query heads read.  Not partial: a leaf split on ``model`` and gathered
    whole (the gather's reduce-scatter sums its gradient); a leaf of no
    split axis (a norm's gain), an MoE router (the routing reads its input
    outside the split; only the gates enter it, and their partial
    gradients are summed there) and a vocabulary leaf the axis does not
    divide (consumed whole), which see the same inputs and gradients on
    every ``model`` rank; an expert leaf, which the check keeps split
    (:func:`_check_model_axis`); and RWKV6's and Mamba2's own leaves (the
    stacked layers' leaves, ``layers/<name>``), which the check keeps
    split where they have a ``heads`` or ``mlp`` dim: RWKV6's mixes, LoRA
    ``wA`` and gate ``cr`` are applied before the split is entered, and
    Mamba2's fused ``w_in`` and ``conv_w`` are split on ``model`` and
    gathered in the forward."""
    from torch.distributed.tensor import Shard

    dim = list(axis_sizes(mesh)).index("model")
    pl = dict(leaves(psh))
    split = {"heads", "kv_heads", "mlp"}
    return frozenset(path for path, spec in leaves(specs)
                     if split & set(spec.axes) and "experts" not in spec.axes
                     and not (len(path) == 2 and path[0] == "layers")
                     and not isinstance(pl[path][dim], Shard))


def _gather_params(params: dict, group, axes=None) -> dict:
    """Each leaf whole over the mesh axes ``axes`` (default all), as a
    plain tensor (:func:`~..optim.tree.whole`): a leaf split over them
    all-gathered over ``group``, a replicated one its local tensor, not
    gathered; a split over other axes (``model``) is kept."""
    return tree_map(lambda p: whole(p, group, axes), params)


def _reduce_grads(grads: dict, params: dict, group, mb: int, axes=None,
                  model=None, partial=frozenset()) -> dict:
    """The ranks' gradient sums added over ``group`` (the ranks of the
    mesh axes ``axes``, default all; one collective a leaf), each into its
    parameter's placement: reduce-scattered into a leaf's shard where it
    is split over those axes, all-reduced where it is not; then the mean
    over the ``mb`` microbatches (in the accumulation dtype), or with one
    microbatch the parameter's dtype, as ``_microbatched_grads`` returns
    them.  A leaf in ``partial`` (:func:`_partial_over_model`) is first
    all-reduced over the ``model`` group.  DTensors for DTensor
    parameters."""
    n = dist.get_world_size(group)
    p_of = dict(leaves(params))

    def one(path, g):
        p = p_of[path]
        if path in partial:
            dist.all_reduce(g, group=model)
        d = shard_dim(p, axes)
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
    """:func:`make_train_step`'s step on a mesh: data-parallel over its
    batch axes, tensor-parallel over its ``model`` axis (the query heads
    and the ffn in balanced ranges, whether or not the axis divides them,
    and a vocabulary the axis divides split over it; the experts of an MoE
    layer too: expert parallelism; RWKV6's and Mamba2's heads, their norms
    over the heads summed over ``model``)."""
    _check_model_axis(cfg, run, opt_cfg, mesh)
    group, model = _mesh_groups(mesh)
    axes = None if model is None else _batch_axes(mesh)
    rules = rules_for(mesh, run)
    partial = frozenset()
    if model is not None:
        specs = M.model_specs(cfg)
        partial = _partial_over_model(specs, param_shardings(
            specs, mesh, rules), mesh)
    update_ = _UPDATE_[type(opt_cfg)]
    mb = max(run.microbatches, 1)

    def step(params, opt_state, batch):
        with mesh_context(mesh, rules), model_parallel(model):
            full = _gather_params(params, group, axes)
            losses, metrics, grads = _mesh_grads(full, batch, cfg, run, mesh,
                                                 rules, group, **kw)
        del full
        grads = _reduce_grads(grads, params, group, mb, axes, model, partial)
        stats = update_(params, grads, opt_state, opt_cfg,
                        group=dist.group.WORLD)
        # the global values, added over the batch ranks in rank order: the
        # same bits on every rank
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
    ``DeviceMesh``) the step is data-parallel over the batch axes and,
    with a ``model`` axis wider than 1, tensor-parallel over it.  It takes
    :func:`init_train_state`'s ``mesh=`` trees (DTensors) and, on every
    rank, the global batch; it gathers each parameter split over the
    batch axes (fsdp) whole there, keeping its ``model`` slice, runs the
    forward and backward on this rank's rows of each global microbatch
    inside ``mesh_context`` and ``model_parallel`` (the loss over the
    global count of labels; the ``model`` ranks of a row compute its
    heads (attention, RWKV6 or Mamba2), ffn or experts, and a vocabulary
    the axis divides, in slices (query heads and ffn columns in balanced
    ranges that the axis need not divide: each rank's columns of a leaf
    split inside a head gathered, or cut from a leaf whole on ``model``),
    with all-reduces over ``model`` where a split ends or a norm spans the
    heads; each rank routes
    every MoE token of its row, and runs a vocabulary the axis does not
    divide whole), sums the gradients over the batch ranks in one
    collective a leaf (a reduce-scatter into a sharded leaf's shard, an
    all-reduce of a replicated one; a leaf whole on ``model`` whose
    gradient is partial there, :func:`_partial_over_model`, is first
    all-reduced over ``model``), and updates each rank's local shards:
    AdamW clipped by the whole gradient's norm, Adafactor with its
    factored means and RMS clip over each whole leaf (sums over a split
    dim added across the ranks).  The metrics are the global batch's, the
    same on every rank.

    :raises ValueError: as :func:`_check_model_axis` says (a ``model``
        axis wider than 1 runs the dense attention and MLP, MoE, RWKV6 and
        hybrid families with AdamW, query heads and an ffn that the axis
        does not divide included); at the step, for a batch the
        microbatches and ranks do not divide, and for an MoE token group
        that would span ranks.
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
    slices, one a replica; each replica's gradient is its slice's.

    On ``mesh`` (``("pod", "data", "model")`` or ``("data", "model")``,
    any ``data`` size, ``model`` 1; :func:`_mesh_pods`) ``n_pods`` is the
    pod axis's size (1 without one), each rank holds its pod's replica
    (a leading axis of 1), and every rank is given the global batch and
    takes its :func:`batch_spec` rows: rank ``(p, d)`` of ``P`` pods and
    ``D`` data ranks rows ``[(p·D + d)·B/(P·D), …)``, so that pod ``p``
    holds rows ``[p·B/P, (p+1)·B/P)``, as in one process.  The loss
    divides by the pod's count of labels (the data group's counts
    all-reduced) and MoE tokens route in the pod's groups; the rank's
    gradient, in float32, is summed over the data group (one all-reduce
    a leaf, :func:`_reduce_grads`) and cast once to the parameter's
    dtype: the pod's gradient, the same bits on its data ranks.  The
    reference's pjit sums the partials in the parameter's dtype (ROADMAP
    queue 3).

    Each leaf's gradients are then exchanged (kernel 7 once, kernel 8
    once a rank; with one replica, not at all): on a mesh each rank with
    the ranks at its data coordinate in the other pods, over the ``pod``
    group.  Each replica takes the optimizer step with the mean.
    ``metrics``: the replicas' mean loss, ``ce`` and ``moe_aux`` (on a
    mesh each pod's the sum of its data ranks' in data order; each
    summed in replica order over float32 ``n``), replica 0's
    ``grad_norm`` and ``lr`` (every replica's are the same).  Like the
    reference's compressed step, it ignores ``run.microbatches``.

    :raises ValueError: as :func:`_mesh_pods` says; at the step, on a
        mesh, for a batch the pods and data ranks do not divide, and for
        an MoE token group that would span data ranks.
    """
    n_pods = _mesh_pods(run, n_pods, mesh)
    n_data = 1 if mesh is None else axis_sizes(mesh)["data"]
    rules = None if mesh is None else rules_for(mesh, run)
    opt_cfg, _, _ = make_optimizer(run, opt_cfg)
    update_ = _UPDATE_[type(opt_cfg)]

    def step(params_r, opt_r, ef_r, batch):
        kw = {}
        if mesh is None:
            split = {k: v.reshape((n_pods, v.shape[0] // n_pods)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            slices = [{k: v[r] for k, v in split.items()}
                      for r in range(n_pods)]
        else:
            B, S = batch["labels"].shape
            if B % (n_pods * n_data):
                raise ValueError(f"a batch of {B} rows does not split into "
                                 f"{n_pods} pods of {n_data} data ranks")
            slices = [_local_batch(batch, cfg, mesh, rules)]
            if n_data > 1:
                count = (slices[0]["labels"] >= 0).sum().cpu()
                dist.all_reduce(count, group=mesh.get_group("data"))
                kw = {"label_count": count, "global_tokens": B // n_pods * S}
        grads = tree_map(lambda p: torch.empty_like(p), params_r)
        runs = []
        for r, b in enumerate(slices):
            loss, metrics, g = value_and_grad(
                replica(params_r, r), b, cfg, run, q_chunk=q_chunk,
                kv_chunk=kv_chunk, **kw)
            if n_data > 1:
                g = _reduce_grads(tree_map(lambda t: t.float(), g),
                                  replica(params_r, r),
                                  mesh.get_group("data"), 1)
            g_of = dict(leaves(g))
            for path, stack in leaves(grads):
                stack[r].copy_(g_of[path])
            del g, g_of
            runs.append({"loss": loss, **metrics})
        if n_data > 1:
            # the pod's values: its data ranks' added in data order
            parts = _gathered(runs[0], mesh, "data")
            runs = [{k: sum((p[k] for p in parts[1:]), parts[0][k])
                     for k in parts[0]}]
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
    process, and on ``mesh`` (as :func:`make_train_step_compressed` takes
    it, any ``data`` size) this rank's one replica, whole: every rank
    draws the same values from a generator seeded alike, and no
    collective runs.

    :raises ValueError: as :func:`_mesh_pods` says."""
    n_pods = _mesh_pods(run, n_pods, mesh)
    n = 1 if mesh is not None else n_pods
    params, opt_state = init_train_state(cfg, run, generator, opt_cfg,
                                         device=device)
    params_r = _replicate(params, n)
    opt_r = _replicate(opt_state, n)
    return params_r, opt_r, init_error_feedback(params_r)


def _restore_latest(mgr, cfg: ModelConfig, run: RunConfig, opt_cfg, mesh):
    """``mgr.restore_latest()`` (``None`` without a checkpoint); on
    ``mesh``, the parameters placed by :func:`~.sharding.param_shardings`
    (the elastic restore) and each optimizer leaf then by
    :func:`~.sharding.opt_shardings`, as :func:`init_train_state` places
    them: this rank's slice of the whole restored leaf, the whole leaves
    released one at a time; the step counter stays on the host."""
    if mesh is None:
        return mgr.restore_latest()
    specs = M.model_specs(cfg)
    rules = rules_for(mesh, run)
    psh = param_shardings(specs, mesh, rules)
    restored = mgr.restore_latest(mesh=mesh, shardings=psh)
    if restored is None:
        return None
    params, opt_state, start = restored
    counter = opt_state.pop("step")
    opt_state = _placed(opt_state, opt_shardings(opt_cfg, specs, psh, mesh,
                                                 rules),
                        mesh, mesh.get_coordinate())
    opt_state["step"] = counter
    return params, opt_state, start


def train_loop(cfg: ModelConfig, run: RunConfig, data_iter, *, steps: int,
               opt_cfg=None, checkpoint_dir: str | None = None,
               checkpoint_every: int = 50, resume: bool = True,
               generator: torch.Generator | None = None,
               watchdog_timeout: float = 0.0, log_every: int = 10,
               mesh=None, device: str | torch.device = "cuda"):
    """Resilient training loop: ``(params, opt_state, history)``.

    The reference's loop, step for step: initialize (from ``generator``,
    default seed 0 on ``device``), then restore the latest checkpoint of
    ``checkpoint_dir`` if ``resume``; take steps ``start .. steps - 1``,
    each on ``next(data_iter)`` (from the iterator's current position: a
    resumed run must be given a stream advanced to its start) inside the
    watchdog, recording ``(step, loss)`` in ``history`` every
    ``log_every`` steps and at the last; save every ``checkpoint_every``
    steps, and save and stop after a preemption signal; wait for the
    last write.

    On ``mesh`` (a data-parallel ``DeviceMesh`` of ``device``'s type, as
    :func:`make_train_step` takes it) every rank runs the loop: the
    state is :func:`init_train_state`'s ``mesh=`` trees, every rank draws
    the global batch, the restore places the parameters and the
    optimizer state on the rank's slices (:func:`_restore_latest`), each
    save is a collective that rank 0 writes, and ``history`` is the same
    on every rank.  The ranks are separate processes, each with its own
    ``PreemptionGuard``, where the reference has one controller: so after
    each step (and its periodic save) the ranks agree on the stop flag
    (an all-reduce of its maximum), and all save the same step and stop
    together.  When the loop returns on any rank, its last file is
    complete.

    :raises ValueError: as :func:`make_train_step` says, and for a
        ``model`` axis wider than 1 (the loop and its sharded save there
        are ROADMAP item 2.6b-4c), before any checkpoint is read or any
        state is made.
    """
    from ..checkpoint.manager import CheckpointManager
    from ..runtime.resilience import PreemptionGuard, StepWatchdog

    n_model = 1 if mesh is None else _mesh_axes(mesh)["model"]
    if n_model > 1:
        raise ValueError(f"train_loop on a model axis of {n_model} is "
                         f"ROADMAP item 2.6b-4c")
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(moments_dtype=run.optimizer_dtype)
    step_fn, opt_cfg = make_train_step(cfg, run, opt_cfg, mesh=mesh)
    group = None if mesh is None else _mesh_groups(mesh)[0]
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params, opt_state = init_train_state(cfg, run, generator, opt_cfg,
                                         mesh=mesh, device=device)

    start = 0
    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, device=device)
        if resume:
            restored = _restore_latest(mgr, cfg, run, opt_cfg, mesh)
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
        stop = guard.should_stop
        if group is not None:
            flag = torch.tensor([int(stop)], dtype=torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            stop = bool(flag.item())
        if stop:
            if mgr:
                mgr.save(step + 1, params, opt_state)
            break
    if mgr:
        mgr.wait()
    return params, opt_state, history
