"""Error-bounded int8 gradient exchange between data-parallel replicas.

The reference's quantization stage reused for gradients: each leaf is
flattened, zero-padded to a whole number of groups of 256 values and
quantized per group to int8 codes with one float32 scale (kernel 7,
``ops.group_quant`` at group 256); the codes cross between replicas
(4× less traffic than float32), every replica dequantizes them (kernel
8, ``ops.group_dequant``) and takes their mean, and the quantization
residual is carried into the next step's gradient as error feedback
(the EF-SGD / EF21 family), so compression does not bias convergence.

The arithmetic is the reference's (its eager ``_quant_leaf`` /
``_dequant_leaf``: the scale divides, it is not a reciprocal product), in
one of two forms:

* one process: the replicas ("pods") are the leading axis of every leaf
  and the all-gather of the codes is the identity.  :func:`exchange_leaf`
  quantizes all the replicas' values of a leaf in one kernel-7 launch
  over an ``(n_pods · groups, 256)`` matrix and dequantizes them in one
  kernel-8 launch, whose rows are at once each replica's own dequantized
  values (its residual) and the gathered codes it averages;
* across ranks (a mesh with a ``pod`` axis, one replica a rank):
  :func:`exchange_across_ranks` quantizes this rank's ``(groups, 256)``
  rows in one kernel-7 launch, the int8 codes and float32 scales cross
  by ``all_gather`` over the mesh's pod group (in pod order), and one
  kernel-8 launch dequantizes the gathered ``(n_pods · groups, 256)``
  rows.

Either way one launch of each kernel a leaf and step (a rank), and the
same bits.  The mean is the reference's ``jnp.mean``: the sum in replica
order times float32(1 / n) (held bit for bit at 2, 3 and 4 replicas).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..kernels import ops
from ..launch.mesh import axis_sizes
from .adamw import f32
from .tree import leaves, tree_map, unflatten

__all__ = ["GROUP", "quantize_tree", "dequantize_tree", "init_error_feedback",
           "compress_pod_reduce", "exchange_leaf", "exchange_across_ranks"]

#: values a scale covers
GROUP = 256


def _rows(flat: torch.Tensor) -> torch.Tensor:
    """``(…, n)`` float32 → ``(…, ⌈n/256⌉, 256)``, zero-padded."""
    pad = (-flat.shape[-1]) % GROUP
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(flat.shape[:-1] + (-1, GROUP))


def quant_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_quant_leaf``: int8 codes ``(groups, 256)`` and
    float32 scales ``(groups,)`` of ``g`` flattened and zero-padded
    (kernel 7; an all-zero group gets scale 1)."""
    rows = _rows(g.reshape(-1).float())
    q, s = ops.group_quant(rows.contiguous(), GROUP)
    return q, s[:, 0]


def dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """The reference's ``_dequant_leaf``: float32 ``q · scale`` (kernel 8)
    cut to ``shape``'s size and reshaped to it."""
    flat = ops.group_dequant(q.contiguous(), scale.reshape(-1, 1).contiguous(),
                             GROUP).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def quantize_tree(grads) -> dict:
    """``(codes, scales)`` of every leaf (:func:`quant_leaf`)."""
    return tree_map(quant_leaf, grads)


def dequantize_tree(qs, shapes) -> dict:
    """Inverse of :func:`quantize_tree`, given each leaf's shape."""
    shape_of = dict(leaves(shapes))
    return unflatten((path, dequant_leaf(q, s, tuple(shape_of[path])))
                     for path, (q, s) in leaves(qs))


def init_error_feedback(params) -> dict:
    """Zeroed float32 residuals, one a parameter leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def exchange_leaf(g: torch.Tensor, e: torch.Tensor, n_pods: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's exchange.  ``g``: the replicas' gradients ``(n_pods,
    …)``; ``e``: their float32 residuals.  Returns ``(the mean of the
    replicas' dequantized ``g + e``, broadcast to every replica in ``g``'s
    dtype; the new residuals ``g + e − dequantized``)``: kernel 7 once
    over the ``(n_pods · groups, 256)`` matrix, kernel 8 once."""
    gc = g.float() + e
    shape = gc.shape[1:]
    n = math.prod(shape)
    rows = _rows(gc.reshape(n_pods, n))
    q, s = ops.group_quant(rows.reshape(-1, GROUP).contiguous(), GROUP)
    del rows
    deq = ops.group_dequant(q, s, GROUP).reshape(n_pods, -1)[:, :n]
    del q, s
    deq = deq.reshape(gc.shape)
    new_e = gc.sub_(deq)
    return _mean(deq, n_pods).to(g.dtype).expand(g.shape), new_e


def _mean(deq: torch.Tensor, n_pods: int) -> torch.Tensor:
    """The reference's ``jnp.mean`` over the replicas ``deq[0 .. n)``:
    their sum in replica order times float32(1 / n) (XLA's reciprocal
    product; it equals a division only where 1 / n is exact, as at 2 and
    4 replicas)."""
    acc = deq[0].clone()
    for r in range(1, n_pods):
        acc.add_(deq[r])
    return acc.mul_(f32(1.0 / n_pods, deq.device))


def exchange_across_ranks(g: torch.Tensor, e: torch.Tensor, mesh,
                          pod_axis: str = "pod"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's exchange between the ranks of ``mesh``'s ``pod_axis``
    group, each holding one replica.  ``g``: this rank's gradient ``(1,
    …)``; ``e``: its float32 residual.  Returns what :func:`exchange_leaf`
    returns for this rank's replica: the mean ``(1, …)`` in ``g``'s dtype
    and the new residual.  Kernel 7 once on this rank's rows, an
    ``all_gather`` of the codes and scales, kernel 8 once on all ranks'.

    :raises RuntimeError: if the group's rank order is not the mesh's pod
        order (the mean would then add the replicas in another order).
    """
    group = mesh.get_group(pod_axis)
    n_pods = dist.get_world_size(group)
    me = mesh.get_local_rank(pod_axis)
    if dist.get_rank(group) != me:
        raise RuntimeError(f"pod coordinate {me} is rank "
                           f"{dist.get_rank(group)} of its group")
    gc = g.float() + e
    shape = gc.shape[1:]
    n = math.prod(shape)
    q, s = ops.group_quant(_rows(gc.reshape(n)).contiguous(), GROUP)
    q_all = q.new_empty((n_pods,) + tuple(q.shape))
    s_all = s.new_empty((n_pods,) + tuple(s.shape))
    dist.all_gather(list(q_all.unbind(0)), q, group=group)
    dist.all_gather(list(s_all.unbind(0)), s, group=group)
    del q, s
    deq = ops.group_dequant(q_all.reshape(-1, GROUP),
                            s_all.reshape(-1, s_all.shape[-1]), GROUP)
    del q_all, s_all
    deq = deq.reshape(n_pods, -1)[:, :n].reshape((n_pods,) + tuple(shape))
    new_e = gc.sub_(deq[me:me + 1])
    return _mean(deq, n_pods).to(g.dtype).expand(g.shape), new_e


def compress_pod_reduce(grads, ef, *, n_pods: int | None = None,
                        pod_axis: str | None = "pod", mesh=None):
    """Reduce ``grads`` across replicas with int8 transport and error
    feedback; every replica's gradient is overwritten with the same mean
    and each residual with its new value, in place, and ``(grads, ef)``
    are returned, as the reference returns ``(reduced grads, new error
    feedback)``.

    Without ``mesh``, each leaf has the leading ``(n_pods, …)`` replica
    axis (:func:`exchange_leaf` a leaf).  With ``mesh`` (a ``DeviceMesh``),
    each leaf has a leading axis of 1, this rank's replica, ``n_pods`` is
    the size of the mesh's ``pod_axis`` (if given, it must agree) and the
    codes cross between ranks (:func:`exchange_across_ranks` a leaf).
    With ``pod_axis=None`` or one replica both trees are left as they
    are."""
    if mesh is not None:
        size = axis_sizes(mesh).get(pod_axis, 1) if pod_axis else 1
        if n_pods is not None and n_pods != size:
            raise ValueError(f"n_pods={n_pods}, but the mesh's {pod_axis!r} "
                             f"axis has {size}")
        n_pods = size
    elif n_pods is None:
        raise TypeError("compress_pod_reduce needs n_pods or a mesh")
    if pod_axis is None or n_pods <= 1:
        return grads, ef
    e_of = dict(leaves(ef))
    with torch.no_grad():
        for path, g in leaves(grads):
            if mesh is None:
                mean, new_e = exchange_leaf(g, e_of[path], n_pods)
            else:
                mean, new_e = exchange_across_ranks(g, e_of[path], mesh,
                                                    pod_axis)
            g.copy_(mean)
            e_of[path].copy_(new_e)
            del mean, new_e
    return grads, ef
