"""Error-bounded int8 gradient exchange between data-parallel replicas.

The reference's quantization stage reused for gradients: each leaf is
flattened, zero-padded to a whole number of groups of 256 values and
quantized per group to int8 codes with one float32 scale (kernel 7,
``ops.group_quant`` at group 256); the codes cross between replicas
(4× less traffic than float32), every replica dequantizes them (kernel
8, ``ops.group_dequant``) and takes their mean, and the quantization
residual is carried into the next step's gradient as error feedback
(the EF-SGD / EF21 family), so compression does not bias convergence.

On one card the replicas ("pods") are the leading axis of every leaf
and the all-gather of the codes is the identity, but the arithmetic is
the reference's (its eager ``_quant_leaf`` / ``_dequant_leaf``: the
scale divides, it is not a reciprocal product).  :func:`exchange_leaf`
quantizes all the replicas' values of a leaf in one kernel-7 launch over
an ``(n_pods · groups, 256)`` matrix and dequantizes them in one kernel-8
launch, whose rows are at once each replica's own dequantized values
(its residual) and the gathered codes it averages: one launch of each
kernel a leaf and step.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from .adamw import f32
from .tree import leaves, tree_map, unflatten

__all__ = ["GROUP", "quantize_tree", "dequantize_tree", "init_error_feedback",
           "compress_pod_reduce", "exchange_leaf"]

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
    mean = deq.sum(0) / f32(n_pods, deq.device)
    return mean.to(g.dtype).expand(g.shape), new_e


def compress_pod_reduce(grads, ef, *, n_pods: int, pod_axis: str | None = "pod"):
    """Reduce ``grads`` across replicas with int8 transport and error
    feedback (:func:`exchange_leaf` a leaf).  Each leaf has the leading
    ``(n_pods, …)`` replica axis; every replica's gradient is overwritten
    with the same mean and each residual with its new value, in place,
    and ``(grads, ef)`` are returned, as the reference returns ``(reduced
    grads, new error feedback)``.  With ``pod_axis=None`` or ``n_pods <=
    1`` both are left as they are."""
    if pod_axis is None or n_pods <= 1:
        return grads, ef
    e_of = dict(leaves(ef))
    with torch.no_grad():
        for path, g in leaves(grads):
            mean, new_e = exchange_leaf(g, e_of[path], n_pods)
            g.copy_(mean)
            e_of[path].copy_(new_e)
            del mean, new_e
    return grads, ef
