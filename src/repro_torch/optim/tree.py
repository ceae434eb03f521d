"""Parameter trees as nested dicts of tensors, walked in the reference's
leaf order: ``jax.tree.leaves`` visits a dict's keys sorted, so every
reduction over leaves (the global gradient norm) adds them in that
order.  On a mesh a leaf may be a DTensor: :func:`local` is the shard a
rank holds, :func:`sharded` says whether other ranks hold other parts,
and :func:`whole` gathers a leaf whole (the train step's gather and the
checkpoint save's).  Each of them may be asked about some of the mesh's
axes only: a leaf split on ``embed`` over the batch axes and on
``heads`` over ``model`` is gathered over the batch axes alone, and keeps
its ``model`` slice."""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["leaves", "tree_map", "unflatten", "replica", "local", "sharded",
           "shard_dim", "whole"]


def leaves(tree) -> list[tuple[tuple[str, ...], torch.Tensor]]:
    """``(path, leaf)`` pairs of a nested dict, keys sorted at each level
    (the reference's ``jax.tree.leaves`` order)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out.append((path, node))
    walk(tree, ())
    return out


def unflatten(pairs) -> dict:
    """The nested dict of ``(path, value)`` pairs."""
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def tree_map(fn: Callable, tree, *rest) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same keys), in leaf order."""
    others = [dict(leaves(t)) for t in rest]
    return unflatten((p, fn(v, *(o[p] for o in others)))
                     for p, v in leaves(tree))


def replica(tree, r: int) -> dict:
    """Views of replica ``r`` of a tree whose leaves carry a leading
    replica axis: writing into a view writes into the stack."""
    return tree_map(lambda a: a[r], tree)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (writing into it writes into the DTensor);
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _wide(t, axes) -> list:
    """``(placement, size)`` of each mesh dim of DTensor ``t`` wider than 1,
    of those named in ``axes`` (all of them for ``None``)."""
    names = t.device_mesh.mesh_dim_names or (None,) * t.device_mesh.ndim
    return [(q, n) for q, n, a in zip(t.placements, t.device_mesh.shape,
                                      names)
            if n > 1 and (axes is None or a in axes)]


def sharded(t: torch.Tensor, axes=None) -> bool:
    """Whether ``t`` is a DTensor split on a mesh dim wider than 1 (of the
    mesh axes named in ``axes``, default all)."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) for p, _ in _wide(t, axes))


def shard_dim(t: torch.Tensor, axes=None) -> int | None:
    """The tensor dim that leaf ``t`` is split on over its mesh's wide
    axes (of those named in ``axes``, default all), or ``None`` for a leaf
    replicated over them or a plain tensor.

    :raises ValueError: for a leaf split on two dims over those axes, or
        split on some of them and replicated on others.
    """
    from torch.distributed.tensor import Shard

    if not sharded(t, axes):
        return None
    dims = {q.dim if isinstance(q, Shard) else None for q, _ in _wide(t, axes)}
    if len(dims) > 1:
        raise ValueError(f"placements {t.placements}: a leaf must be split "
                         f"on one dim over every wide mesh axis of {axes}, "
                         f"or on none")
    return dims.pop()


def whole(t: torch.Tensor, group, axes=None) -> torch.Tensor:
    """Leaf ``t`` whole over the mesh axes ``axes`` (default all), as a
    plain tensor on its device: a leaf split over them all-gathered over
    ``group``, those axes' process group (one ``all_gather_into_tensor``:
    its shards in rank order, which must be the mesh's, along its split
    dim), a leaf replicated over them its local tensor, not gathered (no
    collective).  A split over other axes is kept: the result is this
    rank's slice there."""
    import torch.distributed as dist

    d, x = shard_dim(t, axes), local(t)
    if d is None:
        return x
    x = x.movedim(d, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, d).contiguous()
