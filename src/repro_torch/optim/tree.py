"""Parameter trees as nested dicts of tensors, walked in the reference's
leaf order: ``jax.tree.leaves`` visits a dict's keys sorted, so every
reduction over leaves (the global gradient norm) adds them in that
order.  On a mesh a leaf may be a DTensor: :func:`local` is the shard a
rank holds, :func:`sharded` says whether other ranks hold other parts,
and :func:`whole` gathers a leaf whole (the train step's gather and the
checkpoint save's)."""
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


def sharded(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor split on a mesh dim wider than 1."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and n > 1
        for p, n in zip(t.placements, t.device_mesh.shape))


def shard_dim(t: torch.Tensor) -> int | None:
    """The tensor dim that leaf ``t`` is split on over its mesh's wide
    axes, or ``None`` for a replicated leaf or a plain tensor.

    :raises ValueError: for a leaf split on two dims, or split on some
        wide mesh axes and replicated on others.
    """
    from torch.distributed.tensor import Shard

    if not sharded(t):
        return None
    dims = {q.dim if isinstance(q, Shard) else None
            for q, n in zip(t.placements, t.device_mesh.shape) if n > 1}
    if len(dims) > 1:
        raise ValueError(f"placements {t.placements}: a leaf must be split "
                         f"on one dim over every wide mesh axis, or on none")
    return dims.pop()


def whole(t: torch.Tensor, group) -> torch.Tensor:
    """Leaf ``t`` whole, as a plain tensor on its device: a sharded leaf
    all-gathered over ``group`` (one ``all_gather_into_tensor``: its
    shards in rank order, which must be the mesh's, along its split
    dim), a replicated one its local tensor, not gathered (no
    collective)."""
    import torch.distributed as dist

    d, x = shard_dim(t), local(t)
    if d is None:
        return x
    x = x.movedim(d, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, d).contiguous()
