"""Parameter trees as nested dicts of tensors, walked in the reference's
leaf order: ``jax.tree.leaves`` visits a dict's keys sorted, so every
reduction over leaves (the global gradient norm) adds them in that
order."""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["leaves", "tree_map", "unflatten", "replica"]


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
