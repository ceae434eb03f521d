"""Logical-axis sharding rules (MaxText style), with divisibility
fallback, resolved to DTensor placements.

Parameters and activations carry *logical* axis names (``"embed"``,
``"heads"``, ``"vocab"``, …).  :class:`ShardingRules` maps them to mesh
axes, as the reference's rules do: each tensor dim becomes ``None``
(replicated), a mesh axis, a tuple of mesh axes (major to minor), or
``UNCONSTRAINED``, in a :class:`PartitionSpec`.  A dim whose size the
mesh axes do not divide falls back to replicated (parameters) or
unconstrained (activations), so starcoder2's 2 KV heads replicate on a
16-wide model axis instead of failing.

Default rules (:func:`rules_for`):

* batch → (pod, data), activations;
* embed → the batch axes, parameters (ZeRO-3), with ``RunConfig.fsdp``;
* heads, kv_heads, mlp, experts, vocab → model (tensor / expert
  parallelism);
* seq → model with ``RunConfig.seq_shard`` (sequence parallelism);
* layers → replicated (the stacked leading axis).

:func:`placements` is the one place where a spec becomes DTensor
placements: one ``Shard(d)`` or ``Replicate()`` a mesh dim.  Two mesh axes
on one tensor dim become ``Shard(d)`` on both, which DTensor splits in
mesh-dim order: the major-to-minor order of the reference's tuple, so
the tuple must list them in the mesh's order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import torch
from torch.distributed.tensor import Replicate, Shard

from ..models.layers import abstract_from_specs
from ..optim.tree import tree_map
from .mesh import axis_sizes

__all__ = ["PartitionSpec", "UNCONSTRAINED", "ShardingRules", "rules_for",
           "placements", "local_slice", "param_shardings", "opt_shardings",
           "abstract_params"]


class _Unconstrained:
    """A dim whose sharding a constraint leaves as it is."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry a tensor dim (``None``,
    a mesh axis name, a tuple of names, or ``UNCONSTRAINED``); trailing
    dims past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    table: dict = field(default_factory=dict)

    def mesh_axes(self, logical: str | None):
        if logical is None:
            return None
        return self.table.get(logical)

    def partition_spec(self, axes, shape=None, mesh=None, *,
                       unconstrained_fallback: bool = False) -> PartitionSpec:
        """Resolve logical axes to a :class:`PartitionSpec`, with the
        divisibility fallback: a dim the mesh axes do not divide (shape
        and mesh given), or with no rule, is replicated (``None``) — or,
        with ``unconstrained_fallback`` (activations), ``UNCONSTRAINED``,
        so that a constraint keeps its current sharding instead of
        gathering it.  A mesh axis shards at most one dim; axes the mesh
        lacks are dropped; trailing ``None`` entries are dropped."""
        fb = UNCONSTRAINED if unconstrained_fallback else None
        sizes = None if mesh is None else axis_sizes(mesh)
        used = set()
        out = []
        for i, lg in enumerate(axes):
            ma = self.mesh_axes(lg)
            if ma is None:
                out.append(fb)
                continue
            ma_t = (ma,) if isinstance(ma, str) else tuple(ma)
            ma_t = tuple(a for a in ma_t if sizes is None or a in sizes)
            ma_t = tuple(a for a in ma_t if a not in used)
            if not ma_t:
                out.append(fb)
                continue
            if shape is not None and sizes is not None:
                if shape[i] % math.prod(sizes[a] for a in ma_t):
                    out.append(fb)
                    continue
            used.update(ma_t)
            out.append(ma_t[0] if len(ma_t) == 1 else ma_t)
        if not unconstrained_fallback:
            while out and out[-1] is None:
                out.pop()
        return PartitionSpec(*out)


def rules_for(mesh, run) -> ShardingRules:
    """The rule table for a mesh (a ``DeviceMesh`` or an
    :class:`~.mesh.AbstractMesh`) and a ``RunConfig``."""
    batch_axes = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
    table = {
        "batch": batch_axes,
        "embed": batch_axes if run.fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "seq": "model" if run.seq_shard else None,
        "layers": None,
    }
    return ShardingRules(table={k: v for k, v in table.items()
                                if v is not None})


def placements(spec, mesh, current=None) -> tuple:
    """DTensor placements of a spec on ``mesh``: ``Shard(d)`` on each mesh
    dim that ``spec[d]`` names, ``Replicate()`` on the others.  Given the
    ``current`` placements of a tensor, a mesh dim the spec leaves free
    keeps a current ``Shard(d)`` whose tensor dim the spec marks
    ``UNCONSTRAINED``.

    :raises ValueError: for an axis the mesh lacks, or a tuple of axes
        out of the mesh's order.
    """
    names = list(axis_sizes(mesh))
    out = [None] * len(names)
    for d, entry in enumerate(spec):
        if entry is None or entry is UNCONSTRAINED:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} not in {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} must follow the mesh's order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    for i, p in enumerate(out):
        if p is None:
            cur = None if current is None else current[i]
            keep = (isinstance(cur, Shard) and cur.dim < len(spec)
                    and spec[cur.dim] is UNCONSTRAINED)
            out[i] = cur if keep else Replicate()
    return tuple(out)


def local_slice(t: torch.Tensor, mesh, pls, coordinate) -> torch.Tensor:
    """The view of ``t`` that the mesh place at ``coordinate`` (one index
    a mesh dim) holds under placements ``pls``: each ``Shard(d)`` splits
    dim ``d`` in mesh-dim order into chunks of ``ceil(n / size)``, as
    DTensor splits it."""
    sizes = list(axis_sizes(mesh).values())
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n = t.shape[p.dim]
            chunk = -(-n // sizes[i])
            start = min(coordinate[i] * chunk, n)
            t = t.narrow(p.dim, start, min(chunk, n - start))
    return t


def param_shardings(specs, mesh, rules: ShardingRules) -> dict:
    """A tree of placements, one tuple a ``ParamSpec`` leaf of ``specs``."""
    return tree_map(lambda s: placements(
        rules.partition_spec(s.axes, shape=s.shape, mesh=mesh), mesh), specs)


def opt_shardings(opt_cfg, specs, psh, mesh, rules: ShardingRules) -> dict:
    """Placements of the optimizer state's tree (the reference's
    ``_opt_shardings``), without the host step counter: AdamW's ``mu`` and
    ``nu`` take their parameter's placements ``psh``; Adafactor's factored
    second moments keep the parameter's surviving logical axes, and its
    first moment (``beta1 > 0``) the parameter's placements."""
    from ..optim.adafactor import AdafactorConfig, _factored

    if not isinstance(opt_cfg, AdafactorConfig):
        return {"mu": psh, "nu": psh}

    def pl(axes, shape):
        return placements(rules.partition_spec(axes, shape=shape, mesh=mesh),
                          mesh)

    def v_pl(s):
        if _factored(s.shape):
            return {"vr": pl(s.axes[:-1], s.shape[:-1]),
                    "vc": pl(s.axes[:-2] + s.axes[-1:],
                             s.shape[:-2] + s.shape[-1:])}
        return {"v": pl(s.axes, s.shape)}

    out = {"v": tree_map(v_pl, specs)}
    if opt_cfg.beta1 > 0:
        out["mu"] = psh
    return out


def abstract_params(specs, mesh=None, rules: ShardingRules | None = None
                    ) -> dict:
    """A tree of :class:`~repro_torch.models.layers.ShapeDtypeStruct`
    (no storage), with each leaf's placements on ``mesh`` if given."""
    if mesh is None:
        return abstract_from_specs(specs)
    return tree_map(lambda s, p: replace(s.sds(), placements=p), specs,
                    param_shardings(specs, mesh, rules))

