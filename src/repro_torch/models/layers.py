"""Parameter plumbing and basic layers of the LM plane.

Parameters are plain nested dicts of tensors, built from a tree of
:class:`ParamSpec` as in the reference, so the two trees have the same
keys and shapes (stacked layer parameters keep their leading layers
axis).  Each spec carries the reference's logical sharding axes, which
:mod:`repro_torch.launch.sharding` resolves to DTensor placements on a
mesh; :func:`abstract_from_specs` gives the tree's shapes and dtypes
without storage.

Activation constraints go through :func:`shard`, which reads a
thread-local (mesh, rules) pair that a launcher sets with
:func:`mesh_context`; outside one, and on a plain (not DTensor) tensor,
it is the identity.  The port's models call it at the reference's 16
sites with the same logical axes; their activations are plain tensors
(the mesh step gathers the parameters over its batch axes), so the
constraints change no result.

Tensor parallelism goes through :func:`model_parallel`, a thread-local
``model`` process group that the mesh step sets around its forward and
backward.  Each ``model`` rank holds its slice of the heads, the ffn and
the vocabulary; the residual stream is whole on every rank.  A rank's
query heads or ffn columns are :func:`unit_range`'s balanced range, and
:func:`rank_units` takes their columns from a leaf however the sharding
rules placed it (the axis need not divide the units).  The models
mark the two sides of each split: :func:`into_split` (the identity, and
the gradient summed over ``model``), :func:`out_of_split` (the partial
results summed over ``model``; the gradient as it is), and
:func:`gather_split` for a leaf a rank needs whole.  The partial sums are
added in float32 and rounded once to the activation's dtype.  Outside a
:func:`model_parallel` block, and with a ``model`` group of one rank,
every one of them is the identity, so serving runs as before.  A norm
over split heads (RWKV6's group norm, Mamba2's ``out_ln``) is
:func:`split_rmsnorm`.

Rounding follows the reference: :func:`rmsnorm` computes in float32 and
rounds once; :func:`linear` multiplies in the activation dtype;
:func:`apply_rope` rounds cos and sin to the activation dtype first.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import torch

from ..device import resolve_device

__all__ = ["ParamSpec", "ShapeDtypeStruct", "DTYPES", "init_from_specs",
           "abstract_from_specs", "param_count", "mesh_context",
           "current_mesh_rules", "shard", "activation_shardings",
           "model_parallel", "model_group", "model_rank", "unit_range",
           "rank_units", "into_split", "out_of_split", "gather_split",
           "require_exact_f32_products", "rmsnorm", "split_rmsnorm", "linear",
           "rope_freqs",
           "apply_rope"]

#: The reference's dtype names.
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ShapeDtypeStruct:
    """A tensor's shape and dtype, and on a mesh its placements (one
    ``Shard(d)`` or ``Replicate()`` a mesh dim), with no storage: the
    reference's ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    placements: tuple | None = None


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # the reference's logical axes
    dtype: str = "bfloat16"
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 1.0

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def sds(self) -> ShapeDtypeStruct:
        return ShapeDtypeStruct(tuple(self.shape), self.torch_dtype)


def _leaves(tree, prefix=()):
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, prefix + (k,))


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.torch_dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.torch_dtype, device=device)
    # the reference's rule for one layer's leaf: fan-in is a matrix's
    # leading dim.  A stacked leaf — (layers, …), or a hybrid's (groups,
    # layers, …) — is initialised one layer at a time, so its fan-in is
    # the layer's input width, and an expert leaf (experts, in, out)
    # takes one expert matrix's input width; the reference applies the
    # rule to the stacked shape, which makes it n_layers or the group
    # count (ROADMAP.md, queue 3).
    n_stack = 0
    while spec.axes[n_stack:n_stack + 1] == ("layers",):
        n_stack += 1
    shape, axes = spec.shape[n_stack:], spec.axes[n_stack:]
    if axes[:1] == ("experts",) and len(shape) > 2:
        shape = shape[1:]
    fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
    std = spec.scale / math.sqrt(fan_in)
    out = torch.empty(spec.shape, dtype=spec.torch_dtype, device=device)
    # one float32 draw per layer keeps the float32 scratch small
    for dst in (out.flatten(0, n_stack - 1).unbind(0) if n_stack
                else (out,)):
        w = torch.randn(dst.shape, generator=generator, dtype=torch.float32,
                        device=device)
        dst.copy_(w.mul_(std))
    return out


def init_from_specs(specs, generator: torch.Generator, *,
                    device: str | torch.device = "cuda"):
    """Materialize a parameter tree from a spec tree on ``device``.

    Normal leaves are ``N(0, 1) · scale / √fan_in`` drawn from
    ``generator`` (a generator of ``device``'s type) in the spec tree's
    key order, where fan-in is a layer's input width; norms are ones and
    biases zeros.  The draws differ from the reference's ``jax.random``
    ones (tests carry the reference's parameters across with
    :func:`repro_torch.convert.params_from_reference`).
    """
    device = resolve_device(device)
    return _map_specs(lambda s: _init_leaf(s, generator, device), specs)


def _map_specs(fn, specs) -> dict:
    """The nested dict of ``fn(spec)``, built in the spec tree's order."""
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(spec)
    return out


def abstract_from_specs(specs) -> dict:
    """A tree of :class:`ShapeDtypeStruct`: the dry-run's parameters,
    which allocate nothing."""
    return _map_specs(ParamSpec.sds, specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(specs))


# ---------------------------------------------------------------------------
# the (mesh, rules) context of activation sharding constraints
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def mesh_context(mesh, rules):
    """Within the block (on this thread), :func:`shard` constrains
    activations by ``rules`` on ``mesh``; contexts nest, and the outer one
    returns on exit."""
    prev = getattr(_CTX, "value", None)
    _CTX.value = (mesh, rules)
    try:
        yield
    finally:
        _CTX.value = prev


def current_mesh_rules():
    """The innermost ``(mesh, rules)`` of this thread, or ``None``."""
    return getattr(_CTX, "value", None)


def shard(x, *axes):
    """Constrain an activation's sharding by logical axis names: a DTensor
    is redistributed to the placements its axes resolve to (dims with no
    rule or an indivisible size are unconstrained and keep their current
    sharding).  The identity outside a :func:`mesh_context` and on a plain
    tensor."""
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import placements

    ctx = current_mesh_rules()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = rules.partition_spec(axes, shape=tuple(x.shape), mesh=mesh,
                                unconstrained_fallback=True)
    return x.redistribute(mesh, placements(spec, mesh, current=x.placements))


def activation_shardings(axes_tree):
    """Placements, one tuple a mesh dim, of each logical-axis tuple of
    ``axes_tree`` (a tuple, or a nested dict of tuples) in the current
    :func:`mesh_context`, without divisibility checks.

    :raises RuntimeError: outside a :func:`mesh_context`.
    """
    from ..launch.sharding import placements

    ctx = current_mesh_rules()
    if ctx is None:
        raise RuntimeError("activation_shardings needs a mesh_context")
    mesh, rules = ctx

    def one(axes):
        return placements(rules.partition_spec(axes, mesh=mesh), mesh)
    if isinstance(axes_tree, tuple):
        return one(axes_tree)
    return {k: activation_shardings(v) if isinstance(v, dict) else one(v)
            for k, v in axes_tree.items()}


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's ``model`` group
# ---------------------------------------------------------------------------

_TP = threading.local()


@contextlib.contextmanager
def model_parallel(group):
    """Within the block (on this thread), the split helpers below act over
    ``group``, the mesh's ``model`` process group (``None``, or a group of
    one rank: the identity); contexts nest."""
    import torch.distributed as dist

    prev = getattr(_TP, "group", None)
    _TP.group = (group if group is not None
                 and dist.get_world_size(group) > 1 else None)
    try:
        yield
    finally:
        _TP.group = prev


def model_group():
    """This thread's :func:`model_parallel` group, or ``None`` outside one
    (or with one rank)."""
    return getattr(_TP, "group", None)


def model_rank() -> tuple[int, int] | None:
    """``(rank, size)`` of this thread's :func:`model_parallel` group, or
    ``None`` outside one (or with one rank)."""
    import torch.distributed as dist

    g = model_group()
    if g is None:
        return None
    return dist.get_rank(g), dist.get_world_size(g)


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``: a float32 copy all-reduced, rounded
    once to ``x``'s dtype (every rank gets the same bits)."""
    import torch.distributed as dist

    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _IntoSplit(torch.autograd.Function):
    """The identity; the gradient, partial on each rank, summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _OutOfSplit(torch.autograd.Function):
    """The ranks' partial results summed; the gradient, whole on every
    rank, as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSplit(torch.autograd.Function):
    """A leaf split on ``dim`` gathered whole in rank order; the gradient
    of the whole, partial on each rank, summed and cut back to the rank's
    slice (one reduce-scatter, in float32)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist

        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((n * y.shape[0],) + tuple(y.shape[1:]))
        dist.all_gather_into_tensor(out, y, group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n = dist.get_world_size(ctx.group)
        y = g.to(torch.float32).movedim(ctx.dim, 0).contiguous()
        out = y.new_empty((y.shape[0] // n,) + tuple(y.shape[1:]))
        dist.reduce_scatter_tensor(out, y, group=ctx.group)
        return out.movedim(0, ctx.dim).to(g.dtype).contiguous(), None, None


def into_split(x: torch.Tensor) -> torch.Tensor:
    """Mark a tensor, whole on every ``model`` rank, entering a split: the
    identity forward, the gradient summed over ``model`` in the
    backward."""
    g = model_group()
    return x if g is None else _IntoSplit.apply(x, g)


def out_of_split(x: torch.Tensor) -> torch.Tensor:
    """Leave a split: each ``model`` rank's partial result summed (float32,
    rounded once); the identity backward."""
    g = model_group()
    return x if g is None else _OutOfSplit.apply(x, g)


def gather_split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A leaf split on ``dim`` over ``model``, gathered whole for a rank
    that needs all of it; its gradient summed and cut back to the rank's
    slice."""
    g = model_group()
    return x if g is None else _GatherSplit.apply(x, dim, g)


def unit_range(units: int) -> tuple[int, int]:
    """This ``model`` rank's range ``[lo, hi)`` of ``units`` (query heads,
    ffn columns) over its :func:`model_parallel` group of ``n`` ranks:
    ``[⌊r·units/n⌋, ⌊(r+1)·units/n⌋)``, which is the rank's even slice
    where ``n`` divides ``units``; ``[0, units)`` outside a group."""
    tp = model_rank()
    if tp is None:
        return 0, units
    r, n = tp
    return r * units // n, (r + 1) * units // n


def rank_units(leaf: torch.Tensor, dim: int, units: int,
               width: int = 1) -> torch.Tensor:
    """The part of ``leaf`` along ``dim`` (``units`` units of ``width``
    columns or rows, whole) that holds this ``model`` rank's units
    (:func:`unit_range`), from the placement the sharding rules gave it:

    * the rank's own even slice, where the axis divides ``units``: the
      leaf as it is;
    * split on ``dim`` inside a unit (the axis divides ``units · width``
      but not ``units``): gathered whole (:func:`gather_split`) and cut;
      only the rank's units get a gradient, so the gather's float32
      reduce-scatter adds zeros to each column's one owner, exactly;
    * whole on ``model`` (the rules' divisibility fallback): cut; its
      gradient is partial on each rank, and the mesh step sums it over
      ``model``.

    The identity outside a :func:`model_parallel` group."""
    tp = model_rank()
    if tp is None or units % tp[1] == 0:
        return leaf
    if leaf.shape[dim] != units * width:
        leaf = gather_split(leaf, dim)
    lo, hi = unit_range(units)
    return leaf.narrow(dim, lo * width, (hi - lo) * width)


def require_exact_f32_products(x: torch.Tensor) -> None:
    """Raise unless float32 products on ``x``'s device run in full float32
    (on the card, PyTorch may run them as TF32)."""
    if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 products would run as TF32 on the card: call "
            "torch.set_float32_matmul_precision('highest') first")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def split_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, width: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """:func:`rmsnorm` over a vector ``width`` wide of which ``x`` holds
    this ``model`` rank's slice (its heads) and ``gamma`` the same slice
    of the gain: the float32 sum of squares is summed over ``model`` in
    both directions (``into_split(out_of_split(·))``: the ranks' partial
    sums added, and the gradient of the whole sum, partial on each rank,
    added too) and divided by the whole ``width``.  Outside a
    :func:`model_parallel` group it is :func:`rmsnorm`, bit for bit."""
    if model_group() is None:
        return rmsnorm(x, gamma, eps)
    dt = x.dtype
    x = x.float()
    ss = into_split(out_of_split(torch.sum(x * x, dim=-1, keepdim=True)))
    x = x * torch.rsqrt(ss / width + eps)
    return (x * gamma.float()).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
           ) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 10_000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, head_dim/2) float32 cos/sin tables for the given absolute
    positions."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (…, seq, heads, head_dim); cos/sin: (…, seq, head_dim/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
