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
(the data-parallel step gathers the parameters whole), so the
constraints change no result until a ``model`` axis wider than 1 makes
them DTensors.

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
           "require_exact_f32_products", "rmsnorm", "linear", "rope_freqs",
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
