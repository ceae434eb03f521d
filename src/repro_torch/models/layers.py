"""Parameter plumbing and basic layers of the LM plane.

Parameters are plain nested dicts of tensors, built from a tree of
:class:`ParamSpec` as in the reference, so the two trees have the same
keys and shapes (stacked layer parameters keep their leading layers
axis).  The reference's logical sharding axes are kept on the specs for
the reader; the port runs on one device and shards nothing.

Rounding follows the reference: :func:`rmsnorm` computes in float32 and
rounds once; :func:`linear` multiplies in the activation dtype;
:func:`apply_rope` rounds cos and sin to the activation dtype first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device import resolve_device

__all__ = ["ParamSpec", "DTYPES", "init_from_specs", "param_count",
           "rmsnorm", "linear", "rope_freqs", "apply_rope"]

#: The reference's dtype names.
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    # leading dim.  A stacked (layers, …) leaf is initialised one layer
    # at a time, so its fan-in is the layer's input width; the reference
    # applies the rule to the stacked shape, which makes it n_layers
    # (ROADMAP.md, queue 3).
    stacked = spec.axes[:1] == ("layers",)
    shape = spec.shape[1:] if stacked else spec.shape
    fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
    std = spec.scale / math.sqrt(fan_in)
    out = torch.empty(spec.shape, dtype=spec.torch_dtype, device=device)
    # one float32 draw per layer keeps the float32 scratch small
    for dst in (out.unbind(0) if stacked else (out,)):
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
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_leaf(spec, generator, device)
    return out


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(specs))


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
