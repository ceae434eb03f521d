"""The dense MLP block (SwiGLU or GELU) of the LM plane.

The reference's module also holds the mixture-of-experts layer
(``moe_specs``/``moe_apply``), which the port does not run yet (ROADMAP.md,
queue 1, item 9).
"""
from __future__ import annotations

import math

import torch

from .layers import ParamSpec, linear, rmsnorm

__all__ = ["mlp_specs", "mlp_apply", "silu", "gelu_tanh"]


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "ln": ParamSpec((d,), (None,), cfg.dtype, init="ones"),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), cfg.dtype),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), cfg.dtype),
    }
    if cfg.act == "swiglu":
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"), cfg.dtype)
    return specs


def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · 1/(1 + exp(−x))``, rounded to ``x``'s dtype after every
    operation as ``jax.nn.silu`` is (``torch.nn.functional.silu`` rounds
    once, which differs in bf16 in about a third of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh approximation as it computes it: every
    operation rounded to ``x``'s dtype, the constants too."""
    inner = x + _const(0.044715, x) * (x * x * x)
    cdf = _const(0.5, x) * (1 + torch.tanh(
        _const(math.sqrt(2 / math.pi), x) * inner))
    return x * cdf


def mlp_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Pre-norm MLP body (the caller adds the residual)."""
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    up = linear(xn, params["w_up"])
    if cfg.act == "swiglu":
        up = silu(linear(xn, params["w_gate"])) * up
    else:
        up = gelu_tanh(up)
    return linear(up, params["w_down"])
