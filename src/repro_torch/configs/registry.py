"""Architecture registry: ``get_config(id)`` → :class:`ModelConfig`.

The port runs every architecture of the reference's registry: the
decoders that take token ids — dense, mixture-of-experts, RWKV6 (ssm)
and the Mamba2 / shared-attention hybrid — and the vlm/audio decoders
fed by frontend embeddings (``input_mode="embeddings"``: internvl2-76b,
musicgen-medium; the frontends themselves are stubs in the reference,
and the caller brings the embeddings).
"""
from __future__ import annotations

from dataclasses import replace
from importlib import import_module

from .base import ModelConfig

__all__ = ["ARCH_IDS", "PORTED_IDS", "get_config", "smoke_config"]

#: Every architecture of the reference's registry, in its order.
ARCH_IDS = [
    "granite_moe_1b_a400m",
    "qwen3_moe_30b_a3b",
    "deepseek_7b",
    "llama3_405b",
    "starcoder2_3b",
    "qwen1_5_32b",
    "rwkv6_7b",
    "internvl2_76b",
    "musicgen_medium",
    "zamba2_2_7b",
]

#: The architectures the port runs: all of them.
PORTED_IDS = list(ARCH_IDS)


def get_config(arch: str) -> ModelConfig:
    """The full-size config of ``arch`` (``-`` and ``.`` read as ``_``).

    :raises KeyError: for an id the reference does not know.
    """
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return import_module(f"{__package__}.{arch}").CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: 2 layer-groups, narrow width, tiny
    vocab — the reference's ``smoke_config`` rule."""
    cfg = get_config(arch)
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    n_kv = min(cfg.n_kv_heads, n_heads) if n_heads else 0
    if n_heads and cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads  # preserve MHA-ness
    layers = 2 * max(cfg.shared_attn_every, 1)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=layers,
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=32 if n_heads else 0,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head=32,
        rwkv_head=32,
        shared_attn_every=min(cfg.shared_attn_every, 2),
    )
