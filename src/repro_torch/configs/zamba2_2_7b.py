"""zamba2-2.7b — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]
54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Shared attention (one param set) applied every 6 Mamba2 layers.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, ssm_state=64, ssm_expand=2, ssm_head=64,
    shared_attn_every=6,
    notes="long_500k runs: Mamba2 O(1) state + shared-attn KV; "
          "54 layers = 9 groups of 6",
)
