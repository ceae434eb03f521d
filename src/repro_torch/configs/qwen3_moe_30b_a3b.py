"""qwen3-moe-30b-a3b — 128-expert top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B; hf]
48L d_model=2048 32H (GQA kv=4) d_ff=768/expert vocab=151936, MoE 128e top-8.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab_size=151936, n_experts=128, experts_per_token=8,
    notes="128 experts: strongest SHE analogue (many small blocks)",
)
