"""starcoder2-3b — GQA kv=2, RoPE, gelu MLP, biases. [arXiv:2402.19173; hf]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab_size=49152, act="gelu", qkv_bias=True,
    notes="kv=2 < model-axis width: KV heads replicate, batch/seq shard",
)
