"""rwkv6-7b "Finch" — attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=14336,
    vocab_size=65536, rwkv_head=64,
    notes="attention-free: long_500k runs on O(1) matrix state; TAC's "
          "spatial partitioning inapplicable to the dense 2D state",
)
