"""deepseek-7b — llama-arch dense. [arXiv:2401.02954; hf]

30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008 vocab=102400.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=102400,
)
