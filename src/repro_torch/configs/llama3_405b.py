"""llama3-405b — dense GQA, 128k vocab. [arXiv:2407.21783; unverified]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab_size=128256, rope_theta=500_000.0,
    notes="largest memory cell: FSDP + remat + microbatching required",
)
