"""musicgen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
input_mode=embeddings: EnCodec frame embeddings are the stubbed frontend.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, input_mode="embeddings", act="gelu",
    notes="EnCodec codebook head (vocab=2048); frame frontend stubbed",
)
