"""internvl2-76b — InternViT frontend (stub) + InternLM2 backbone.

[arXiv:2404.16821; unverified]
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
input_mode=embeddings: input_specs() provides precomputed patch embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, input_mode="embeddings",
    notes="backbone only; vision frontend stubbed per the brief",
)
