"""Deterministic host-sharded synthetic data pipelines (:mod:`.pipeline`),
yielding tensors on a device."""
from .pipeline import amr_token_batches, embedding_batches, lm_batches

__all__ = ["lm_batches", "embedding_batches", "amr_token_batches"]
