"""Atomic/async checkpointing, optionally TAC-compressed (lossy), in the
reference's file format (:mod:`.manager`)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
