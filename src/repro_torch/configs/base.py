"""Model and run configuration schema of the LM plane.

:class:`ModelConfig` copies the reference's frozen dataclass field for
field, so that a config reads the same in either package.
:class:`RunConfig` keeps the reference's knobs that the port's serving
path, its train steps and the mesh's sharding rules (``fsdp``,
``seq_shard``, read by :func:`repro_torch.launch.sharding.rules_for`)
read, with the reference's defaults; ``grad_compress`` comes with the
caller that reads it (the cells), and ``ShapeConfig`` (the benchmark
cells' input shapes) with the cells.  The port always loops over the
stacked layers, and nothing in the reference reads ``scan_layers``, so
the port has no ``scan_layers``.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ModelConfig", "RunConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 → d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- SSM / RWKV ---
    ssm_state: int = 0          # Mamba2 d_state (hybrid family)
    ssm_expand: int = 2
    ssm_head: int = 64
    rwkv_head: int = 64
    # --- hybrid (Zamba2): shared attention block every k core layers ---
    shared_attn_every: int = 0
    # --- modality frontend (vlm/audio): stubbed embeddings in ---
    input_mode: str = "tokens"  # tokens | embeddings
    act: str = "swiglu"         # swiglu | gelu
    norm_eps: float = 1e-5
    # numerics
    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if serve-time state is O(1) in context (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")


@dataclass(frozen=True)
class RunConfig:
    """Execution knobs of the serving path, the train steps and the
    sharding rules."""

    microbatches: int = 1       # gradient-accumulation steps per train step
    remat: str = "layer"        # none | layer | zero: not none checkpoints
                                # each layer (activation checkpointing)
    fsdp: bool = False          # shard params over the batch axes (embed)
    seq_shard: bool = False     # shard the sequence dim on the model axis
    kv_quant: bool = False      # int8 KV cache with per-(token, head) scales
    optimizer: str = "adamw"    # adamw | adafactor (factored 2nd moment)
    optimizer_dtype: str = "float32"   # moments dtype
    grad_accum_dtype: str = "float32"  # microbatch gradient accumulator
    logits_fp32: bool = True
