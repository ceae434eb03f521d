"""Model and run configs of the LM plane (copies of the reference's
dataclasses) and the registry of the architectures the port runs."""
from .base import ModelConfig, RunConfig, ShapeConfig  # noqa: F401
from .registry import ARCH_IDS, PORTED_IDS, get_config, smoke_config  # noqa: F401
