"""Model configuration schema (the LM stack itself is not ported yet)."""

from .config import (AttentionConfig, EncDecConfig, ModelConfig, MoEConfig,
                     SHAPES, ShapeConfig, SSMConfig)

__all__ = [
    "ModelConfig", "AttentionConfig", "MoEConfig", "SSMConfig",
    "EncDecConfig", "SHAPES", "ShapeConfig",
]
