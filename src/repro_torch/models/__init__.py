"""Model stack in PyTorch: the config schema (copied), the layers, the
Mamba and MoE blocks, the decoder-only LM and the ``Model`` API."""

from .api import Model, cell_is_runnable, get_model, input_specs
from .config import (AttentionConfig, EncDecConfig, ModelConfig, MoEConfig,
                     SHAPES, ShapeConfig, SSMConfig)

__all__ = [
    "ModelConfig", "AttentionConfig", "MoEConfig", "SSMConfig",
    "EncDecConfig", "SHAPES", "ShapeConfig", "Model", "get_model",
    "input_specs", "cell_is_runnable",
]
