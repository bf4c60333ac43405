"""Architecture configs: one module per assigned architecture.

``get_config(arch_id)`` -> full-size ModelConfig (dry-run only).
``get_smoke_config(arch_id)`` -> reduced same-family config (CPU tests).
"""

from importlib import import_module
from typing import List

from ..models.config import ModelConfig

ARCH_IDS = [
    "minicpm3_4b",
    "h2o_danube3_4b",
    "mistral_large_123b",
    "olmo_1b",
    "phi3_vision_4b",
    "deepseek_moe_16b",
    "olmoe_1b_7b",
    "jamba_v01_52b",
    "falcon_mamba_7b",
    "whisper_small",
]

# canonical assignment spelling -> module name
ALIASES = {
    "minicpm3-4b": "minicpm3_4b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "mistral-large-123b": "mistral_large_123b",
    "olmo-1b": "olmo_1b",
    "phi-3-vision-4.2b": "phi3_vision_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-small": "whisper_small",
}


def _module(arch_id: str):
    name = ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    return import_module(f"{__name__}.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG


def all_arch_ids() -> List[str]:
    return list(ARCH_IDS)
