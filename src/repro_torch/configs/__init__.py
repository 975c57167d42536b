"""Architecture registry: ``--arch <id>`` -> (CONFIG, SMOKE_CONFIG)."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from .base import ModelConfig, ShapeSpec, SHAPES, applicable_shapes

_MODULES: Dict[str, str] = {
    "smollm-360m": "smollm_360m",
    "internlm2-20b": "internlm2_20b",
    "granite-34b": "granite_34b",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "internvl2-76b": "internvl2_76b",
    "jamba-1.5-large-398b": "jamba_1p5_large",
    "whisper-medium": "whisper_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "applicable_shapes",
           "ARCH_IDS", "get_config"]
