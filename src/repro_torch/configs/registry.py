"""Architecture registry: --arch <id> resolution for launchers/tests."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-26b": "internvl2_26b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-780m": "mamba2_780m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "deepseek-67b": "deepseek_67b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "olmo-1b": "olmo_1b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
