"""Model configurations the port serves: ``get_config(arch_id)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, \
    ShapeConfig, applicable_shapes  # noqa: F401

_ARCH_MODULES = {
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "whisper-base": "repro_torch.configs.whisper_base",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG
