"""Architecture registry of the port: ``--arch <id>`` resolution.

``get_config(arch)`` returns the full config, ``get_tiny(arch)`` the
reduced test config of the same family. The port lists every architecture
of the reference's registry, in the reference's order.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch id -> module name under repro_torch.configs
_MODULES: Dict[str, str] = {
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama3-405b": "llama3_405b",
    "nemotron-4-340b": "nemotron_4_340b",
    "llama3-8b": "llama3_8b",
    "qwen2-72b": "qwen2_72b",
    "hubert-xlarge": "hubert_xlarge",
    "xlstm-350m": "xlstm_350m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    # paper-native extras (not part of the assigned grid):
    "kvstore-demo": "kvstore_demo",       # Memcached-analogue workload
    "lm-100m": "lm_100m",                 # end-to-end trainable ~100M example
}

ASSIGNED_ARCHS: List[str] = [
    "zamba2-2.7b", "granite-moe-3b-a800m", "deepseek-moe-16b", "llama3-405b",
    "nemotron-4-340b", "llama3-8b", "qwen2-72b", "hubert-xlarge",
    "xlstm-350m", "llava-next-mistral-7b",
]


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_tiny(arch: str) -> ModelConfig:
    return _module(arch).tiny()


def list_archs() -> List[str]:
    return list(_MODULES)
