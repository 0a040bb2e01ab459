"""Architecture registry of the port: ``--arch <id>`` resolution.

``get_config(arch)`` returns the full config, ``get_tiny(arch)`` the
reduced test config of the same family. ``list_archs()`` lists every
architecture of the reference's registry, in the reference's order;
``PORT_ARCHS`` lists, apart from it, those the port alone runs.
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

# arch id -> module name: architectures the reference does not have
_PORT_MODULES: Dict[str, str] = {
    "deepseek-v2-lite": "deepseek_v2_lite",   # latent attention (MLA)
}
PORT_ARCHS: List[str] = list(_PORT_MODULES)

ASSIGNED_ARCHS: List[str] = [
    "zamba2-2.7b", "granite-moe-3b-a800m", "deepseek-moe-16b", "llama3-405b",
    "nemotron-4-340b", "llama3-8b", "qwen2-72b", "hubert-xlarge",
    "xlstm-350m", "llava-next-mistral-7b",
]


def _module(arch: str):
    name = _MODULES.get(arch) or _PORT_MODULES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + PORT_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_tiny(arch: str) -> ModelConfig:
    return _module(arch).tiny()


def list_archs() -> List[str]:
    return list(_MODULES)
