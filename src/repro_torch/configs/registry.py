"""Architecture registry of the port: ``get_config(arch)`` returns the full
config, ``get_tiny(arch)`` the reduced test config of the same family.
The port lists the architectures it runs: the dense, MoE, hybrid and
xLSTM families on tokens, and the audio and vision frontends. The 72-405 B
dense configs wait for ROADMAP.md, queue 1, item 12b."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

# arch id -> module name under repro_torch.configs
_MODULES: Dict[str, str] = {
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama3-8b": "llama3_8b",
    "hubert-xlarge": "hubert_xlarge",
    "xlstm-350m": "xlstm_350m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "kvstore-demo": "kvstore_demo",       # Memcached-analogue workload
    "lm-100m": "lm_100m",                 # end-to-end trainable ~100M example
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_tiny(arch: str) -> ModelConfig:
    return _module(arch).tiny()
