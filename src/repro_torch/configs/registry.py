"""Architecture registry of the port: ``get_config(arch)`` returns the full
config, ``get_tiny(arch)`` the reduced test config of the same family.
Only the architectures whose families the port runs are listed."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

# arch id -> module name under repro_torch.configs
_MODULES: Dict[str, str] = {
    "llama3-8b": "llama3_8b",
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
