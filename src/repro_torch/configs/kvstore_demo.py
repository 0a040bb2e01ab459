"""kvstore-demo — Memcached-analogue workload for the Fig. 2 campaign.

An in-memory key->value store served as a big embedding table with a tiny
read path: the paper's second application class. Modeled as a 1-layer
"model" whose dominant memory region is the value table (the paper's
"heap"-like region for Memcached). A copy of ``repro.configs.kvstore_demo``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kvstore-demo",
        family="dense",
        n_layers=1,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=1 << 20,      # 1M keys -> value table dominates memory
        act="gelu",
        param_dtype="float32",
    )


def tiny() -> ModelConfig:
    return config().replace(name="kvstore-demo-tiny", vocab_size=4096,
                            d_model=32, n_heads=2, n_kv_heads=2, d_ff=64)
