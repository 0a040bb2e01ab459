"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

GQA with 128k vocab. [arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        act="swiglu",
        rope_theta=500000.0,
        param_dtype="bfloat16",
        moment_dtype="bfloat16",   # required to fit train_4k in 16 GB/chip
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="llama3-405b-tiny", n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=192, vocab_size=256, param_dtype="float32", moment_dtype="float32",
    )
