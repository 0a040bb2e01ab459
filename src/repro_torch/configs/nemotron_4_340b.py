"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

GQA, squared-ReLU MLP (two matrices, no gate). [arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        act="relu2",
        rope_theta=10000.0,
        param_dtype="bfloat16",
        moment_dtype="bfloat16",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="nemotron-4-340b-tiny", n_layers=2, d_model=96, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=256,
        param_dtype="float32", moment_dtype="float32",
    )
