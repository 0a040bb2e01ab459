"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

GQA with QKV bias. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        act="swiglu",
        qkv_bias=True,
        rope_theta=1000000.0,
        param_dtype="bfloat16",
        moment_dtype="bfloat16",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="qwen2-72b-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=256, param_dtype="float32", moment_dtype="float32",
    )
