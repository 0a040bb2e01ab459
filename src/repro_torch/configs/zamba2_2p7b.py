"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000.

Mamba2 mixer layers with a shared full-attention + MLP block applied every
6 layers (weights shared across applications, Zamba-style).
ssm_state=64. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        act="swiglu",
        rope_theta=10000.0,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
        attn_every=6,
        param_dtype="bfloat16",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="zamba2-2.7b-tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        attn_every=2, param_dtype="float32",
    )
