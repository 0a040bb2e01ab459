"""lm-100m — the end-to-end example model (~100M params, llama-style).

The model that the training launcher, the train_hrm example and the
scrub-overhead benchmark train. A copy of ``repro.configs.lm_100m``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    # 12L * (4*512^2 + 3*512*2048) + 2*32768*512 ~= 84M params
    return ModelConfig(
        name="lm-100m",
        family="dense",
        n_layers=12,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=2048,
        vocab_size=32768,
        act="swiglu",
        rope_theta=10000.0,
        param_dtype="float32",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="lm-100m-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
    )
