"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155.

MoE 40 experts top-8 (per assignment; the cited HF card family also ships a
32e variant — we follow the assignment's explicit numbers). d_ff is the
per-expert hidden width. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        act="swiglu",
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
        param_dtype="bfloat16",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="granite-moe-3b-a800m-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64),
        param_dtype="float32",
    )
