"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400.

Fine-grained MoE: 2 shared + 64 routed experts, top-6; d_ff is the
per-expert hidden width. [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        act="swiglu",
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
        param_dtype="bfloat16",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="deepseek-moe-16b-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1),
        param_dtype="float32",
    )
