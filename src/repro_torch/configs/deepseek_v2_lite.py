"""deepseek-v2-lite [moe, MLA] — 27L d_model=2048 16H, latent attention
(kv_lora_rank 512, no q_lora), layer 0 dense (d_ff 10944), layers 1-26
MoE (64 routed experts of 1408, top-6, 2 shared), vocab 102400.

The published config.json (deepseek-ai/DeepSeek-V2-Lite): qk_nope_head_dim
128, qk_rope_head_dim 64, v_head_dim 128; YaRN RoPE with factor 40 over
4,096 original positions, beta_fast 32, beta_slow 1, mscale =
mscale_all_dim = 0.707, theta 10,000; softmax gates, norm_topk_prob
false, routed scaling 1; rms_norm_eps 1e-6; untied embedding.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import MLAConfig, MoEConfig


def config() -> MLAConfig:
    return MLAConfig(
        name="deepseek-v2-lite",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        vocab_size=102400,
        act="swiglu",
        rope_theta=10000.0,
        norm_eps=1e-6,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      capacity_factor=64 / 6),
        param_dtype="bfloat16",
    )


def tiny() -> MLAConfig:
    """One dense layer, then two MoE layers, at CPU widths; the published
    YaRN settings (at a RoPE width of 8 its ramp spans pairs 1-3)."""
    return config().replace(
        name="deepseek-v2-lite-tiny", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab_size=256, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                      capacity_factor=4.0),
        param_dtype="float32",
    )
