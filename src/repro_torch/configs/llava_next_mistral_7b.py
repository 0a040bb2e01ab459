"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Mistral-7B backbone; the anyres vision tiling is a stub, as in the
reference: batches carry precomputed patch embeddings (batch, n_patches,
d_model) that are prepended to the text sequence. n_patches=2880 matches
the anyres 4-tile + base-image token count.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        act="swiglu",
        rope_theta=1000000.0,
        frontend="vision_patches",
        n_patches=2880,
        param_dtype="bfloat16",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="llava-next-mistral-7b-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, n_patches=8,
        param_dtype="float32",
    )
