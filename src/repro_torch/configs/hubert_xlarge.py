"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional) transformer backbone, same arch as wav2vec2.
The conv waveform frontend is a stub, as in the reference: batches carry
precomputed frame embeddings (batch, frames, d_model). The 504-way output
head predicts masked-frame cluster targets. [arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        act="gelu",
        causal=False,
        frontend="audio_frames",
        param_dtype="float32",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="hubert-xlarge-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=64,
    )
