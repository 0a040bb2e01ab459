"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (xLSTM[7:1] layout: one sLSTM per 8 blocks); no separate
FFN (d_ff=0) — mixing happens inside the up-projected blocks.
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        xlstm=XLSTMConfig(slstm_every=8, chunk=256, expand=2),
        param_dtype="float32",
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="xlstm-350m-tiny", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        vocab_size=256, xlstm=XLSTMConfig(slstm_every=2, chunk=32, expand=2),
    )
