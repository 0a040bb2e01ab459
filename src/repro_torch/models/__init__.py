"""Models of the port: the dense, MoE, hybrid (Mamba2), xLSTM, audio and
vision families (``init_params``, ``init_cache``, ``forward``, ``loss_fn``,
``decode_step``)."""
from repro_torch.models.transformer import (  # noqa: F401
    decode_step, forward, init_cache, init_params, loss_fn,
)
