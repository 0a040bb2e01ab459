"""Models of the port: the dense transformer (``init_params``,
``init_cache``, ``forward``)."""
from repro_torch.models.transformer import (  # noqa: F401
    forward, init_cache, init_params,
)
