from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    get_config, get_tiny,
)
