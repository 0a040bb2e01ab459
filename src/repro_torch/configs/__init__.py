from repro_torch.configs.base import (  # noqa: F401
    MULTI_POD, SINGLE_POD, MeshConfig, ModelConfig, MoEConfig, SSMConfig,
    ShapeSpec, TrainConfig, XLSTMConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ASSIGNED_ARCHS, get_config, get_tiny, list_archs,
)
