from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K, LONG_500K, MULTI_POD, PREFILL_32K, SHAPE_BY_NAME, SHAPES,
    SINGLE_POD, TRAIN_4K, MeshConfig, ModelConfig, MoEConfig, SSMConfig,
    ShapeSpec, TrainConfig, XLSTMConfig, shape_applicability,
)
from repro_torch.configs.registry import (  # noqa: F401
    ASSIGNED_ARCHS, get_config, get_tiny, list_archs,
)
