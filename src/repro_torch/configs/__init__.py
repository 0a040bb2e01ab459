from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K, LONG_500K, MULTI_POD, PREFILL_32K, SHAPE_BY_NAME, SHAPES,
    SINGLE_POD, TRAIN_4K, MeshConfig, MLAConfig, ModelConfig, MoEConfig,
    SSMConfig, ShapeSpec, TrainConfig, XLSTMConfig, is_mla,
    shape_applicability,
)
from repro_torch.configs.registry import (  # noqa: F401
    ASSIGNED_ARCHS, PORT_ARCHS, get_config, get_tiny, list_archs,
)
