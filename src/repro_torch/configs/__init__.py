"""Architecture configs of the port: one module per architecture, each with
the exact published configuration plus a reduced smoke variant (copies of
the JAX package's, every one of them registered)."""
from .base import (  # noqa: F401
    ModelConfig,
    SHAPES,
    ShapeConfig,
    get_config,
    list_configs,
    register,
)
from . import (  # noqa: F401
    starcoder2_15b,
    nemotron4_15b,
    llama32_3b,
    qwen2_7b,
    llama32_vision_90b,
    whisper_large_v3,
    deepseek_moe_16b,
    dbrx_132b,
    zamba2_1p2b,
    xlstm_350m,
    weldbench,
)
