"""Architecture configs of the port: one module per architecture, each with
the exact published configuration plus a reduced smoke variant (copies of
the JAX package's).  Only the dense family is registered; the other
families' configs come with their models."""
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
)
