# Weld core: the data-parallel IR (loops + builders), the lazy runtime
# API (WeldObject DAG), the optimizer, and the PyTorch backend that runs
# the fused cross-library program on the device.
from . import ir, macros, wtypes  # noqa: F401
from .cudf import register_cudf  # noqa: F401
from .lazy import (  # noqa: F401
    ArrayEncoder,
    Encoder,
    Evaluate,
    FreeWeldObject,
    FreeWeldResult,
    GetObjectType,
    NewWeldObject,
    WeldObject,
    WeldResult,
    ScalarEncoder,
)
