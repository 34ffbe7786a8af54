"""PyTorch backend: lowers optimized Weld IR to tensor operations."""
from .torchgen import WeldCompileError, WeldMemoryError, emit_program  # noqa: F401
from .values import WDict, WVec, from_numpy  # noqa: F401
