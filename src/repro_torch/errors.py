"""Top-level alias for :mod:`repro_torch.core.errors` (the typed exception
hierarchy): ``from repro_torch import errors; errors.CapacityError``."""
from .core.errors import (  # noqa: F401
    CapacityError,
    InjectedFault,
    KernelCompileError,
    KernelQuarantinedError,
    ResourceError,
    WeldError,
    WeldVerifyError,
)

__all__ = [
    "WeldError", "CapacityError", "ResourceError",
    "KernelCompileError", "KernelQuarantinedError", "InjectedFault",
    "WeldVerifyError",
]
