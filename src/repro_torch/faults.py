"""Top-level alias for :mod:`repro_torch.core.faults` (deterministic fault
injection): ``from repro_torch import faults; faults.inject(...)``."""
from .core.faults import (  # noqa: F401
    ENV_FAULTS,
    armed,
    capacity_override,
    clear,
    fingerprint,
    fired,
    inject,
    maybe_raise,
    poisoned,
)

__all__ = [
    "ENV_FAULTS", "inject", "clear", "armed", "fired", "fingerprint",
    "maybe_raise", "poisoned", "capacity_override",
]
