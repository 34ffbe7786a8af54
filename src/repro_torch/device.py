"""The port's device choice.

Every entry point evaluates on :func:`default_device`, which starts at
``"cuda"``.  When CUDA is absent it raises instead of running on the
CPU: the CPU is taken only when the caller asks for it with
``set_default_device("cpu")`` (the tests do so).
"""
from __future__ import annotations

import torch

_default = torch.device("cuda")


class DeviceUnavailableError(RuntimeError):
    """The default device is CUDA and this process has no CUDA device."""


def set_default_device(device) -> None:
    """Evaluate on ``device`` ("cuda", "cuda:1", "cpu", ...) from now on."""
    global _default
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    _default = dev


def default_device() -> torch.device:
    """The device evaluations run on; raises when it is CUDA and there
    is none (never falls back to the CPU)."""
    if _default.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "repro_torch evaluates on CUDA by default, but "
            "torch.cuda.is_available() is False; call "
            "repro_torch.set_default_device('cpu') to run on the CPU")
    return _default
