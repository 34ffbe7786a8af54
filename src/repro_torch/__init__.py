"""Weld on PyTorch and CUDA: the port of the JAX package ``repro``.

The lazy frames (``frames.weldnp``/``welddf``/``weldrel``), the IR, the
optimizer passes and the kernel planner are copies of the JAX package's
JAX-free modules; the emitter (``core.backend.torchgen``), the runtime
and the kernels (``kernels/csrc/*.cu``, hand-written CUDA for sm_90a)
are ported.  Nothing here imports ``jax`` or ``repro``.

Evaluations run on :func:`default_device` — CUDA unless
:func:`set_default_device` says otherwise.
"""
from .device import (  # noqa: F401
    DeviceUnavailableError,
    default_device,
    set_default_device,
)
