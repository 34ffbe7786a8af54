"""Kernel planning: lower fused Weld IR loops onto the CUDA kernel library.

The subsystem sits between the optimizer and the backend emitter:

    frames -> lazy DAG -> optimize (fusion/predication/CSE)
           -> **plan_kernels** (this package; cost-gated in "auto" mode)
           -> **tune_plan** (the autotuner bakes tuned launch parameters)
           -> torchgen emitter (KernelCall nodes dispatch to
              repro_torch.kernels.ops, everything else lowers through
              the generic vector emitter)

``kernelize`` accepts three modes (bools are accepted for
back-compatibility):

* ``"auto"`` (the default, ``None``) — route a matched loop only when
  the roofline cost model (:mod:`.cost`) prices the kernel route at
  least as fast as the generic lowering;
* ``"always"`` (``True``) — route every sound match unconditionally;
* ``"off"`` (``False``) — bypass the planner entirely.

``kernel_impl`` ("cuda" or "ref", default: by the tensors' device) is
forwarded to the kernel entries.  A route that failed to build or
launch is in the quarantine (:mod:`.quarantine`): on the CPU the gate
refuses it up front; on a card it raises under ``"always"`` and is
refused with a ``RuntimeWarning`` under ``"auto"``.  The autotuner
(:mod:`.autotune`) picks the grid cap of the routes that take one on
the card, and the ledger calibration (:mod:`.calibrate`) replaces the
gate's roofline kernel figure with measured medians.

This module stays import-light: the planner, registry, autotuner and
calibration load lazily on first attribute access.
"""
from __future__ import annotations

from typing import Union

KERNELIZE_MODES = ("always", "auto", "off")

#: process-wide default for evaluations that don't pass ``kernelize=``.
#: "auto" = cost-gated routing — safe to leave on everywhere because the
#: gate falls back to the jnp lowering whenever the kernel can't win.
DEFAULT_KERNELIZE: str = "auto"


def normalize_kernelize(kernelize: Union[None, bool, str]) -> str:
    """Map the public knob (None/bool/str) onto a mode string."""
    if kernelize is None:
        return DEFAULT_KERNELIZE
    if kernelize is True:
        return "always"
    if kernelize is False:
        return "off"
    if kernelize in KERNELIZE_MODES:
        return str(kernelize)
    raise ValueError(
        f"kernelize must be None, bool, or one of {KERNELIZE_MODES}; "
        f"got {kernelize!r}"
    )


def set_default_kernelize(mode: Union[bool, str]) -> None:
    global DEFAULT_KERNELIZE
    if mode is None:
        raise ValueError("default kernelize mode cannot be None")
    DEFAULT_KERNELIZE = normalize_kernelize(mode)


def resolve_kernelize(kernelize: Union[None, bool, str]) -> str:
    return normalize_kernelize(kernelize)


_PLANNER_ATTRS = {"plan_kernels"}
_AUTOTUNE_ATTRS = {"tune_plan"}
_REGISTRY_ATTRS = {
    "KernelPlanError", "KernelSpec", "all_specs", "available", "describe",
    "fingerprint", "get", "register", "unregister",
}


def __getattr__(name: str):  # PEP 562 lazy re-exports
    if name in _PLANNER_ATTRS:
        from . import planner

        return getattr(planner, name)
    if name in _REGISTRY_ATTRS:
        from . import registry

        return getattr(registry, name)
    if name in _AUTOTUNE_ATTRS:
        from . import autotune

        return getattr(autotune, name)
    if name in ("autotune", "quarantine", "calibrate"):
        # importlib (not ``from . import``) — the fromlist lookup would
        # re-enter this __getattr__ before the submodule is bound
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "plan_kernels",
    "tune_plan",
    "KernelPlanError",
    "KernelSpec",
    "register",
    "unregister",
    "get",
    "available",
    "all_specs",
    "describe",
    "fingerprint",
    "set_default_kernelize",
    "resolve_kernelize",
    "normalize_kernelize",
    "KERNELIZE_MODES",
    "DEFAULT_KERNELIZE",
    "autotune",
    "quarantine",
    "calibrate",
]
