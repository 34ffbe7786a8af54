"""The port's device choice.

Every entry point evaluates on :func:`default_device`, which starts at
``"cuda"``.  When CUDA is absent it raises instead of running on the
CPU: the CPU is taken only when the caller asks for it with
``set_default_device("cpu")`` (the tests do so).

:func:`shared_use` and :func:`sole_use` share the card among a
process's threads: executions share it, while a timing that must see
the card alone (the autotuner's candidates, the cost ledger's measured
replay) waits for the executions in flight and holds new ones off.
"""
from __future__ import annotations

import contextlib
import threading

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


class _Gate:
    """Shared or sole use, by threads; a waiting sole user goes before
    new shared ones, so serving traffic cannot starve a timing.  A thread
    that already holds the gate passes through."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._shared = 0
        self._sole = False
        self._waiting = 0
        self._mine = threading.local()

    @contextlib.contextmanager
    def shared(self):
        if getattr(self._mine, "held", False):
            yield
            return
        with self._cond:
            while self._sole or self._waiting:
                self._cond.wait()
            self._shared += 1
        self._mine.held = True
        try:
            yield
        finally:
            self._mine.held = False
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def sole(self):
        if getattr(self._mine, "held", False):
            raise RuntimeError("sole use of the card asked for by a thread "
                               "that already uses it")
        with self._cond:
            self._waiting += 1
            try:
                while self._sole or self._shared:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._sole = True
        self._mine.held = True
        try:
            yield
        finally:
            self._mine.held = False
            with self._cond:
                self._sole = False
                self._cond.notify_all()


_gate = _Gate()


def shared_use():
    """Context: this thread runs work on the card beside others."""
    return _gate.shared()


def sole_use():
    """Context: this thread has the card to itself (no other thread of
    this process is inside :func:`shared_use` or :func:`sole_use`)."""
    return _gate.sole()
