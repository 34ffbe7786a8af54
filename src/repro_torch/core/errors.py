"""Typed exception hierarchy for the Weld runtime.

Every runtime failure the recovery layer (``core.recovery``) can act on
carries a type, not just a message string:

* :class:`WeldError` — base class for all runtime-raised errors.
* :class:`CapacityError` — a builder/dict capacity was exceeded: the
  negative-count poison convention observed at decode time, or a
  host-side capacity guard (``weldrel.Query.join``).  Subclasses BOTH
  ``RuntimeError`` and ``ValueError`` so the pre-existing catch sites
  (poison decode raised ``RuntimeError``, the join guard raised
  ``ValueError``) keep working unchanged.
* :class:`ResourceError` — an estimated resource budget was breached
  before execution (``memory_limit`` accounting in the backend).
* :class:`KernelCompileError` — a planned accelerator kernel failed to
  stage/compile/launch.  Carries the quarantine key
  ``(kernel, impl, dtype, n)`` so ``kernelplan.quarantine`` can record
  the offender.  On the CPU the recovery layer then falls back to the
  generic lowering; on a card it raises (see ``core.recovery``).
* :class:`KernelQuarantinedError` — the planner's gate met a quarantined
  route under ``kernelize="always"`` on a card, where the generic
  lowering may not stand in for the hand-written kernel.
* :class:`InjectedFault` — raised by an armed ``core.faults`` failpoint
  (deterministic fault injection for tests/CI).
* :class:`WeldVerifyError` — the static verifier (``core.check``) found
  an ill-formed program after an optimizer pass, the kernel planner, or
  a recovery rewrite.  Carries the offending phase and the structured
  diagnostics so callers can pinpoint the pass that broke the IR.

The module is dependency-free on purpose: anything in the runtime may
import it without cycles.  Re-exported at top level as ``repro.errors``.
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "WeldError",
    "CapacityError",
    "ResourceError",
    "KernelCompileError",
    "KernelQuarantinedError",
    "InjectedFault",
    "WeldVerifyError",
]


class WeldError(RuntimeError):
    """Base class for all typed Weld runtime errors."""


class CapacityError(WeldError, ValueError):
    """A dictmerger/groupbuilder/vecbuilder capacity was exceeded.

    Raised when decode observes the negative-count poison convention, or
    by host-side capacity guards.  The adaptive recovery ladder
    (``core.recovery``) treats this as retryable: re-stamp capacities
    with geometric growth, then degrade to the generic lowering.
    """


class ResourceError(WeldError):
    """An estimated resource budget (``memory_limit``) would be breached."""


class KernelCompileError(WeldError):
    """A planned kernel failed to stage, compile, or launch.

    ``kernel``/``impl``/``dtype``/``n`` identify the offender for the
    quarantine health file; any may be None when unknown.
    """

    def __init__(self, message: str, *, kernel: Optional[str] = None,
                 impl: Optional[str] = None, dtype: Optional[str] = None,
                 n: Optional[int] = None):
        super().__init__(message)
        self.kernel = kernel
        self.impl = impl
        self.dtype = dtype
        self.n = n


class KernelQuarantinedError(KernelCompileError):
    """A quarantined route was planned under ``kernelize="always"`` on a
    card: raised at the planner's gate, before anything is built or
    launched.  ``kernelplan.quarantine.clear()`` lifts it."""


class InjectedFault(WeldError):
    """Raised by an armed deterministic failpoint (``core.faults``)."""


class WeldVerifyError(WeldError):
    """The static verifier rejected a program.

    ``phase`` names the pipeline stage whose output failed (``"input"``,
    ``"pass.fusion"``, ``"kernelplan"``, ``"recovery.regrow"``, ...);
    ``diagnostics`` is the list of :class:`repro.core.check.Diagnostic`
    objects that survived, each naming a code and the offending
    subexpression.
    """

    def __init__(self, message: str, *, phase: Optional[str] = None,
                 diagnostics=None):
        super().__init__(message)
        self.phase = phase
        self.diagnostics = list(diagnostics or [])

    @property
    def codes(self):
        return [d.code for d in self.diagnostics]
