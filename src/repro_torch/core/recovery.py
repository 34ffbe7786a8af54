"""Adaptive recovery around ``compile_and_run``: retry, regrow, degrade.

Weld's premise is one runtime safely owning execution for many
libraries — so the runtime must not delegate failure back to the user.
Two failure families are retryable, and this module owns the ladder:

* **Capacity poison** (:class:`~repro_torch.core.errors.CapacityError`): a
  dictmerger/groupbuilder overflowed its static capacity and flagged the
  result with the negative-count convention, detected at decode.  The
  ladder re-stamps every dict/group capacity literal in the program with
  geometric growth (×2, up to :data:`MAX_REGROW` attempts) and re-runs;
  if growth alone cannot fix it (e.g. a kernel route that cannot
  represent the keys), the last rung degrades to the generic
  ``kernelize="off"`` lowering — the unmodified-library safety net Split
  Annotations keeps around, which the torchgen lowering exactly is.
* **Kernel failure** (:class:`~repro_torch.core.errors.KernelCompileError`):
  a planned kernel failed to build (``nvcc`` refused a generated
  map-chain body) or its ``kernel.<route>`` fault fired.  The offender
  is recorded in the quarantine (``kernelplan.quarantine``, keyed by the
  device's name).  On the CPU the same program then re-runs on the
  generic lowering, as the reference's rung does.  On a card the rung
  raises the error, naming the key: the generic lowering never stands
  in for a hand-written kernel there, and the planner's gate raises on
  the quarantined route under ``"always"`` until
  ``quarantine.clear()``.  Other failures (out of memory, a C entry's
  refusal, a CUDA error, a missing card) are not kernel failures and
  reach no rung.

Every step emits a ``RuntimeWarning``, an obs event + ``recovery.retry``
span, and lands in the ``recovery.*`` stats namespace of the attempt
that finally succeeded.

Disable with ``WELD_RECOVERY=0`` (or :func:`set_enabled` /
:func:`disabled`): failures then surface as their typed exceptions.
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Optional

from . import ir
from . import obs
from . import wtypes as wt
from .errors import (CapacityError, KernelCompileError,
                     KernelQuarantinedError)

ENV_RECOVERY = "WELD_RECOVERY"

#: capacity-regrow rungs before degrading to the generic lowering:
#: factors ×2, ×4, ×8 over the originally planned capacities.
MAX_REGROW = 3
GROWTH = 2

_enabled_override: Optional[bool] = None


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(ENV_RECOVERY, "1").lower() not in (
        "0", "off", "false", "no"
    )


def set_enabled(on: Optional[bool]) -> None:
    """Override the env knob in-process (None restores it)."""
    global _enabled_override
    _enabled_override = on


@contextlib.contextmanager
def disabled():
    """``with recovery.disabled(): ...`` — typed errors instead of retries."""
    prev = _enabled_override
    set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


def regrow_capacities(e: ir.Expr, factor: int, bounds=None):
    """Re-stamp every dict/group builder capacity literal with
    ``capacity * factor``; returns ``(expr, n_stamped)``.

    ``bounds`` (``id(NewBuilder) -> (lb, ub)``, from
    ``analysis.bounds.BoundsReport.capacity_bounds``) clamps the ladder
    at what the interval analysis proved: a rung below the proven lower
    bound jumps straight to it (growing there would provably still
    poison), and no rung grows past the proven upper bound — a capacity
    already at/above it provably cannot be exceeded, so it is left
    unstamped (and an all-clamped program falls through to the generic
    lowering instead of burning rungs)."""
    n = 0
    bounds = bounds or {}

    def rec(x: ir.Expr) -> ir.Expr:
        nonlocal n
        orig = x
        x = x.map_children(rec)
        if (isinstance(x, ir.NewBuilder)
                and isinstance(x.ty, (wt.DictMerger, wt.GroupBuilder))
                and isinstance(x.arg, ir.Literal)):
            old = int(x.arg.value)
            new = old * factor
            lb, ub = bounds.get(id(orig), (0, None))
            if lb and new < lb:
                new = int(lb)
            if ub is not None and int(ub) > 0:
                # never shrink below the current rung's own value: the
                # differential WV404 check (and cache keys) rely on
                # regrow being monotone
                new = min(new, max(int(ub), old))
            if new <= old:
                return x  # provably can't overflow: nothing to regrow
            n += 1
            return ir.NewBuilder(
                x.ty,
                arg=ir.Literal(new, x.arg.ty),
                size_hint=x.size_hint,
            )
        return x

    return rec(e), n


def _capacity_bounds(prog):
    """Proven ``id(NewBuilder) -> (lb, ub)`` capacity bounds for the
    program's dict/group builders, from the weldbound interval analysis
    evaluated at the bound input shapes.  Best-effort: any failure (or
    the analysis being disabled) just leaves the ladder unclamped."""
    try:
        import numpy as np

        from .analysis import bounds as _bounds

        if not _bounds.enabled():
            return {}
        shapes = {}
        for name, bound in getattr(prog, "inputs", {}).items():
            try:
                # a re-bound CompiledProgram input is a tensor, possibly
                # on the card: read its shape, never copy it to the host
                data = bound[-1]
                shapes[name] = tuple(data.shape if hasattr(data, "shape")
                                     else np.asarray(data).shape)
            except Exception:
                continue
        return _bounds.analyze(prog.expr).capacity_bounds(shapes)
    except Exception:
        return {}


def _warn(msg: str) -> None:
    warnings.warn(msg, RuntimeWarning, stacklevel=4)


def run_with_recovery(runner, prog, *, optimize, memory_limit, passes,
                      mode, kernel_impl, root):
    """Drive ``runner`` (``runtime._compile_and_run``) up the ladder.

    Returns the runner's ``(value, compile_ms, from_cache, stats)``; on
    a recovered run the stats gain the ``recovery.*`` namespace.
    """
    events = []
    quarantined = []
    cur_prog = prog
    cur_mode = mode
    factor = 1
    regrows = 0
    attempt = 0
    while True:
        attempt += 1
        try:
            if attempt == 1:
                out = runner(cur_prog, optimize, memory_limit, passes,
                             cur_mode, cur_mode != "off", kernel_impl, root)
            else:
                with obs.span("recovery.retry", attempt=attempt,
                              mode=cur_mode, factor=factor):
                    out = runner(cur_prog, optimize, memory_limit, passes,
                                 cur_mode, cur_mode != "off", kernel_impl,
                                 root)
            value, compile_ms, from_cache, stats = out
            if events:
                stats["recovery.attempts"] = attempt
                stats["recovery.events"] = events
                stats["recovery.regrow_factor"] = factor
                stats["recovery.fallback"] = cur_mode != mode
                if quarantined:
                    stats["recovery.quarantined"] = quarantined
                root.set("recovery.attempts", attempt)
            return value, compile_ms, from_cache, stats
        except CapacityError as e:
            if not enabled():
                raise
            grown = None
            if regrows < MAX_REGROW:
                grown, n_stamped = regrow_capacities(
                    prog.expr, factor * GROWTH,
                    bounds=_capacity_bounds(prog))
                if n_stamped == 0:
                    # every capacity already sits at its proven upper bound,
                    # yet the runtime still observed a poison — the bound is
                    # contradicted (transient fault or unsound proof), so
                    # distrust the clamp and double unconditionally
                    grown, n_stamped = regrow_capacities(
                        prog.expr, factor * GROWTH)
                if n_stamped == 0:
                    grown = None  # nothing to regrow: skip to fallback
            if grown is not None:
                regrows += 1
                factor *= GROWTH
                # differential check: the regrown program must re-verify
                # clean AND every capacity must dominate its predecessor
                # (WV404) — a buggy rewrite here would loop the ladder
                from . import check

                check.verify_rewrite("recovery.regrow", prog.expr, grown)
                cur_prog = type(prog)(expr=grown, inputs=prog.inputs,
                                      out_ty=prog.out_ty)
                detail = (f"capacity poison; regrowing {n_stamped} "
                          f"builder capacit{'y' if n_stamped == 1 else 'ies'}"
                          f" x{factor}")
            elif cur_mode != "off":
                cur_mode = "off"
                detail = ("capacity poison persists; degrading to the "
                          "generic kernelize='off' lowering")
            else:
                raise CapacityError(
                    f"{e} [recovery exhausted after {attempt} attempts: "
                    f"capacity regrow x{factor}, generic fallback"
                ) from e
            events.append({"attempt": attempt, "action": "regrow"
                           if grown is not None else "fallback",
                           "detail": detail})
            _warn(f"weld recovery (attempt {attempt}): {detail}")
            obs.event("recovery.step", attempt=attempt, detail=detail)
        except KernelCompileError as e:
            if (isinstance(e, KernelQuarantinedError) or not enabled()
                    or cur_mode == "off"):
                raise
            from .kernelplan import quarantine

            qkey = quarantine.record(e.kernel or "?", impl=e.impl,
                                     dtype=e.dtype, n=e.n, error=str(e))
            quarantined.append(qkey)
            if quarantine.on_card():
                obs.event("recovery.step", attempt=attempt, kernel=e.kernel,
                          detail=f"quarantined [{qkey}]; raised")
                raise KernelCompileError(
                    f"{e} [quarantined as {qkey}; on a card the generic "
                    f"lowering does not stand in for a kernel]",
                    kernel=e.kernel, impl=e.impl, dtype=e.dtype,
                    n=e.n) from e
            detail = (f"kernel {e.kernel!r} failed ({e}); quarantined "
                      f"[{qkey}] and degrading to the generic lowering")
            events.append({"attempt": attempt, "action": "quarantine",
                           "detail": detail})
            _warn(f"weld recovery (attempt {attempt}): {detail}")
            obs.event("recovery.step", attempt=attempt, kernel=e.kernel,
                      detail=detail)
            cur_mode = "off"
