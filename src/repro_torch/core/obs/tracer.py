"""weldtrace: a zero-dependency span tracer for the evaluation pipeline.

Spans are nested wall-clock intervals with free-form tags and counters.
Tracing is OFF by default; when disabled, ``span()`` hands back a shared
no-op object so instrumented code pays one flag check per call site.
Enable with ``repro_torch.obs.enable()`` or ``WELD_TRACE=1`` in the
environment.

Finished spans accumulate in a process-global list (pre-order: a span is
registered when it *opens*, its duration is filled in when it closes) and
can be exported as Chrome-trace/Perfetto JSON (``to_chrome``) or a
human-readable tree (``format_tree``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Span",
    "enable",
    "disable",
    "enabled",
    "clear",
    "span",
    "event",
    "mark",
    "spans",
    "spans_since",
    "to_chrome",
    "dump_chrome",
    "format_tree",
]

ENV_TRACE = "WELD_TRACE"


def _env_enabled(env: Optional[dict] = None) -> bool:
    v = (env if env is not None else os.environ).get(ENV_TRACE, "")
    return str(v).strip().lower() not in ("", "0", "false", "no", "off")


class Span:
    """One timed interval.  ``dur_ns`` is None while the span is open."""

    __slots__ = ("name", "tags", "counters", "start_ns", "dur_ns",
                 "depth", "tid")

    def __init__(self, name: str, tags: Optional[Dict[str, Any]] = None,
                 depth: int = 0, tid: int = 0):
        self.name = name
        self.tags: Dict[str, Any] = dict(tags) if tags else {}
        self.counters: Dict[str, float] = {}
        self.start_ns = time.perf_counter_ns()
        self.dur_ns: Optional[int] = None
        self.depth = depth
        self.tid = tid

    def set(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def count(self, key: str, delta: float = 1) -> "Span":
        self.counters[key] = self.counters.get(key, 0) + delta
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        _close(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        dur = "open" if self.dur_ns is None else f"{self.dur_ns / 1e3:.1f}us"
        return f"Span({self.name!r}, {dur}, tags={self.tags})"


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def set(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def count(self, key: str, delta: float = 1) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    # mirror Span's readable attrs so callers can poke them unconditionally
    name = ""
    tags: Dict[str, Any] = {}
    counters: Dict[str, float] = {}
    start_ns = 0
    dur_ns = 0
    depth = 0
    tid = 0


NOOP = _NoopSpan()

_enabled = _env_enabled()
_lock = threading.Lock()
_spans: List[Span] = []
_tls = threading.local()


def enable() -> None:
    """Turn tracing on for the whole process."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop all recorded spans (open stacks on other threads survive)."""
    with _lock:
        _spans.clear()


def _stack() -> List[Span]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def span(name: str, **tags):
    """Open a span.  Use as a context manager::

        with obs.span("optimize", passes=6) as sp:
            ...
            sp.set("iterations", 3)

    Returns the shared no-op span when tracing is disabled.
    """
    if not _enabled:
        return NOOP
    st = _stack()
    sp = Span(name, tags, depth=len(st), tid=threading.get_ident())
    st.append(sp)
    with _lock:
        _spans.append(sp)
    return sp


def _close(sp: Span) -> None:
    sp.dur_ns = time.perf_counter_ns() - sp.start_ns
    st = _stack()
    # tolerate out-of-order exits (exceptions unwind the whole stack)
    while st and st[-1] is not sp:
        st.pop()
    if st:
        st.pop()


def event(name: str, **tags):
    """Record an instantaneous (zero-duration) span."""
    if not _enabled:
        return NOOP
    sp = span(name, **tags)
    sp.dur_ns = 0
    st = _stack()
    if st and st[-1] is sp:
        st.pop()
    return sp


def mark() -> int:
    """A position in the span log; pair with :func:`spans_since`."""
    with _lock:
        return len(_spans)


def spans() -> List[Span]:
    with _lock:
        return list(_spans)


def spans_since(pos: int) -> List[Span]:
    with _lock:
        return list(_spans[pos:])


# ---------------------------------------------------------------- exports

def _args_of(sp: Span) -> Dict[str, Any]:
    args = {}
    for k, v in sp.tags.items():
        try:
            json.dumps(v)
            args[k] = v
        except (TypeError, ValueError):
            args[k] = repr(v)
    for k, v in sp.counters.items():
        args[f"count.{k}"] = v
    return args


def to_chrome(span_list: Optional[List[Span]] = None) -> dict:
    """Chrome-trace ("trace event") JSON object.  Load the dumped file at
    ``chrome://tracing`` or https://ui.perfetto.dev."""
    sl = spans() if span_list is None else span_list
    events = []
    for sp in sl:
        events.append({
            "name": sp.name,
            "ph": "X",
            "ts": sp.start_ns / 1e3,          # Chrome wants microseconds
            "dur": (sp.dur_ns or 0) / 1e3,
            "pid": os.getpid(),
            "tid": sp.tid,
            "args": _args_of(sp),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome(path: str, span_list: Optional[List[Span]] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome(span_list), f)
    return path


def format_tree(span_list: Optional[List[Span]] = None,
                min_ns: int = 0) -> str:
    """Human-readable indented tree of the recorded spans."""
    sl = spans() if span_list is None else span_list
    lines = []
    base = min((sp.depth for sp in sl), default=0)
    for sp in sl:
        if sp.dur_ns is not None and sp.dur_ns < min_ns and sp.dur_ns > 0:
            continue
        pad = "  " * (sp.depth - base)
        dur = "..." if sp.dur_ns is None else f"{sp.dur_ns / 1e6:10.3f} ms"
        bits = [f"{k}={v}" for k, v in sp.tags.items()]
        bits += [f"{k}={v:g}" for k, v in sp.counters.items()]
        tagtxt = (" [" + ", ".join(bits) + "]") if bits else ""
        lines.append(f"{pad}{sp.name:<{max(1, 40 - len(pad))}} {dur}{tagtxt}")
    return "\n".join(lines)
