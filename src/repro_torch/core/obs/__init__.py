"""weldtrace: spans, Chrome-trace export, and the cost ledger.

Usage::

    from repro_torch.core import obs   # (or: from repro_torch import obs)

    obs.enable()                 # or WELD_TRACE=1 in the environment
    ... run queries ...
    print(obs.format_tree())
    obs.dump_chrome("trace.json")   # load in Perfetto / chrome://tracing

See ``tracer`` for the span API and ``ledger`` for the on-disk
predicted-vs-measured record format.
"""
from . import ledger  # noqa: F401
from .tracer import (  # noqa: F401
    NOOP,
    Span,
    clear,
    disable,
    dump_chrome,
    enable,
    enabled,
    event,
    format_tree,
    mark,
    span,
    spans,
    spans_since,
    to_chrome,
)

__all__ = [
    "NOOP", "Span", "clear", "disable", "dump_chrome", "enable", "enabled",
    "event", "format_tree", "ledger", "mark", "span", "spans",
    "spans_since", "to_chrome",
]
