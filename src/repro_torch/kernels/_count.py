"""Launch counters that several threads may bump at once.

Each wrapper keeps its counts as attributes of the function
(``.launches``, ``.plain_calls``; flash_attention also
``.launches_sm90``, ``.launches_pack`` and ``.backward_calls``).  ``f.launches += 1`` is a
read and a write, which two serving threads can interleave and lose a
count; :func:`bump` makes the pair atomic.

The counts are a program's own calls.  The autotuner's timing runs of a
candidate (``kernelplan/autotune.py``) launch the same wrappers on a
synthetic workload; inside :func:`aside` a thread's calls are not
counted, so a query's counts hold its own launches only.

The cost ledger's measured replay reads the card's clock around a
routed call's kernel entries: inside :func:`device_clock` every call of
a :func:`clocked` entry (``kernels/ops.py``) is bracketed by CUDA
events, so the time a call's staged bodies take stays out of the
reading.  Each entry's launches queue behind a ``torch.cuda._sleep`` of
:data:`ENTRY_COVER_CYCLES` recorded before its start event, so the
entry's own host path (checks, allocations, ``ctypes``) stays out too,
up to a synchronize inside the entry.  Under a fake mode (the dry run)
an entry is not clocked.
"""
from __future__ import annotations

import contextlib
import functools
import threading

_lock = threading.Lock()
_local = threading.local()

#: the cover a clocked entry's launches queue behind (cycles of the SM
#: clock: about 2 ms on an H100 at 1.98 GHz), longer than the host takes
#: to reach an entry's last launch
ENTRY_COVER_CYCLES = 4_000_000

@contextlib.contextmanager
def aside():
    """Leave this thread's wrapper calls uncounted (the autotuner's
    timing runs)."""
    prev = getattr(_local, "aside", False)
    _local.aside = True
    try:
        yield
    finally:
        _local.aside = prev


def bump(f, attr: str = "launches", by: int = 1) -> None:
    """Add ``by`` to ``f.<attr>`` atomically (nothing inside
    :func:`aside`)."""
    if getattr(_local, "aside", False):
        return
    with _lock:
        setattr(f, attr, getattr(f, attr) + int(by))


def reset(fs, attrs=("launches", "plain_calls")) -> None:
    """Zero ``attrs`` of every function in ``fs`` atomically."""
    with _lock:
        for f in fs:
            for a in attrs:
                setattr(f, a, 0)


@contextlib.contextmanager
def device_clock():
    """Time this thread's kernel entries on the card: the block yields
    the list that every :func:`clocked` entry called inside it appends
    its (start, stop) CUDA events to.  Read it with :func:`clock_ns`
    after the card is synchronized."""
    prev = getattr(_local, "clock", None)
    marks: list = []
    _local.clock = marks
    try:
        yield marks
    finally:
        _local.clock = prev


def clocked(entry):
    """``entry`` bracketed by CUDA events on the current stream inside a
    :func:`device_clock`, behind a cover (as it is outside one).  An
    entry that calls another is one window."""
    @functools.wraps(entry)
    def timed(*args, **kwargs):
        marks = getattr(_local, "clock", None)
        if marks is None or _faking():
            return entry(*args, **kwargs)
        import torch

        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        _local.clock = None
        try:
            torch.cuda._sleep(ENTRY_COVER_CYCLES)
            start.record()
            out = entry(*args, **kwargs)
            stop.record()
        finally:
            _local.clock = marks
        marks.append((start, stop))
        return out
    return timed


def _faking() -> bool:
    """Whether a fake mode is active (the dry run traces the entries on
    fake tensors: nothing to time, and no event may be recorded)."""
    from torch._guards import active_fake_mode

    return active_fake_mode() is not None


def clock_ns(marks) -> int:
    """Nanoseconds the card spent inside the windows of ``marks``."""
    return int(sum(a.elapsed_time(b) for a, b in marks) * 1e6)
