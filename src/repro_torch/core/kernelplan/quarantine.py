"""Kernel quarantine: a health table of failing kernel routes.

When a planned kernel fails to build or launch (the ``nvcc`` run of a
generated map-chain body, or the ``kernel.<route>`` fault), the recovery
layer (``core.recovery``) records the offender here under the key
``(kernel, impl, dtype, size-bucket, device)``.  The device part is the
card's name (``torch.cuda.get_device_name``) or ``"cpu"``, so a route
that failed on one card is not refused on another.  The planner's gate
consults :func:`is_quarantined` before routing: on the CPU it keeps the
generic lowering for that route, as the reference does; on a card it
raises under ``"always"`` and warns under ``"auto"``, because there the
generic lowering may not stand in for a hand-written kernel unseen.

The table lives in the process.  It is written to a file only when
``$WELD_KERNEL_HEALTH`` names one, and then read back by later
processes; nothing is written by default, so one failed run cannot
route a kernel away in every later run on the same checkout.  Writes
are atomic (tmp+rename), a corrupt file degrades to empty with a
``RuntimeWarning``, and :func:`fingerprint` participates in the
runtime's compile-cache key so quarantining (or clearing) a kernel can
never be served by a stale compiled program.

Reset with :func:`clear` (or delete the file) after fixing the kernel.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..obs.ledger import size_bucket

ENV_FILE = "WELD_KERNEL_HEALTH"

#: guards the table: serving threads read its fingerprint while another
#: thread's recovery rung may record a kernel
_lock = threading.RLock()
_health: Optional[Dict[str, dict]] = None  # lazily loaded from disk
_generation = 0  # bumps on every mutation (part of fingerprint)


def path() -> Optional[str]:
    """The health file, or None: the table then stays in the process."""
    return os.environ.get(ENV_FILE) or None


def _load() -> Dict[str, dict]:
    with _lock:
        return _load_locked()


def _load_locked() -> Dict[str, dict]:
    global _health
    if _health is None:
        p = path()
        if p is None:
            _health = {}
            return _health
        try:
            with open(p) as f:
                _health = json.load(f)
            if not isinstance(_health, dict):
                raise ValueError("health file root is not an object")
        except OSError:
            _health = {}  # no file yet: every kernel is healthy
        except ValueError as e:
            warnings.warn(
                f"kernel health file {p} is corrupt ({e}); ignoring it "
                "and starting with an empty quarantine — delete the file "
                "to silence this warning",
                RuntimeWarning, stacklevel=2,
            )
            _health = {}
    return _health


def _save() -> None:
    from .. import faults

    p = path()
    if p is None:
        return
    tmp = f"{p}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        faults.maybe_raise("io.quarantine", exc=OSError)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with _lock:
            text = json.dumps(_health, indent=1, sort_keys=True)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, p)  # atomic: readers never see a partial file
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        # the quarantine still applies in-process; persistence is
        # best-effort


def clear(disk: bool = True) -> None:
    """Forget every quarantined kernel (after a fix / for tests)."""
    global _health, _generation
    with _lock:
        _health = {}
        _generation += 1
    if disk and path() is not None:
        try:
            os.remove(path())
        except OSError:
            pass


def device_name() -> str:
    """The evaluation device's name: the card's, or ``"cpu"``."""
    from ...device import default_device

    dev = default_device()
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def on_card() -> bool:
    """True where evaluations run on a card: there a quarantined route
    raises rather than falls back to the generic lowering."""
    return device_name() != "cpu"


def _key(kernel: str, impl: Optional[str], dtype, n: Optional[int]) -> str:
    dev = device_name()
    if impl is None:
        # the port picks the implementation by device; name it, so a
        # record and the gate's lookup agree whatever the caller passed
        impl = "ref" if dev == "cpu" else "cuda"
    bucket = size_bucket(max(int(n or 0), 0))
    return f"{kernel}|{impl}|{np.dtype(dtype or 'f8').name}|{bucket}|{dev}"


def record(kernel: str, impl: Optional[str] = None, dtype=None,
           n: Optional[int] = None, error: Optional[str] = None) -> str:
    """Quarantine one (kernel, impl, dtype, size-bucket, device); returns
    the key."""
    global _generation
    k = _key(kernel, impl, dtype, n)
    with _lock:
        h = _load()
        ent = h.setdefault(k, {"kernel": kernel, "impl": impl, "count": 0})
        ent["count"] += 1
        if error:
            ent["last_error"] = error[:500]
        _generation += 1
    _save()
    return k


def is_quarantined(kernel: str, impl: Optional[str] = None, dtype=None,
                   n: Optional[int] = None) -> bool:
    with _lock:
        h = _load()
        return bool(h) and _key(kernel, impl, dtype, n) in h


def entries() -> Dict[str, dict]:
    """Copy of the current quarantine table (reporting/tests)."""
    with _lock:
        return {k: dict(v) for k, v in _load().items()}


def fingerprint() -> str:
    """Stable digest of the quarantine state for the compile-cache key."""
    import zlib

    with _lock:
        h = _load()
        items = ";".join(sorted(h))
        return f"g{_generation}n{len(h)}h{zlib.crc32(items.encode()):08x}"
