"""Deterministic fault injection for the Weld runtime.

Every degradation path in the recovery runtime (poison-triggered retry,
kernel quarantine, best-effort IO) is unreachable on healthy inputs —
this module makes them reachable on demand so tests and CI can prove
them.  A *failpoint* is a named site in the runtime; arming one makes
the next N evaluations of that site fire an action:

* ``raise`` — raise :class:`~repro_torch.core.errors.InjectedFault` (or a
  caller-chosen exception class at IO sites).
* ``poison`` — flip the site's overflow/poison flag (builder finalizes,
  kernel adapters) so the negative-count convention propagates exactly
  as a real capacity overflow would.
* ``cap=<int>`` — override a capacity the site is about to use
  (e.g. ``join.capacity``), simulating a mis-estimated build size.

Arming is either programmatic::

    from repro_torch import faults
    faults.inject("kernel.hash_probe", "raise", times=1)

or via the environment, parsed once at first use::

    WELD_FAULTS="kernel.hash_probe:raise@1,dict.build:poison@2"

``site:action@N`` fires the action for the next N evaluations of the
site (``@N`` optional, default 1), then disarms.  Known sites include
``kernel.<name>`` (every planned kernel launch, via
``kernelplan.registry.execute_spec``), ``dict.build`` / ``group.build``
(the generic keyed finalize), ``join.capacity`` (weldrel's host-side
capacity choice), ``decode`` (poison/raise at result decode),
``measure.replay`` (the traced eager replay), ``autotune.time`` (the
tuner's candidate timer), and ``io.autotune_cache`` / ``io.ledger``
(best-effort cache/ledger writes).

Fired failpoints emit ``fault.fired`` obs events; :func:`fingerprint`
participates in the runtime's compile-cache key whenever anything is
armed, so an armed fault can never be defeated by a cached executable.
Everything here is deterministic — no randomness, no timing.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from .errors import InjectedFault

__all__ = [
    "inject", "clear", "armed", "fired", "fingerprint",
    "maybe_raise", "poisoned", "capacity_override",
]

ENV_FAULTS = "WELD_FAULTS"

_ACTIONS = ("raise", "poison", "cap")

_lock = threading.RLock()
_armed: Optional[Dict[str, List[dict]]] = None  # site -> [entry, ...]
_fired: List[dict] = []
_generation = 0


def _parse_spec(spec: str) -> dict:
    """``raise`` | ``poison`` | ``cap=<int>``, with optional ``@N``."""
    times = 1
    if "@" in spec:
        spec, _, t = spec.rpartition("@")
        times = int(t)
    value = None
    if "=" in spec:
        spec, _, v = spec.partition("=")
        value = int(v)
    if spec not in _ACTIONS:
        raise ValueError(
            f"unknown fault action {spec!r} (expected one of {_ACTIONS})"
        )
    if spec == "cap" and value is None:
        raise ValueError("fault action 'cap' needs a value: cap=<int>")
    return {"action": spec, "value": value, "remaining": max(int(times), 0)}


def _load() -> Dict[str, List[dict]]:
    """Armed table, seeding from $WELD_FAULTS on first use."""
    global _armed, _generation
    with _lock:
        if _armed is None:
            _armed = {}
            env = os.environ.get(ENV_FAULTS, "").strip()
            for part in filter(None, (p.strip() for p in env.split(","))):
                site, sep, spec = part.partition(":")
                if not sep:
                    raise ValueError(
                        f"bad {ENV_FAULTS} entry {part!r} "
                        "(expected site:action[@N])"
                    )
                _armed.setdefault(site, []).append(_parse_spec(spec))
            if _armed:
                _generation += 1
        return _armed


def inject(site: str, action: str = "raise", times: int = 1,
           value: Optional[int] = None) -> None:
    """Arm ``site`` to fire ``action`` for the next ``times`` hits."""
    global _generation
    spec = action if value is None else f"{action}={value}"
    with _lock:
        _load().setdefault(site, []).append(
            dict(_parse_spec(spec), remaining=max(int(times), 0))
        )
        _generation += 1


def clear() -> None:
    """Disarm every failpoint and forget the fired log ($WELD_FAULTS is
    NOT re-read; use it for one-shot process-level arming)."""
    global _armed, _generation
    with _lock:
        _armed = {}
        _fired.clear()
        _generation += 1


def armed() -> Dict[str, List[dict]]:
    """Copy of the currently armed table (introspection/tests)."""
    with _lock:
        return {s: [dict(e) for e in v] for s, v in _load().items() if v}


def fired() -> List[dict]:
    """Log of every failpoint that fired since the last :func:`clear`."""
    with _lock:
        return [dict(e) for e in _fired]


def fingerprint() -> str:
    """Cache-key token: empty when nothing is armed (the common path),
    else a digest of the armed table INCLUDING remaining counts — a
    consumed fault changes the key, so a poisoned executable compiled
    under an armed fault is never served once the fault is spent."""
    with _lock:
        t = _load()
        live = sorted(
            f"{s}:{e['action']}@{e['remaining']}"
            for s, v in t.items() for e in v if e["remaining"] > 0
        )
        return ",".join(live)


def _fire(site: str, action: str) -> Optional[dict]:
    """Consume one armed hit of ``action`` at ``site``; None if unarmed."""
    with _lock:
        for entry in _load().get(site, ()):
            if entry["action"] == action and entry["remaining"] > 0:
                entry["remaining"] -= 1
                rec = {"site": site, "action": action,
                       "value": entry["value"]}
                _fired.append(rec)
                break
        else:
            return None
    from . import obs  # deferred: obs.ledger imports this module

    obs.event("fault.fired", site=site, action=action)
    return rec


def maybe_raise(site: str, exc: Optional[type] = None) -> None:
    """Raise if ``site`` is armed with a ``raise`` action.  ``exc``
    substitutes the exception class at sites whose callers only swallow
    specific types (e.g. ``OSError`` for best-effort IO)."""
    if _fire(site, "raise") is not None:
        cls = exc or InjectedFault
        raise cls(f"fault injected at {site}")


def poisoned(site: str) -> bool:
    """True (consuming one hit) if ``site`` is armed with ``poison``."""
    return _fire(site, "poison") is not None


def capacity_override(site: str) -> Optional[int]:
    """The injected capacity for ``site`` (consuming one hit), or None."""
    rec = _fire(site, "cap")
    return None if rec is None else int(rec["value"])
