"""Ledger-calibrated cost overlay: measured medians over roofline math.

The roofline hooks in ``kernelplan.cost`` price every kernel candidate
from synthetic byte/flop constants.  Once the weldtrace cost ledger
(``core/obs/ledger.py``) has seen real traffic, those constants are the
weakest link — this module closes the ROADMAP's calibration loop by
reading the ledger's **median measured time per (kernel, dtype,
size-bucket)** and letting the cost gate substitute it for the analytic
kernel-side estimate.  The gate's ``why`` string then carries
``source=measured`` (vs ``source=roofline``), visible in
``Query.explain()``'s cost-gate decision table.

Precedence: a measured median wins over the roofline estimate iff the
ledger holds at least ``$WELD_CALIBRATE_MIN`` (default 3) records for
the exact ``(kernel, dtype, bucket)`` group — a single noisy launch
must not flip routing.  Disable entirely with ``WELD_CALIBRATE=0``.

Medians are cached in-process keyed on the ledger file's
``(mtime_ns, size)`` signature, so serving traffic that appends records
(measured replay) is picked up on the next *cold* compile without
re-parsing the JSONL on every estimate.  Note calibration state is
deliberately NOT part of the compile-cache key: a cached executable
keeps serving the plan it was compiled with (compile amortization wins
over calibration freshness); new medians take effect on the next cold
compile — ``runtime.clear_cache()`` forces the switchover.

Like :mod:`~repro_torch.core.obs.ledger`, this module reads only the
ledger, so ``tools/trace_smoke_torch.py --calibrate-dump`` prints its
table without building or loading a kernel.

Where the port departs from the reference, and why:

* a group is ``(kernel, dtype, bucket, impl, device)``, the record's
  ``impl`` and the name of the device it ran on (the card's, or
  ``cpu``): the plain versions' times on the CPU never price a card's
  kernels, nor one card's times another's.  The gate looks a group up
  with the impl the compile resolved and the default device's name; a
  caller that gives no impl (a bare ``cost.estimate``) reads the group
  of records that name none;
* on a card ``measured_ns`` is the device time inside the call's kernel
  entries (``kernels/_count.device_clock``), the clock of the roofline's
  generic-side figure it is compared with.  The replay's host span
  (``host_ns``), which holds the staged bodies both routes evaluate and
  the adapter's host path, never prices a route.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from ..obs import ledger

__all__ = [
    "enabled",
    "min_samples",
    "medians",
    "measured_ns",
    "invalidate",
]

ENV_CALIBRATE = "WELD_CALIBRATE"
ENV_MIN_SAMPLES = "WELD_CALIBRATE_MIN"
DEFAULT_MIN_SAMPLES = 3

#: (kernel, dtype, bucket, impl, device) -> {"measured_ns": median,
#: "calls": count}
Group = Tuple[str, str, int, Optional[str], Optional[str]]
Medians = Dict[Group, Dict[str, float]]

_lock = threading.Lock()
_cached: Optional[Tuple[str, Optional[Tuple[int, int]], Medians]] = None


def enabled() -> bool:
    return os.environ.get(ENV_CALIBRATE, "1").lower() not in (
        "0", "off", "false", "no"
    )


def min_samples() -> int:
    try:
        return max(1, int(os.environ.get(ENV_MIN_SAMPLES,
                                         DEFAULT_MIN_SAMPLES)))
    except ValueError:
        return DEFAULT_MIN_SAMPLES


def _sig(path: str) -> Optional[Tuple[int, int]]:
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def invalidate() -> None:
    """Drop the in-process medians cache (tests / explicit reload)."""
    global _cached
    with _lock:
        _cached = None


def _compute(records: List[dict]) -> Medians:
    groups: Dict[Group, List[float]] = {}
    for r in records:
        kernel = r.get("kernel")
        dtype = r.get("dtype")
        bucket = r.get("bucket")
        meas = r.get("measured_ns")
        if not kernel or not dtype or not bucket or not meas:
            continue
        groups.setdefault((str(kernel), str(dtype), int(bucket),
                           r.get("impl"), r.get("device")),
                          []).append(float(meas))
    out: Medians = {}
    for key, xs in groups.items():
        xs.sort()
        m = len(xs) // 2
        med = xs[m] if len(xs) % 2 else (xs[m - 1] + xs[m]) / 2.0
        out[key] = {"measured_ns": med, "calls": len(xs)}
    return out


def medians(path: Optional[str] = None) -> Medians:
    """Median measured_ns per (kernel, dtype, bucket, impl, device) — the
    exact table
    the cost gate consumes (all groups, including under-sampled ones;
    eligibility is applied in :func:`measured_ns`)."""
    global _cached
    p = path or ledger.ledger_path()
    sig = _sig(p)
    with _lock:
        if _cached is not None and _cached[0] == p and _cached[1] == sig:
            return _cached[2]
    if sig is None:
        table: Medians = {}
    else:
        table = _compute(ledger.read(p))
    with _lock:
        _cached = (p, sig, table)
    return table


def measured_ns(kernel: str, dtype: str, n: int,
                path: Optional[str] = None, impl: Optional[str] = None,
                device: Optional[str] = None
                ) -> Optional[Tuple[float, int]]:
    """``(median_measured_ns, calls)`` for the bucket covering ``n`` of
    the records of ``impl`` on ``device``, or None when the gate must
    stay on the roofline (calibration off, no ledger, or fewer than
    :func:`min_samples` records)."""
    if not enabled() or not kernel or not dtype or not n or n <= 0:
        return None
    entry = medians(path).get(
        (str(kernel), str(dtype), ledger.size_bucket(int(n)), impl, device))
    if entry is None or entry["calls"] < min_samples():
        return None
    return entry["measured_ns"], entry["calls"]
