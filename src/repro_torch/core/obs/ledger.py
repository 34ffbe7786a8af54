"""Persistent predicted-vs-measured cost ledger.

Every kernelized execution with tracing enabled appends one JSONL record
per kernel launch::

    {"kernel": "group_probe", "dtype": "float64", "n": 262144,
     "bucket": 262144, "predicted_ns": 181000, "measured_ns": 240917,
     "impl": "ref", "params": {"block": 1024}, "ts": 1754600000.0,
     "device": "cpu", "host_ns": 240917}

``impl`` and ``device`` (the card's name, or ``cpu``) say where the call
ran: the calibration groups records by them, so the plain versions'
times on the CPU never price a card's kernels.  On a card
``measured_ns`` is the device time inside the call's kernel entries and
``host_ns`` the host span around the whole call.

The file lives next to the autotune cache (default
``~/.cache/weld-repro/cost_ledger.jsonl``) and is overridable via
``$WELD_COST_LEDGER``.  ``tools/cost_report.py`` summarizes calibration
error per ``(kernel, dtype, size-bucket)`` group — the dataset the
ROADMAP's measured-cost serving gate will train on.

This module deliberately avoids importing the kernelplan/torch stack so
the report CLI can read ledgers from a bare Python interpreter; the
path and bucketing logic mirror ``kernelplan.autotune`` (``ENV_CACHE``,
``MIN_BUCKET``) and must be kept in sync with it.
"""
from __future__ import annotations

import json
import math
import os
import time
import warnings
from typing import Any, Dict, List, Optional

__all__ = [
    "ledger_path",
    "record",
    "read",
    "summarize",
    "format_report",
]

ENV_LEDGER = "WELD_COST_LEDGER"
_ENV_AUTOTUNE_CACHE = "WELD_AUTOTUNE_CACHE"  # autotune.ENV_CACHE
_MIN_BUCKET = 1024  # autotune.MIN_BUCKET


def ledger_path() -> str:
    override = os.environ.get(ENV_LEDGER)
    if override:
        return override
    # default: sit next to the autotune cache so both calibration
    # artifacts live (and get wiped) together
    at = os.environ.get(_ENV_AUTOTUNE_CACHE)
    # abspath first: a bare-filename WELD_AUTOTUNE_CACHE has dirname ""
    # which would silently drop the ledger into whatever cwd is
    base = os.path.dirname(os.path.abspath(at)) if at else os.path.join(
        os.path.expanduser("~"), ".cache", "weld-repro"
    )
    return os.path.join(base, "cost_ledger.jsonl")


def size_bucket(n: int) -> int:
    """Next power of two ≥ n, floored at 1024 (mirrors autotune)."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def record(kernel: str, dtype: str, n: int, predicted_ns: Optional[int],
           measured_ns: int, impl: Optional[str] = None,
           params: Optional[Dict[str, Any]] = None,
           path: Optional[str] = None, device: Optional[str] = None,
           host_ns: Optional[int] = None) -> Optional[dict]:
    """Append one launch record.  Best-effort: IO failures are swallowed
    so observability can never break an execution."""
    rec = {
        "kernel": kernel,
        "dtype": str(dtype),
        "n": int(n),
        "bucket": size_bucket(int(n)) if n and n > 0 else 0,
        "predicted_ns": int(predicted_ns) if predicted_ns else None,
        "measured_ns": int(measured_ns),
        "impl": impl,
        "params": dict(params) if params else {},
        "ts": time.time(),
        "device": device,
    }
    if host_ns is not None:
        rec["host_ns"] = int(host_ns)
    p = path or ledger_path()
    try:
        # the io.ledger failpoint proves the best-effort contract: an
        # injected OSError must drop the record, never the execution
        from .. import faults

        faults.maybe_raise("io.ledger", exc=OSError)
        d = os.path.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        return None
    return rec


def read(path: Optional[str] = None) -> List[dict]:
    """Load all records, skipping corrupt lines (a crashed writer can
    leave a truncated tail — a torn write must never crash the reader).

    Malformed lines raise ONE RuntimeWarning naming the file and the
    first bad line number (mirroring the autotune corrupt-cache idiom)
    so the torn tail is visible instead of silently shrinking the
    calibration dataset."""
    p = path or ledger_path()
    out: List[dict] = []
    bad = 0
    first_bad = None
    first_err = None
    try:
        with open(p) as f:
            for lineno, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    bad += 1
                    if first_bad is None:
                        first_bad, first_err = lineno, e
                    continue
                if isinstance(rec, dict) and "kernel" in rec:
                    out.append(rec)
    except OSError:
        pass
    if bad:
        warnings.warn(
            f"cost ledger {p} has {bad} malformed line"
            f"{'s' if bad != 1 else ''} (first at line {first_bad}: "
            f"{first_err}); skipping them — likely a writer killed "
            "mid-append; truncate or delete the file to silence this "
            "warning",
            RuntimeWarning, stacklevel=2,
        )
    return out


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2


def summarize(records: List[dict]) -> List[dict]:
    """Group by (kernel, dtype, bucket); report median predicted/measured
    times, their ratio, and the mean |log2 ratio| calibration error."""
    groups: Dict[tuple, List[dict]] = {}
    for r in records:
        key = (r.get("kernel"), r.get("dtype"), r.get("bucket"))
        groups.setdefault(key, []).append(r)
    rows = []
    for (kernel, dtype, bucket), rs in sorted(groups.items(),
                                              key=lambda kv: str(kv[0])):
        meas = [r["measured_ns"] for r in rs if r.get("measured_ns")]
        pred = [r["predicted_ns"] for r in rs if r.get("predicted_ns")]
        both = [(r["predicted_ns"], r["measured_ns"]) for r in rs
                if r.get("predicted_ns") and r.get("measured_ns")]
        ratios = [m / p for p, m in both if p > 0]
        log2err = [abs(math.log2(x)) for x in ratios if x > 0]
        rows.append({
            "kernel": kernel,
            "dtype": dtype,
            "bucket": bucket,
            "calls": len(rs),
            "predicted_us": round(_median(pred) / 1e3, 2) if pred else None,
            "measured_us": round(_median(meas) / 1e3, 2) if meas else None,
            "ratio": round(_median(ratios), 3) if ratios else None,
            "log2_err": round(sum(log2err) / len(log2err), 3)
            if log2err else None,
        })
    return rows


def format_report(rows: List[dict]) -> str:
    """Fixed-width table of :func:`summarize` rows.  ``ratio`` is
    measured/predicted (>1 ⇒ the roofline is optimistic); ``log2_err``
    is the mean absolute log2 of that ratio (0 = perfectly calibrated,
    1 = off by 2x on average)."""
    hdr = (f"{'kernel':<24} {'dtype':<10} {'bucket':>10} {'calls':>6} "
           f"{'pred_us':>10} {'meas_us':>10} {'ratio':>8} {'log2_err':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        def fmt(v, spec):
            return format(v, spec) if v is not None else "-"
        lines.append(
            f"{r['kernel']:<24} {r['dtype']:<10} {r['bucket']:>10} "
            f"{r['calls']:>6} {fmt(r['predicted_us'], '>10.2f'):>10} "
            f"{fmt(r['measured_us'], '>10.2f'):>10} "
            f"{fmt(r['ratio'], '>8.3f'):>8} {fmt(r['log2_err'], '>9.3f'):>9}"
        )
    return "\n".join(lines)
