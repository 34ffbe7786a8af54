#!/usr/bin/env python
"""Summarize the weldtrace cost ledger of the PyTorch port: calibration
error per kernel (the counterpart of ``tools/cost_report.py``).

The ledger (``~/.cache/weld-repro/cost_ledger.jsonl`` by default, or
``$WELD_COST_LEDGER``) accumulates one record per measured kernel launch
— the planner's roofline ``predicted_ns`` next to the replay's
``measured_ns``.  This CLI groups records by (kernel, dtype,
size-bucket) and reports median predicted/measured times, their ratio,
and the mean |log2 ratio| calibration error, through
``repro_torch.core.obs.ledger``.

    PYTHONPATH=src python tools/cost_report_torch.py [--ledger PATH]
        [--kernel NAME] [--json] [--calibrate-dump]

``--calibrate-dump`` prints the cost gate's own view instead, through
``repro_torch.core.kernelplan.calibrate``: one row per (kernel, dtype,
size bucket, impl, device) — the port groups by where a call ran, so a
CPU time never prices a card's kernel — with the median the gate would
overlay and whether the group clears ``$WELD_CALIBRATE_MIN``.  It reads
ledgers only: nothing runs on a device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
)

from repro_torch.core.obs import ledger  # noqa: E402


def calibrate_dump(path: str, kernel: Optional[str] = None) -> dict:
    """The gate's own view of the ledger at ``path``: one row per
    (kernel, dtype, size bucket, impl, device) with the median it would
    overlay and whether the group clears the sample floor.  It goes
    through ``kernelplan.calibrate`` itself, so what it prints is what
    ``cost.estimate`` would use."""
    from repro_torch.core.kernelplan import calibrate

    floor = calibrate.min_samples()
    rows = []
    groups = sorted(calibrate.medians(path).items(),
                    key=lambda kv: tuple(str(x) for x in kv[0]))
    for (kern, dtype, bucket, impl, device), g in groups:
        if kernel and kern != kernel:
            continue
        rows.append({"kernel": kern, "dtype": dtype, "bucket": bucket,
                     "impl": impl, "device": device, "calls": g["calls"],
                     "measured_ns_median": g["measured_ns"],
                     "eligible": g["calls"] >= floor,
                     "min_samples": floor})
    return {"ledger": path, "enabled": calibrate.enabled(), "groups": rows}


def summary(path: str, kernel: Optional[str] = None) -> dict:
    """``{"ledger", "records", "groups"}``: the ledger's records at
    ``path`` (those of ``kernel`` only, if given) grouped by
    ``ledger.summarize``."""
    records = ledger.read(path)
    if kernel:
        records = [r for r in records if r.get("kernel") == kernel]
    return {"ledger": path, "records": len(records),
            "groups": ledger.summarize(records)}


def report_text(data: dict) -> str:
    """The report of a :func:`summary`, as the CLI prints it."""
    head = f"# ledger: {data['ledger']} ({data['records']} records)"
    if not data["groups"]:
        return head + "\n# no records — run a kernelized query with " \
                      "WELD_TRACE=1"
    return head + "\n" + ledger.format_report(data["groups"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $WELD_COST_LEDGER or "
                         "next to the autotune cache)")
    ap.add_argument("--kernel", default=None,
                    help="only report this kernel")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary rows as JSON")
    ap.add_argument("--calibrate-dump", action="store_true",
                    help="emit the per-(kernel, dtype, bucket, impl, "
                         "device) medians the serving cost gate overlays "
                         "on the roofline estimates, as JSON rows")
    args = ap.parse_args(argv)

    path = args.ledger or ledger.ledger_path()
    if args.calibrate_dump:
        print(json.dumps(calibrate_dump(path, args.kernel), indent=1))
        return 0
    data = summary(path, args.kernel)
    if args.json:
        print(json.dumps(data, indent=1))
    else:
        print(report_text(data))
    return 0


if __name__ == "__main__":
    sys.exit(main())
