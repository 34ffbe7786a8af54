#!/usr/bin/env python
"""Trace smoke of the PyTorch port (the counterpart of trace_smoke.py).

Runs a kernelized m:n hash join and a group-by through ``repro_torch``
with tracing on, then asserts the observability surface end to end:

* the Chrome-trace export is valid JSON with the expected span names
  (``jit_compile``, ``measure.replay`` and a ``kernel.<name>`` span per
  routed call among them) and monotonic nested spans;
* the measured replay wrote one cost-ledger record per routed call of
  the join, each with the planner's ``predicted_ns`` and a positive
  ``measured_ns``;
* ``Query.explain(analyze=True)`` shows ``group_build``/``group_probe``
  launches with both predicted and measured times;
* the ledger's per-(kernel, dtype, size-bucket) summary — the report
  ``tools/cost_report_torch.py`` prints, made by its own functions —
  covers both join kernels.

State (ledger, autotune cache, kernel health file) is confined to a temp
directory.

    PYTHONPATH=src python tools/trace_smoke_torch.py [--device cpu]

The cost gate's view of a ledger is ``tools/cost_report_torch.py
--calibrate-dump``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_TOOLS, "..", "src"))

_td = tempfile.mkdtemp(prefix="weld-trace-smoke-torch-")
os.environ["WELD_COST_LEDGER"] = os.path.join(_td, "cost_ledger.jsonl")
os.environ["WELD_KERNEL_HEALTH"] = os.path.join(_td, "kernel_health.json")
os.environ["WELD_AUTOTUNE_CACHE"] = os.path.join(_td, "autotune.json")

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from cost_report_torch import report_text, summary  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.frames import weldrel  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="evaluation device (default: cuda)")
    args = ap.parse_args(argv)
    repro_torch.set_default_device(args.device)
    obs.enable()

    n, k, fanout = 8192, 64, 4
    rng = np.random.RandomState(7)
    rkey = np.repeat(np.arange(k, dtype=np.int64), fanout)
    right = weldrel.Table({"key": rkey, "rate": rng.rand(rkey.size)})
    left = weldrel.Table({
        "key": rng.randint(0, 2 * k, n).astype(np.int64),
        "price": rng.rand(n),
    })

    # -- m:n join, traced: replay spans and ledger records --------------
    ledger_path = os.environ["WELD_COST_LEDGER"]
    st: dict = {}
    weldrel.Query(left).join(right, on="key", kernelize="always",
                             collect_stats=st)
    routed = st["kernelplan"]["routed"]
    assert set(routed) == {"group_build", "group_probe"}, routed
    recs = obs.ledger.read(ledger_path)
    assert [r["kernel"] for r in recs] == ["group_build", "group_probe"], \
        recs
    for r in recs:
        assert r["predicted_ns"] and r["measured_ns"] > 0, r
    print("measured replay: " + ", ".join(
        f"{r['kernel']} predicted {r['predicted_ns']} ns, measured "
        f"{r['measured_ns']} ns" for r in recs))

    # -- EXPLAIN ANALYZE: predicted and measured per launch -------------
    rep = weldrel.Query(left).explain(analyze=True).join(
        right, on="key", kernelize="always")
    launches = {r["kernel"]: r for r in rep.kernel_spans()}
    for kern in ("group_build", "group_probe"):
        r = launches.get(kern)
        assert r, f"missing measured {kern} launch: {launches}"
        assert r["predicted_ns"] and r["measured_ns"], (kern, r)
    text = rep.render()
    for needle in ("EXPLAIN ANALYZE", "kernel[group_build]",
                   "predicted vs measured", "span tree"):
        assert needle in text, needle
    obs.enable()  # explain(analyze=True) restores what it found: on
    print("explain(analyze=True): " + ", ".join(
        f"{k} predicted {r['predicted_ns']} ns, measured "
        f"{r['measured_ns']} ns" for k, r in sorted(launches.items())))

    # -- group-by query, plain tracing ----------------------------------
    grouped = weldrel.Query(left).group_agg(
        [left.col("key")], {"s": (left.col("price"), "+")},
        capacity=2 * k, kernelize="auto")
    assert grouped, "group-by returned nothing"

    # -- trace export: valid JSON, expected names, monotonic nesting ----
    trace_path = os.path.join(_td, "trace.json")
    obs.dump_chrome(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    for want in ("weld.evaluate", "optimize", "pass.fusion", "kernelplan",
                 "kernelplan.candidate", "bounds", "jit_compile",
                 "execute", "measure.replay", "decode", "cache.lookup",
                 "kernel.group_build", "kernel.group_probe"):
        assert want in names, f"trace missing span {want!r}: {sorted(names)}"
    assert all(e["ph"] in ("X", "i") and e.get("dur", 0) >= 0
               for e in events)
    stack: list = []
    for sp in obs.spans():
        while stack and sp.depth <= stack[-1].depth:
            stack.pop()
        if stack:
            parent = stack[-1]
            end = parent.start_ns + (parent.dur_ns or 0)
            assert sp.start_ns >= parent.start_ns, (sp.name, parent.name)
            assert sp.start_ns + (sp.dur_ns or 0) <= end + 1_000_000, \
                (sp.name, parent.name)
        stack.append(sp)
    print(f"chrome trace OK: {len(events)} events, nesting monotonic")

    # -- the ledger's summary (what tools/cost_report_torch.py prints) --
    text = report_text(summary(ledger_path))
    assert "group_build" in text and "group_probe" in text, text
    print("ledger summary OK:")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
