"""The port's weldtrace (``repro_torch.core.obs``) against the JAX
package's, on the CPU: the span tracer, its Chrome-trace export and
tree rendering, the cost ledger, and the spans an evaluation emits.

The tracer cases of ``test_obs.py`` that need neither JAX nor
``Query.explain`` (which waits for the AOT slice), each run against
both packages; then the port's pipeline spans, the planner's
``kernelplan.candidate`` events and the measured replay's ledger
records, held against the reference's on the same inputs.  Nothing
here is timed against a limit: spans are checked for nesting and order
only, and a record's ``measured_ns`` only for being positive.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro_torch
from repro import obs as r_obs_top
from repro.core import obs as r_obs
from repro.core.obs import ledger as r_ledger, tracer as r_tracer
from repro_torch import obs as t_obs_top
from repro_torch.core import obs as t_obs
from repro_torch.core.obs import ledger as t_ledger, tracer as t_tracer

REF = SimpleNamespace(obs=r_obs, top=r_obs_top, ledger=r_ledger,
                      tracer=r_tracer)
PORT = SimpleNamespace(obs=t_obs, top=t_obs_top, ledger=t_ledger,
                       tracer=t_tracer)
PKGS = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])


@pytest.fixture(autouse=True)
def clean_tracer(tmp_path, monkeypatch):
    """Every test starts with tracing off, an empty span log, and a
    private ledger location."""
    monkeypatch.setenv("WELD_COST_LEDGER",
                       str(tmp_path / "cost_ledger.jsonl"))
    monkeypatch.setenv("WELD_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    for pkg in (PORT, REF):
        pkg.obs.disable()
        pkg.obs.clear()
    yield
    for pkg in (PORT, REF):
        pkg.obs.disable()
        pkg.obs.clear()


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------


@PKGS
def test_disabled_tracer_is_noop(pkg):
    obs = pkg.obs
    assert not obs.enabled()
    sp = obs.span("anything", tag=1)
    assert sp is obs.NOOP
    sp.set("x", 2).count("y")
    with obs.span("nested"):
        pass
    obs.event("evt")
    assert obs.spans() == []


@PKGS
def test_spans_nest_and_time(pkg):
    obs = pkg.obs
    obs.enable()
    with obs.span("outer", who="t") as outer:
        with obs.span("inner") as inner:
            inner.count("items", 3)
        with obs.span("inner2"):
            pass
    spans = obs.spans()
    assert [s.name for s in spans] == ["outer", "inner", "inner2"]
    assert outer.depth == 0 and inner.depth == 1
    assert outer.dur_ns >= inner.dur_ns >= 0
    assert inner.start_ns >= outer.start_ns
    assert inner.start_ns + inner.dur_ns <= outer.start_ns + outer.dur_ns
    assert inner.counters == {"items": 3}
    assert outer.tags == {"who": "t"}


@PKGS
def test_mark_and_spans_since(pkg):
    obs = pkg.obs
    obs.enable()
    with obs.span("before"):
        pass
    pos = obs.mark()
    with obs.span("after"):
        pass
    assert [s.name for s in obs.spans_since(pos)] == ["after"]


@PKGS
def test_event_is_instant_and_keeps_nesting(pkg):
    obs = pkg.obs
    obs.enable()
    with obs.span("parent"):
        obs.event("tick", n=1)
        with obs.span("child"):
            pass
    spans = {s.name: s for s in obs.spans()}
    assert spans["tick"].dur_ns == 0
    assert spans["tick"].depth == 1
    assert spans["child"].depth == 1  # the event did not stay on the stack


@PKGS
def test_env_enable(pkg, monkeypatch):
    tracer = pkg.tracer
    monkeypatch.setenv(tracer.ENV_TRACE, "1")
    assert tracer._env_enabled()
    monkeypatch.setenv(tracer.ENV_TRACE, "0")
    assert not tracer._env_enabled()
    monkeypatch.setenv(tracer.ENV_TRACE, "false")
    assert not tracer._env_enabled()
    monkeypatch.delenv(tracer.ENV_TRACE)
    assert not tracer._env_enabled()


@PKGS
def test_chrome_export_valid_and_monotonic(pkg, tmp_path):
    obs = pkg.obs
    obs.enable()
    with obs.span("a", kind="outer"):
        with obs.span("b"):
            obs.event("e")
    path = obs.dump_chrome(str(tmp_path / "trace.json"))
    evs = json.loads(open(path).read())["traceEvents"]
    assert [e["name"] for e in evs] == ["a", "b", "e"]
    for e in evs:
        assert e["ph"] == "X"
        assert e["ts"] >= 0 and e["dur"] >= 0
    a, b = evs[0], evs[1]
    assert b["ts"] >= a["ts"]
    assert b["ts"] + b["dur"] <= a["ts"] + a["dur"]
    assert evs[0]["args"]["kind"] == "outer"


@PKGS
def test_format_tree_renders_nesting(pkg):
    obs = pkg.obs
    obs.enable()
    with obs.span("root", q=1):
        with obs.span("leaf"):
            pass
    lines = obs.format_tree().splitlines()
    assert lines[0].startswith("root") and "q=1" in lines[0]
    assert lines[1].startswith("  leaf")


@PKGS
def test_unserializable_tag_survives_chrome_export(pkg):
    obs = pkg.obs
    obs.enable()
    with obs.span("s", obj=object()):
        pass
    data = obs.to_chrome()
    json.dumps(data)  # must not raise
    assert "object" in data["traceEvents"][0]["args"]["obj"]


@PKGS
def test_obs_alias(pkg):
    assert pkg.top.enable is pkg.obs.enable
    assert pkg.top.ledger is pkg.ledger


# ---------------------------------------------------------------------------
# cost ledger
# ---------------------------------------------------------------------------


@PKGS
def test_ledger_roundtrip_and_summary(pkg, tmp_path):
    ledger = pkg.ledger
    path = str(tmp_path / "l.jsonl")
    for i in range(3):
        rec = ledger.record("k1", "float64", 5000, predicted_ns=1000,
                            measured_ns=2000 + i, path=path)
        assert rec["bucket"] == 8192
    ledger.record("k2", "int64", 100, predicted_ns=None,
                  measured_ns=500, path=path)
    with open(path, "a") as f:
        f.write("{corrupt json\n")  # a truncated tail is skipped
    recs = ledger.read(path)
    assert len(recs) == 4
    rows = ledger.summarize(recs)
    by_kernel = {r["kernel"]: r for r in rows}
    assert by_kernel["k1"]["calls"] == 3
    assert by_kernel["k1"]["ratio"] == pytest.approx(2.0, abs=0.01)
    assert by_kernel["k1"]["log2_err"] == pytest.approx(1.0, abs=0.01)
    assert by_kernel["k2"]["ratio"] is None  # no prediction recorded
    txt = ledger.format_report(rows)
    assert "k1" in txt and "k2" in txt


def test_ledger_summaries_match_the_reference(tmp_path):
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        path = str(tmp_path / f"{name}.jsonl")
        for n, meas in ((100, 10), (5000, 2000), (5000, 2600), (1 << 20, 7)):
            pkg.ledger.record("k", "float64", n, predicted_ns=1000,
                              measured_ns=meas, path=path)
        rows = pkg.ledger.summarize(pkg.ledger.read(path))
        out[name] = [{k: v for k, v in r.items()} for r in rows]
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# the port's pipeline spans
# ---------------------------------------------------------------------------


def test_evaluate_emits_pipeline_spans():
    from repro_torch.core import runtime
    from repro_torch.frames import weldnp

    obs = t_obs
    runtime.clear_cache()
    obs.enable()
    x = weldnp.array(np.arange(1000, dtype=np.float64))
    ((x + 1.0) * 2.0).evaluate()
    names = [s.name for s in obs.spans()]
    for want in ("weld.evaluate", "encode", "cache.lookup", "optimize",
                 "pass.fusion", "jit_compile", "execute", "decode"):
        assert want in names, (want, names)
    root = next(s for s in obs.spans() if s.name == "weld.evaluate")
    assert root.depth == 0 and root.tags["from_cache"] is False
    # second run: a cache hit, so no compile-side spans
    pos = obs.mark()
    ((x + 1.0) * 2.0).evaluate()
    names2 = [s.name for s in obs.spans_since(pos)]
    assert "execute" in names2 and "optimize" not in names2
    hit = [s for s in obs.spans_since(pos) if s.name == "cache.lookup"]
    assert hit and hit[0].tags["hit"] is True


def test_recovery_shows_in_the_trace():
    """A recovered evaluation carries its retry span and step event."""
    from repro_torch.core import faults, runtime
    from repro_torch.frames import weldnp

    runtime.clear_cache()
    obs = t_obs
    obs.enable()
    faults.inject("decode", "poison", times=1)
    try:
        with pytest.warns(RuntimeWarning, match="weld recovery"):
            weldnp.array(np.arange(10, dtype=np.float64)).sum().evaluate()
    finally:
        faults.clear()
    names = [s.name for s in obs.spans()]
    for want in ("recovery.retry", "recovery.step", "fault.fired"):
        assert want in names, (want, names)
    root = next(s for s in obs.spans() if s.name == "weld.evaluate")
    assert root.tags["recovery.attempts"] == 2


def test_group_agg_accepts_collect_stats():
    from repro_torch.frames import weldrel

    rng = np.random.RandomState(7)
    left = weldrel.Table({"key": rng.randint(0, 128, 4096).astype(np.int64),
                          "price": rng.rand(4096)})
    st: dict = {}
    out = weldrel.Query(left).group_agg(
        [left.col("key")], {"s": (left.col("price"), "+")},
        capacity=256, kernelize="auto", collect_stats=st)
    assert out and "loops.before" in st


# ---------------------------------------------------------------------------
# the planner's candidate events and the measured replay
# ---------------------------------------------------------------------------


def _m1_join(w, mode, impl, **kw):
    rng = np.random.RandomState(11)
    left = w.Table({"k": rng.randint(0, 64, 2048).astype(np.int64),
                    "p": rng.rand(2048)})
    right = w.Table({"k": np.arange(48, dtype=np.int64),
                     "v": rng.rand(48)})
    return w.Query(left).join(right, on="k", kernelize=mode,
                              kernel_impl=impl, **kw)


def _traced(pkg, fn):
    obs = pkg.obs
    obs.enable()
    pos = obs.mark()
    try:
        out = fn()
        return out, obs.spans_since(pos)
    finally:
        obs.disable()


@pytest.mark.parametrize("mode", ["always", "auto"])
def test_candidate_events_match_the_reference(mode):
    """Each priced candidate is one ``kernelplan.candidate`` event, with
    the same kernels, sizes and (under "always") decisions as the
    reference's; under "auto" each event carries its gate's decision."""
    from repro.frames import weldrel as r_weldrel
    from repro_torch.core import runtime
    from repro_torch.frames import weldrel as t_weldrel

    runtime.clear_cache()
    events = {}
    for pkg, w, impl in ((PORT, t_weldrel, None), (REF, r_weldrel, "ref")):
        _, spans = _traced(pkg, lambda: _m1_join(w, mode, impl))
        events[id(pkg)] = [sp.tags for sp in spans
                           if sp.name == "kernelplan.candidate"]
    port, ref = events[id(PORT)], events[id(REF)]
    assert [(e["kernel"], e["n"]) for e in port] == \
        [(e["kernel"], e["n"]) for e in ref]
    assert {e["kernel"] for e in port} == {"dict_hash_build", "hash_probe"}
    if mode == "always":
        assert port == ref
    for e in port:
        assert isinstance(e["routed"], bool) and e["why"]


def test_traced_evaluate_appends_one_record_per_routed_call(tmp_path):
    """A traced kernelized evaluation replays the plan once under
    ``measure.replay``: one ``kernel.<name>`` span and one ledger record
    per routed call, with the planner's ``predicted_ns`` and dtype, as
    the reference records them."""
    from repro.frames import weldrel as r_weldrel
    from repro_torch.core import runtime
    from repro_torch.frames import weldrel as t_weldrel

    path = str(tmp_path / "cost_ledger.jsonl")
    runtime.clear_cache()
    records, kspans, stats = {}, {}, {}
    for pkg, w, impl in ((PORT, t_weldrel, None), (REF, r_weldrel, "ref")):
        before = len(pkg.ledger.read(path))
        st = stats[id(pkg)] = {}
        _, spans = _traced(pkg, lambda: _m1_join(w, "always", impl,
                                                 collect_stats=st))
        records[id(pkg)] = pkg.ledger.read(path)[before:]
        kspans[id(pkg)] = [sp for sp in spans
                           if sp.name.startswith("kernel.")]
        assert sum(sp.name == "measure.replay" for sp in spans) == 1
    port = records[id(PORT)]
    assert [r["kernel"] for r in port] == \
        [r["kernel"] for r in records[id(REF)]] == \
        ["dict_hash_build", "hash_probe"]
    for got, want in zip(port, records[id(REF)]):
        assert (got["dtype"], got["n"], got["bucket"]) == \
            (want["dtype"], want["n"], want["bucket"])
        assert got["measured_ns"] > 0 and got["predicted_ns"] > 0
    assert [sp.tags["measured_ns"] for sp in kspans[id(PORT)]] == \
        [r["measured_ns"] for r in port]
    # the record's dtype is the planner's meta["dtype"] formula
    from repro_torch.core import ir
    from repro_torch.core.kernelplan.planner import _np_dtype_of

    calls = [n for n in ir.walk(stats[id(PORT)]["plan.ir"])
             if isinstance(n, ir.KernelCall)]
    assert [r["dtype"] for r in port] == \
        [str(np.dtype(_np_dtype_of(kc.ret_ty))) for kc in calls]
    assert [r["predicted_ns"] for r in port] == \
        [dict(kc.params)["predicted_ns"] for kc in calls]


def test_untraced_evaluate_replays_nothing(tmp_path):
    from repro_torch.frames import weldrel as t_weldrel

    path = tmp_path / "cost_ledger.jsonl"
    st: dict = {}
    _m1_join(t_weldrel, "always", None, collect_stats=st)
    assert st["kernelize.matched"] == 2
    assert not path.exists()
    assert t_obs.spans() == []


def test_trace_smoke_tool_runs_on_the_cpu():
    """``tools/trace_smoke_torch.py --device cpu`` passes end to end."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, str(root / "tools" / "trace_smoke_torch.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ledger summary OK" in proc.stdout
