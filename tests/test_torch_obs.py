"""The port's weldtrace (``repro_torch.core.obs``) against the JAX
package's, on the CPU: the span tracer, its Chrome-trace export and
tree rendering, the cost ledger, and the spans an evaluation emits.

The tracer cases of ``test_obs.py`` that need neither JAX nor
``Query.explain`` (which waits for the AOT slice), each run against
both packages; then the port's pipeline spans.  Nothing here is timed
against a limit: spans are checked for nesting and order only.
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
                 "pass.fusion", "execute", "decode"):
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
