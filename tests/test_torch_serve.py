"""The port's AOT staging, compile cache, ``QueryServer``, autotuner and
ledger calibration against the JAX package's, on the CPU.

The cases of ``test_serve.py`` run against ``repro_torch`` unchanged
(``torch_refcases``), except ``test_first_encounter_tuning_files_one_
entry``, which makes the reference tune through ``kernel_impl=
"interpret"`` (the Pallas bodies on the CPU).  The port's plain versions
take no launch parameter, so the CPU never tunes; its counterpart below
makes the tuner time a patched ``make_bench`` and holds the refile to
one cache entry.  Then cross-package cases: the same staged queries
through ``repro.frames.weldrel`` and the port (join columns exact, f64
rtol 1e-12), ``CompiledQuery.run`` after a rebind against a fresh
evaluation in both packages; the autotuner's key, its impl resolution
and its failure rule; and the launch counters under the server's
threads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.frames import weldrel as r_weldrel
from repro_torch.core import faults as t_faults, obs as t_obs
from repro_torch.core import runtime as t_runtime
from repro_torch.core.errors import ResourceError as t_ResourceError
from repro_torch.core.kernelplan import autotune as t_autotune
from repro_torch.core.kernelplan import calibrate as t_calibrate
from repro_torch.core.kernelplan import registry as t_registry
from repro_torch.core.lazy import Evaluate as t_Evaluate
from repro_torch.core.serve import QueryServer as t_QueryServer
from repro_torch.frames import weldnp as t_weldnp
from repro_torch.frames import weldrel as t_weldrel
from repro_torch.kernels import ops as t_ops
from torch_refcases import port_cases

port_cases("test_serve", globals(),
           leave_out=("test_first_encounter_tuning_files_one_entry",))


@pytest.fixture
def tunes_on_cpu(monkeypatch):
    """The tuner times on the CPU: a compile tunes its plan as for
    ``impl="cuda"`` and the filter-reduce spec's bench is a no-op (the
    plain versions the CPU runs ignore the grid cap)."""
    spec = dataclasses.replace(t_registry.get("filter_reduce_sum"),
                               make_bench=lambda m, p, i: (lambda: None))
    monkeypatch.setitem(t_registry._REGISTRY, "filter_reduce_sum", spec)
    real = t_autotune.tune_plan
    monkeypatch.setattr(t_autotune, "tune_plan",
                        lambda e, impl, stats=None: real(e, "cuda", stats))
    return spec


def test_first_encounter_tuning_files_one_entry_port(tunes_on_cpu):
    """First-encounter tuning refreshes the fingerprint mid-compile; the
    program is filed under the refreshed key only (the reference's case,
    with the tuner timing a patched bench instead of interpret mode)."""
    rng = np.random.default_rng(0)
    x = t_weldnp.array(rng.normal(size=4096))
    t_runtime.clear_cache()
    st = {}
    t_Evaluate((x * 2.0).sum().obj, kernelize="always", collect_stats=st)
    events = st.get("kernelplan", {}).get("autotune")
    assert events and events[0]["cached"] is False, events
    assert events[0]["params"]["max_blocks"] in \
        tunes_on_cpu.tune_space["max_blocks"]
    assert events[0]["us"] is not None and events[0]["default_us"] is not None
    assert t_runtime.cache_size() == 1, \
        "refile must evict the stale pre-tuning key (leak: size grew to 2)"
    misses = t_runtime.cache_stats()["cache.misses"]
    res = t_Evaluate((x * 2.0).sum().obj, kernelize="always")
    assert res.from_cache
    assert t_runtime.cache_stats()["cache.misses"] == misses
    assert t_runtime.cache_size() == 1


# ---------------------------------------------------------------------------
# the autotuner's key, impl resolution and failure rule
# ---------------------------------------------------------------------------


def test_autotune_key_names_the_device(tunes_on_cpu):
    params, cached = t_autotune.tune(tunes_on_cpu, {"n": 3000,
                                                    "dtype": np.float64},
                                     impl="cuda")
    assert not cached
    (key,) = t_autotune._load()
    assert key.startswith("filter_reduce_sum|float64|4096|cuda|")
    assert key.endswith("|cpu")
    assert t_autotune.lookup("filter_reduce_sum", np.float64, 3000,
                             "cuda") == params


def test_autotune_none_impl_resolves_by_device(monkeypatch):
    assert t_autotune.resolve_impl(None) == "ref"
    assert t_autotune.resolve_impl("cuda") == "cuda"
    spec = t_registry.get("filter_reduce_sum")
    params, cached = t_autotune.tune(spec, {"n": 4096, "dtype": np.float64},
                                     impl=None)
    # on the CPU None is the plain versions: the defaults, untimed
    assert params == spec.tune_defaults and not cached
    assert t_autotune._load() == {}
    from repro_torch import device as t_device

    monkeypatch.setattr(t_device, "default_device",
                        lambda: torch.device("cuda"))
    assert t_autotune.resolve_impl(None) == "cuda"


def test_autotune_real_candidate_failure_raises():
    """A failure that is not the injected timer fault raises as it is and
    records nothing: here the bench's kernel entry refuses CPU tensors
    for impl="cuda"."""
    spec = t_registry.get("filter_reduce_sum")
    with pytest.raises(ValueError, match="cannot serve a tensor on cpu"):
        t_autotune.tune(spec, {"n": 2048, "dtype": np.float64}, impl="cuda")
    assert t_autotune._load() == {}


def test_autotune_injected_timer_fault_skips_one_candidate(tunes_on_cpu):
    t_faults.inject("autotune.time", "raise", times=1)
    t_obs.enable()
    try:
        params, _ = t_autotune.tune(tunes_on_cpu, {"n": 2048,
                                                   "dtype": np.float64},
                                    impl="cuda")
        evs = [sp for sp in t_obs.spans() if sp.name == "autotune.candidate"]
    finally:
        t_obs.disable()
        t_obs.clear()
        t_faults.clear()
    skipped = [e for e in evs if e.tags.get("skipped")]
    assert len(skipped) == 1
    assert len(evs) == len(tunes_on_cpu.tune_space["max_blocks"])
    assert params["max_blocks"] in tunes_on_cpu.tune_space["max_blocks"]


# ---------------------------------------------------------------------------
# the same staged queries through both packages
# ---------------------------------------------------------------------------


def _tables_np(seed=0, n=6000, k=80):
    rng = np.random.default_rng(seed)
    probe = {"k": rng.integers(0, 2 * k, n), "x": rng.normal(size=n)}
    build = {"k": np.arange(k), "w": rng.normal(size=k)}
    dup = {"k": np.repeat(np.arange(k // 2), 3),
           "w": rng.normal(size=3 * (k // 2))}
    return probe, build, dup


def _staged(weldrel, which, probe, build, dup, mode):
    t = weldrel.Table(dict(probe))
    q = weldrel.Query(t)
    if which == "join_m1":
        return q.stage().join(weldrel.Table(dict(build)), on="k",
                              validate="m:1", kernelize=mode)
    if which == "join_mn":
        return q.stage().join(weldrel.Table(dict(dup)), on="k",
                              kernelize=mode)
    if which == "group_agg":
        return q.stage().group_agg([t.col("k")], {"s": (t.col("x"), "+")},
                                   capacity=256, kernelize=mode)
    return q.filter(t.col("x") > 0.0).stage().agg(
        {"s": (t.col("x"), "+"), "m": (t.col("x"), "max")}, kernelize=mode)


def _held(got, want, what):
    if isinstance(want, r_weldrel.Table):
        assert sorted(got.cols) == sorted(want.cols), what
        for c in want.cols:
            g = np.asarray(t_weldrel._host(got.cols[c]))
            w = np.asarray(r_weldrel._host(want.cols[c]))
            assert g.dtype == w.dtype, (what, c)
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{c}")
        return
    assert sorted(got) == sorted(want), what
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                   np.asarray(want[key], dtype=float),
                                   rtol=1e-12, err_msg=f"{what}[{key}]")


@pytest.mark.parametrize("mode", ["always", "auto"])
@pytest.mark.parametrize("which", ["join_m1", "join_mn", "group_agg", "agg"])
def test_staged_queries_equal_across_packages(which, mode):
    probe, build, dup = _tables_np()
    want = _staged(r_weldrel, which, probe, build, dup, mode).compile().run()
    got = _staged(t_weldrel, which, probe, build, dup, mode).compile().run()
    _held(got, want, f"{which}[{mode}]")


@pytest.mark.parametrize("which", ["join_m1", "join_mn", "group_agg", "agg"])
def test_rebound_compiled_query_equals_fresh_evaluate_both_packages(which):
    probe, build, dup = _tables_np(seed=1)
    probe2, build2, dup2 = _tables_np(seed=2)
    right2 = {"join_m1": build2, "join_mn": dup2}.get(which)
    outs = {}
    for name, weldrel in (("ref", r_weldrel), ("port", t_weldrel)):
        cq = _staged(weldrel, which, probe, build, dup, "always").compile()
        cq.run()
        rebind = {"table": weldrel.Table(dict(probe2))}
        if right2 is not None:
            rebind["right"] = weldrel.Table(dict(right2))
        again = cq.run(**rebind)
        fresh = _staged(weldrel, which, probe2, build2, dup2,
                        "always").compile().run()
        if isinstance(fresh, weldrel.Table):
            fresh_cols = {c: np.asarray(weldrel._host(v))
                          for c, v in fresh.cols.items()}
            for c, v in fresh_cols.items():
                np.testing.assert_array_equal(
                    np.asarray(weldrel._host(again.cols[c])), v,
                    err_msg=f"{name}.{which}.{c}")
        else:
            assert again == fresh, (name, which)
        outs[name] = again
    _held(outs["port"], outs["ref"], f"{which} rebound")


def test_port_compiled_run_takes_device_tensors_without_a_copy():
    probe, build, _ = _tables_np(seed=3)
    cq = _staged(t_weldrel, "join_m1", probe, build, None, "always").compile()
    arrays = list(cq.handle._low.arrays)
    bound = cq.handle.bind(arrays)
    assert all(b.data_ptr() == a.data_ptr() for a, b in zip(arrays, bound))
    with pytest.raises(ValueError, match="signature"):
        cq.handle.bind([a[:-1] for a in arrays])


# ---------------------------------------------------------------------------
# the server's threads and the kernels' counters
# ---------------------------------------------------------------------------


def test_server_counts_every_call_under_eight_threads():
    """32 requests of one routed group-by across 8 worker threads: every
    wrapper call of every request is counted (32 times the serial run's
    counts), results equal the serial run bitwise, one compile."""
    probe, _, _ = _tables_np(seed=4)
    t_ops.reset_counts()
    serial = _staged(t_weldrel, "group_agg", probe, None, None,
                     "always").compile().run()
    once = t_ops.counts()
    assert sum(p for _, p in once.values()) > 0, once
    t_runtime.clear_cache()
    reqs = [_staged(t_weldrel, "group_agg", probe, None, None, "always")
            for _ in range(32)]
    t_ops.reset_counts()
    with t_QueryServer(workers=8) as srv:
        outs = srv.map(reqs)
        st = srv.stats()
    assert t_ops.counts() == {k: (32 * a, 32 * p)
                              for k, (a, p) in once.items()}
    assert st["serve.completed"] == 32 and st["cache.misses"] == 1
    for got in outs:
        assert got == serial


def test_server_sheds_one_byte_below_the_certified_peak():
    probe, build, _ = _tables_np(seed=5)
    st = {}
    _staged(t_weldrel, "join_m1", probe, build, None,
            "always").compile(collect_stats=st)
    peak = st["bounds.peak_bytes"]
    t_runtime.clear_cache()
    sq = _staged(t_weldrel, "join_m1", probe, build, None, "always")
    sq.memory_limit = peak - 1
    t_ops.reset_counts()
    with t_QueryServer(workers=2) as srv:
        with pytest.raises(t_ResourceError, match="at admission"):
            srv.run(sq)
        stats = srv.stats()
    assert stats["serve.shed"] == 1 and stats["serve.errors"] == 0
    assert all(v == (0, 0) for v in t_ops.counts().values())
    assert t_runtime.cache_size() == 0


def test_calibrated_explain_shows_measured_source(monkeypatch):
    """A traced run writes the ledger; after ``clear_cache`` the next
    "auto" compile prices each group with >= 3 records from its median
    and ``explain()`` says ``source=measured``."""
    monkeypatch.setenv("WELD_CALIBRATE_MIN", "1")
    probe, build, _ = _tables_np(seed=6)
    t_obs.enable()
    try:
        _staged(t_weldrel, "join_m1", probe, build, None,
                "always").compile().run()
    finally:
        t_obs.disable()
        t_obs.clear()
    t_calibrate.invalidate()
    assert t_calibrate.medians()
    t_runtime.clear_cache()
    cq = _staged(t_weldrel, "join_m1", probe, build, None, "auto").compile()
    costs = cq.explain().costs()
    assert costs and all(c["source"] == "measured" for c in costs), costs
    assert "source=measured" in cq.explain().render()


# ---------------------------------------------------------------------------
# the calibration's groups and clock, the card's gate, the tuner's winner
# ---------------------------------------------------------------------------


def test_calibration_groups_by_impl_and_device(tmp_path, monkeypatch):
    """Records of another impl or device never price a compile: the CPU's
    plain versions never calibrate a card's gate, nor a card the CPU's.
    A caller that names no impl reads the records that name none."""
    from repro_torch.core.kernelplan import cost as t_cost
    from repro_torch.core.obs import ledger as t_ledger

    monkeypatch.setenv("WELD_COST_LEDGER", str(tmp_path / "l.jsonl"))
    spec = t_registry.get("filter_reduce_sum")
    meta = {"kernel": "filter_reduce_sum", "n": 200000, "cols": 1,
            "n_aggs": 1, "ops": 1, "dtype": "float64"}

    def seed(impl, device, ns):
        for _ in range(3):
            t_ledger.record("filter_reduce_sum", "float64", 200000, None, ns,
                            impl=impl, device=device)
        t_calibrate.invalidate()

    seed("cuda", "NVIDIA H100 80GB HBM3", int(5e9))
    seed(None, None, 10)
    on_cpu = t_cost.estimate(spec, dict(meta, impl="ref"))
    assert on_cpu.source == "roofline" and on_cpu.routed
    bare = t_cost.estimate(spec, meta)
    assert bare.source == "measured" and bare.kernel_s == pytest.approx(1e-8)
    seed("ref", "cpu", int(5e9))
    on_cpu = t_cost.estimate(spec, dict(meta, impl="ref"))
    assert on_cpu.source == "measured" and not on_cpu.routed
    groups = t_calibrate.medians()
    assert ("filter_reduce_sum", "float64", 262144, "cuda",
            "NVIDIA H100 80GB HBM3") in groups
    assert ("filter_reduce_sum", "float64", 262144, "ref", "cpu") in groups
    t_calibrate.invalidate()


def test_cpu_replay_records_name_the_impl_and_the_device(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("WELD_COST_LEDGER", str(tmp_path / "l.jsonl"))
    from repro_torch.core.obs import ledger as t_ledger

    probe, build, _ = _tables_np(seed=4)
    t_obs.enable()
    try:
        _staged(t_weldrel, "join_m1", probe, build, None,
                "always").compile().run()
    finally:
        t_obs.disable()
        t_obs.clear()
    recs = t_ledger.read()
    assert recs and all(r["impl"] == "ref" and r["device"] == "cpu"
                        for r in recs)
    assert all(r["measured_ns"] == r["host_ns"] > 0 for r in recs)


class _FakeEvent:
    """A CUDA event stand-in: each record() takes the next tick."""
    ticks = [0]

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        _FakeEvent.ticks[0] += 1
        self.at = _FakeEvent.ticks[0]

    def elapsed_time(self, other):
        return float(other.at - self.at)  # ms


def test_device_clock_brackets_each_kernel_entry_once(monkeypatch):
    """Inside ``device_clock`` each ``kernels/ops.py`` entry is one window
    of CUDA events behind a cover (an entry called inside another is
    inside its window); outside one nothing is recorded."""
    from repro_torch.kernels import _count

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    covers = []
    monkeypatch.setattr(torch.cuda, "_sleep", covers.append)
    inner = _count.clocked(lambda x: x + 1)
    outer = _count.clocked(lambda x: inner(x) * 2)
    assert outer(1) == 4
    x = torch.arange(4.0)
    with _count.device_clock() as marks:
        assert outer(1) == 4
        t_ops.filter_reduce_sum(x, x > 1.0)
    assert len(marks) == 2
    assert covers == [_count.ENTRY_COVER_CYCLES] * 2
    assert _count.clock_ns(marks) == 2_000_000
    with _count.device_clock() as again:
        pass
    assert again == [] and len(marks) == 2


def test_card_gate_holds_executions_off_a_sole_user():
    """A sole user waits for the executions in flight and new ones wait
    for it; a thread already inside passes through, and cannot ask for
    the card alone from inside."""
    import threading
    import time

    from repro_torch import device as t_device

    gate = t_device._Gate()
    order = []
    inside = threading.Event()
    release = threading.Event()

    def execute(tag, hold=None):
        with gate.shared():
            order.append(f"{tag}+")
            if hold is not None:
                inside.set()
                hold.wait(5)
            order.append(f"{tag}-")

    def tune():
        with gate.sole():
            order.append("sole")

    first = threading.Thread(target=execute, args=("a", release))
    first.start()
    assert inside.wait(5)
    sole = threading.Thread(target=tune)
    sole.start()
    time.sleep(0.05)
    late = threading.Thread(target=execute, args=("b",))
    late.start()
    time.sleep(0.05)
    assert order == ["a+"]
    release.set()
    for t in (first, sole, late):
        t.join(5)
    assert order == ["a+", "a-", "sole", "b+", "b-"]
    with gate.shared():
        with gate.shared():
            pass
        with pytest.raises(RuntimeError, match="already uses it"):
            with gate.sole():
                pass


def test_tuning_holds_the_card_alone(tunes_on_cpu, tmp_path, monkeypatch):
    from repro_torch import device as t_device

    monkeypatch.setenv(t_autotune.ENV_CACHE, str(tmp_path / "a.json"))
    t_autotune.clear_cache(disk=False)
    seen = []
    spec = dataclasses.replace(
        tunes_on_cpu, make_bench=lambda m, p, i: (
            lambda: seen.append(t_device._gate._sole)))
    t_autotune.tune(spec, {"n": 4096, "dtype": np.float64}, impl="cuda")
    assert seen and all(seen)
    assert not t_device._gate._sole
    t_autotune.clear_cache(disk=False)


@pytest.mark.parametrize("times,spread,want", [
    ({1024: 100.0, 528: 97.0, 264: 99.0}, 0.0, 1024),  # within MIN_GAIN
    ({1024: 100.0, 528: 90.0, 264: 93.0}, 0.0, 528),   # beyond it
    ({1024: 100.0, 528: 85.0, 264: 99.0}, 0.2, 1024),  # within the spread
    ({1024: 100.0, 528: 75.0, 264: 70.0}, 0.2, 264),
])
def test_tuner_keeps_the_default_within_its_clock_spread(times, spread,
                                                         want):
    def timing(t, s=0.0):
        out = t_autotune._Timing(t)
        out.spread = s
        return out

    timed = [({"max_blocks": c}, timing(t, spread if c == 1024 else 0.0))
             for c, t in times.items()]
    params, best, default = t_autotune._winner(timed, {"max_blocks": 1024})
    assert params == {"max_blocks": want}
    assert best == times[want] and default == times[1024]
