#!/usr/bin/env python
"""Serving smoke of the PyTorch port (the counterpart of serve_smoke.py).

Drives the port's serving stack end to end and asserts the §7.8
economics hold under concurrency, with the JAX smoke's checks:

* admission: a provably over-budget query sheds with a typed
  ``ResourceError``, launches nothing and never enters the compile
  cache;
* 8 worker threads x 32 mixed staged queries (two m:1 join shapes, an
  m:n variant, a group-by): every result byte-identical to the serial
  run of its plan through the same entry point, joins equal to the
  eager oracle exactly and group sums within rtol 1e-12, exactly ONE
  compile per distinct (plan, shape) key by the ``cache.*`` counters,
  ``cache_size()`` bounded by ``WELD_COMPILE_CACHE_MAX``;
* AOT re-binding: ``CompiledQuery.run(**tables)`` against fresh
  same-shape tables spends zero compiles;
* calibration: ledger medians seeded from an authentic traced run (each
  group's predictions, recorded as measured times) overlay the roofline;
  the recompiled plan's ``explain()`` shows ``source=measured`` for
  every group at or above ``$WELD_CALIBRATE_MIN`` records, and every
  routing decision stays as it was.

State (autotune cache, cost ledger, kernel health file) is confined to
a temp directory, with ``WELD_COMPILE_CACHE_MAX=8``.

    PYTHONPATH=src python tools/serve_smoke_torch.py [--device cpu]

Without ``--device`` it runs on the card (``cuda``), where the routed
kernels launch and the tuner times the routes that take a grid cap.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_TOOLS, "..", "src"))

_td = tempfile.mkdtemp(prefix="weld-serve-smoke-torch-")
os.environ["WELD_AUTOTUNE_CACHE"] = os.path.join(_td, "autotune.json")
os.environ["WELD_COST_LEDGER"] = os.path.join(_td, "cost_ledger.jsonl")
os.environ["WELD_KERNEL_HEALTH"] = os.path.join(_td, "kernel_health.json")
os.environ["WELD_COMPILE_CACHE_MAX"] = "8"

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import runtime  # noqa: E402
from repro_torch.core.errors import ResourceError  # noqa: E402
from repro_torch.core.kernelplan import calibrate  # noqa: E402
from repro_torch.core.obs import ledger  # noqa: E402
from repro_torch.core.serve import QueryServer  # noqa: E402
from repro_torch.frames.weldrel import Query, Table, _host  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _tables(n, k, seed):
    rng = np.random.RandomState(seed)
    probe = {"k": rng.randint(0, k, n).astype(np.int64), "x": rng.rand(n)}
    build = {"k": np.arange(k, dtype=np.int64), "w": rng.rand(k)}
    return probe, build


def _cols(t: Table) -> dict:
    return {c: np.asarray(_host(v)) for c, v in t.cols.items()}


def _same(got, want, label: str, exact: bool = True) -> None:
    """Tables column by column, group dicts key by key: bitwise when
    ``exact``, else joins exact and sums within rtol 1e-12."""
    if isinstance(want, Table):
        g, w = _cols(got), _cols(want)
        assert sorted(g) == sorted(w), label
        for c in w:
            assert g[c].dtype == w[c].dtype, (label, c)
            if exact and w[c].dtype.kind == "f":
                assert np.array_equal(g[c].view(np.int64),
                                      w[c].view(np.int64)), (label, c)
            else:
                np.testing.assert_array_equal(g[c], w[c],
                                              err_msg=f"{label}: {c}")
        return
    assert set(got) == set(want), label
    for key in want:
        if exact:
            assert got[key] == want[key], (label, key)
        else:
            np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                       np.asarray(want[key], dtype=float),
                                       rtol=1e-12, err_msg=f"{label} {key}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="evaluation device (default: cuda)")
    args = ap.parse_args(argv)
    repro_torch.set_default_device(args.device)

    pa, ba = _tables(n=20000, k=100, seed=1)
    pb, bb = _tables(n=7000, k=50, seed=2)
    dup = {"k": np.concatenate([ba["k"], ba["k"]]),
           "w": np.concatenate([ba["w"], ba["w"] + 1.0])}

    def staged_group(cols):
        t = Table(dict(cols))
        return Query(t).stage().group_agg(
            [t.col("k")], {"s": (t.col("x"), "+")})

    makers = [
        lambda: Query(Table(dict(pa))).stage().join(
            Table(dict(ba)), on="k", validate="m:1"),
        lambda: Query(Table(dict(pb))).stage().join(
            Table(dict(bb)), on="k", validate="m:1"),
        lambda: Query(Table(dict(pa))).stage().join(
            Table(dict(dup)), on="k"),
        lambda: staged_group(pa),
    ]

    def eager_join(probe, build, **kw):
        return Query(Table(dict(probe), eager=True)).join(
            Table(dict(build), eager=True), **kw)

    te = Table(dict(pa), eager=True)
    oracles = [
        eager_join(pa, ba, on="k", validate="m:1"),
        eager_join(pb, bb, on="k", validate="m:1"),
        eager_join(pa, dup, on="k"),
        Query(te).group_agg([te.col("k")], {"s": (te.col("x"), "+")}),
    ]

    # -- admission shedding (first: cold cache, empty ledger) ------------
    runtime.clear_cache()
    ops.reset_counts()
    with QueryServer(workers=2, memory_limit=64) as tiny:
        try:
            tiny.run(makers[0]())
            raise AssertionError("64-byte budget must shed the join")
        except ResourceError as e:
            assert "admission" in str(e), e
    assert tiny.stats()["serve.shed"] == 1
    assert runtime.cache_size() == 0, "a shed plan must never be cached"
    assert all(v == (0, 0) for v in ops.counts().values()), ops.counts()
    print("admission: over-budget query shed with typed ResourceError, "
          "no launch, nothing cached")

    # -- serial runs, one per plan, through the same entry point ---------
    with QueryServer(workers=1) as one:
        serial = [one.run(m()) for m in makers]
    for i, (got, want) in enumerate(zip(serial, oracles)):
        _same(got, want, f"serial plan {i}", exact=False)

    # -- concurrent serving: 8 threads x 32 mixed queries ----------------
    runtime.clear_cache()
    n_req, distinct = 32, len(makers)
    reqs = [makers[i % distinct]() for i in range(n_req)]
    with QueryServer(workers=8) as srv:
        results = srv.map(reqs)
    st = srv.stats()
    assert st["cache.misses"] == distinct, \
        f"single-flight broken: {distinct} plans, {st['cache.misses']} compiles"
    assert st["cache.hits"] + st["cache.waits"] == n_req - distinct, st
    assert runtime.cache_size() <= 8, st
    assert st["serve.completed"] == n_req and st["serve.shed"] == 0, st
    for i, got in enumerate(results):
        _same(got, serial[i % distinct], f"request {i} vs serial")
    print(f"serve: {n_req} requests / 8 threads -> "
          f"{st['cache.misses']} compiles ({distinct} distinct plans), "
          f"{st['cache.hits']} hits, {st['cache.waits']} waits, results "
          f"byte-identical to the serial runs")

    # -- AOT re-binding: zero recompiles ---------------------------------
    cq = makers[0]().compile()
    misses0 = runtime.cache_stats()["cache.misses"]
    pa2, ba2 = _tables(n=20000, k=100, seed=9)
    out = cq.run(table=Table(dict(pa2)), right=Table(dict(ba2)))
    assert runtime.cache_stats()["cache.misses"] == misses0, \
        "same-shape rebind must not recompile"
    _same(out, eager_join(pa2, ba2, on="k", validate="m:1"), "rebind",
          exact=False)
    print("rebind: same-shape run(**tables) spent 0 recompiles")

    # -- calibration: measured medians overlay the roofline --------------
    os.environ["WELD_COST_LEDGER"] = os.path.join(_td, "ledger_cal.jsonl")
    calibrate.invalidate()
    runtime.clear_cache()
    obs.enable()
    try:
        # authentic records: a traced always-routed m:n join writes one
        # ledger row per kernel call (predicted AND measured)
        Query(Table(dict(pa))).join(Table(dict(dup)), on="k",
                                    kernelize="always")
    finally:
        obs.disable()
        obs.clear()
    recs = ledger.read()
    assert recs, "a traced always-run must seed the cost ledger"
    base = makers[2]().compile()
    base_costs = {c["kernel"]: bool(c["routed"])
                  for c in base.stats["kernelplan"]["costs"]}
    assert "source=roofline" in base.explain().render()
    # seed medians that EQUAL the roofline predictions so provenance
    # switches to measured while every routing decision stays put
    need = calibrate.min_samples() + 2
    for r in {(r["kernel"], r["dtype"], r["bucket"]): r
              for r in recs if r.get("predicted_ns")}.values():
        for _ in range(need):
            ledger.record(r["kernel"], r["dtype"], r["n"],
                          r["predicted_ns"], r["predicted_ns"],
                          impl=r["impl"], device=r["device"])
    calibrate.invalidate()
    runtime.clear_cache()
    cal = makers[2]().compile()
    rendered = cal.explain().render()
    assert "source=measured" in rendered, rendered
    cal_costs = {c["kernel"]: bool(c["routed"])
                 for c in cal.stats["kernelplan"]["costs"]
                 if c.get("source") == "measured"}
    assert cal_costs, "no measured-provenance cost rows after seeding"
    for kern, routed in cal_costs.items():
        assert base_costs.get(kern) == routed, \
            (f"calibration flipped routing for {kern}: "
             f"{base_costs.get(kern)} -> {routed}")
    print(f"calibration: {len(cal_costs)} kernels repriced from ledger "
          f"medians (source=measured), routing decisions unchanged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
