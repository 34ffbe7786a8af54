"""The port's hash join against the JAX package's, on the CPU.

Every join workload is written once, as a function of a package's
``weldrel``, and runs through ``repro.frames.weldrel`` (with
``kernel_impl="ref"``: the reference's interpret paths of
``hash_to_slot`` and ``group_build`` do not run on the installed jax)
and ``repro_torch.frames.weldrel`` on the same numpy inputs under
kernelize "off", "always" and "auto".  Tolerance: every column equal
exactly — integers equal, floats bitwise equal (NaN fills included) —
because a join moves values and sums nothing.  Under "always" each
kernel route is taken the same number of times in both packages.
Sizes stay at a few thousand probe rows."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import repro_torch
from repro.core.errors import CapacityError as RCapacityError
from repro.frames import weldrel as r_weldrel
from repro_torch.core.errors import CapacityError as TCapacityError
from repro_torch.frames import weldrel as t_weldrel

REF = SimpleNamespace(weldrel=r_weldrel, impl="ref",
                      CapacityError=RCapacityError)
PORT = SimpleNamespace(weldrel=t_weldrel, impl=None,
                       CapacityError=TCapacityError)

MODES = ("off", "always", "auto")
JOIN_SPECS = ("dict_hash_build", "hash_probe", "group_build", "group_probe")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed) and the workloads, written once
# ---------------------------------------------------------------------------


def _probe(n=3000, key_hi=100, seed=3):
    rng = np.random.RandomState(seed)
    return {
        "key": rng.randint(0, key_hi, n).astype(np.int64),
        "k2": rng.randint(0, 3, n).astype(np.int64),
        "qty": rng.uniform(1, 50, n),
        "flag": rng.randint(0, 2, n).astype(np.int32),
    }


def _build(k=64, fanout=1, seed=5, dup_one=False):
    """k distinct keys (every other one of [0, 2k)), each `fanout` times;
    ``dup_one`` repeats one key once more (an m:n build at fan-out 1)."""
    rng = np.random.RandomState(seed)
    keys = np.repeat(np.arange(k, dtype=np.int64) * 2, fanout)
    if dup_one:
        keys = np.concatenate([keys, keys[:1]])
    rng.shuffle(keys)
    n = keys.shape[0]
    return {
        "key": keys,
        "k2": (keys // 2) % 3,
        "rv": rng.rand(n),
        "rw": rng.randint(0, 9, n).astype(np.int64),
    }


def _join(pkg, mode, stats, lcols, rcols, on="key", how="inner",
          pred=None, **kw):
    w = pkg.weldrel
    t = w.Table(lcols)
    q = w.Query(t)
    if pred is not None:
        q = q.filter(pred(t))
    out = q.join(w.Table(rcols), on=on, how=how, kernelize=mode,
                 kernel_impl=pkg.impl, collect_stats=stats, **kw)
    return {c: np.asarray(w._host(out.cols[c])) for c in out.cols}


def _float_keys(cols):
    out = dict(cols)
    out["key"] = cols["key"].astype(np.float64) * 0.5 - 3.0
    return out


def _workloads():
    wl = {}
    for how in ("inner", "left", "anti"):
        wl[f"m1_{how}"] = dict(lcols=_probe(), rcols=_build(), how=how)
        wl[f"m1_{how}_filtered"] = dict(
            lcols=_probe(), rcols=_build(), how=how,
            pred=lambda t: t.col("qty") < 24.0)
        wl[f"m1_{how}_two_keys"] = dict(
            lcols=_probe(), rcols=_build(), how=how, on=["key", "k2"])
        wl[f"m1_{how}_float_keys"] = dict(
            lcols=_float_keys(_probe()), rcols=_float_keys(_build()),
            how=how)
        wl[f"m1_{how}_empty_build"] = dict(
            lcols=_probe(), rcols={c: v[:0] for c, v in _build().items()},
            how=how)
    for how in ("inner", "left"):
        wl[f"mn_{how}_fanout1"] = dict(
            lcols=_probe(), rcols=_build(dup_one=True), how=how)
        wl[f"mn_{how}_fanout4"] = dict(
            lcols=_probe(), rcols=_build(fanout=4), how=how,
            pred=lambda t: t.col("flag") == 1)
        wl[f"mn_{how}_fanout32"] = dict(
            lcols=_probe(n=1000, key_hi=40), rcols=_build(k=16, fanout=32),
            how=how)
        wl[f"mn_{how}_two_keys"] = dict(
            lcols=_probe(), rcols=_build(fanout=4), how=how,
            on=["key", "k2"])
        wl[f"mn_{how}_precount_off"] = dict(
            lcols=_probe(), rcols=_build(fanout=4), how=how, precount=False)
    return wl


WORKLOADS = _workloads()


def _assert_same_table(got: dict, want: dict):
    """Every column equal exactly: same names, dtypes and values, floats
    bitwise (NaN fills compare as NaN)."""
    assert list(got) == list(want)
    for c in want:
        g, w = got[c], want[c]
        assert g.dtype == w.dtype and g.shape == w.shape, c
        if w.dtype.kind == "f":
            assert np.array_equal(np.isnan(g), np.isnan(w)), c
            ok = ~np.isnan(w)
            bits = {4: np.int32, 8: np.int64}[w.itemsize]
            np.testing.assert_array_equal(g[ok].view(bits), w[ok].view(bits))
        else:
            np.testing.assert_array_equal(g, w)


def _routed(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k.startswith("kernelize.")}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_join_matches_reference(name, mode):
    t_stats, r_stats = {}, {}
    got = _join(PORT, mode, t_stats, **WORKLOADS[name])
    want = _join(REF, mode, r_stats, **WORKLOADS[name])
    _assert_same_table(got, want)
    if mode == "always":
        assert _routed(t_stats) == _routed(r_stats)


def test_always_routes_each_join_spec():
    """The workloads above take all four join routes, and the m:1 and
    m:n plans route exactly one build and one probe each."""
    seen = set()
    for name in ("m1_inner", "m1_left_two_keys", "mn_inner_fanout4",
                 "mn_left_precount_off"):
        st = {}
        _join(PORT, "always", st, **WORKLOADS[name])
        routed = {s: st.get(f"kernelize.{s}", 0) for s in JOIN_SPECS}
        pair = (("dict_hash_build", "hash_probe") if name.startswith("m1")
                else ("group_build", "group_probe"))
        assert routed == {s: int(s in pair) for s in JOIN_SPECS}, name
        seen |= set(pair)
    assert seen == set(JOIN_SPECS)


def _single_column_probe(pkg, mode, stats, gather: bool):
    """A hand-written probe loop merging ONE vecbuilder (the unfused
    ``hash_probe`` form): keep the probe rows whose key is in a built
    dict and whose value passes a filter, emitting the looked-up build
    value (``gather``) or an expression over the probe row."""
    ir, wt, lazy = pkg.ir, pkg.wt, pkg.lazy
    rng = np.random.RandomState(9)
    objs = [lazy.NewWeldObject(a, None) for a in (
        np.arange(50, dtype=np.int64) * 3, rng.rand(50),
        rng.randint(0, 200, 2000).astype(np.int64), rng.rand(2000))]
    rk, rv, lk, lv = (ir.Ident(o.obj_id, o.weld_type()) for o in objs)
    pair = wt.Struct((wt.I64, wt.F64))
    bt = wt.DictMerger(wt.I64, wt.F64, "+")
    b, i, x = (ir.Ident(ir.fresh("b"), bt), ir.Ident(ir.fresh("i"), wt.I64),
               ir.Ident(ir.fresh("x"), pair))
    build = ir.Result(ir.For(
        (ir.Iter(rk), ir.Iter(rv)),
        ir.NewBuilder(bt, arg=ir.Literal(64, wt.I64)),
        ir.Lambda((b, i, x), ir.Merge(b, ir.MakeStruct(
            (ir.GetField(x, 0), ir.GetField(x, 1)))))))
    d_obj = lazy.NewWeldObject(objs[:2], build)
    d = ir.Ident(d_obj.obj_id, d_obj.weld_type())
    vb = wt.VecBuilder(wt.F64)
    b2, i2, x2 = (ir.Ident(ir.fresh("b"), vb), ir.Ident(ir.fresh("i"), wt.I64),
                  ir.Ident(ir.fresh("x"), pair))
    key = ir.GetField(x2, 0)
    val = ir.Lookup(d, key) if gather else ir.BinOp(
        "*", ir.GetField(x2, 1), ir.Literal(2.0, wt.F64))
    cond = ir.BinOp("&&", ir.BinOp("<", ir.GetField(x2, 1),
                                   ir.Literal(0.7, wt.F64)),
                    ir.KeyExists(d, key))
    probe = ir.Result(ir.For(
        (ir.Iter(lk), ir.Iter(lv)), ir.NewBuilder(vb),
        ir.Lambda((b2, i2, x2), ir.If(cond, ir.Merge(b2, val), b2))))
    obj = lazy.NewWeldObject([d_obj] + objs[2:], probe)
    return np.asarray(lazy.Evaluate(obj, kernelize=mode, kernel_impl=pkg.impl,
                                    collect_stats=stats).value)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gather", [True, False], ids=["gather", "expr"])
def test_single_column_probe_matches_reference(gather, mode):
    from repro.core import ir as r_ir, lazy as r_lazy, wtypes as r_wt
    from repro_torch.core import ir as t_ir, lazy as t_lazy, wtypes as t_wt

    t_stats, r_stats = {}, {}
    got = _single_column_probe(
        SimpleNamespace(**vars(PORT), ir=t_ir, wt=t_wt, lazy=t_lazy), mode,
        t_stats, gather)
    want = _single_column_probe(
        SimpleNamespace(**vars(REF), ir=r_ir, wt=r_wt, lazy=r_lazy), mode,
        r_stats, gather)
    _assert_same_table({"v": got}, {"v": want})
    if mode == "always":
        assert _routed(t_stats) == _routed(r_stats)
        assert t_stats.get("kernelize.hash_probe") == 1


# ---------------------------------------------------------------------------
# errors: the same ones, raised by both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["validate_m1", "suffix_collision",
                                  "capacity", "anti_mn"])
@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_join_raises_like_the_reference(pkg, case):
    lcols, rcols = _probe(), _build(fanout=2)
    kw, err = {}, ValueError
    if case == "validate_m1":
        kw = dict(validate="m:1")
    elif case == "suffix_collision":
        # the build's "rv" becomes "rv_r", a name the probe side has
        lcols = dict(lcols, rv=lcols["qty"], rv_r=lcols["qty"])
        kw = dict(suffix="_r")
    elif case == "capacity":
        kw, err = dict(capacity=10), pkg.CapacityError
    else:
        kw, err = dict(how="anti"), NotImplementedError
    with pytest.raises(err):
        _join(pkg, "always", {}, lcols, rcols, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_undersized_symbolic_capacity_poisons_in_both(mode, monkeypatch):
    """precount=False with a capacity below the distinct build keys: no
    host count can refuse it, so the build poisons and, with the recovery
    ladder switched off in both packages, the decode raises
    CapacityError (with it on, both regrow and retry:
    test_torch_recovery.py)."""
    monkeypatch.setenv("WELD_RECOVERY", "0")
    for pkg in (PORT, REF):
        with pytest.raises(pkg.CapacityError):
            _join(pkg, mode, {}, _probe(), _build(fanout=4),
                  precount=False, capacity=10)


def _routes(stats):
    return {k: v for k, v in stats.items()
            if k.startswith("kernelize.") and k != "kernelize.matched"}


def _stats_of(pkg, mode, kw):
    st: dict = {}
    _join(pkg, mode, st, **kw)
    return st


def test_memory_limit_waits_for_the_weldbound_slice():
    """``join(memory_limit=)`` is weldbound admission in both packages:
    a limit equal to the port's own certified peak admits and gives the
    rows of the unlimited run; one byte less raises ``ResourceError``
    before anything runs.  The result rows the certificate derives
    (``bounds.out_rows``) equal the reference's."""
    from repro.core.errors import ResourceError as RResourceError
    from repro_torch.core.errors import ResourceError as TResourceError

    for mode in MODES:
        for wl in ("m1_inner", "mn_left_fanout4", "mn_inner_precount_off"):
            kw = dict(_workloads()[wl])
            stats = {pkg: {} for pkg in ("port", "ref")}
            free = _join(PORT, mode, stats["port"], **kw)
            routes = _routes(stats["port"])
            ref_mode = mode
            if mode == "auto":
                ref_mode = next((m for m in ("auto", "always", "off")
                                 if _routes(_stats_of(REF, m, kw)) == routes),
                                None)
            _join(REF, ref_mode or mode, stats["ref"], **kw)
            if ref_mode is not None:
                assert stats["port"]["bounds.out_rows"] == \
                    stats["ref"]["bounds.out_rows"], (mode, wl)
            ref_mode = ref_mode or mode
            for pkg, m, st, err in (
                    (PORT, mode, stats["port"], TResourceError),
                    (REF, ref_mode, stats["ref"], RResourceError)):
                peak = st["bounds.peak_bytes"]
                got = _join(pkg, m, {}, memory_limit=peak, **kw)
                if pkg is PORT:
                    assert set(got) == set(free)
                    for c in free:
                        np.testing.assert_array_equal(got[c], free[c])
                with pytest.raises(err, match="admission"):
                    _join(pkg, m, {}, memory_limit=peak - 1, **kw)
