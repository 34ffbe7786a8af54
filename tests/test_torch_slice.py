"""The port's main path against the JAX package, on the CPU.

Each workload is written once, as a function of a package's frame and
IR modules, and runs through both packages on the same numpy inputs
under kernelize "off", "always" and "auto".  Values agree to: integers
exactly, f64 to rtol 1e-12 (the two backends sum in different orders).
Under "always" the three routes this slice ports are taken the same
number of times in both packages."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import repro_torch
from repro.core import ir as r_ir, lazy as r_lazy, macros as r_M
from repro.core import wtypes as r_wt
from repro.core.backend import values as r_values
from repro.core.errors import CapacityError as RCapacityError
from repro.frames import welddf as r_welddf, weldnp as r_weldnp
from repro.frames import weldrel as r_weldrel
from repro_torch.core import ir as t_ir, lazy as t_lazy, macros as t_M
from repro_torch.core import runtime as t_runtime
from repro_torch.core import wtypes as t_wt
from repro_torch.core.backend import values as t_values
from repro_torch.core.errors import CapacityError as TCapacityError
from repro_torch.frames import welddf as t_welddf, weldnp as t_weldnp
from repro_torch.frames import weldrel as t_weldrel

REF = SimpleNamespace(ir=r_ir, wt=r_wt, M=r_M, lazy=r_lazy, weldnp=r_weldnp,
                      welddf=r_welddf, weldrel=r_weldrel)
PORT = SimpleNamespace(ir=t_ir, wt=t_wt, M=t_M, lazy=t_lazy, weldnp=t_weldnp,
                       welddf=t_welddf, weldrel=t_weldrel)

MODES = ("off", "always", "auto")
SPECS = ("filter_reduce_sum", "vecmerger_segment_sum", "dict_group_sum")
RTOL_F64 = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed) and the workloads, written once
# ---------------------------------------------------------------------------


def _lineitem(n=3001, seed=3):
    rng = np.random.RandomState(seed)
    return {
        "ship": rng.randint(0, 2557, n).astype(np.int64),
        "disc": rng.uniform(0, 0.1, n),
        "qty": rng.uniform(1, 50, n),
        "price": rng.uniform(100, 10_000, n),
        "rf": rng.randint(0, 3, n).astype(np.int64),
        "ls": rng.randint(0, 2, n).astype(np.int64),
    }


def quickstart(pkg, kz, stats):
    rng = np.random.RandomState(0)
    n = 4000
    data = {"population": rng.randint(0, 1_000_000, n).astype(np.float64),
            "crime": rng.rand(n)}
    df = pkg.welddf.DataFrame(data)
    big = df[df["population"] > 500_000]
    total = (big["population"] * 0.1 + big["crime"] * 2.0).sum()
    return pkg.lazy.Evaluate(total.obj, kernelize=kz,
                             collect_stats=stats).value


def q6(pkg, kz, stats):
    t = pkg.weldrel.Table(_lineitem())
    q = pkg.weldrel.Query(t).filter(
        (t.col("ship") >= 365) & (t.col("ship") < 730)
        & (t.col("disc") >= 0.05) & (t.col("disc") <= 0.07)
        & (t.col("qty") < 24.0)
    )
    return q.agg({"rev": (t.col("price") * t.col("disc"), "+")},
                 kernelize=kz, collect_stats=stats)["rev"]


def q1_agg(pkg, kz, stats):
    t = pkg.weldrel.Table(_lineitem())
    q = pkg.weldrel.Query(t).filter(t.col("ship") <= 2000)
    return q.agg({
        "sum_qty": (t.col("qty"), "+"),
        "sum_price": (t.col("price"), "+"),
        "sum_disc_price": (t.col("price") * (1.0 - t.col("disc")), "+"),
        "sum_disc": (t.col("disc"), "+"),
    }, kernelize=kz, collect_stats=stats)


def group_agg_2key(pkg, kz, stats):
    t = pkg.weldrel.Table(_lineitem())
    q = pkg.weldrel.Query(t).filter(t.col("ship") < 1500)
    return q.group_agg([t.col("rf"), t.col("ls")],
                       {"sum_qty": (t.col("qty"), "+"),
                        "sum_price": (t.col("price"), "+")},
                       capacity=16, kernelize=kz, collect_stats=stats)


def groupby_sum(pkg, kz, stats):
    rng = np.random.RandomState(11)
    n = 5000
    df = pkg.welddf.DataFrame({
        "k": rng.randint(0, 64, n).astype(np.int64),
        "v": rng.rand(n),
    })
    return df.groupby_sum("k", "v", capacity=64, kernelize=kz,
                          collect_stats=stats)


def pagerank(pkg, kz, stats):
    """One PageRank iteration: gathers + vecmerger scatter in one loop."""
    ir, wt, M, lazy = pkg.ir, pkg.wt, pkg.M, pkg.lazy
    rng = np.random.RandomState(5)
    nv, ne, damp = 64, 2000, 0.85
    src = rng.randint(0, nv, ne).astype(np.int64)
    dst = rng.randint(0, nv, ne).astype(np.int64)
    deg = np.maximum(np.bincount(src, minlength=nv).astype(np.float64), 1.0)
    r = lazy.NewWeldObject(np.full(nv, 1.0 / nv), None)
    s_o, d_o = lazy.NewWeldObject(src, None), lazy.NewWeldObject(dst, None)
    inv_o = lazy.NewWeldObject(1.0 / deg, None)
    base = lazy.NewWeldObject(np.zeros(nv), None)

    def ident(o):
        return ir.Ident(o.obj_id, o.weld_type())

    bt = wt.VecMerger(wt.F64, "+")
    b = ir.Ident(ir.fresh("b"), bt)
    i = ir.Ident(ir.fresh("i"), wt.I64)
    x = ir.Ident(ir.fresh("x"), wt.Struct((wt.I64, wt.I64)))
    contrib = ir.BinOp("*", ir.Lookup(ident(r), ir.GetField(x, 0)),
                       ir.Lookup(ident(inv_o), ir.GetField(x, 0)))
    loop = ir.Result(ir.For(
        (ir.Iter(ident(s_o)), ir.Iter(ident(d_o))),
        ir.NewBuilder(bt, arg=ident(base)),
        ir.Lambda((b, i, x), ir.Merge(b, ir.MakeStruct((ir.GetField(x, 1),
                                                        contrib)))),
    ))
    out = M.map_(loop, lambda v: ir.BinOp(
        "+", ir.Literal((1 - damp) / nv, wt.F64),
        ir.BinOp("*", ir.Literal(damp, wt.F64), v)))
    obj = lazy.NewWeldObject([r, s_o, d_o, inv_o, base], out)
    return np.asarray(lazy.Evaluate(obj, kernelize=kz,
                                    collect_stats=stats).value)


def black_scholes(pkg, kz, stats):
    """The Black-Scholes expression of benchmarks/workloads.py."""
    rng = np.random.RandomState(1)
    n = 3000
    wnp = pkg.weldnp
    s = wnp.array(rng.uniform(10, 200, n))
    k = wnp.array(rng.uniform(10, 200, n))
    t = wnp.array(rng.uniform(0.1, 2.0, n))
    rf, vol, inv_sqrt2 = 0.02, 0.30, 1.0 / np.sqrt(2.0)

    def cnd(x):
        return (wnp.erf(x * inv_sqrt2) + 1.0) * 0.5

    sqrt_t = wnp.sqrt(t)
    sig_t = sqrt_t * vol
    d1 = (wnp.log(s / k) + t * (rf + 0.5 * vol * vol)) / sig_t
    d2 = d1 - sig_t
    call = s * cnd(d1) - k * wnp.exp(t * (-rf)) * cnd(d2)
    return pkg.lazy.Evaluate(call.sum().obj, kernelize=kz,
                             collect_stats=stats).value


WORKLOADS = {
    "quickstart": quickstart, "q6": q6, "q1_agg": q1_agg,
    "group_agg_2key": group_agg_2key, "groupby_sum": groupby_sum,
    "pagerank": pagerank, "black_scholes": black_scholes,
}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        w = np.asarray(want)
        g = np.asarray(got)
        assert g.shape == w.shape
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL_F64, atol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_matches_reference(name, mode):
    t_stats, r_stats = {}, {}
    got = WORKLOADS[name](PORT, mode, t_stats)
    want = WORKLOADS[name](REF, mode, r_stats)
    _assert_same(got, want)
    if mode == "always":
        for spec in SPECS:
            key = f"kernelize.{spec}"
            assert t_stats.get(key, 0) == r_stats.get(key, 0), key


def test_always_routes_each_spec_somewhere():
    """The workloads above exercise all three ported routes."""
    seen = set()
    for fn in WORKLOADS.values():
        st = {}
        fn(PORT, "always", st)
        seen |= {s for s in SPECS if st.get(f"kernelize.{s}")}
    assert seen == set(SPECS)


def _poisoned_groupby(pkg):
    df = pkg.welddf.DataFrame({
        "k": np.array([1, 2, 100, 3], dtype=np.int64),
        "v": np.array([1.0, 2.0, 3.0, 4.0]),
    })
    return df.groupby_sum("k", "v", capacity=8, kernelize="always")


def test_out_of_range_key_poisons_in_both(monkeypatch):
    monkeypatch.setenv("WELD_RECOVERY", "0")
    with pytest.raises(TCapacityError):
        _poisoned_groupby(PORT)
    with pytest.raises(RCapacityError):
        _poisoned_groupby(REF)


def test_decode_parity_through_from_numpy():
    keys = np.array([3, 5, 9, 0], dtype=np.int64)
    vals = np.array([0.5, 1.5, 2.5, 0.0])
    ref_dict = r_values.WDict(keys, vals, np.int64(3))
    ref_vec = r_values.WVec(vals, np.int64(2))
    assert t_runtime.decode_value(t_values.from_numpy(ref_dict),
                                  t_wt.DictType(t_wt.I64, t_wt.F64)) \
        == ref_dict.to_numpy()
    np.testing.assert_array_equal(
        t_runtime.decode_value(t_values.from_numpy(ref_vec),
                               t_wt.Vec(t_wt.F64)),
        ref_vec.to_numpy())
    poisoned = r_values.WDict(keys, vals, np.int64(-4))
    with pytest.raises(RCapacityError):
        poisoned.to_numpy()
    with pytest.raises(TCapacityError):
        t_runtime.decode_value(t_values.from_numpy(poisoned), None)
    # groupbuilder results: CSR values + offsets, scalar and struct keys
    offsets = np.array([0, 2, 3, 6, 6], dtype=np.int32)
    payload = np.array([4, 1, 7, 0, 2, 5], dtype=np.int64)
    for gkeys in (keys, (keys, keys * 10)):
        ref_group = r_values.WGroup(gkeys, payload, offsets, np.int64(3))
        got = t_runtime.decode_value(t_values.from_numpy(ref_group), None)
        assert got == ref_group.to_numpy()
        assert isinstance(t_values.from_numpy(ref_group), t_values.WGroup)
    bad_group = r_values.WGroup(keys, payload, offsets, np.int64(-4))
    with pytest.raises(RCapacityError):
        bad_group.to_numpy()
    with pytest.raises(TCapacityError):
        t_runtime.decode_value(t_values.from_numpy(bad_group), None)
