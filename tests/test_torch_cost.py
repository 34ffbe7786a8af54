"""The port's cost gate (``kernelize="auto"``) against the JAX package's,
on the CPU.

The reference's five gate tests (``test_kernelplan.py``: a tiny filtered
sum rejected, a 500,000-row one routed, a vecmerger past the segment
kernels' K bound rejected, an unknown size rejected; ``test_join.py``: a
300,000 x 20,000 join routed and a tiny join rejected) run through both
packages on the same numpy inputs.  Each package is held to its own
decisions (routed and rejected counts, the planner's ``kernelize.*``
stats): equal on the large filtered sum, the large join and the unknown
size; apart on the tiny filtered sum, the vecmerger past 4,096 keys and
the tiny join, which the port's gate, charging every kernel launch on
either route alike, routes (PERF.md section 6 has the card's
readings of all five).
The values must agree in every case (f64 rtol 1e-10, the reference's own
limit; join columns exactly).

Then the launch counts themselves: for each pattern, the launches the
gate charges the two routes differ by as many as the routes run, counted
as the operators that write a tensor (each a kernel on a card) with each
kernel wrapper at its kernels' launches.  And the port's own decisions,
priced from its kernels on the H100 (``core/kernelplan/cost.py``): the
4,096-key ``welddf.groupby_sum`` routes at 1 M rows with the values of
``"off"`` (f64 rtol 1e-12: the two routes sum in other orders), and its
estimate routes at 16 M and 59,986,052 rows; ``filter_reduce_sum`` at
59,986,052 rows routes with a predicted gain near the 2.8x the card
measured; the f64 4096^3 product is priced on the FP64 tensor cores
(above the CUDA-core rate's time) and goes to ``torch.matmul``, which the
card measured faster; the f32 product takes whichever of the SGEMM and
``torch.matmul`` the card measured faster (within the margin); and
``group_probe``'s kernel term at the m:n join's 16,777,216 queries is the
time the card measured for the kernel, staged (50,000 keys) and windowed
(65,536).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch
from repro.core import ir as r_ir, lazy as r_lazy, macros as r_M
from repro.core import kernelplan as r_kp, wtypes as r_wt
from repro.core.kernelplan import cost as r_cost
from repro.frames import welddf as r_welddf, weldrel as r_weldrel
from repro_torch.core import ir as t_ir, lazy as t_lazy, macros as t_M
from repro_torch.core import kernelplan as t_kp, wtypes as t_wt
from repro_torch.core import runtime as t_runtime
from repro_torch.core.kernelplan import cost as t_cost
from repro_torch.frames import welddf as t_welddf, weldrel as t_weldrel
from repro_torch.kernels import filter_reduce as t_fr, group_build as t_gb
from repro_torch.kernels import hash_probe as t_hp, hash_table as t_ht
from repro_torch.kernels import segment_reduce as t_sr

REF = SimpleNamespace(name="ref", ir=r_ir, lazy=r_lazy, M=r_M, wt=r_wt,
                      kp=r_kp, cost=r_cost, welddf=r_welddf,
                      weldrel=r_weldrel)
PORT = SimpleNamespace(name="port", ir=t_ir, lazy=t_lazy, M=t_M, wt=t_wt,
                       kp=t_kp, cost=t_cost, welddf=t_welddf,
                       weldrel=t_weldrel)
PKGS = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


def _decisions(stats: dict) -> dict:
    plan = stats.get("kernelplan", {})
    return {"routed": plan.get("routed", {}),
            "rejected": plan.get("rejected", {}),
            **{k: v for k, v in stats.items() if k.startswith("kernelize.")}}


def _both(fn, *args):
    """``fn(pkg, stats, *args)`` through the port and the reference:
    [(value, stats)] in that order."""
    out = []
    for pkg in (PORT, REF):
        st: dict = {}
        out.append((fn(pkg, st, *args), st))
    return out


# -- the workloads of the reference's gate tests, on numpy inputs ------------


def _ident(pkg, o):
    return pkg.ir.Ident(o.obj_id, o.weld_type())


def q6_like(pkg, stats, n, mode="auto"):
    """sum(price * disc where price < 0.5) (test_kernelplan._q6_like_obj)."""
    rng = np.random.RandomState(n % 1000)
    price, disc = rng.rand(n), rng.rand(n)
    L, ir, wt = pkg.lazy, pkg.ir, pkg.wt
    po, do = L.NewWeldObject(price, None), L.NewWeldObject(disc, None)
    expr = pkg.M.filter_reduce(
        pkg.M.zip_map([_ident(pkg, po), _ident(pkg, do)],
                      lambda p, d: ir.MakeStruct((p, d))),
        lambda x: ir.BinOp("<", ir.GetField(x, 0), ir.Literal(0.5, wt.F64)),
        "+",
        lambda x: ir.BinOp("*", ir.GetField(x, 0), ir.GetField(x, 1)),
    )
    obj = L.NewWeldObject([po, do], expr)
    got = float(L.Evaluate(obj, kernelize=mode, collect_stats=stats).value)
    return got, float((price * disc)[price < 0.5].sum())


def scatter_add(pkg, stats, n, k, mode="auto"):
    """A vecmerger scatter of n rows into k slots."""
    rng = np.random.RandomState(7)
    idxs = rng.randint(0, k, n).astype(np.int64)
    vals = rng.rand(n)
    base = np.zeros(k)
    L = pkg.lazy
    io, vo, bo = (L.NewWeldObject(a, None) for a in (idxs, vals, base))
    expr = pkg.M.scatter_add(_ident(pkg, bo), _ident(pkg, io),
                             _ident(pkg, vo))
    obj = L.NewWeldObject([bo, io, vo], expr)
    got = np.asarray(L.Evaluate(obj, kernelize=mode,
                                collect_stats=stats).value)
    want = base.copy()
    np.add.at(want, idxs, vals)
    return got, want


def join(pkg, stats, n, k, mode="auto"):
    """An m:1 inner join of n probe rows on keys in [0, 2k) against k
    unique build keys (test_join.test_join_auto_routes_large_and_rejects_
    tiny)."""
    rng = np.random.RandomState(n + k)
    lcols = {"key": rng.randint(0, 2 * k, n).astype(np.int64),
             "lv": rng.rand(n)}
    rcols = {"key": np.arange(k, dtype=np.int64), "rv": rng.rand(k)}
    W = pkg.weldrel
    out = W.Query(W.Table(lcols, eager=False)).join(
        W.Table(rcols, eager=False), on="key", kernelize=mode,
        collect_stats=stats)
    return {c: np.asarray(W._host(out.cols[c])) for c in out.cols}


def groupby(pkg, stats, n, mode):
    """welddf.groupby_sum over n rows of 4,096 dense keys."""
    rng = np.random.RandomState(3)
    df = pkg.welddf.DataFrame({"k": rng.randint(0, 4096, n).astype(np.int64),
                               "v": rng.rand(n)})
    return df.groupby_sum("k", "v", capacity=4096, kernelize=mode,
                          collect_stats=stats)


# -- the reference's five gate tests, through both packages ------------------
#
# The two gates price fixed costs apart.  The reference's generic lowering
# is one fused XLA program; the port's runs one eager operator a launch,
# and the port's gate charges every launch on either route alike.  Where
# that makes the port decide otherwise, the test holds each package to
# its own decision and the values to each other; PERF.md (section 6)
# lists the card's readings of those inputs.


def test_cost_gate_rejects_tiny_input():
    """The reference rejects the 256-row filtered sum.  The port routes
    it: two launches (fr_partial, fr_combine) against the generic three
    (where, sum, the identity's add), and the card ran the kernel route
    faster."""
    (port, t_st), (ref, r_st) = _both(q6_like, 256)
    assert r_st["kernelize.matched"] == 0
    assert r_st["kernelplan"]["rejected"].get("filter_reduce_sum", 0) == 1
    (entry,) = r_st["kernelplan"]["costs"]
    assert entry["routed"] is False
    assert entry["kernel_us"] > entry["jnp_us"]
    assert t_st["kernelize.filter_reduce_sum"] == 1
    assert t_st["kernelplan"]["routed"] == {"filter_reduce_sum": 1}
    (entry,) = t_st["kernelplan"]["costs"]
    assert entry["routed"] is True
    assert entry["kernel_us"] < entry["jnp_us"]
    for got, want in (port, ref):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL)


def test_cost_gate_routes_large_dense_input():
    (port, t_st), (ref, r_st) = _both(q6_like, 500_000)
    assert _decisions(t_st) == _decisions(r_st)
    for (got, want), st in ((port, t_st), (ref, r_st)):
        assert st["kernelize.filter_reduce_sum"] == 1
        assert st["kernelplan"]["routed"] == {"filter_reduce_sum": 1}
        np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL)


def test_cost_gate_rejects_large_key_vecmerger():
    """The reference rejects the scatter of 100,000 rows into 50,000
    slots (past its kernel's tile).  The port's segment kernel reads the
    rows once a window of MAX_K keys, 13 passes here, which its gate
    prices below the generic scatter's sort (a radix sort of 11 kernels,
    a bincount and a segment_reduce): it routes it."""
    (port, t_st), (ref, r_st) = _both(scatter_add, 100_000, 50_000)
    assert r_st["kernelize.matched"] == 0
    assert r_st["kernelplan"]["rejected"].get("vecmerger_segment_sum", 0) == 1
    assert t_st["kernelize.vecmerger_segment_sum"] == 1
    assert t_st["kernelplan"]["routed"] == {"vecmerger_segment_sum": 1}
    for got, want in (port, ref):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL)


@PKGS
def test_cost_gate_unknown_size_is_conservative(pkg):
    spec = pkg.kp.get("filter_reduce_sum")
    est = pkg.cost.estimate(spec, {"kernel": "filter_reduce_sum", "n": None})
    assert est.routed is False
    assert "unknown" in est.why


@pytest.mark.parametrize("n,k,routed", [(300_000, 20_000, True),
                                        (100, 8, False)])
def test_join_auto_routes_large_and_rejects_tiny(n, k, routed):
    """The reference routes the 300,000 x 20,000 join and rejects the
    100 x 8 one, build and probe alike.  The port routes both at both
    sizes: at 100 x 8 its hash build runs as many kernels as the keyed
    sum (46), and its probe 22 against the generic search's 60."""
    (port, t_st), (ref, r_st) = _both(join, n, k)
    if routed:
        assert _decisions(t_st) == _decisions(r_st)
    else:
        assert r_st["kernelize.matched"] == 0
        assert r_st["kernelplan"]["rejected"].get("hash_probe", 0) >= 1
    assert t_st.get("kernelize.dict_hash_build", 0) == 1
    assert t_st.get("kernelize.hash_probe", 0) == 1
    assert sorted(port) == sorted(ref)
    order_t = np.lexsort((port["lv"], port["key"]))
    order_r = np.lexsort((ref["lv"], ref["key"]))
    for c in ref:
        np.testing.assert_array_equal(port[c][order_t], ref[c][order_r])


# -- the launches each route runs, against the gate's counts ----------------

#: the launches of each kernel wrapper on the card (its csrc launch sites),
#: by the module attribute the executors reach it through
KERNEL_LAUNCHES = {
    (t_fr, "filter_reduce_sum"): lambda *a: 2,  # fr_partial, fr_combine
    (t_fr, "filter_reduce_sum_multi"): lambda *a: 2,
    (t_sr, "segment_sum"): lambda seg, v, k: 2 * t_sr.windows(k),
    (t_sr, "segment_sum_vectors"): lambda seg, v, k: 2 * t_sr.windows(k),
    (t_ht, "hash_to_slot"): lambda *a: 1,  # build_small or build_table
    (t_gb, "hash_to_slot"): lambda *a: 1,
    (t_gb, "slot_hist"): lambda *a: 1,
    (t_hp, "dict_probe"): lambda *a: 1,
    (t_hp, "group_probe"): lambda *a: 1,
}

#: aten operators that launch nothing on a card
_NO_LAUNCH = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "lift_fresh"}


class _Launches(TorchDispatchMode):
    """Counts the kernels that the operators writing a tensor run on a
    card (``cost.operator_launches``: one for most, several for a sort or
    a scan), and adds each kernel wrapper's own launches in place of its
    plain version's operators."""

    def __init__(self):
        super().__init__()
        self.count = 0
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        writes = any(isinstance(t, torch.Tensor)
                     for t in (out if isinstance(out, (tuple, list))
                               else (out,)))
        if (not self.inside and writes and not func.is_view
                and name not in _NO_LAUNCH):
            x = args[0] if args and isinstance(args[0], torch.Tensor) \
                else None
            self.count += t_cost.operator_launches(
                name, x.numel() if x is not None else 1,
                x.element_size() if x is not None else 8)
        return out

    def wrap(self, fn, launches):
        @functools.wraps(fn)  # keeps the counters the wrapper bumps
        def wrapper(*args):
            self.inside += 1
            try:
                return fn(*args)
            finally:
                self.inside -= 1
                self.count += 0 if self.inside else launches(*args)
        return wrapper


def _mn_join(pkg, stats, mode):
    """An m:n inner join: 3,000 probe rows on 64 build keys at fan-out 4."""
    rng = np.random.RandomState(5)
    lcols = {"key": rng.randint(0, 100, 3000).astype(np.int64),
             "lv": rng.rand(3000)}
    rcols = {"key": np.repeat(np.arange(64, dtype=np.int64), 4),
             "rv": rng.rand(256)}
    W = pkg.weldrel
    return W.Query(W.Table(lcols, eager=False)).join(
        W.Table(rcols, eager=False), on="key", how="inner",
        kernelize=mode, collect_stats=stats)


def _wide_join(pkg, stats, mode):
    """An m:1 join carrying three value columns on each side."""
    rng = np.random.RandomState(9)
    lcols = {"key": rng.randint(0, 16, 100).astype(np.int64)}
    rcols = {"key": np.arange(8, dtype=np.int64)}
    for j in range(3):
        lcols[f"l{j}"] = rng.rand(100)
        rcols[f"r{j}"] = rng.rand(8)
    W = pkg.weldrel
    return W.Query(W.Table(lcols, eager=False)).join(
        W.Table(rcols, eager=False), on="key", kernelize=mode,
        collect_stats=stats)


LAUNCH_CASES = {
    "filter_reduce_sum": lambda st, m: q6_like(PORT, st, 256, mode=m),
    "vecmerger": lambda st, m: scatter_add(PORT, st, 1000, 500, mode=m),
    "vecmerger_windows": lambda st, m: scatter_add(PORT, st, 1000, 5000,
                                                   mode=m),
    "dict_group_sum": lambda st, m: groupby(PORT, st, 1000, m),
    "m1_join": lambda st, m: join(PORT, st, 100, 8, mode=m),
    "m1_join_wide": lambda st, m: _wide_join(PORT, st, m),
    "mn_join": lambda st, m: _mn_join(PORT, st, m),
}


@pytest.mark.parametrize("name", sorted(LAUNCH_CASES))
def test_gate_counts_the_launches_each_route_runs(name, monkeypatch):
    """The launches the gate charges (its price with every byte and every
    row free) differ between the routes by as many as the routes run:
    the kernels of "off" less those of "always", each operator at the
    kernels it runs on a card and each kernel wrapper at its own."""
    run = LAUNCH_CASES[name]
    t_runtime.clear_cache()  # a cached program is not priced again
    priced = []
    real = t_cost.estimate
    with monkeypatch.context() as mp:
        mp.setitem(t_cost.HW_H100, "hbm_bw", float("inf"))
        mp.setattr(t_cost, "KEYED_SUM_S_PER_ROW", 0.0)
        mp.setattr(t_cost, "ARGSORT_S_PER_ROW", 0.0)
        mp.setattr(t_cost, "estimate",
                   lambda spec, meta: priced.append(real(spec, meta))
                   or priced[-1])
        run({}, "auto")
    assert priced
    saved = sum(round((e.jnp_s - e.kernel_s) / t_cost.LAUNCH_S)
                for e in priced)
    counted = {}
    for mode in ("off", "always"):
        counter = _Launches()
        with monkeypatch.context() as mp:
            for (mod, attr), launches in KERNEL_LAUNCHES.items():
                mp.setattr(mod, attr, counter.wrap(getattr(mod, attr),
                                                   launches))
            st: dict = {}
            with counter:
                run(st, mode)
        counted[mode] = counter.count
        matched = st.get("kernelize.matched", 0)
        assert matched == (len(priced) if mode == "always" else 0), st
    assert counted["off"] - counted["always"] == saved, counted


# -- the port's own decisions (fault F2) -------------------------------------


def test_groupby_routes_at_a_million_rows_with_the_values_of_off():
    auto, off = {}, {}
    got = groupby(PORT, auto, 1_000_000, "auto")
    want = groupby(PORT, off, 1_000_000, "off")
    assert auto["kernelize.dict_group_sum"] == 1
    assert auto["kernelplan"]["routed"] == {"dict_group_sum": 1}
    assert off.get("kernelize.matched", 0) == 0
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], rtol=1e-12)


@pytest.mark.parametrize("n", [1_000_000, 16_000_000, 59_986_052])
def test_groupby_estimate_routes(n):
    spec = t_kp.get("dict_group_sum")
    est = t_cost.estimate(spec, {"kernel": "dict_group_sum", "n": n,
                                 "k": 4096, "elem_bytes": 8})
    assert est.routed, est
    # the segment kernel streams; no 2 n K one-hot product is priced
    assert est.kernel_s < 2.0 * n * 4096 / t_cost.HW_H100["peak_flops_f64"]


def test_filter_reduce_at_sf10_predicts_the_measured_gain():
    spec = t_kp.get("filter_reduce_sum")
    est = t_cost.estimate(spec, {"kernel": "filter_reduce_sum",
                                 "n": 59_986_052, "n_aggs": 1,
                                 "elem_bytes": 8})
    assert est.routed
    # the card: 0.179 ms for the kernel, 0.505 ms for the plain version
    assert 2.0 <= est.jnp_s / est.kernel_s <= 3.5, est


def test_f64_matmul_is_priced_on_the_fp64_tensor_cores():
    spec = t_kp.get("matmul")
    est = t_cost.estimate(spec, {"kernel": "matmul", "elem_bytes": 8,
                                 "dims": (4096, 4096, 4096)})
    flops = 2.0 * 4096 ** 3
    dmma = flops / t_cost.HW_H100["peak_flops_f64_tc"]
    cuda_cores = flops / t_cost.HW_H100["peak_flops_f64"]
    assert dmma < est.kernel_s < cuda_cores
    # torch.matmul measured faster on the card (2.452 against 2.784 ms)
    assert est.jnp_s < est.kernel_s and not est.routed


def test_f32_matmul_takes_the_route_the_card_measured_faster():
    """The f32 4096^3 product priced at the shares of the FP32 peak that
    tiled_matmul.cu's SGEMM and torch.matmul reached on the card
    (PERF.md, B10 f32): the gate takes the kernel only within
    ROUTE_MARGIN of the library's time."""
    spec = t_kp.get("matmul")
    est = t_cost.estimate(spec, {"kernel": "matmul", "elem_bytes": 4,
                                 "dims": (4096, 4096, 4096)})
    flops = 2.0 * 4096 ** 3
    peak = t_cost.HW_H100["peak_flops_f32"]
    kernel_ms = flops / (peak * t_cost.MATMUL_SHARE["kernel", 4]) * 1e3
    library_ms = flops / (peak * t_cost.MATMUL_SHARE["library", 4]) * 1e3
    assert est.kernel_s == pytest.approx(kernel_ms * 1e-3 + t_cost.LAUNCH_S)
    assert est.routed == (kernel_ms <= library_ms * (1 + t_cost.ROUTE_MARGIN))


@pytest.mark.parametrize("e", (8, 4))
def test_matvec_is_priced_at_the_share_of_its_element_size(e):
    """logreg's matvec (4,194,304 x 64) priced at the shares of the HBM
    rate that the bulk row launch and torch.matmul reached on the card in
    its element size (PERF.md, the B10 matvec rows), one launch each; the
    kernel is priced ahead of the library, as the card measured it, and
    its route is taken."""
    m, k = 4_194_304, 64
    est = t_cost.estimate(t_kp.get("matvec"), {
        "kernel": "matvec", "elem_bytes": e, "dims": (m, k, 1)})
    nbytes = (m * k + k + m) * e
    rate = t_cost.HW_H100["hbm_bw"]
    for route, got in (("kernel", est.kernel_s), ("library", est.jnp_s)):
        assert got == pytest.approx(
            nbytes / (rate * t_cost.MATVEC_SHARE[route, e]) + t_cost.LAUNCH_S)
    assert est.routed and est.kernel_s < est.jnp_s, est


def test_matvec_shares_differ_by_element_size():
    """f32 and f64 rows stream at their own shares of the HBM rate on
    both routes, so the gate keeps one per element size."""
    shares = t_cost.MATVEC_SHARE
    assert set(shares) == {(r, e) for r in ("kernel", "library")
                           for e in (4, 8)}
    assert shares["kernel", 4] != shares["kernel", 8]
    f32 = t_cost.cost_matmul({"dims": (4_194_304, 64, 1), "elem_bytes": 4})
    f64 = t_cost.cost_matmul({"dims": (4_194_304, 64, 1), "elem_bytes": 8})
    launch = t_cost.LAUNCH_S
    assert (f32.kernel_s - launch) / (f64.kernel_s - launch) == \
        pytest.approx(0.5 * shares["kernel", 8] / shares["kernel", 4])


@pytest.mark.parametrize("k", sorted(t_cost.GROUP_PROBE_MS))
def test_group_probe_is_priced_at_its_measured_time(k):
    """The kernel term of the m:n probe at join_mn's 16,777,216 queries
    is the time the card measured for group_probe (the key column staged
    whole at 50,000 keys, every 2nd key at 65,536), and the route is
    taken there."""
    n = 16_777_216
    assert t_cost._group_probe_s(n, k) == pytest.approx(
        t_cost.GROUP_PROBE_MS[k] * 1e-3)
    est = t_cost.estimate(t_kp.get("group_probe"),
                          {"kernel": "group_probe", "n": n, "k": k,
                           "out": 2 * n, "cols": 2, "elem_bytes": 8})
    assert est.routed and est.kernel_s < est.jnp_s, est
