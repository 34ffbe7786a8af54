"""The port's recovery ladder against the JAX package's, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``: the two
workloads where the port used to raise ``CapacityError`` and the
reference regrew and retried (``M.groupby_agg`` over 8,000 keys at
capacity 4,097; ``welddf.groupby_sum`` at capacity 64 over keys {1, 2,
100}), under kernelize "off", "always" and "auto"; then the
reference's own recovery and fault-injection cases (``test_recovery.py``,
``test_verify.py``, the capacity and poison faults of
``test_join_fuzz.py``), each run against both packages.

Tolerances: group-by sums f64 rtol 1e-12 (the two backends sum in
different orders), join rows equal exactly (as sets: a regrown table
may order rows differently).  In every mode the ``recovery.*`` stats
must be equal too (attempts, the events' actions, the regrow factor, the
fallback flag), and so must the routes each package took
(``kernelize.*``).  Under "auto" the two gates decide apart on the
4-row dense group-by, which the port's gate (charging every kernel
launch on either route alike) routes and the reference's does not:
there the port's "auto" run is held to the reference's run on the route
the port took, "always" (``PORT_AUTO_AS``).
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import repro_torch
from repro import errors as r_errors_top
from repro import faults as r_faults_top
from repro.core import check as r_check, faults as r_faults, ir as r_ir
from repro.core import lazy as r_lazy, macros as r_M, recovery as r_recovery
from repro.core import runtime as r_runtime, wtypes as r_wt
from repro.core import errors as r_errors
from repro.frames import welddf as r_welddf, weldrel as r_weldrel
from repro_torch import errors as t_errors_top
from repro_torch import faults as t_faults_top
from repro_torch.core import check as t_check, faults as t_faults, ir as t_ir
from repro_torch.core import lazy as t_lazy, macros as t_M
from repro_torch.core import recovery as t_recovery, runtime as t_runtime
from repro_torch.core import wtypes as t_wt
from repro_torch.core import errors as t_errors
from repro_torch.frames import welddf as t_welddf, weldrel as t_weldrel
from test_join_fuzz import make_case, pd_oracle, _rowset as fuzz_rowset

REF = SimpleNamespace(name="ref", faults=r_faults, faults_top=r_faults_top,
                      recovery=r_recovery, runtime=r_runtime, check=r_check,
                      ir=r_ir, wt=r_wt, M=r_M, lazy=r_lazy, welddf=r_welddf,
                      weldrel=r_weldrel, errors=r_errors,
                      errors_top=r_errors_top)
PORT = SimpleNamespace(name="port", faults=t_faults, faults_top=t_faults_top,
                       recovery=t_recovery, runtime=t_runtime, check=t_check,
                       ir=t_ir, wt=t_wt, M=t_M, lazy=t_lazy,
                       welddf=t_welddf, weldrel=t_weldrel, errors=t_errors,
                       errors_top=t_errors_top)
PKGS = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
MODES = ("off", "always", "auto")
RTOL_F64 = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


@pytest.fixture(autouse=True)
def _isolated():
    """Disarmed faults and cold compile caches around every test."""
    for pkg in (PORT, REF):
        pkg.faults.clear()
        pkg.runtime.clear_cache()
    yield
    for pkg in (PORT, REF):
        pkg.faults.clear()
        pkg.runtime.clear_cache()
        pkg.recovery.set_enabled(None)


def _quiet(fn, *a, **kw):
    """Run ``fn`` collecting the ladder's RuntimeWarnings."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(*a, **kw)
    return out, [str(x.message) for x in w
                 if issubclass(x.category, RuntimeWarning)]


def _routes(stats: dict) -> dict:
    """The routes taken (``kernelize.*`` counts that are not 0)."""
    return {k: v for k, v in stats.items()
            if k.startswith("kernelize.") and v}


def _ladder(stats: dict) -> dict:
    return {
        "attempts": stats.get("recovery.attempts"),
        "actions": [e["action"] for e in stats.get("recovery.events", [])],
        "factor": stats.get("recovery.regrow_factor"),
        "fallback": stats.get("recovery.fallback"),
    }


# ---------------------------------------------------------------------------
# the two workloads of fault F1
# ---------------------------------------------------------------------------


def groupby_agg_8000(pkg, mode, stats):
    """8,000 distinct keys into a dictmerger of capacity 4,097."""
    rng = np.random.RandomState(1)
    L, ir, M = pkg.lazy, pkg.ir, pkg.M
    keys = L.NewWeldObject(rng.permutation(8000).astype(np.int64) * 3, None)
    vals = L.NewWeldObject(rng.rand(8000), None)
    kid = ir.Ident(keys.obj_id, keys.weld_type())
    vid = ir.Ident(vals.obj_id, vals.weld_type())
    obj = L.NewWeldObject([keys, vals],
                          M.groupby_agg(kid, vid, "+", capacity=4097))
    return L.Evaluate(obj, kernelize=mode, collect_stats=stats).value


def groupby_sum_out_of_range(pkg, mode, stats):
    """Key 100 lies outside the dense-key route's [0, 64)."""
    df = pkg.welddf.DataFrame({
        "k": np.array([100, 100, 1, 2], dtype=np.int64),
        "v": np.array([1.0, 2.0, 3.0, 4.0]),
    })
    return df.groupby_sum("k", "v", capacity=64, kernelize=mode,
                          collect_stats=stats)


F1 = {"groupby_agg_8000": groupby_agg_8000,
      "groupby_sum_out_of_range": groupby_sum_out_of_range}


#: the reference's mode whose routes the port's "auto" takes, where its
#: gate decides apart from the reference's (core/kernelplan/cost.py): the
#: dense group-by's route runs 33 kernels against the keyed sum's 46
PORT_AUTO_AS = {"groupby_sum_out_of_range": "always"}


def _same_groups(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_F64, atol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(F1))
def test_f1_workload_matches_the_reference(name, mode):
    t_stats, r_stats = {}, {}
    got, t_warn = _quiet(F1[name], PORT, mode, t_stats)
    want, r_warn = _quiet(F1[name], REF, mode, r_stats)
    _same_groups(got, want)
    if mode == "auto" and name in PORT_AUTO_AS:
        own = _routes(r_stats)
        r_stats = {}
        _, r_warn = _quiet(F1[name], REF, PORT_AUTO_AS[name], r_stats)
        assert _routes(r_stats) != own
    if name == "groupby_sum_out_of_range":
        assert want == {1: 3.0, 2: 4.0, 100: 3.0}
    else:
        assert len(want) == 8000
    assert _ladder(t_stats) == _ladder(r_stats)
    assert t_warn == r_warn
    assert _routes(t_stats) == _routes(r_stats)
    if name == "groupby_agg_8000" or mode == "always":
        # the cases that poison: the ladder ran
        assert t_stats["recovery.attempts"] >= 2
        assert any("weld recovery" in m for m in t_warn)


@pytest.mark.parametrize("name", sorted(F1))
@PKGS
def test_f1_workload_raises_with_recovery_disabled(pkg, name):
    match = ("outside \\[0, capacity\\)" if name == "groupby_sum_out_of_range"
             else "capacity")
    with pkg.recovery.disabled():
        with pytest.raises(pkg.errors.CapacityError, match=match):
            F1[name](pkg, "always", {})
    assert pkg.recovery.enabled()


@PKGS
def test_f1_workload_raises_under_the_env_knob(pkg, monkeypatch):
    monkeypatch.setenv("WELD_RECOVERY", "0")
    with pytest.raises(pkg.errors.CapacityError):
        groupby_agg_8000(pkg, "off", {})


# ---------------------------------------------------------------------------
# fault injection (test_recovery.py)
# ---------------------------------------------------------------------------


@PKGS
def test_fault_spec_env_parsing(pkg, monkeypatch):
    faults = pkg.faults
    assert pkg.faults_top.inject is faults.inject
    monkeypatch.setenv(faults.ENV_FAULTS,
                       "kernel.hash_probe:raise@2, dict.build:poison,"
                       "join.capacity:cap=7@3")
    monkeypatch.setattr(faults, "_armed", None)  # force env re-read
    armed = faults.armed()
    assert armed["kernel.hash_probe"][0] == {
        "action": "raise", "value": None, "remaining": 2}
    assert armed["dict.build"][0]["remaining"] == 1
    assert armed["join.capacity"][0] == {
        "action": "cap", "value": 7, "remaining": 3}
    monkeypatch.setattr(faults, "_armed", None)
    monkeypatch.setenv(faults.ENV_FAULTS, "garbage-no-colon")
    with pytest.raises(ValueError, match="site:action"):
        faults.armed()
    monkeypatch.setattr(faults, "_armed", None)
    monkeypatch.setenv(faults.ENV_FAULTS, "x:frobnicate")
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.armed()
    monkeypatch.setattr(faults, "_armed", None)
    monkeypatch.delenv(faults.ENV_FAULTS)


@PKGS
def test_fault_consumption_and_fingerprint(pkg):
    faults = pkg.faults
    assert faults.fingerprint() == ""  # unarmed: no cache-key pollution
    faults.inject("decode", "raise", times=2)
    fp0 = faults.fingerprint()
    assert "decode:raise@2" in fp0
    with pytest.raises(pkg.errors.InjectedFault,
                       match="fault injected at decode"):
        faults.maybe_raise("decode")
    assert faults.fingerprint() != fp0  # remaining count is in the key
    faults.maybe_raise("io.test-site")  # unarmed site: no-op
    with pytest.raises(pkg.errors.InjectedFault):
        faults.maybe_raise("decode")
    faults.maybe_raise("decode")  # spent: no-op
    assert faults.fingerprint() == ""
    assert [f["site"] for f in faults.fired()] == ["decode", "decode"]
    faults.inject("io.ledger", "raise")
    with pytest.raises(OSError):
        faults.maybe_raise("io.ledger", exc=OSError)


@PKGS
def test_error_aliases(pkg):
    for name in ("WeldError", "CapacityError", "ResourceError",
                 "KernelCompileError", "InjectedFault", "WeldVerifyError"):
        assert getattr(pkg.errors_top, name) is getattr(pkg.errors, name)
    assert issubclass(pkg.errors.CapacityError, ValueError)


# ---------------------------------------------------------------------------
# the ladder (test_recovery.py)
# ---------------------------------------------------------------------------


def _join_tables(pkg):
    w = pkg.weldrel
    L = w.Table({"k": np.array([1, 2, 2, 3, 3, 3], dtype=np.int64),
                 "a": np.array([10.0, 20, 21, 30, 31, 32])})
    R = w.Table({"k": np.array([2, 2, 3, 5], dtype=np.int64),
                 "b": np.array([1.0, 2, 3, 4])})
    return L, R


def _rowset(t):
    cols = sorted(t.cols)
    arrs = [np.asarray(t.cols[c].to_numpy()) for c in cols]
    return {tuple(str(a[i]) for a in arrs) for i in range(len(arrs[0]))}


def _join(pkg, mode, **kw):
    L, R = _join_tables(pkg)
    impl = {"kernel_impl": "ref"} if pkg is REF else {}
    return pkg.weldrel.Query(L).join(R, on="k", kernelize=mode, **impl, **kw)


@PKGS
def test_mn_join_capacity_fault_recovers_to_oracle(pkg):
    want = _rowset(_join(pkg, "always"))
    pkg.runtime.clear_cache()
    pkg.faults.inject("join.capacity", "cap", times=1, value=1)
    st: dict = {}
    got, msgs = _quiet(_join, pkg, "always", collect_stats=st)
    assert _rowset(got) == want
    assert st["recovery.attempts"] >= 2
    assert all(e["action"] == "regrow" for e in st["recovery.events"])
    assert st["recovery.regrow_factor"] >= 2
    assert not st["recovery.fallback"]
    assert any("weld recovery" in m for m in msgs)
    assert pkg.faults.fired()[0]["site"] == "join.capacity"


def test_mn_join_capacity_fault_ladder_matches_the_reference():
    stats = {}
    for pkg in (PORT, REF):
        pkg.faults.inject("join.capacity", "cap", times=1, value=1)
        st: dict = {}
        got, _ = _quiet(_join, pkg, "always", collect_stats=st)
        stats[pkg.name] = (_rowset(got), _ladder(st))
    assert stats["port"] == stats["ref"]


def test_undersized_symbolic_capacity_regrows_in_both():
    """precount=False with a capacity below the distinct build keys (no
    host count refuses it): both packages poison, regrow and return the
    rows of a run with enough capacity."""
    rng = np.random.RandomState(3)
    lcols = {"k": rng.randint(0, 80, 2000).astype(np.int64),
             "a": rng.rand(2000)}
    rcols = {"k": np.repeat(np.arange(40, dtype=np.int64) * 2, 3),
             "b": rng.rand(120)}
    seen = {}
    for pkg in (PORT, REF):
        w = pkg.weldrel
        impl = {"kernel_impl": "ref"} if pkg is REF else {}
        want = w.Query(w.Table(lcols)).join(w.Table(rcols), on="k",
                                            kernelize="always", **impl)
        st: dict = {}
        got, _ = _quiet(lambda: w.Query(w.Table(lcols)).join(
            w.Table(rcols), on="k", kernelize="always", precount=False,
            capacity=12, collect_stats=st, **impl))
        assert _rowset(got) == _rowset(want)
        assert st["recovery.attempts"] >= 2
        seen[pkg.name] = (_rowset(got), _ladder(st))
    assert seen["port"] == seen["ref"]


@PKGS
def test_recovery_disabled_surfaces_typed_capacity_error(pkg):
    pkg.faults.inject("join.capacity", "cap", times=1, value=1)
    with pkg.recovery.disabled():
        with pytest.raises(pkg.errors.CapacityError):
            _join(pkg, "always")
    assert pkg.recovery.enabled()  # context manager restored the default


@PKGS
def test_recovery_env_knob(pkg, monkeypatch):
    recovery = pkg.recovery
    try:
        monkeypatch.setenv(recovery.ENV_RECOVERY, "off")
        assert not recovery.enabled()
        monkeypatch.setenv(recovery.ENV_RECOVERY, "1")
        assert recovery.enabled()
        recovery.set_enabled(False)
        assert not recovery.enabled()
        recovery.set_enabled(None)  # back to the env
        assert recovery.enabled()
    finally:
        recovery.set_enabled(None)


@PKGS
def test_injected_decode_poison_recovers_then_exhausts(pkg):
    pkg.faults.inject("decode", "poison", times=1)
    st: dict = {}
    got, _ = _quiet(_join, pkg, "off", collect_stats=st)
    assert st["recovery.attempts"] == 2
    assert len(_rowset(got)) == 7
    pkg.faults.clear()
    pkg.runtime.clear_cache()
    pkg.faults.inject("decode", "poison", times=99)  # deeper than the ladder
    with pytest.raises(pkg.errors.CapacityError, match="recovery exhausted"):
        _quiet(_join, pkg, "off")


@PKGS
@pytest.mark.parametrize("site,mode", [("group.build", "off"),
                                       ("kernel.group_build", "always")])
def test_injected_build_poison_recovers(pkg, site, mode):
    """A poison forced where a builder sets its overflow flag (the
    generic group build, or after the group_build kernel's launch) is
    indistinguishable from a real overflow: the ladder absorbs it."""
    want = _rowset(_join(pkg, mode))
    pkg.runtime.clear_cache()
    pkg.faults.inject(site, "poison", times=1)
    st: dict = {}
    got, _ = _quiet(_join, pkg, mode, collect_stats=st)
    assert _rowset(got) == want
    assert [f["site"] for f in pkg.faults.fired()] == [site]
    assert st["recovery.attempts"] == 2


def _keyed_program(pkg, keys_np, vals_np, capacity):
    L, ir, M = pkg.lazy, pkg.ir, pkg.M
    keys = L.NewWeldObject(keys_np, None)
    vals = L.NewWeldObject(vals_np, None)
    kid = ir.Ident(keys.obj_id, keys.weld_type())
    vid = ir.Ident(vals.obj_id, vals.weld_type())
    return L.NewWeldObject([keys, vals],
                           M.groupby_agg(kid, vid, "+", capacity=capacity))


@PKGS
def test_generic_build_overflow_poisons_not_truncates(pkg):
    """The generic dictmerger flags the same negative-count poison the
    kernels do: recovered to the full result, or a typed error."""
    vals_np = np.random.RandomState(7).rand(100)
    keys_np = np.arange(100, dtype=np.int64)
    Evaluate = pkg.lazy.Evaluate
    want = Evaluate(_keyed_program(pkg, keys_np, vals_np, 256),
                    kernelize="off").value
    assert len(want) == 100
    st: dict = {}
    got, _ = _quiet(lambda: Evaluate(
        _keyed_program(pkg, keys_np, vals_np, 32), kernelize="off",
        collect_stats=st).value)
    assert st["recovery.attempts"] >= 2  # 32 -> 64 -> 128
    _same_groups(got, want)
    with pkg.recovery.disabled():
        with pytest.raises(pkg.errors.CapacityError,
                           match="poisoned|distinct|capacity"):
            Evaluate(_keyed_program(pkg, keys_np, vals_np, 32),
                     kernelize="off")


def _overflow_parity(pkg):
    keys_np = (np.arange(300, dtype=np.int64) % 150) * 2
    vals_np = np.random.RandomState(7).rand(300)
    outs, ladders = {}, {}
    for mode in ("always", "off"):
        st: dict = {}
        outs[mode], _ = _quiet(lambda: pkg.lazy.Evaluate(
            _keyed_program(pkg, keys_np, vals_np, 64), kernelize=mode,
            collect_stats=st).value)
        assert st["recovery.attempts"] >= 2, mode
        ladders[mode] = _ladder(st)
    assert len(outs["always"]) == 150
    _same_groups(outs["always"], outs["off"])
    return ladders


@PKGS
def test_kernel_generic_overflow_parity(pkg):
    """Same undersized program, kernel and generic routes: both poison,
    both recover to identical results."""
    _overflow_parity(pkg)


def test_kernel_generic_overflow_ladders_match_the_reference():
    assert _overflow_parity(PORT) == _overflow_parity(REF)


# ---------------------------------------------------------------------------
# weldcheck's differential check of a regrow (test_verify.py)
# ---------------------------------------------------------------------------


def _dict_loop(pkg, cap):
    ir, wt = pkg.ir, pkg.wt
    xs = ir.Ident("xs", wt.Vec(wt.F64))
    bty = wt.DictMerger(wt.I64, wt.F64, "+")
    b, i, e = (ir.Ident("b", bty), ir.Ident("i", wt.I64),
               ir.Ident("e", wt.F64))
    return ir.Result(ir.For(
        (ir.Iter(xs),), ir.NewBuilder(bty, arg=ir.Literal(cap, wt.I64)),
        ir.Lambda((b, i, e),
                  ir.Merge(b, ir.MakeStruct((ir.Cast(e, wt.I64), e))))))


@PKGS
def test_verify_rewrite_rejects_shrinking_regrow(pkg):
    check = pkg.check
    before, after = _dict_loop(pkg, 16), _dict_loop(pkg, 8)
    check.set_enabled(True)
    try:
        with pytest.raises(pkg.errors.WeldVerifyError) as exc:
            check.verify_rewrite("recovery.regrow", before, after)
        assert "WV404" in exc.value.codes
        # a genuine regrow passes
        grown, n = pkg.recovery.regrow_capacities(before, 2)
        assert n == 1
        check.verify_rewrite("recovery.regrow", before, grown)
    finally:
        check.set_enabled(None)


def test_regrow_restamps_what_the_reference_restamps():
    got = PORT.recovery.regrow_capacities(_dict_loop(PORT, 16), 4)
    want = REF.recovery.regrow_capacities(_dict_loop(REF, 16), 4)
    assert got[1] == want[1] == 1
    assert PORT.ir.canon_key(got[0]) == REF.ir.canon_key(want[0])


# ---------------------------------------------------------------------------
# the join fuzzer's fault profile (test_join_fuzz.py), capacity and poison
# ---------------------------------------------------------------------------


def _fuzz_run(pkg, lcols, rcols, on, how, mode, filtered):
    w = pkg.weldrel
    t, r = w.Table(lcols), w.Table(rcols)
    q = w.Query(t)
    if filtered:
        q = q.filter(t.col("lv") > 0.5)
    impl = {"kernel_impl": "ref"} if pkg is REF else {}
    out = q.join(r, on=on, how=how, kernelize=mode, **impl)
    return {c: np.asarray(w._host(out.cols[c])) for c in out.cols}


FUZZ_FAULTS = (
    ("join.capacity", "cap", 1),
    ("decode", "poison", None),
    ("group.build", "poison", None),
    ("kernel.group_build", "poison", None),
    ("kernel.dict_hash_build", "poison", None),
)


@pytest.mark.parametrize("seed", [77, 78])
def test_join_fuzz_fault_injection(seed):
    """Seeded cases, each re-run with a drawn failpoint armed: the port
    recovers to the pandas oracle (or the fault never fired), and a
    consumed decode poison with recovery disabled raises the typed
    error.  The reference's kernel-raise faults need the quarantine rung,
    which the port does not have yet."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    faults, recovery = PORT.faults, PORT.recovery
    for _ in range(12):
        lcols, rcols, on, how, filtered = make_case(rng)
        on_list = on if isinstance(on, list) else [on]
        site, action, value = FUZZ_FAULTS[rng.randint(0, len(FUZZ_FAULTS))]
        mode = ("off", "always")[rng.randint(0, 2)]
        if how == "anti" and pd.DataFrame(rcols)[on_list].duplicated().any():
            continue  # error-parity shape: held by the healthy profile
        m = (lcols["lv"] > 0.5) if filtered else None
        want = fuzz_rowset(pd_oracle(lcols, rcols, on, how, m=m))
        try:
            faults.inject(site, action, times=1, value=value)
            got, _ = _quiet(_fuzz_run, PORT, lcols, rcols, on, how, mode,
                            filtered)
            assert fuzz_rowset(got) == want, (site, mode, how, on, filtered)
            fired = [f["site"] for f in faults.fired()]
            if site == "decode" and site in fired:
                faults.clear()
                PORT.runtime.clear_cache()
                faults.inject(site, action, times=1, value=value)
                with recovery.disabled():
                    with pytest.raises(PORT.errors.CapacityError):
                        _fuzz_run(PORT, lcols, rcols, on, how, mode,
                                  filtered)
        finally:
            faults.clear()
