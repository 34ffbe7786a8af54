#!/usr/bin/env python
"""Recovery smoke of the PyTorch port (the counterpart of faults_smoke.py).

Drives the adaptive recovery runtime end to end with deterministic
fault injection — the degradation paths no healthy workload reaches:

* an m:n join forced onto an undersized build capacity
  (``join.capacity:cap=4``) must recover by regrowing and match the
  un-faulted rows, with the ladder visible as RuntimeWarnings and
  ``recovery.*`` stats;
* a join whose kernel launch is made to fail (``kernel.<name>:raise``)
  must quarantine the offender in the health file; on the CPU it
  degrades to the generic lowering and the NEXT compile rejects the
  quarantined route at the cost gate, on a card it raises and the NEXT
  compile raises at the gate — either way without a cache clear,
  proving the quarantine fingerprint invalidates the compile cache;
* with recovery disabled the same capacity fault surfaces as the typed
  ``CapacityError``.

Every evaluation goes through ``repro_torch`` on the device given
(``--device``, default ``cuda``); a quarantine key names that device.
State is confined to a temp directory (health file + ledger) so the
smoke never pollutes — or depends on — the checkout's own health file.

    PYTHONPATH=src python tools/faults_smoke_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import warnings

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_TOOLS, "..", "src"))

_td = tempfile.mkdtemp(prefix="weld-faults-smoke-")
os.environ["WELD_KERNEL_HEALTH"] = os.path.join(_td, "kernel_health.json")
os.environ["WELD_COST_LEDGER"] = os.path.join(_td, "cost_ledger.jsonl")

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import errors, faults  # noqa: E402
from repro_torch.core import recovery, runtime  # noqa: E402
from repro_torch.core.kernelplan import quarantine  # noqa: E402
from repro_torch.frames import weldrel  # noqa: E402


def _rowset(t):
    cols = sorted(t.cols)
    arrs = [np.asarray(t.cols[c].to_numpy()) for c in cols]
    return sorted(zip(*[a.tolist() for a in arrs]))


def _tables(rng):
    k, n, fanout = 32, 2048, 3
    rkey = np.repeat(np.arange(k, dtype=np.int64), fanout)
    right = weldrel.Table({"key": rkey, "rate": rng.rand(rkey.size)})
    left = weldrel.Table({
        "key": rng.randint(0, 2 * k, n).astype(np.int64),
        "price": rng.rand(n),
    })
    return left, right


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="evaluation device (default: cuda)")
    args = ap.parse_args(argv)
    repro_torch.set_default_device(args.device)
    rng = np.random.RandomState(11)
    left, right = _tables(rng)

    # -- 1. capacity fault on an m:n join: regrow to parity -------------
    want = _rowset(weldrel.Query(left).join(right, on="key",
                                            kernelize="always"))
    runtime.clear_cache()
    # cap=4 against 32 distinct build keys: x2/x4 still overflow, the
    # third rung (x8 = 32) fits — the deepest recoverable ladder
    faults.inject("join.capacity", "cap", times=1, value=4)
    st: dict = {}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = weldrel.Query(left).join(right, on="key", kernelize="always",
                                       collect_stats=st)
    assert _rowset(got) == want, "recovered join differs from healthy run"
    assert st.get("recovery.attempts", 0) >= 2, st
    assert any("weld recovery" in str(x.message) for x in w), \
        "recovery must warn"
    assert faults.fired(), "the armed capacity fault never fired"
    faults.clear()
    print(f"join capacity fault: recovered after "
          f"{st['recovery.attempts']} attempts "
          f"(regrow x{st['recovery.regrow_factor']}), rows match")

    # -- 1b. group-by with an injected generic-build poison --------------
    runtime.clear_cache()
    want_gb = weldrel.Query(left).group_agg(
        [left.col("key")], {"s": (left.col("price"), "+")},
        capacity=128, kernelize="off")
    faults.inject("dict.build", "poison", times=1)
    stg: dict = {}
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        got_gb = weldrel.Query(left).group_agg(
            [left.col("key")], {"s": (left.col("price"), "+")},
            capacity=128, kernelize="off", collect_stats=stg)
    assert stg.get("recovery.attempts", 0) >= 2, stg
    assert set(got_gb) == set(want_gb) and all(
        abs(got_gb[k][0] - want_gb[k][0]) < 1e-9 for k in want_gb)
    faults.clear()
    print(f"group-by build poison: recovered after "
          f"{stg['recovery.attempts']} attempts, groups match")

    # -- 2. kernel fault: quarantine + cost gate ------------------------
    runtime.clear_cache()
    quarantine.clear(disk=True)
    want_g = _rowset(weldrel.Query(left).join(right, on="key",
                                              kernelize="off"))
    qfp = quarantine.fingerprint()
    faults.inject("kernel.group_build", "raise", times=1)
    st2: dict = {}
    if quarantine.on_card():
        # a card never swaps a kernel for the generic lowering: it raises
        try:
            weldrel.Query(left).join(right, on="key", kernelize="always")
        except errors.KernelCompileError:
            pass
        else:
            raise AssertionError("a kernel fault on the card must raise")
        qkeys = list(quarantine.entries())
    else:
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            got2 = weldrel.Query(left).join(right, on="key",
                                            kernelize="always",
                                            collect_stats=st2)
        assert _rowset(got2) == want_g, \
            "fallback join differs from generic run"
        assert st2.get("recovery.fallback"), st2
        qkeys = st2.get("recovery.quarantined") or []
    assert len(qkeys) == 1 and qkeys[0].startswith("group_build|"), qkeys
    assert qkeys[0].endswith("|" + quarantine.device_name()), qkeys
    assert os.path.exists(os.environ["WELD_KERNEL_HEALTH"]), \
        "health file not written"
    assert quarantine.fingerprint() != qfp, \
        "quarantine fingerprint must change (compile-cache invalidation)"
    faults.clear()
    # next compile, NO cache clear: the gate consults the quarantine
    if quarantine.on_card():
        try:
            weldrel.Query(left).join(right, on="key", kernelize="always")
        except errors.KernelQuarantinedError:
            pass
        else:
            raise AssertionError("the gate must raise on the card")
        verdict = "raised at the cost gate"
    else:
        st3: dict = {}
        got3 = weldrel.Query(left).join(right, on="key", kernelize="always",
                                        collect_stats=st3)
        assert _rowset(got3) == want_g
        kp = st3.get("kernelplan", {})
        assert kp.get("rejected", {}).get("group_build"), kp
        assert any(c.get("why") == "quarantined"
                   for c in kp.get("costs", [])), kp
        assert "recovery.attempts" not in st3, \
            "healthy run touched the ladder"
        verdict = "rejected it at the cost gate"
    quarantine.clear(disk=True)
    got4 = weldrel.Query(left).join(right, on="key", kernelize="always")
    assert _rowset(got4) == want_g
    print(f"kernel fault: quarantined {qkeys[0]}; next compile {verdict}; "
          f"after quarantine.clear() the kernel route ran again")

    # -- 3. recovery disabled: the typed error surfaces ------------------
    runtime.clear_cache()
    faults.inject("join.capacity", "cap", times=1, value=4)
    try:
        with recovery.disabled():
            try:
                weldrel.Query(left).join(right, on="key", kernelize="always")
            except errors.CapacityError:
                pass
            else:
                raise AssertionError(
                    "recovery.disabled() must surface CapacityError")
    finally:
        faults.clear()
    print("recovery disabled: typed CapacityError surfaced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
