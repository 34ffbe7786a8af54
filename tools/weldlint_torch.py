#!/usr/bin/env python
"""weldlint for the PyTorch port: run the weldcheck static verifier from
the command line (the counterpart of ``tools/weldlint.py``, through
``repro_torch``).

Modes:

* ``--smoke`` (the CI gate) — compile a representative corpus (hash
  join, m:n join, group-by) with verification on, assert every
  checkpoint ran clean, print the per-phase timing table, and gate the
  verifier's overhead at <10% of compile time;
* ``--mutate N`` — run the seeded mutation harness N rounds per
  mutator over the same corpus and report verifier recall (gated at
  >=95%);
* ``--bounds-smoke`` — the weldbound gate: every corpus pipeline must
  carry a peak-memory certificate in its stats, the analysis overhead
  must stay <10% of compile time, and the symbolic (no host pre-count)
  m:n certificate must render in ``explain()``;
* ``--demo`` — print a diagnostic rendered on a deliberately broken
  program (what a failing checkpoint looks like).

State is confined to a temp directory (autotune cache + ledger) so the
smoke never pollutes — or depends on — the developer's caches.

The modes and gates are the reference's.  One departure: each corpus
item runs under the ``kernelize`` mode that the reference's ``"auto"``
takes on it at the corpus's sizes (:data:`PINNED`), so that both tools
verify and mutate the same planned programs; under the port's own
``"auto"`` its cost gate prices its own kernels and routes some of these
small joins apart from the reference's.

The corpus evaluates on the card (``--device cuda``, the default; no
card raises) unless ``--device cpu`` is given.

    PYTHONPATH=src python tools/weldlint_torch.py --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_TOOLS, "..", "src"))

_td = tempfile.mkdtemp(prefix="weld-lint-")
os.environ["WELD_AUTOTUNE_CACHE"] = os.path.join(_td, "autotune.json")
os.environ["WELD_COST_LEDGER"] = os.path.join(_td, "cost_ledger.jsonl")
os.environ["WELD_VERIFY"] = "1"

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import check, ir, wtypes as wt  # noqa: E402
from repro_torch.core.check import mutate  # noqa: E402
from repro_torch.frames import weldrel  # noqa: E402

OVERHEAD_GATE = 0.10  # verify time / compile time
RECALL_GATE = 0.95

#: each corpus item's ``kernelize``: the route the reference's ``"auto"``
#: takes on it at these sizes (its cost gate prices every kernel above
#: the generic lowering and rejects it, so nothing is routed: "off")
PINNED = {
    "join.inner.1:1": "off",   # rejects dict_hash_build, hash_probe
    "join.inner.m:n": "off",   # rejects group_build, group_probe
    "join.left": "off",        # rejects dict_hash_build, hash_probe
    "join.left.m:n": "off",    # rejects group_build, group_probe
    "group_agg.sum": "off",    # rejects dict_hash_build
}


def corpus():
    """(label, stats) per representative pipeline — the planned IR rides
    in stats['plan.ir'], verify counters in stats['verify.*']."""
    rng = np.random.RandomState(11)
    n = 512
    left = weldrel.Table({"k": rng.randint(0, 64, n).astype(np.int64),
                          "lv": rng.rand(n)})
    uniq = weldrel.Table({"k": np.arange(64, dtype=np.int64),
                          "rv": rng.rand(64)})
    mn = weldrel.Table({"k": rng.randint(0, 16, 128).astype(np.int64),
                        "rv": rng.rand(128)})
    out = []
    for label, run in (
            ("join.inner.1:1", lambda kw: weldrel.Query(left).join(
                uniq, on="k", how="inner", **kw)),
            ("join.inner.m:n", lambda kw: weldrel.Query(left).join(
                mn, on="k", how="inner", **kw)),
            ("join.left", lambda kw: weldrel.Query(left).join(
                uniq, on="k", how="left", **kw)),
            ("join.left.m:n", lambda kw: weldrel.Query(left).join(
                mn, on="k", how="left", **kw)),
            ("group_agg.sum", lambda kw: weldrel.Query(left).group_agg(
                [left.col("k")], {"s": (left.col("lv"), "+")}, **kw))):
        st = {}
        run({"collect_stats": st, "kernelize": PINNED[label]})
        out.append((label, st))
    return out


def cmd_smoke() -> int:
    from repro_torch.core import runtime

    runtime.clear_cache()
    print("== weldlint --smoke ==")
    total_verify = 0.0
    total_compile = 0.0
    runs = 0
    for label, st in corpus():
        vms = st.get("verify.ms", 0.0)
        cms = st.get("compile_ms", 0.0)
        vruns = st.get("verify.runs", 0)
        if vruns == 0:
            print(f"FAIL {label}: no verify checkpoints ran")
            return 1
        plan = st.get("plan.ir")
        resid = check.verify(plan) if plan is not None else []
        if resid:
            print(f"FAIL {label}: planned IR has diagnostics:")
            for d in resid:
                print("  " + d.render(plan))
            return 1
        total_verify += vms
        total_compile += cms
        runs += vruns
        print(f"  {label:<18} checkpoints={vruns:<3} "
              f"verify={vms:7.1f}ms compile={cms:8.1f}ms "
              f"({vms / cms:6.1%})")
    frac = total_verify / total_compile if total_compile else 0.0
    print(f"  {'TOTAL':<18} checkpoints={runs:<3} "
          f"verify={total_verify:7.1f}ms compile={total_compile:8.1f}ms "
          f"({frac:6.1%})")
    if frac >= OVERHEAD_GATE:
        print(f"FAIL: verifier overhead {frac:.1%} >= "
              f"{OVERHEAD_GATE:.0%} of compile time")
        return 1
    print(f"OK: corpus clean, overhead {frac:.1%} < {OVERHEAD_GATE:.0%}")
    return 0


def cmd_mutate(rounds: int, seed: int) -> int:
    print(f"== weldlint --mutate (rounds={rounds}, seed={seed}) ==")
    caught = [st for _, st in corpus() if "plan.ir" in st]
    progs = [st["plan.ir"] for st in caught]
    # bound input shapes per program: the WV501/WV502 bounds mutators
    # are only catchable when derived symbolic sizes evaluate to numbers
    shapes = [st.get("plan.inputs", (None, None, None))[2]
              for st in caught]
    score = mutate.run_mutations(progs, seed=seed, rounds=rounds,
                                 shapes=shapes)
    print(f"  mutants applied: {score.applied}")
    print(f"  caught (right code, right node): {score.caught} "
          f"({score.rate:.0%})")
    for name, seen in score.misses:
        print(f"  MISS {name}: diagnostics seen {seen}")
    if score.rate < RECALL_GATE:
        print(f"FAIL: recall {score.rate:.0%} < {RECALL_GATE:.0%}")
        return 1
    print(f"OK: recall {score.rate:.0%} >= {RECALL_GATE:.0%}")
    return 0


def cmd_bounds_smoke() -> int:
    """weldbound gate: every corpus pipeline gets a peak-memory
    certificate, analysis overhead stays <10% of compile time, and the
    symbolic m:n certificate (no host pre-count) renders in explain()."""
    from repro_torch.core import runtime

    runtime.clear_cache()
    print("== weldlint --bounds-smoke ==")
    total_bounds = 0.0
    total_compile = 0.0
    for label, st in corpus():
        for key in ("bounds.certificate", "bounds.peak_bytes",
                    "bounds.admitted"):
            if key not in st:
                print(f"FAIL {label}: no {key} in stats (analysis "
                      f"failed or was skipped)")
                return 1
        if not st["bounds.admitted"]:
            print(f"FAIL {label}: rejected with no memory_limit set")
            return 1
        bms = st.get("bounds.ms", 0.0)
        cms = st.get("compile_ms", 0.0)
        total_bounds += bms
        total_compile += cms
        print(f"  {label:<18} peak={st['bounds.peak_bytes']:>12} "
              f"bounds={bms:6.2f}ms compile={cms:8.1f}ms  "
              f"cert: {st['bounds.certificate'][:60]}")
    frac = total_bounds / total_compile if total_compile else 0.0
    if frac >= OVERHEAD_GATE:
        print(f"FAIL: bounds-analysis overhead {frac:.1%} >= "
              f"{OVERHEAD_GATE:.0%} of compile time")
        return 1
    # golden: the symbolic certificate of an m:n join with NO host
    # pre-count must render in explain() in terms of the input lengths
    rng = np.random.RandomState(7)
    left = weldrel.Table({"k": rng.randint(0, 16, 256).astype(np.int64),
                          "lv": rng.rand(256)})
    mn = weldrel.Table({"k": rng.randint(0, 16, 64).astype(np.int64),
                        "rv": rng.rand(64)})
    rep = weldrel.Query(left).explain().join(mn, on="k", how="left",
                                             precount=False)
    txt = rep.render()
    if "-- bounds --" not in txt or "len(" not in txt:
        print("FAIL: precount=False explain() lacks a symbolic "
              "'-- bounds --' certificate:")
        print(txt)
        return 1
    i = txt.index("-- bounds --")
    print("  golden symbolic m:n certificate (precount=False):")
    for line in txt[i:].splitlines()[:4]:
        print("  " + line)
    print(f"OK: certificates on corpus, overhead {frac:.1%} < "
          f"{OVERHEAD_GATE:.0%}, symbolic certificate renders")
    return 0


def cmd_demo() -> int:
    bty = wt.DictMerger(wt.I64, wt.F64, "+")
    xs = ir.Ident("xs", wt.Vec(wt.F64))
    b, i, e = (ir.Ident("b", bty), ir.Ident("i", wt.I64),
               ir.Ident("e", wt.F64))
    prog = ir.Result(ir.For(
        (ir.Iter(xs),),
        ir.NewBuilder(bty, arg=ir.Literal(0, wt.I64)),
        ir.Lambda((b, i, e),
                  ir.Merge(b, ir.MakeStruct((ir.Cast(e, wt.I64), e))))))
    try:
        check.checkpoint("pass.demo", prog)
    except check.WeldVerifyError as err:
        print(str(err))
        return 0
    print("expected the demo program to fail verification")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="weldlint_torch", description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: corpus clean + overhead < 10%%")
    ap.add_argument("--mutate", type=int, metavar="N", default=None,
                    help="mutation harness, N rounds per mutator")
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--bounds-smoke", action="store_true",
                    help="weldbound gate: certificates + overhead < 10%%"
                         " + symbolic m:n golden")
    ap.add_argument("--demo", action="store_true",
                    help="show a rendered diagnostic")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the corpus evaluates (default: cuda)")
    args = ap.parse_args(argv)
    repro_torch.set_default_device(args.device)
    if args.smoke:
        return cmd_smoke()
    if args.mutate is not None:
        return cmd_mutate(args.mutate, args.seed)
    if args.bounds_smoke:
        return cmd_bounds_smoke()
    if args.demo:
        return cmd_demo()
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
