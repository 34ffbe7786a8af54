"""The port's verifier made cheaper without changing what it checks.

* ``Expr.children`` and ``map_children`` read a tuple of child-field
  names kept per class: they give what the ``dataclasses.fields`` walk
  gives, node for node, for every ``Expr`` subclass; ``ir.walk`` visits
  what the recursive preorder walk visits, in its order.
* ``races.lint_races`` finds the reads of a builder under construction
  with one pass over a loop body: its diagnostics equal those of the
  walk that asked each ``Let`` anew, on clean programs and on planted
  WV302 faults.
* ``check.checkpoint`` reuses a clean verdict only for the very object
  the last checkpoint of the same compile verified, with the same env
  and shapes; a checkpoint after a pass that changed nothing counts in
  ``verify.reused`` (and still in ``verify.runs``); an equal copy, an
  object with a planted fault, another compile's stats, ``verify_rewrite``
  and ``check.verify`` are verified in full.
* ``tools/weldlint_torch.py --mutate 3 --device cpu`` still catches every
  mutant it applies.
"""
from __future__ import annotations

import dataclasses
import os
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch
from repro_torch.core import check, ir, wtypes as wt
from repro_torch.core.check import mutate, races
from repro_torch.core.check.diagnostics import Diagnostic
from repro_torch.core.errors import WeldVerifyError
from repro_torch.frames import weldrel

ROOT = Path(__file__).resolve().parents[1]


def _subclasses(cls):
    for sub in cls.__subclasses__():
        yield sub
        yield from _subclasses(sub)


EXPR_CLASSES = sorted(set(_subclasses(ir.Expr)), key=lambda c: c.__name__)


def _fields_children(node):
    """The walk ``Expr.children`` made before: every field, by
    ``dataclasses.fields``."""
    out = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ir.Expr):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(c for c in v if isinstance(c, ir.Expr))
    return tuple(out)


def _sample(cls):
    """An instance of ``cls`` with every field filled by its annotation
    (Expr fields by distinct literals), built past the constructors'
    checks as the mutation harness builds its mutants."""
    lit = iter(ir.Literal(i, wt.I64) for i in range(100))
    ident = ir.Ident("x%0", wt.I64)
    lam = ir.Lambda((ident,), next(lit))
    by_type = {
        "Expr": lambda: next(lit), "Optional[Expr]": lambda: next(lit),
        "Tuple[Expr, ...]": lambda: (next(lit), next(lit)),
        "Tuple[Ident, ...]": lambda: (ident, ir.Ident("y%0", wt.I64)),
        "Tuple[Iter, ...]": lambda: (ir.Iter(next(lit), None, None, None),),
        "Tuple[Lambda, ...]": lambda: (lam,),
        "Lambda": lambda: lam,
        "Tuple[Tuple[str, object], ...]": lambda: (("k", 3),),
        "str": lambda: "n", "int": lambda: 1, "object": lambda: 7,
        "WeldType": lambda: wt.I64, "wt.Scalar": lambda: wt.I64,
        "wt.BuilderType": lambda: wt.VecBuilder(wt.I64),
    }
    node = object.__new__(cls)
    for f in dataclasses.fields(cls):
        object.__setattr__(node, f.name, by_type[f.type]())
    return node


def _fields_changes(node, fn):
    """The fields the ``dataclasses.fields`` walk of ``map_children``
    replaced, and their new values."""
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ir.Expr):
            if fn(v) is not v:
                changes[f.name] = fn(v)
        elif isinstance(v, tuple) and any(isinstance(c, ir.Expr) for c in v):
            nv = tuple(fn(c) if isinstance(c, ir.Expr) else c for c in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return changes


@pytest.mark.parametrize("cls", EXPR_CLASSES, ids=lambda c: c.__name__)
def test_children_equal_the_fields_walk(cls, monkeypatch):
    node = _sample(cls)
    assert ir.child_fields(cls) == tuple(
        f.name for f in dataclasses.fields(cls)
        if f.type not in ("str", "int", "WeldType", "wt.Scalar",
                          "wt.BuilderType"))
    kids = node.children()
    assert len(kids) == len(_fields_children(node))
    assert all(a is b for a, b in zip(kids, _fields_children(node)))
    assert node.map_children(lambda c: c) is node
    swapped = {id(c): ir.Literal(-1, wt.I64) for c in kids}

    def fn(c):
        return swapped.get(id(c), c)

    # the sample skips the constructors' checks: read the changes that
    # map_children hands to ``replace`` instead of building the node
    monkeypatch.setattr(ir, "replace", lambda obj, **changes: changes)
    got = node.map_children(fn)
    want = _fields_changes(node, fn)
    if not want:
        assert got is node and not kids
        return
    assert got.keys() == want.keys() and len(want) == len({
        f for f in ir.child_fields(cls)
        if any(isinstance(c, ir.Expr) for c in (
            getattr(node, f) if isinstance(getattr(node, f), tuple)
            else (getattr(node, f),)))})
    for name, value in want.items():
        if isinstance(value, tuple):
            assert all(a is b for a, b in zip(got[name], value))
        else:
            assert got[name] is value


def _corpus():
    """The weldlint corpus's planned programs (verification on), their
    shapes and stats, on the CPU."""
    from repro_torch.core import runtime

    repro_torch.set_default_device("cpu")
    runtime.clear_cache()
    rng = np.random.RandomState(11)
    n = 512
    left = weldrel.Table({"k": rng.randint(0, 64, n).astype(np.int64),
                          "lv": rng.rand(n)})
    uniq = weldrel.Table({"k": np.arange(64, dtype=np.int64),
                          "rv": rng.rand(64)})
    mn = weldrel.Table({"k": rng.randint(0, 16, 128).astype(np.int64),
                        "rv": rng.rand(128)})
    out = []
    for run in (lambda kw: weldrel.Query(left).join(uniq, on="k", how="inner",
                                                    **kw),
                lambda kw: weldrel.Query(left).join(mn, on="k", how="left",
                                                    **kw),
                lambda kw: weldrel.Query(left).group_agg(
                    [left.col("k")], {"s": (left.col("lv"), "+")}, **kw)):
        for mode in ("off", "always"):
            st = {}
            run({"collect_stats": st, "kernelize": mode})
            out.append(st)
    return out


@pytest.fixture(scope="module")
def corpus():
    old = check._override
    check.set_enabled(True)
    try:
        yield _corpus()
    finally:
        check.set_enabled(old)


def _recursive_walk(e):
    yield e
    for c in _fields_children(e):
        yield from _recursive_walk(c)


def test_walk_visits_in_the_recursive_preorder(corpus):
    for st in corpus:
        e = st["plan.ir"]
        assert [id(n) for n in ir.walk(e)] == [
            id(n) for n in _recursive_walk(e)]


def _races_by_walks(e, types):
    """``lint_races`` as it was: WV302's mentions asked by walking each
    Let's value and each read's target anew."""
    diags = []
    flagged = set()
    for node in ir.walk(e):
        ty = node.ty if isinstance(node, (ir.NewBuilder, ir.Ident)) else None
        for bad in races._bad_op_types(ty) if ty is not None else ():
            if id(node) in flagged:
                continue
            flagged.add(id(node))
            diags.append(Diagnostic("WV301", "", node, analysis="races"))
    for node in ir.walk(e):
        if not isinstance(node, ir.For) or not node.func.params:
            continue
        bparam = node.func.params[0]
        iparam = node.func.params[1] if len(node.func.params) > 1 else None
        derived = {bparam.name}

        def mentions(x):
            return any(isinstance(n, ir.Ident) and n.name in derived
                       for n in ir.walk(x))

        def rec(x):
            if isinstance(x, ir.Let):
                rec(x.value)
                if mentions(x.value):
                    derived.add(x.name)
                rec(x.body)
                return
            if isinstance(x, (ir.Result, ir.Lookup, ir.GroupLookup,
                              ir.KeyExists, ir.Len)):
                target = x.builder if isinstance(x, ir.Result) else x.expr
                if mentions(target):
                    diags.append(Diagnostic("WV302", "", x,
                                            analysis="races"))
            if isinstance(x, ir.Merge):
                races._lint_scatter(x, iparam, types, diags)
            for c in x.children():
                rec(c)

        rec(node.func.body)
    return [(d.code, id(d.node)) for d in diags]


def _read_mid_build(e, rng):
    """A planted WV302: a loop body that binds the length of a result of
    its own builder and merges it, under a Let chain (the derived name
    reaches the read through two bindings)."""
    loops = [n for n in ir.walk(e) if isinstance(n, ir.For)
             and len(n.func.params) >= 1
             and isinstance(n.func.params[0].ty, wt.BuilderType)]
    if not loops:
        return None
    loop = rng.choice(loops)
    b = loop.func.params[0]
    alias = ir.Ident(ir.fresh("alias"), b.ty)
    seen = ir.Ident(ir.fresh("seen"), wt.I64)
    body = ir.Let(alias.name, b, ir.Let(
        seen.name, ir.Len(ir.Result(alias)), loop.func.body))
    bad = dataclasses.replace(loop, func=dataclasses.replace(loop.func,
                                                             body=body))
    return mutate._replace_node(e, loop, bad)


def test_races_single_pass_equals_the_walk_per_let(corpus):
    rng = random.Random(5)
    planted = 0
    for st in corpus:
        e = st["plan.ir"]
        for prog in (e, _read_mid_build(e, rng)):
            if prog is None:
                continue
            env = check._free_env(prog)
            types, _ = check.annotate(prog, env)
            got = [(d.code, id(d.node)) for d in races.lint_races(prog,
                                                                  types)]
            assert got == _races_by_walks(prog, types)
            planted += prog is not e and ("WV302" in {c for c, _ in got})
    assert planted > 0


def test_a_checkpoint_after_a_pass_that_changed_nothing_reuses(corpus):
    for st in corpus:
        phases = [p for p, _ in st["verify.phases"]]
        assert st["verify.runs"] == len(phases)
        assert 0 < st["verify.reused"] < st["verify.runs"]
    e = corpus[0]["plan.ir"]
    stats = {}
    with check_on():
        check.checkpoint("a", e, stats=stats)
        check.checkpoint("b", e, stats=stats)           # the same object
        check.checkpoint("c", e, env=check._free_env(e), stats=stats)
        check.checkpoint("d", e, stats=stats, shapes={"x": (3,)})
        check.checkpoint("e", e, stats=stats, shapes={"x": (3,)})
    assert stats["verify.runs"] == 5 and stats["verify.reused"] == 3
    assert [p for p, _ in stats["verify.phases"]] == list("abcde")


class check_on:
    def __enter__(self):
        self.old = check._override
        check.set_enabled(True)

    def __exit__(self, *exc):
        check.set_enabled(self.old)


def test_only_the_very_object_of_the_same_compile_is_reused(corpus):
    e = corpus[0]["plan.ir"]
    copy = ir.postorder_map(e, lambda x: dataclasses.replace(x))
    assert copy == e and copy is not e
    stats, other = {}, {}
    with check_on():
        check.checkpoint("a", e, stats=stats)
        check.checkpoint("b", copy, stats=stats)        # equal, not `is`
        check.checkpoint("c", copy, stats=other)        # another compile
        check.checkpoint("d", copy, stats=stats)        # the last was other's
        check.verify_rewrite("e", copy, copy, stats=stats)
        check.checkpoint("f", copy, stats=stats)        # after verify_rewrite
    assert stats["verify.runs"] == 5 and stats.get("verify.reused") == 1
    assert other["verify.runs"] == 1 and other["verify.reused"] == 0


def test_a_planted_fault_equal_but_for_it_raises(corpus):
    rng = random.Random(3)
    raised = 0
    for st in corpus:
        e = st["plan.ir"]
        shapes = st["plan.inputs"][2]
        for name, mutator in mutate.MUTATORS.items():
            m = mutator(e, rng)
            if m is None or not check.verify(m.mutant, shapes=shapes):
                continue
            stats = {}
            with check_on():
                check.checkpoint("clean", e, stats=stats, shapes=shapes)
                with pytest.raises(WeldVerifyError):
                    check.checkpoint("faulty", m.mutant, stats=stats,
                                     shapes=shapes)
                # the fault is not remembered as clean: the clean program
                # is verified again, the faulty one raises again
                check.checkpoint("clean", e, stats=stats, shapes=shapes)
                with pytest.raises(WeldVerifyError):
                    check.checkpoint("faulty", m.mutant, stats=stats,
                                     shapes=shapes)
            assert stats["verify.reused"] == 0
            raised += 1
    assert raised >= len(mutate.MUTATORS) // 2


def test_weldlint_mutate_3_catches_every_mutant():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "weldlint_torch.py"),
         "--mutate", "3", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    applied = int(re.search(r"mutants applied: (\d+)", out.stdout).group(1))
    caught = int(re.search(r"caught \(right code, right node\): (\d+)",
                           out.stdout).group(1))
    assert applied == caught == 93, out.stdout
