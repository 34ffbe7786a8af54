"""The port's verifier in one walk, against the JAX package's verifier.

``check.verify`` types the program and gathers what the lints read in
one walk (``verify_types.walk``); the lints read its events where each
walked the tree again, and the bounds lint runs the interval analysis
only where the program declares a size it could contradict.

* On the weldlint corpus (planned and input programs) and on seeded
  mutants of each (every mutator of ``check.mutate``, three rounds), the
  port's diagnostics equal the reference's: code, analysis, the node
  (by preorder place), message and data, identifier names taken by
  their first place in the program (the two packages number fresh names
  apart).
* The walk's events equal those of the plain preorder scan
  (``facts.scan``) kind for kind, node for node, each span holding the
  same names; the free identifiers' annotations equal ``ir.free_vars``'
  wherever the walk gives them.
* Wherever the bounds lint skips the analysis, the analysis finds
  nothing to report.
"""
from __future__ import annotations

import random
import re

import numpy as np
import pytest

import repro_torch
from repro.core import check as r_check
from repro.core import ir as r_ir
from repro.core import runtime as r_runtime
from repro.core.check import mutate as r_mutate
from repro.frames import weldrel as r_weldrel
from repro_torch.core import check as t_check
from repro_torch.core import ir as t_ir
from repro_torch.core import runtime as t_runtime
from repro_torch.core.check import bounds_lint, facts, verify_types
from repro_torch.core.check import mutate as t_mutate
from repro_torch.frames import weldrel as t_weldrel

ROUNDS = 3


def _corpus(weldrel, runtime, check):
    """The weldlint corpus (``tools/weldlint_torch.py``'s, under its
    pinned "off"): each item's input program, env and shapes, and its
    planned program and shapes."""
    rng = np.random.RandomState(11)
    n = 512
    left = weldrel.Table({"k": rng.randint(0, 64, n).astype(np.int64),
                          "lv": rng.rand(n)})
    uniq = weldrel.Table({"k": np.arange(64, dtype=np.int64),
                          "rv": rng.rand(64)})
    mn = weldrel.Table({"k": rng.randint(0, 16, 128).astype(np.int64),
                        "rv": rng.rand(128)})
    seen = []
    checkpoint = runtime.check.checkpoint

    def spy(phase, e, env=None, stats=None, shapes=None):
        if phase == "input":
            seen.append((e, env, shapes))
        return checkpoint(phase, e, env=env, stats=stats, shapes=shapes)

    runtime.check.checkpoint = spy
    out = []
    try:
        for how, right in (("inner", uniq), ("inner", mn), ("left", uniq),
                           ("left", mn), (None, None)):
            st = {}
            kw = {"collect_stats": st, "kernelize": "off"}
            if how is None:
                weldrel.Query(left).group_agg(
                    [left.col("k")], {"s": (left.col("lv"), "+")}, **kw)
            else:
                weldrel.Query(left).join(right, on="k", how=how, **kw)
            out.append((st["plan.ir"], None, st["plan.inputs"][2]))
    finally:
        runtime.check.checkpoint = checkpoint
    return out + seen


def _programs(weldrel, runtime, check, mutate):
    """The corpus and its seeded mutants: (program, env, shapes)."""
    progs = []
    for pi, (e, env, shapes) in enumerate(_corpus(weldrel, runtime,
                                                  check)):
        progs.append((e, env, shapes))
        rng = random.Random(pi)
        for name in sorted(mutate.MUTATORS):
            for _ in range(ROUNDS):
                m = mutate.MUTATORS[name](e, rng)
                if m is not None:
                    progs.append((m.mutant, env, shapes))
    return progs


@pytest.fixture(scope="module")
def programs():
    repro_torch.set_default_device("cpu")
    return (_programs(r_weldrel, r_runtime, r_check, r_mutate),
            _programs(t_weldrel, t_runtime, t_check, t_mutate))


def _names(e, ir):
    """Each identifier of ``e`` by its first place in preorder."""
    order = {}
    for n in ir.walk(e):
        for name in ((n.name,) if isinstance(n, (ir.Ident, ir.Let))
                     else ()):
            order.setdefault(name, f"<v{len(order)}>")
    return order


def _plain(e, diags, ir):
    order = _names(e, ir)
    pat = (re.compile("|".join(re.escape(k) for k in sorted(
        order, key=len, reverse=True))) if order else None)

    def norm(v):
        return pat.sub(lambda m: order[m.group(0)], v) \
            if pat is not None and isinstance(v, str) else v

    place = {id(n): i for i, n in reversed(list(enumerate(ir.walk(e))))}
    return [(d.code, d.analysis, place.get(id(d.node)), norm(d.message),
             sorted((k, norm(v)) for k, v in (d.data or {}).items()))
            for d in diags]


def test_diagnostics_equal_the_references_on_the_corpus_and_mutants(
        programs):
    ref, port = programs
    assert len(ref) == len(port) > 100
    faulty = 0
    for (re_, renv, rshp), (te, tenv, tshp) in zip(ref, port):
        want = _plain(re_, r_check.verify(re_, env=renv, shapes=rshp), r_ir)
        got = _plain(te, t_check.verify(te, env=tenv, shapes=tshp), t_ir)
        assert got == want
        faulty += bool(got)
    assert faulty > 50


def _events(e, fx):
    out = []
    for ev in fx.events:
        kind = ev[0]
        if kind in (facts.LET, facts.LAM, facts.READ):
            # the walk types a loop's builder before its iters: a span
            # holds the same names, in another order
            spans = [sorted(fx.names[ev[i]:ev[i + 1]])
                     for i in range(2, len(ev) - 1)]
            out.append((kind, id(ev[1]), spans))
        elif kind in (facts.LOOP, facts.END):
            out.append((kind,))
        else:
            out.append((kind, id(ev[1])))
    return out


def test_the_walk_gathers_what_the_scan_gathers(programs):
    _, port = programs
    unsure = 0
    for e, env, _ in port:
        _, _, walked = verify_types.walk(e, env or {})
        scanned = facts.scan(e)
        assert _events(e, walked) == _events(e, scanned)
        assert sorted(walked.names) == sorted(scanned.names)
        if walked.free is None:
            unsure += 1
        else:
            assert walked.free == t_ir.free_vars(e)
    assert unsure < len(port) // 10


def test_the_bounds_lint_skips_only_what_it_could_not_fault(
        programs, monkeypatch):
    _, port = programs
    skipped = 0
    for e, env, shapes in port:
        if bounds_lint._declares_a_size(facts.scan(e)):
            continue
        skipped += 1
        with monkeypatch.context() as m:
            m.setattr(bounds_lint, "_declares_a_size", lambda fx: True)
            assert bounds_lint.lint_bounds(e, {}, shapes=shapes) == []
    assert skipped > 50
