"""Mutation harness: seeded IR sabotage to measure verifier recall.

Each mutator takes a well-typed program and returns ``(mutant,
expected_codes, target)`` — a broken variant, the diagnostic codes that
would legitimately catch it, and the node (or its replacement) the
verifier should name.  ``run_mutations`` applies every applicable
mutator at every applicable site (or a seeded sample) and scores the
verifier: a *catch* requires at least one diagnostic with an expected
code anchored at the mutated node (or any node for whole-type
corruptions, where the offender is a type embedded at many sites).

The mutators deliberately bypass the IR/type constructors
(``object.__setattr__`` on frozen dataclasses) — that is the point:
weldcheck guards against *passes* corrupting programs in ways the
constructors would have rejected.
"""
from __future__ import annotations

import copy
import random
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .. import ir
from .. import wtypes as wt
from . import verify
from .diagnostics import Diagnostic


@dataclass
class Mutation:
    """One applied sabotage."""
    name: str
    mutant: ir.Expr
    expected: Set[str]
    #: the node whose replacement carries the defect (None = anywhere)
    target: Optional[ir.Expr]


@dataclass
class Score:
    applied: int = 0
    caught: int = 0
    misses: List[Tuple[str, List[str]]] = None  # (mutator, codes seen)

    def __post_init__(self):
        if self.misses is None:
            self.misses = []

    @property
    def rate(self) -> float:
        return self.caught / self.applied if self.applied else 1.0


def _replace_node(root: ir.Expr, old: ir.Expr,
                  new: ir.Expr) -> ir.Expr:
    """Rebuild ``root`` with the single occurrence of ``old`` (by
    identity) swapped for ``new``."""

    def rec(x: ir.Expr) -> ir.Expr:
        if x is old:
            return new
        return x.map_children(rec)

    return rec(root)


def _sites(e: ir.Expr, pred: Callable[[ir.Expr], bool]) -> List[ir.Expr]:
    return [n for n in ir.walk(e) if pred(n)]


# -- mutators ------------------------------------------------------------


def drop_result(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Delete a Result(For(...)) wrapper: the loop's builder escapes
    unconsumed / the program's type changes."""
    sites = _sites(e, lambda n: isinstance(n, ir.Result))
    if not sites:
        return None
    r = rng.choice(sites)
    # a dropped result shows up as a type break at the use sites
    # (WV101/WV102), an unconsumed or loop-captured builder
    # (WV201/WV204/WV205), or a builder-typed program root (WV201)
    return Mutation("drop_result", _replace_node(e, r, r.builder),
                    {"WV101", "WV102", "WV201", "WV204", "WV205"},
                    r.builder)


def swap_merge_op(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Corrupt a merger-family op to non-commutative '-' in place
    (bypassing the constructor's commutativity guard)."""

    def has_merger(n):
        return isinstance(n, ir.NewBuilder) and isinstance(
            n.ty, (wt.Merger, wt.DictMerger, wt.VecMerger))

    sites = _sites(e, has_merger)
    if not sites:
        return None
    nb = rng.choice(sites)
    bad_ty = copy.copy(nb.ty)
    object.__setattr__(bad_ty, "op", "-")
    bad = replace(nb, ty=bad_ty)
    return Mutation("swap_merge_op", _replace_node(e, nb, bad),
                    {"WV301"}, bad)


def shrink_capacity(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Zero out a dict/group capacity literal."""

    def is_cap(n):
        return (isinstance(n, ir.NewBuilder)
                and isinstance(n.ty, (wt.DictMerger, wt.GroupBuilder))
                and isinstance(n.arg, ir.Literal))

    sites = _sites(e, is_cap)
    if not sites:
        return None
    nb = rng.choice(sites)
    bad = replace(nb, arg=ir.Literal(0, nb.arg.ty))
    return Mutation("shrink_capacity", _replace_node(e, nb, bad),
                    {"WV401"}, bad)


def retype_param(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Flip a scalar lambda parameter's type (i64 <-> f64): the loop
    signature check and every arithmetic use goes inconsistent."""

    def scalar_param(n):
        return isinstance(n, ir.Lambda) and any(
            isinstance(p.ty, wt.Scalar) for p in n.params)

    sites = _sites(e, scalar_param)
    if not sites:
        return None
    lam = rng.choice(sites)
    idx = rng.choice([i for i, p in enumerate(lam.params)
                      if isinstance(p.ty, wt.Scalar)])
    old_p = lam.params[idx]
    new_ty = wt.F64 if old_p.ty != wt.F64 else wt.I64
    new_p = ir.Ident(old_p.name, new_ty)
    bad = replace(lam, params=tuple(
        new_p if i == idx else p for i, p in enumerate(lam.params)))
    return Mutation("retype_param", _replace_node(e, lam, bad),
                    {"WV101", "WV102"}, None)


def getfield_oob(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Push a GetField index out of range."""
    sites = _sites(e, lambda n: isinstance(n, ir.GetField))
    if not sites:
        return None
    gf = rng.choice(sites)
    bad = replace(gf, index=gf.index + 64)
    return Mutation("getfield_oob", _replace_node(e, gf, bad),
                    {"WV101"}, bad)


def dup_builder(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Alias a builder-typed loop and merge into both names — the
    classic linearity violation."""

    def builder_for(n):
        return isinstance(n, ir.For) and isinstance(
            n.builder, ir.NewBuilder)

    sites = _sites(e, builder_for)
    if not sites:
        return None
    loop = rng.choice(sites)
    name = ir.fresh("dup")
    # let dup = newbuilder in for(iters, dup, fn(... uses of dup twice))
    alias = ir.Ident(name, loop.builder.ty)
    bad_for = replace(loop, builder=alias)
    two = ir.Let(name, loop.builder,
                 ir.MakeStruct((bad_for, alias)))
    return Mutation("dup_builder", _replace_node(e, loop, two),
                    {"WV202", "WV101", "WV201", "WV205"}, None)


def _probe_out_caps(e: ir.Expr, left_only: bool = False
                    ) -> List[ir.KernelCall]:
    """Planned ``group_probe`` calls carrying an ``out_cap`` param (the
    post-kernelplan spelling of an expansion-buffer size)."""
    out = []
    for n in ir.walk(e):
        if not (isinstance(n, ir.KernelCall)
                and n.kernel == "group_probe"):
            continue
        params = dict(n.params)
        if "out_cap" not in params:
            continue
        if left_only and not (params.get("how") == "left"
                              and not params.get("has_pred")):
            continue
        out.append(n)
    return out


def _with_out_cap(kc: ir.KernelCall, value: int) -> ir.KernelCall:
    return replace(kc, params=tuple(
        (k, value if k == "out_cap" else v) for k, v in kc.params))


def inflate_size_hint(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Blow a vecbuilder size hint (or a planned group_probe out_cap)
    far past anything the inputs could produce — the weldbound interval
    analysis proves the declared size exceeds the derived upper bound
    (WV502: budget provably wasted / certificate inflated)."""

    def is_hinted(n):
        return (isinstance(n, ir.NewBuilder)
                and isinstance(n.ty, wt.VecBuilder)
                and isinstance(n.size_hint, ir.Literal))

    sites = _sites(e, is_hinted) + _probe_out_caps(e)
    if not sites:
        return None
    s = rng.choice(sites)
    if isinstance(s, ir.NewBuilder):
        huge = int(s.size_hint.value) * 1000 + 10 ** 7
        bad: ir.Expr = replace(
            s, size_hint=ir.Literal(huge, s.size_hint.ty))
    else:
        huge = int(dict(s.params)["out_cap"]) * 1000 + 10 ** 7
        bad = _with_out_cap(s, huge)
    return Mutation("inflate_size_hint", _replace_node(e, s, bad),
                    {"WV502"}, bad)


def undersize_hint(e: ir.Expr, rng: random.Random) -> Optional[Mutation]:
    """Shrink an expansion-buffer size below the weldbound-derived lower
    bound (WV501: provable truncation).  Only left-join expansion sites
    carry a nonzero derived lower bound (every probe row emits at least
    one output row), so the sites are hinted vecbuilders initializing a
    loop whose body is guarded by KeyExists — the left m:n shape — or a
    planned left group_probe."""
    sites: List[ir.Expr] = []
    for n in ir.walk(e):
        if not (isinstance(n, ir.For) and isinstance(n.func, ir.Lambda)):
            continue
        body = n.func.body
        if not (isinstance(body, ir.If)
                and isinstance(body.cond, ir.KeyExists)):
            continue
        init = n.builder
        items = init.items if isinstance(init, ir.MakeStruct) else (init,)
        for item in items:
            if (isinstance(item, ir.NewBuilder)
                    and isinstance(item.ty, wt.VecBuilder)
                    and isinstance(item.size_hint, ir.Literal)):
                sites.append(item)
    sites += _probe_out_caps(e, left_only=True)
    if not sites:
        return None
    s = rng.choice(sites)
    if isinstance(s, ir.NewBuilder):
        bad: ir.Expr = replace(s, size_hint=ir.Literal(
            1, s.size_hint.ty))
    else:
        bad = _with_out_cap(s, 1)
    return Mutation("undersize_hint", _replace_node(e, s, bad),
                    {"WV501"}, bad)


MUTATORS: Dict[str, Callable] = {
    "drop_result": drop_result,
    "swap_merge_op": swap_merge_op,
    "shrink_capacity": shrink_capacity,
    "retype_param": retype_param,
    "getfield_oob": getfield_oob,
    "dup_builder": dup_builder,
    "inflate_size_hint": inflate_size_hint,
    "undersize_hint": undersize_hint,
}


def run_mutations(
    programs: Sequence[ir.Expr],
    seed: int = 0,
    rounds: int = 3,
    mutators: Optional[Sequence[str]] = None,
    shapes: Optional[Sequence[Optional[dict]]] = None,
) -> Score:
    """Apply each mutator ``rounds`` times per program (seeded) and
    score how many mutants the verifier catches with an expected code.

    ``shapes`` (one input-shapes dict per program, or None) lets the
    bounds lint resolve symbolic sizes — the WV501/WV502 mutators are
    only catchable when the derived bounds evaluate to numbers.
    """
    rng = random.Random(seed)
    score = Score()
    names = list(mutators if mutators is not None else MUTATORS)
    for pi, prog in enumerate(programs):
        shp = shapes[pi] if shapes is not None else None
        for mname in names:
            for _ in range(rounds):
                m = MUTATORS[mname](prog, rng)
                if m is None:
                    continue
                score.applied += 1
                diags = verify(m.mutant, shapes=shp)
                if _caught(m, diags):
                    score.caught += 1
                else:
                    score.misses.append(
                        (mname, sorted({d.code for d in diags})))
    return score


def _caught(m: Mutation, diags: List[Diagnostic]) -> bool:
    hits = [d for d in diags if d.code in m.expected]
    if not hits:
        return False
    if m.target is None:
        return True
    # the verifier must name the mutated node, a node inside it, or an
    # enclosing node (a deletion is correctly blamed on the binding that
    # now holds the broken value)
    inside = {id(n) for n in ir.walk(m.target)}
    for d in hits:
        if d.node is None:
            continue
        if id(d.node) in inside:
            return True
        if any(n is m.target for n in ir.walk(d.node)):
            return True
    return False
