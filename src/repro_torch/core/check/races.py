"""Analysis 3: merge-race lint for parallel loops.

Weld ``for`` loops are parallel: iterations may interleave or reorder
arbitrarily, so a loop is only sound when its merges commute and nothing
reads a builder mid-construction.  Three lints:

* **WV301** — a merger-family builder (merger / dictmerger / vecmerger)
  carries a merge op outside the commutative set.  The type constructors
  reject these, so a hit means a pass (or a mutation) corrupted the type
  in place.
* **WV302** — the loop body *reads* a value derived from the loop's own
  builder (``result``/``lookup``/``grouplookup``/``keyexists``/``len``
  of it): observing a builder still being built races with the merges.
* **WV303** — a vecmerger scatter whose index expression can alias
  across iterations (it is not the bare loop index) combined with a
  non-commutative op: reordered iterations hitting one slot disagree.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from .. import ir
from .. import wtypes as wt
from . import facts as F
from .diagnostics import Diagnostic

_MERGER_FAMILY = (wt.Merger, wt.DictMerger, wt.VecMerger)

def _bad_op_types(ty) -> List[wt.WeldType]:
    """Merger-family types reachable inside ``ty`` whose op is not
    commutative (recurses into struct builders)."""
    out = []
    if isinstance(ty, _MERGER_FAMILY) and ty.op not in wt.MERGE_OPS:
        out.append(ty)
    if isinstance(ty, wt.StructBuilder):
        for b in ty.builders:
            out.extend(_bad_op_types(b))
    return out


def lint_races(
    e: ir.Expr,
    types: Dict[int, Optional[wt.WeldType]],
    facts: Optional[F.Facts] = None,
) -> List[Diagnostic]:
    """WV301 over every builder-typed Ident and NewBuilder in preorder,
    then each loop's WV302/WV303 in loop preorder: one pass over the
    events of :func:`~.facts.scan`, each loop body's events read by
    every loop open around them."""
    if facts is None:
        facts = F.scan(e)
    diags: List[Diagnostic] = []
    flagged: Set[int] = set()
    names = facts.names
    #: per loop, by its ordinal: [builder param, index param, the names
    #: derived from the builder, the loop's diagnostics], or None for a
    #: loop with no params; ``order``: the loops in preorder
    loops: Dict[int, Optional[list]] = {}
    order: List[Optional[list]] = []
    open_: List[list] = []

    for ev in facts.events:
        kind = ev[0]
        if kind == F.TY:
            node = ev[1]
            # -- WV301: corrupted merge ops, wherever the type is embedded
            for bad in _bad_op_types(node.ty):
                if id(node) in flagged:
                    continue
                flagged.add(id(node))
                diags.append(Diagnostic(
                    "WV301",
                    f"non-commutative merge op {bad.op!r} on {bad} — "
                    f"parallel merges reorder freely, result is "
                    f"nondeterministic",
                    node, analysis="races", data={"op": bad.op}))
        elif kind == F.FOR:
            params = ev[1].func.params
            st = loops[ev[2]] = [
                params[0], params[1] if len(params) > 1 else None,
                {params[0].name}, []] if params else None
            order.append(st)
        # -- WV302/WV303: what the open loops' bodies do ------------------
        elif kind == F.LOOP:
            st = loops[ev[1]]
            if st is not None:
                open_.append(st)
        elif kind == F.END:
            if loops[ev[1]] is not None:
                open_.pop()
        elif kind == F.LET:
            # names whose value derives from the loop's builder param:
            # the builder's and those of Lets whose value mentions one
            # already in it
            seen = names[ev[2]:ev[3]]
            for st in open_:
                if not st[2].isdisjoint(seen):
                    st[2].add(ev[1].name)
        elif kind == F.READ:
            seen = names[ev[2]:ev[3]]
            for st in open_:
                if not st[2].isdisjoint(seen):
                    st[3].append(Diagnostic(
                        "WV302",
                        f"loop body reads builder {st[0].name} while it "
                        f"is still being built "
                        f"({type(ev[1]).__name__.lower()})",
                        ev[1], analysis="races",
                        data={"builder": st[0].name}))
        elif kind == F.MERGE:
            for st in open_:
                _lint_scatter(ev[1], st[1], types, st[3])
    for st in order:
        if st is not None:
            diags.extend(st[3])
    return diags


def _lint_scatter(m: ir.Merge, iparam: Optional[ir.Ident], types,
                  diags: List[Diagnostic]) -> None:
    """WV303: vecmerger {index, value} merge with an alias-capable index
    under a non-commutative combine."""
    bt = types.get(id(m.builder))
    if bt is None and isinstance(m.builder, ir.Ident):
        bt = m.builder.ty
    if not isinstance(bt, wt.VecMerger):
        return
    if bt.op in wt.MERGE_OPS:
        return  # commutative combines tolerate aliasing by construction
    idx = (m.value.items[0]
           if isinstance(m.value, ir.MakeStruct) and len(m.value.items) == 2
           else None)
    if idx is None or _index_injective(idx, iparam):
        return
    diags.append(Diagnostic(
        "WV303",
        f"vecmerger scatter index can alias across iterations and the "
        f"combine op {bt.op!r} is not commutative",
        m, analysis="races", data={"op": bt.op}))


def _index_injective(idx: ir.Expr, iparam: Optional[ir.Ident]) -> bool:
    """Conservatively true only for the bare loop index (optionally
    shifted by a constant) — anything data-dependent can alias."""
    if iparam is None:
        return False
    if isinstance(idx, ir.Ident):
        return idx.name == iparam.name
    if isinstance(idx, ir.Cast):
        return _index_injective(idx.expr, iparam)
    if isinstance(idx, ir.BinOp) and idx.op in ("+", "-"):
        l_i = isinstance(idx.left, ir.Ident) and idx.left.name == iparam.name
        r_i = (isinstance(idx.right, ir.Ident)
               and idx.right.name == iparam.name)
        l_c = isinstance(idx.left, ir.Literal)
        r_c = isinstance(idx.right, ir.Literal)
        return (l_i and r_c) or (r_i and l_c)
    return False
