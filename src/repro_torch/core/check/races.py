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
from .diagnostics import Diagnostic

_MERGER_FAMILY = (wt.Merger, wt.DictMerger, wt.VecMerger)

#: read operations that observe a collection's contents
_READS = (ir.Result, ir.Lookup, ir.GroupLookup, ir.KeyExists, ir.Len)


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
) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    flagged: Set[int] = set()

    # -- WV301: corrupted merge ops, wherever the type is embedded -------
    loops: List[ir.For] = []
    for node in ir.walk(e):
        ty = None
        if isinstance(node, ir.NewBuilder):
            ty = node.ty
        elif isinstance(node, ir.Ident):
            ty = node.ty
        elif isinstance(node, ir.For):
            loops.append(node)
        for bad in _bad_op_types(ty) if ty is not None else ():
            if id(node) in flagged:
                continue
            flagged.add(id(node))
            diags.append(Diagnostic(
                "WV301",
                f"non-commutative merge op {bad.op!r} on {bad} — parallel "
                f"merges reorder freely, result is nondeterministic",
                node, analysis="races", data={"op": bad.op}))

    # -- WV302/WV303: per-loop body analysis -----------------------------
    for loop in loops:
        _lint_loop(loop, types, diags)
    return diags


def _lint_loop(loop: ir.For, types, diags: List[Diagnostic]) -> None:
    if not loop.func.params:
        return
    bparam = loop.func.params[0]
    iparam = loop.func.params[1] if len(loop.func.params) > 1 else None
    body = loop.func.body

    # names whose value derives from the loop's builder param: the
    # builder's and those of Lets whose value mentions one already in it
    derived: Set[str] = {bparam.name}
    candidates = {bparam.name} | {n.name for n in ir.walk(body)
                                  if isinstance(n, ir.Let)}
    mentioned = _mentions(body, candidates)

    def mentions_derived(x: ir.Expr) -> bool:
        return not mentioned[id(x)].isdisjoint(derived)

    def rec(x: ir.Expr) -> None:
        if isinstance(x, ir.Let):
            rec(x.value)
            if mentions_derived(x.value):
                derived.add(x.name)
            rec(x.body)
            return
        if isinstance(x, _READS):
            target = x.builder if isinstance(x, ir.Result) else x.expr
            if mentions_derived(target):
                diags.append(Diagnostic(
                    "WV302",
                    f"loop body reads builder {bparam.name} while it is "
                    f"still being built ({type(x).__name__.lower()})",
                    x, analysis="races", data={"builder": bparam.name}))
        if isinstance(x, ir.Merge):
            _lint_scatter(x, iparam, types, diags)
        for c in x.children():
            rec(c)

    rec(body)


_NONE: frozenset = frozenset()


def _mentions(e: ir.Expr, names: Set[str]) -> Dict[int, frozenset]:
    """id(node) -> the names of ``names`` that an Ident under the node
    (itself included) carries, for every node of ``e``: one post-order
    pass (a shared subtree once), where asking each Let's value anew
    walked a subtree once per enclosing Let."""
    out: Dict[int, frozenset] = {}

    def rec(x: ir.Expr) -> frozenset:
        got = out.get(id(x))
        if got is not None:
            return got
        if isinstance(x, ir.Ident):
            got = frozenset((x.name,)) if x.name in names else _NONE
        else:
            got = _NONE
            for c in x.children():
                sub = rec(c)
                if sub:
                    got = sub if not got else got | sub
        out[id(x)] = got
        return got

    rec(e)
    return out


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
