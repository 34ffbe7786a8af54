"""One walk that gathers what the lints read of a program.

Linearity, races, capacity and the bounds lint each walked the whole
tree; they now read the events of this one preorder walk (children left
to right, as ``ir.walk``), each in the order its own walk met the nodes:

* ``TY`` — an ``Ident`` (a ``Lambda`` parameter too) or ``NewBuilder``
  whose type is a builder (the only ones WV301 can flag);
* ``LET`` — after the binding's value, before its body;
* ``LAM`` — after the parameters, before the body;
* ``FOR`` — a ``For``, with its ordinal among the loops; ``LOOP`` …
  ``END`` around the events of its loop body;
* ``READ`` — a ``Result``/``Lookup``/``GroupLookup``/``KeyExists``/
  ``Len``, with the span of the collection it reads;
* ``MERGE``, ``NB`` (``NewBuilder``), ``KC`` (``KernelCall``).

``names`` lists the name of every ``Ident`` in walk order, so a subtree
is a slice of it (``starts``/``ends``: ``id(node) ->`` the slice's bounds,
for every node but an ``Ident`` or ``Literal``): whether a subtree mentions a name is a
search of its slice, where each lint walked the subtree again.  A ``LET`` event is
``[LET, node, value_start, body_start, body_end]``, a ``LAM`` event
``[LAM, node, body_start, body_end]`` and a ``READ`` event ``[READ,
node, target_start, target_end]``, spans into ``names``.

``free`` gives each free identifier's annotation as ``ir.free_vars``
does (the first one met; the walk visits in its order).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .. import ir
from .. import wtypes as wt

TY, LET, LAM, FOR, LOOP, END, READ, MERGE, NB, KC = range(10)

#: the read operations whose collection WV302 asks about, and the field
#: that holds the collection (their first child)
READ_TARGET = {ir.Result: "builder", ir.Lookup: "expr",
                ir.GroupLookup: "expr", ir.KeyExists: "expr",
                ir.Len: "expr"}


class Facts:
    __slots__ = ("events", "names", "starts", "ends", "free", "loops")

    def __init__(self):
        self.events: list = []
        self.names: List[str] = []
        self.starts: Dict[int, int] = {}
        self.ends: Dict[int, int] = {}
        #: None when a walk could not tell (see ``verify_types.walk``)
        self.free: Optional[Dict[str, wt.WeldType]] = {}
        self.loops = 0


def scan(e: ir.Expr) -> Facts:
    facts = Facts()
    scan_into(facts, facts.events, e, frozenset())
    return facts


def scan_into(facts: Facts, events: list, e: ir.Expr,
              bound: frozenset) -> None:
    """Gather ``e``'s events into ``events`` (``bound``: the names bound
    around ``e``); the type walk hands over the subtrees it does not
    type."""
    names = facts.names
    free = facts.free
    starts, ends = facts.starts, facts.ends
    ev = events.append
    nm = names.append
    builder = wt.BuilderType

    def visit(x: ir.Expr, bound: frozenset) -> None:
        t = type(x)
        if t is ir.Ident:
            nm(x.name)
            if free is not None and x.name not in bound:
                free.setdefault(x.name, x.ty)
            if isinstance(x.ty, builder):
                ev((TY, x))
            return
        if t is ir.Literal:
            return
        s = len(names)
        if t is ir.Let:
            visit(x.value, bound)
            rec = [LET, x, s, len(names), None]
            ev(rec)
            visit(x.body, bound | {x.name})
            rec[4] = len(names)
        elif t is ir.Lambda:
            lam(x, bound, None)
        elif t is ir.For:
            k = facts.loops
            facts.loops += 1
            ev((FOR, x, k))
            for it in x.iters:
                visit(it, bound)
            visit(x.builder, bound)
            if type(x.func) is ir.Lambda:
                f = len(names)
                lam(x.func, bound, k)
                starts[id(x.func)] = f
                ends[id(x.func)] = len(names)
            else:
                visit(x.func, bound)
        elif t in READ_TARGET:
            kids = x.children()
            rec = [READ, x, s, s]
            ev(rec)
            if kids and kids[0] is getattr(x, READ_TARGET[t]):
                visit(kids[0], bound)
                rec[3] = len(names)
                kids = kids[1:]
            for c in kids:
                visit(c, bound)
        else:
            if t is ir.NewBuilder:
                if isinstance(x.ty, builder):
                    ev((TY, x))
                ev((NB, x))
            elif t is ir.KernelCall:
                ev((KC, x))
            elif t is ir.Merge:
                ev((MERGE, x))
            for c in x.children():
                visit(c, bound)
        starts[id(x)] = s
        ends[id(x)] = len(names)

    def lam(x: ir.Lambda, bound: frozenset, loop) -> None:
        for p in x.params:
            nm(p.name)
            if isinstance(p.ty, builder):
                ev((TY, p))
        rec = [LAM, x, len(names), None]
        ev(rec)
        if loop is not None:
            ev((LOOP, loop))
        visit(x.body, bound | {p.name for p in x.params})
        if loop is not None:
            ev((END, loop))
        rec[3] = len(names)

    visit(e, bound)
