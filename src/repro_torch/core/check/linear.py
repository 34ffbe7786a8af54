"""Analysis 2: builder linearity (paper §3.2), as a dataflow pass.

Every builder-typed binding (a ``Let`` name or a ``Lambda`` parameter)
must be consumed **exactly once along every control path**:

* ``If`` branches are alternative paths — each path's total must be 1
  (e.g. ``if(p, merge(b, x), b)`` is linear);
* ``Select`` evaluates *both* sides — builder uses sum (WV206/WV202);
* a builder captured free inside a loop body is consumed once per
  iteration (WV204);
* a struct-of-builders binding is tracked per field: ``b.$k`` consumes
  field ``k``, a bare ``b`` consumes every field — so the fused
  "merge into each slot, rebuild the struct" idiom checks exactly.

The pass reuses the type map produced by ``verify_types.annotate`` so
it never re-runs inference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import ir
from .. import wtypes as wt
from .diagnostics import Diagnostic

#: sentinel count for "many" (captured by a per-iteration lambda)
MANY = 1 << 20


def lint_linearity(
    e: ir.Expr,
    types: Dict[int, Optional[wt.WeldType]],
) -> List[Diagnostic]:
    diags: List[Diagnostic] = []

    def check_binding(name: str, bty: wt.BuilderType, scope: ir.Expr,
                      binding_node: ir.Expr) -> None:
        if isinstance(bty, wt.StructBuilder):
            width = len(bty.builders)
            counts = [_count(scope, name, field=k) for k in range(width)]
        else:
            width = 0
            counts = [_count(scope, name, field=None)]
        for k, (lo, hi, consumers) in enumerate(counts):
            label = f"{name}.${k}" if width else name
            if lo == 1 and hi == 1:
                continue
            if hi >= MANY or "lambda" in consumers:
                diags.append(Diagnostic(
                    "WV204",
                    f"builder {label} captured free by a loop body — "
                    f"consumed once per iteration, not once",
                    binding_node, analysis="linearity",
                    data={"name": name}))
            elif hi == 0:
                diags.append(Diagnostic(
                    "WV201",
                    f"builder {label} is never consumed",
                    binding_node, analysis="linearity",
                    data={"name": name}))
            elif lo != hi and hi <= 1:
                diags.append(Diagnostic(
                    "WV205",
                    f"builder {label} consumed on some paths only "
                    f"(min {lo}, max {hi} uses)",
                    binding_node, analysis="linearity",
                    data={"name": name, "min": lo, "max": hi}))
            elif "result" in consumers and (
                    "merge" in consumers or "select" in consumers):
                diags.append(Diagnostic(
                    "WV203",
                    f"builder {label} used after result() consumed it "
                    f"({hi} uses on a path)",
                    binding_node, analysis="linearity",
                    data={"name": name, "max": hi}))
            elif "select" in consumers:
                diags.append(Diagnostic(
                    "WV206",
                    f"builder {label} duplicated across select() arms — "
                    f"both sides evaluate ({hi} uses)",
                    binding_node, analysis="linearity",
                    data={"name": name, "max": hi}))
            else:
                diags.append(Diagnostic(
                    "WV202",
                    f"builder {label} consumed {hi} times along a path "
                    f"(must be exactly 1)",
                    binding_node, analysis="linearity",
                    data={"name": name, "min": lo, "max": hi}))

    def rec(x: ir.Expr) -> None:
        if isinstance(x, ir.Let):
            rec(x.value)
            vt = types.get(id(x.value))
            if isinstance(vt, wt.BuilderType):
                check_binding(x.name, vt, x.body, x)
            rec(x.body)
            return
        if isinstance(x, ir.Lambda):
            for p in x.params:
                if isinstance(p.ty, wt.BuilderType):
                    check_binding(p.name, p.ty, x.body, x)
            rec(x.body)
            return
        for c in x.children():
            rec(c)

    rec(e)
    return diags


def _count(
    x: ir.Expr,
    name: str,
    field: Optional[int],
    parent_kind: str = "other",
) -> Tuple[int, int, set]:
    """(min, max, consumer-kinds) of uses of ``name`` (restricted to
    struct field ``field`` when given) along control paths through
    ``x``.  ``parent_kind`` tags how a hit is being consumed."""

    def is_hit(n: ir.Expr) -> bool:
        return isinstance(n, ir.Ident) and n.name == name

    consumers: set = set()

    def go(n: ir.Expr, kind: str) -> Tuple[int, int]:
        if isinstance(n, ir.Ident):
            if n.name != name:
                return (0, 0)
            consumers.add(kind)
            return (1, 1)
        if field is not None and isinstance(n, ir.GetField) \
                and is_hit(n.expr):
            # b.$k consumes only field k of a struct-of-builders binding
            if n.index == field:
                consumers.add(kind)
                return (1, 1)
            return (0, 0)
        if isinstance(n, ir.Let):
            if n.name == name:  # shadowed in body
                return go(n.value, "alias")
            v = go(n.value, "alias" if is_hit(n.value) else "other")
            b = go(n.body, "other")
            return (v[0] + b[0], v[1] + b[1])
        if isinstance(n, ir.Lambda):
            if any(p.name == name for p in n.params):
                return (0, 0)
            lo, hi = go(n.body, "lambda")
            if hi > 0:
                # the body runs per iteration: any use is a many-use
                consumers.add("lambda")
                return (lo, MANY)
            return (0, 0)
        if isinstance(n, ir.If):
            c = go(n.cond, "other")
            t = go(n.on_true, "other")
            f = go(n.on_false, "other")
            return (c[0] + min(t[0], f[0]), c[1] + max(t[1], f[1]))
        if isinstance(n, ir.Select):
            c = go(n.cond, "other")
            t = go(n.on_true, "select")
            f = go(n.on_false, "select")
            both = t[1] + f[1]
            if both > 1:
                consumers.add("select")
            return (c[0] + t[0] + f[0], c[1] + both)
        if isinstance(n, ir.Merge):
            b = go(n.builder, "merge")
            v = go(n.value, "other")
            return (b[0] + v[0], b[1] + v[1])
        if isinstance(n, ir.Result):
            return go(n.builder, "result")
        if isinstance(n, ir.For):
            b = go(n.builder, "for")
            lo, hi = b
            for it in n.iters:
                l2, h2 = go(it, "other")
                lo, hi = lo + l2, hi + h2
            l3, h3 = go(n.func, "other")
            return (lo + l3, hi + h3)
        lo = hi = 0
        for c in n.children():
            l2, h2 = go(c, kind if kind != "other" else "other")
            lo, hi = lo + l2, hi + h2
        return (lo, hi)

    lo, hi = go(x, parent_kind)
    return (lo, hi, consumers)
