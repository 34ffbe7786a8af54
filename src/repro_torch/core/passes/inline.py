"""Let-inlining: exposes producer→consumer loop chains to the fusion pass.

A binding `let n = v; body` is inlined when
  * `v` is trivial (Ident/Literal), or
  * `n` is used exactly once in `body` and that use is not under a Lambda
    (inlining into a loop body would re-evaluate `v` every iteration).
"""
from __future__ import annotations

from typing import Dict

from .. import ir


def _count_uses(e: ir.Expr, name: str, in_lambda: bool = False):
    """Returns (total_uses, uses_under_lambda)."""
    total = lam = 0
    stack = [(e, in_lambda)]
    while stack:
        x, under = stack.pop()
        if isinstance(x, ir.Ident):
            if x.name == name:
                total += 1
                lam += 1 if under else 0
            continue
        if isinstance(x, ir.Let) and x.name == name:
            stack.append((x.value, under))
            continue  # shadowed in body
        if isinstance(x, ir.Lambda):
            if any(p.name == name for p in x.params):
                continue
            stack.append((x.body, True))
            continue
        for c in x.children():
            stack.append((c, under))
    return total, lam


def _is_loop_result(e: ir.Expr) -> bool:
    return isinstance(e, ir.Result) and isinstance(e.builder, ir.For)


def _sole_use_is_iter_data(body: ir.Expr, name: str) -> bool:
    """True if the only use of `name` is as the data of a For's Iter —
    the position vertical fusion consumes."""
    hits = []

    def rec(x: ir.Expr):
        if isinstance(x, ir.For):
            for it in x.iters:
                if isinstance(it.data, ir.Ident) and it.data.name == name:
                    hits.append("iter")
                else:
                    rec(it)
            rec(x.builder)
            rec(x.func)
            return
        if isinstance(x, ir.Ident) and x.name == name:
            hits.append("other")
            return
        if isinstance(x, ir.Let) and x.name == name:
            rec(x.value)
            return
        if isinstance(x, ir.Lambda) and any(p.name == name for p in x.params):
            return
        for c in x.children():
            rec(c)

    rec(body)
    return hits == ["iter"]


def inline_lets(e: ir.Expr, stats: Dict[str, int]) -> ir.Expr:
    def rec(x: ir.Expr) -> ir.Expr:
        x = x.map_children(rec)
        if isinstance(x, ir.Let):
            trivial = isinstance(x.value, (ir.Ident, ir.Literal))
            total, under_lam = _count_uses(x.body, x.name)
            if total == 0 and not trivial:
                # dead binding (value is pure in Weld IR) — drop it
                stats["inline.dead"] = stats.get("inline.dead", 0) + 1
                return x.body
            inlinable = trivial or (total == 1 and under_lam == 0)
            if inlinable and _is_loop_result(x.value) and not trivial:
                # keep loops at let-level (horizontal fusion matches the
                # chain) unless the single use is a consumer loop's input,
                # where inlining enables vertical fusion.
                inlinable = _sole_use_is_iter_data(x.body, x.name)
            if inlinable:
                stats["inline.lets"] = stats.get("inline.lets", 0) + 1
                return ir.substitute(x.body, {x.name: x.value})
        return x

    return rec(e)
