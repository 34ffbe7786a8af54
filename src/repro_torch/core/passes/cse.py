"""Common subexpression elimination (paper Table 3).

After DAG stitching, every library operator is a top-level let binding.
Two libraries that independently built the same computation produce two
let-bound values with identical (alpha-invariant) structure; CSE aliases
the later binding to the earlier one, so the computation runs once.  The
shared loop is then further combinable by horizontal fusion.

Builder linearity is preserved: only *completed* values (e.g.
``result(for(...))`` with its own fresh builders) are shared, never open
builder flow.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .. import ir


def cse(e: ir.Expr, stats: Dict[str, int]) -> ir.Expr:
    def rec(x: ir.Expr, seen: Dict[str, Tuple[str, object]]) -> ir.Expr:
        if isinstance(x, ir.Let):
            value = rec(x.value, seen)
            key = ir.canon_key(value)
            if key in seen and not isinstance(value, (ir.Ident, ir.Literal)):
                prev_name, prev_ty = seen[key]
                stats["cse.hits"] = stats.get("cse.hits", 0) + 1
                alias = ir.Ident(prev_name, prev_ty)
                return rec(
                    ir.substitute(x.body, {x.name: alias}), seen
                )
            try:
                ty = ir.typeof(value)
            except Exception:
                ty = None
            seen2 = dict(seen)
            seen2[key] = (x.name, ty)
            return ir.Let(x.name, value, rec(x.body, seen2))
        if isinstance(x, ir.Lambda):
            # loop bodies are evaluated per-iteration; their duplicates are
            # local and handled by the backend's jaxpr-level sharing.
            return x
        return x.map_children(lambda c: rec(c, seen))

    return rec(e, {})
