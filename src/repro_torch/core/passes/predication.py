"""Predication (paper Table 3): transform branches inside loop bodies into
unconditional select instructions.

    if (c) merge(b, v) else b   ==>   merge(b, select(c, v, identity))

Valid for mergers (identity exists for every commutative MERGE_OP) and for
vecmergers (merge identity at a clamped index is a no-op).  Dict-family
builders are NOT predicated: merging a sentinel key would insert it.

On TPU this transform is load-bearing rather than cosmetic: SPMD lanes have
no divergent control flow, so a non-predicated conditional merge would
otherwise force a serial loop.
"""
from __future__ import annotations

from typing import Dict, Optional

from .. import ir
from .. import wtypes as wt


def _identity_expr(ty: wt.WeldType, op: str) -> Optional[ir.Expr]:
    if isinstance(ty, wt.Scalar):
        return ir.Literal(wt.merge_identity(op, ty), ty)
    if isinstance(ty, wt.Struct):
        items = []
        for f in ty.fields:
            it = _identity_expr(f, op)
            if it is None:
                return None
            items.append(it)
        return ir.MakeStruct(tuple(items))
    return None


def _builder_ty_of(e: ir.Expr) -> Optional[wt.BuilderType]:
    try:
        t = ir.typeof(e)
    except Exception:
        return None
    return t if isinstance(t, wt.BuilderType) else None


def predicate(e: ir.Expr, stats: Dict[str, int]) -> ir.Expr:
    def rec(x: ir.Expr) -> ir.Expr:
        x = x.map_children(rec)
        if not isinstance(x, ir.If):
            return x
        t, f = x.on_true, x.on_false
        # normalize: if(c, b, merge(..)) -> if(!c, merge(..), b)
        if isinstance(f, ir.Merge) and not isinstance(t, ir.Merge):
            t, f = f, t
            cond: ir.Expr = ir.UnaryOp("not", x.cond)
        else:
            cond = x.cond
        if not isinstance(t, ir.Merge):
            return x
        if ir.canon_key(f) != ir.canon_key(t.builder):
            return x  # else-branch must be the un-merged builder
        bty = _builder_ty_of(t.builder)
        if isinstance(bty, wt.Merger):
            ident = _identity_expr(bty.elem, bty.op)
            if ident is None:
                return x
            stats["predication"] = stats.get("predication", 0) + 1
            return ir.Merge(t.builder, ir.Select(cond, t.value, ident))
        if isinstance(bty, wt.VecMerger):
            ident = _identity_expr(bty.elem, bty.op)
            if ident is None:
                return x
            stats["predication"] = stats.get("predication", 0) + 1
            val = t.value  # {index, v}
            idx = ir.GetField(val, 0)
            v = ir.GetField(val, 1)
            safe = ir.MakeStruct(
                (
                    ir.Select(cond, idx, ir.Literal(0, wt.I64)),
                    ir.Select(cond, v, ident),
                )
            )
            return ir.Merge(t.builder, safe)
        return x

    return rec(e)
