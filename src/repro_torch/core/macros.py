"""Higher-level operators (paper §3.3) — map/filter/reduce etc. as macros
that expand to `for` loops and builders.  Library integrations build their
IR almost exclusively through these.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from . import ir
from . import wtypes as wt


def _lam3(bt: wt.BuilderType, elem_ty: wt.WeldType, body_fn) -> ir.Lambda:
    b = ir.Ident(ir.fresh("b"), bt)
    i = ir.Ident(ir.fresh("i"), wt.I64)
    x = ir.Ident(ir.fresh("x"), elem_ty)
    return ir.Lambda((b, i, x), body_fn(b, i, x))


def elem_type(vec_expr: ir.Expr) -> wt.WeldType:
    ty = ir.typeof(vec_expr)
    if not isinstance(ty, wt.Vec):
        raise wt.WeldTypeError(f"expected vec, got {ty}")
    return ty.elem


def map_(vec: ir.Expr, fn: Callable[[ir.Expr], ir.Expr],
         out_ty: Optional[wt.WeldType] = None) -> ir.Expr:
    """map(v, f): for(v, vecbuilder, (b,i,x)=>merge(b, f(x)))"""
    et = elem_type(vec)
    probe = ir.Ident(ir.fresh("probe"), et)
    if out_ty is None:
        out_ty = ir.typeof(fn(probe), {probe.name: et})
    bt = wt.VecBuilder(out_ty)
    lam = _lam3(bt, et, lambda b, i, x: ir.Merge(b, fn(x)))
    return ir.Result(ir.For((ir.Iter(vec),), ir.NewBuilder(bt), lam))


def zip_map(vecs: Sequence[ir.Expr], fn, out_ty: Optional[wt.WeldType] = None) -> ir.Expr:
    """Elementwise map over multiple equal-length vectors.

    `fn` receives one expression per vector.
    """
    etys = [elem_type(v) for v in vecs]
    struct_ty = wt.Struct(tuple(etys)) if len(vecs) > 1 else etys[0]
    probe = ir.Ident(ir.fresh("probe"), struct_ty)
    if len(vecs) == 1:
        body = lambda x: fn(x)
    else:
        body = lambda x: fn(*[ir.GetField(x, k) for k in range(len(vecs))])
    if out_ty is None:
        out_ty = ir.typeof(body(probe), {probe.name: struct_ty})
    bt = wt.VecBuilder(out_ty)
    lam = _lam3(bt, struct_ty, lambda b, i, x: ir.Merge(b, body(x)))
    return ir.Result(
        ir.For(tuple(ir.Iter(v) for v in vecs), ir.NewBuilder(bt), lam)
    )


def filter_(vec: ir.Expr, pred: Callable[[ir.Expr], ir.Expr]) -> ir.Expr:
    """filter(v, p): conditional merge into a vecbuilder."""
    et = elem_type(vec)
    bt = wt.VecBuilder(et)
    lam = _lam3(
        bt, et,
        lambda b, i, x: ir.If(pred(x), ir.Merge(b, x), b),
    )
    return ir.Result(ir.For((ir.Iter(vec),), ir.NewBuilder(bt), lam))


def reduce_(vec: ir.Expr, op: str = "+",
            fn: Optional[Callable[[ir.Expr], ir.Expr]] = None,
            init: Optional[ir.Expr] = None) -> ir.Expr:
    """reduce(v, op): merger over (optionally mapped) elements."""
    et = elem_type(vec)
    probe = ir.Ident(ir.fresh("probe"), et)
    vt = et if fn is None else ir.typeof(fn(probe), {probe.name: et})
    bt = wt.Merger(vt, op)
    lam = _lam3(
        bt, et,
        lambda b, i, x: ir.Merge(b, fn(x) if fn is not None else x),
    )
    return ir.Result(ir.For((ir.Iter(vec),), ir.NewBuilder(bt, arg=init), lam))


def filter_reduce(vec: ir.Expr, pred, op: str = "+", fn=None) -> ir.Expr:
    """Fused filter+reduce (Listing 10): produced directly by some frames,
    also the result of fusing filter_ into reduce_."""
    et = elem_type(vec)
    probe = ir.Ident(ir.fresh("probe"), et)
    vt = et if fn is None else ir.typeof(fn(probe), {probe.name: et})
    bt = wt.Merger(vt, op)
    lam = _lam3(
        bt, et,
        lambda b, i, x: ir.If(
            pred(x), ir.Merge(b, fn(x) if fn is not None else x), b
        ),
    )
    return ir.Result(ir.For((ir.Iter(vec),), ir.NewBuilder(bt), lam))


def scatter_add(base: ir.Expr, idx: ir.Expr, vals: ir.Expr, op: str = "+") -> ir.Expr:
    """vecmerger: merge vals[i] into base[idx[i]]."""
    et = elem_type(vals)
    bt = wt.VecMerger(et, op)
    struct_ty = wt.Struct((elem_type(idx), et))
    lam = _lam3(
        bt, struct_ty,
        lambda b, i, x: ir.Merge(
            b,
            ir.MakeStruct((_as_i64(ir.GetField(x, 0)), ir.GetField(x, 1))),
        ),
    )
    return ir.Result(
        ir.For(
            (ir.Iter(idx), ir.Iter(vals)),
            ir.NewBuilder(bt, arg=base),
            lam,
        )
    )


def groupby_agg(keys: ir.Expr, vals: ir.Expr, op: str = "+",
                capacity: int = 1024) -> ir.Expr:
    """dictmerger: aggregate vals by key → dict[key, val]."""
    kt, vt = elem_type(keys), elem_type(vals)
    bt = wt.DictMerger(kt, vt, op)
    struct_ty = wt.Struct((kt, vt))
    lam = _lam3(bt, struct_ty, lambda b, i, x: ir.Merge(b, x))
    cap = ir.Literal(capacity, wt.I64)
    return ir.Result(
        ir.For((ir.Iter(keys), ir.Iter(vals)), ir.NewBuilder(bt, arg=cap), lam)
    )


def group_vals(keys: ir.Expr, vals: ir.Expr, capacity: int = 1024) -> ir.Expr:
    """groupbuilder: dict[key, vec[val]]."""
    kt, vt = elem_type(keys), elem_type(vals)
    bt = wt.GroupBuilder(kt, vt)
    struct_ty = wt.Struct((kt, vt))
    lam = _lam3(bt, struct_ty, lambda b, i, x: ir.Merge(b, x))
    cap = ir.Literal(capacity, wt.I64)
    return ir.Result(
        ir.For((ir.Iter(keys), ir.Iter(vals)), ir.NewBuilder(bt, arg=cap), lam)
    )


def dot(a: ir.Expr, b: ir.Expr) -> ir.Expr:
    """Inner product via a merger (the tiling pass raises this to matmul)."""
    return reduce_(
        zip_map([a, b], lambda x, y: ir.BinOp("*", x, y)), "+"
    )


def lit(v, ty: Optional[wt.Scalar] = None) -> ir.Literal:
    if ty is None:
        if isinstance(v, bool):
            ty = wt.Bool
        elif isinstance(v, int):
            ty = wt.I64
        else:
            ty = wt.F64
    return ir.Literal(v, ty)


def _as_i64(e: ir.Expr) -> ir.Expr:
    t = ir.typeof(e)
    return e if t == wt.I64 else ir.Cast(e, wt.I64)
