"""welddf — the Pandas integration (paper §6).

DataFrames are named collections of columns; columns ARE weldnp arrays, so
dataframe operators and numpy operators compose into one Weld program (the
paper's crime-index workload is exactly this composition).

Ported operators (the set the paper ports): filtering / predicate masking,
column arithmetic, aggregation, groupby-aggregate, unique, and fixed-width
"slicing" of zip codes.  The paper slices zipcode *strings*; TPU-side we
adapt to fixed-width numeric codes (zip//10**k), as documented in
DESIGN.md §2 — same data movement, no variable-length strings.

A filtered dataframe is *lazy*: it carries the predicate column and only
materializes (filter+op fused) when an operator consumes it — this is what
lets Weld fuse the paper's Listing 7 into a single masked pass.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..core import ir, macros as M, wtypes as wt
from ..core.lazy import Evaluate, NewWeldObject
from . import weldnp


class Series(weldnp.ndarray):
    """A named column — a weldnp array with an optional pending filter."""


def _as_col(arr) -> weldnp.ndarray:
    if isinstance(arr, weldnp.ndarray):
        return arr
    return weldnp.array(np.asarray(arr))


class DataFrame:
    def __init__(self, columns: Dict[str, object], mask: Optional[weldnp.ndarray] = None,
                 eager: bool = False):
        self.eager = eager
        self.columns: Dict[str, weldnp.ndarray] = {}
        for k, v in columns.items():
            if isinstance(v, weldnp.ndarray):
                self.columns[k] = v
            else:
                self.columns[k] = weldnp.array(np.asarray(v), eager=eager)
        #: pending row predicate (lazy filter), None = all rows
        self.mask = mask

    # -- basic access ---------------------------------------------------------

    def __getitem__(self, key):
        if isinstance(key, str):
            col = self.columns[key]
            if self.mask is None:
                return col
            return _apply_filter(col, self.mask)
        if isinstance(key, weldnp.ndarray):  # boolean predicate
            m = key if self.mask is None else _and(self.mask, key)
            return DataFrame(self.columns, mask=m, eager=self.eager)
        raise KeyError(key)

    def __setitem__(self, key: str, value):
        assert self.mask is None, "cannot assign into a filtered view"
        self.columns[key] = _as_col(value)

    def raw(self, key: str) -> weldnp.ndarray:
        """Column WITHOUT applying the pending filter."""
        return self.columns[key]

    # -- ported operators -------------------------------------------------------

    def filter(self, pred: weldnp.ndarray) -> "DataFrame":
        return self[pred]

    def agg_sum(self, key: str):
        col = self.columns[key]
        if self.eager:
            m = self.mask._eager if self.mask is not None else None
            d = col._eager
            out = np.sum(d[m] if m is not None else d)
            return weldnp.ndarray(None, (), out.dtype, eager_data=np.asarray(out))
        if self.mask is None:
            return col.sum()
        # fused filter+reduce — the paper's Listing 10
        expr = M.filter_reduce(
            _zip_pred_val(self.mask, col), _pred_fn, "+", _val_fn
        )
        obj = NewWeldObject([self.mask.obj, col.obj], expr)
        return weldnp.ndarray(obj, (), col.dtype)

    def count(self):
        if self.eager:
            if self.mask is not None:
                out = np.asarray(int(np.sum(self.mask._eager)))
            else:
                out = np.asarray(len(next(iter(self.columns.values()))._eager))
            return weldnp.ndarray(None, (), out.dtype, eager_data=out)
        if self.mask is None:
            any_col = next(iter(self.columns.values()))
            expr = ir.Len(ir.Ident(any_col.obj.obj_id, any_col.obj.weld_type()))
            return weldnp.ndarray(
                NewWeldObject([any_col.obj], expr), (), np.int64
            )
        ones = self.mask.astype(np.int64)
        return ones.sum()

    def groupby_sum(self, key: str, val: str, capacity: int = 4096,
                    kernelize=None, kernel_impl=None,
                    collect_stats: Optional[dict] = None) -> dict:
        """dict[key -> sum(val)] via a dictmerger; evaluation point.

        Under the default ``kernelize="auto"`` the group-by routes onto
        the segment-reduce CUDA kernel when the key column is
        int-typed, the capacity fits the kernel's shared-memory
        accumulator, and the roofline cost gate favors it (see
        ``repro_torch.core.kernelplan``);
        ``"always"``/True forces the route, ``"off"``/False disables."""
        kcol, vcol = self.columns[key], self.columns[val]
        if self.eager:
            k, v = kcol._eager, vcol._eager
            if self.mask is not None:
                m = self.mask._eager
                k, v = k[m], v[m]
            out: dict = {}
            # numpy-native groupby
            uk, inv = np.unique(k, return_inverse=True)
            sums = np.bincount(inv, weights=v.astype(np.float64))
            return {int(a): float(b) for a, b in zip(uk, sums)}
        kid = ir.Ident(kcol.obj.obj_id, kcol.obj.weld_type())
        vid = ir.Ident(vcol.obj.obj_id, vcol.obj.weld_type())
        deps = [kcol.obj, vcol.obj]
        if self.mask is None:
            expr = M.groupby_agg(kid, vid, "+", capacity=capacity)
        else:
            mid = ir.Ident(self.mask.obj.obj_id, self.mask.obj.weld_type())
            deps.append(self.mask.obj)
            bt = wt.DictMerger(kcol.weld_elem_ty, vcol.weld_elem_ty, "+")
            struct_ty = wt.Struct((kcol.weld_elem_ty, vcol.weld_elem_ty, wt.Bool))
            b = ir.Ident(ir.fresh("b"), bt)
            i = ir.Ident(ir.fresh("i"), wt.I64)
            x = ir.Ident(ir.fresh("x"), struct_ty)
            body = ir.If(
                ir.GetField(x, 2),
                ir.Merge(b, ir.MakeStruct((ir.GetField(x, 0), ir.GetField(x, 1)))),
                b,
            )
            expr = ir.Result(
                ir.For(
                    (ir.Iter(kid), ir.Iter(vid), ir.Iter(mid)),
                    ir.NewBuilder(bt, arg=ir.Literal(capacity, wt.I64)),
                    ir.Lambda((b, i, x), body),
                )
            )
        obj = NewWeldObject(deps, expr)
        return Evaluate(obj, kernelize=kernelize, kernel_impl=kernel_impl,
                        collect_stats=collect_stats).value

    def unique(self, key: str, capacity: int = 4096,
               kernelize=None, kernel_impl=None) -> np.ndarray:
        """Distinct values of a column (dictmerger keys)."""
        col = self.columns[key]
        if self.eager:
            v = col._eager
            if self.mask is not None:
                v = v[self.mask._eager]
            return np.unique(v)
        d = self.groupby_sum(key, key, capacity=capacity,
                             kernelize=kernelize, kernel_impl=kernel_impl)
        return np.sort(np.array(list(d.keys())))

    def slice_code(self, key: str, digits: int = 5) -> weldnp.ndarray:
        """Fixed-width code 'slice': keep the top `digits` digits
        (numeric adaptation of the paper's zipcode string slicing)."""
        col = self.columns[key]
        if self.eager:
            v = col._eager
            width = np.where(v > 0, np.floor(np.log10(np.maximum(v, 1))) + 1, 1)
            drop = np.maximum(width - digits, 0).astype(np.int64)
            out = (v // np.power(10, drop)).astype(v.dtype)
            return weldnp.ndarray(None, out.shape, out.dtype, eager_data=out)
        ty = col.weld_elem_ty

        def fn(x):
            fx = ir.Cast(x, wt.F64)
            width = ir.BinOp(
                "+",
                ir.UnaryOp(
                    "floor",
                    ir.BinOp(
                        "/",
                        ir.UnaryOp("log", ir.BinOp("max", fx, ir.Literal(1.0, wt.F64))),
                        ir.Literal(float(np.log(10.0)), wt.F64),
                    ),
                ),
                ir.Literal(1.0, wt.F64),
            )
            drop = ir.BinOp("max", ir.BinOp("-", width, ir.Literal(float(digits), wt.F64)),
                            ir.Literal(0.0, wt.F64))
            div = ir.BinOp("pow", ir.Literal(10.0, wt.F64), drop)
            return ir.Cast(ir.UnaryOp("floor", ir.BinOp("/", fx, div)), ty)

        expr = M.map_(ir.Ident(col.obj.obj_id, col.obj.weld_type()), fn)
        return weldnp.ndarray(NewWeldObject([col.obj], expr), col.shape, col.dtype)


# -- helpers ------------------------------------------------------------------


def _and(a: weldnp.ndarray, b: weldnp.ndarray) -> weldnp.ndarray:
    return a & b


def _apply_filter(col: weldnp.ndarray, mask: weldnp.ndarray) -> weldnp.ndarray:
    """Materializes filter(col, mask) — a conditional vecbuilder merge;
    usually fused away into whatever consumes it."""
    mid = ir.Ident(mask.obj.obj_id, mask.obj.weld_type())
    cid = ir.Ident(col.obj.obj_id, col.obj.weld_type())
    et = col.weld_elem_ty
    bt = wt.VecBuilder(et)
    b = ir.Ident(ir.fresh("b"), bt)
    i = ir.Ident(ir.fresh("i"), wt.I64)
    x = ir.Ident(ir.fresh("x"), wt.Struct((et, wt.Bool)))
    body = ir.If(ir.GetField(x, 1), ir.Merge(b, ir.GetField(x, 0)), b)
    expr = ir.Result(
        ir.For((ir.Iter(cid), ir.Iter(mid)), ir.NewBuilder(bt),
               ir.Lambda((b, i, x), body))
    )
    obj = NewWeldObject([col.obj, mask.obj], expr)
    out = weldnp.ndarray(obj, col.shape, col.dtype)
    return out


def _zip_pred_val(mask: weldnp.ndarray, col: weldnp.ndarray):
    """zip(col, mask) as a single vec-of-struct expression for macros."""
    cid = ir.Ident(col.obj.obj_id, col.obj.weld_type())
    mid = ir.Ident(mask.obj.obj_id, mask.obj.weld_type())
    return M.zip_map([cid, mid], lambda v, m: ir.MakeStruct((v, m)))


def _pred_fn(x):
    return ir.GetField(x, 1)


def _val_fn(x):
    return ir.GetField(x, 0)
