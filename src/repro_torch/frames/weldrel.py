"""weldrel — the Spark SQL integration (paper §6).

Column-store tables with relational operators (scan/filter/aggregate/
grouped-aggregate).  Mirrors the paper's port: *each operator emits its
own loop, independent of downstream operators*, and Weld's optimizer
fuses the chain into one pass.  Used for the TPC-H Q1/Q6 workloads.

The copy of the JAX package's module for this slice: ``join``,
``explain``, ``stage`` and ``compile`` wait for later slices (ROADMAP A).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ir, wtypes as wt
from ..core.lazy import Evaluate, NewWeldObject, WeldObject
from . import weldnp


class Table:
    def __init__(self, columns: Dict[str, np.ndarray], eager: bool = False):
        self.eager = eager
        self.cols = {
            k: weldnp.array(np.asarray(v), eager=eager)
            for k, v in columns.items()
        }

    def col(self, name: str) -> weldnp.ndarray:
        return self.cols[name]


class Query:
    """A chain of relational operators over a table.  Each operator appends
    an independent IR fragment; the aggregate is the evaluation point."""

    def __init__(self, table: Table):
        self.table = table
        self.pred: Optional[weldnp.ndarray] = None

    def filter(self, pred: weldnp.ndarray) -> "Query":
        self.pred = pred if self.pred is None else (self.pred & pred)
        return self

    def _finish(self, obj: WeldObject, finalize, *, kernelize=None,
                kernel_impl=None, collect_stats=None):
        res = Evaluate(obj, kernelize=kernelize, kernel_impl=kernel_impl,
                       collect_stats=collect_stats)
        return finalize(res.value)

    # -- ungrouped aggregate ---------------------------------------------------

    def agg(self, exprs: Dict[str, Tuple[weldnp.ndarray, str]],
            kernelize=None, kernel_impl=None,
            collect_stats: Optional[dict] = None):
        """exprs: name -> (value column expression, op).  Returns dict of
        scalars; single fused pass over the data.  Under the default
        ``kernelize="auto"`` the fused filter+reduce routes onto the
        CUDA kernel library when the cost gate favors it — all
        aggregates share one multi-output kernel launch; ``"always"``/
        True forces the route, ``"off"``/False disables it."""
        if self.table.eager:
            out = {}
            m = self.pred._eager if self.pred is not None else None
            for name, (col, op) in exprs.items():
                v = col._eager
                if m is not None:
                    v = v[m]
                # empty/fully-filtered input reduces to the merger
                # identity of the op, matching the lazy path (0 for "+",
                # 1 for "*", +/-inf-like extremes for min/max)
                out[name] = {
                    "+": np.sum, "min": np.min, "max": np.max, "*": np.prod,
                }[op](v) if v.size else wt.merge_identity(
                    op, wt.dtype_to_weld(v.dtype))
            return out

        names = list(exprs)
        deps: List[WeldObject] = []
        ids: List[ir.Expr] = []
        seen: Dict[str, int] = {}

        def slot(arr: weldnp.ndarray) -> int:
            if arr.obj.obj_id not in seen:
                seen[arr.obj.obj_id] = len(ids)
                deps.append(arr.obj)
                ids.append(ir.Ident(arr.obj.obj_id, arr.obj.weld_type()))
            return seen[arr.obj.obj_id]

        val_slots = [slot(exprs[n][0]) for n in names]
        pred_slot = slot(self.pred) if self.pred is not None else None

        builders = tuple(
            wt.Merger(exprs[n][0].weld_elem_ty, exprs[n][1]) for n in names
        )
        sbt = wt.StructBuilder(builders)
        elem_ty = (
            wt.Struct(tuple(_ety(i, ids) for i in range(len(ids))))
            if len(ids) > 1 else _ety(0, ids)
        )
        b = ir.Ident(ir.fresh("b"), sbt)
        i = ir.Ident(ir.fresh("i"), wt.I64)
        x = ir.Ident(ir.fresh("x"), elem_ty)

        def field(k: int) -> ir.Expr:
            return ir.GetField(x, k) if len(ids) > 1 else x

        cur: ir.Expr = b
        items = []
        for k, n in enumerate(names):
            items.append(ir.Merge(ir.GetField(b, k), field(val_slots[k])))
        merged = ir.MakeStruct(tuple(items))
        if pred_slot is not None:
            body: ir.Expr = ir.If(field(pred_slot), merged, b)
        else:
            body = merged
        loop = ir.For(
            tuple(ir.Iter(idn) for idn in ids),
            ir.MakeStruct(tuple(ir.NewBuilder(bt) for bt in builders)),
            ir.Lambda((b, i, x), body),
        )
        obj = NewWeldObject(deps, ir.Result(loop))
        return self._finish(
            obj, lambda v: {n: v[k] for k, n in enumerate(names)},
            kernelize=kernelize, kernel_impl=kernel_impl,
            collect_stats=collect_stats)

    # -- grouped aggregate -------------------------------------------------------

    def group_agg(
        self,
        keys: Sequence[weldnp.ndarray],
        vals: Dict[str, Tuple[weldnp.ndarray, str]],
        capacity: int = 4096,
        kernelize=None,
        kernel_impl=None,
        collect_stats: Optional[dict] = None,
    ):
        """GROUP BY keys; all aggregates share ONE dictmerger pass.
        Returns {key_tuple: (agg,...)} (+ implicit count as last value).

        NOTE: grouped multi-aggregates build a struct-valued dictmerger,
        which the kernel planner does not yet route (ROADMAP: multi-agg
        fusion) — ``kernelize=True`` is accepted for API symmetry but
        currently always falls back to the generic sort-based path."""
        if self.table.eager:
            # same contract as the lazy path below: anything but "+"
            # must fail loudly instead of silently summing
            ops = {vals[n][1] for n in vals} | {"+"}
            assert ops == {"+"}, "grouped aggregates support sum/count"
            m = self.pred._eager if self.pred is not None else slice(None)
            karrs = [k._eager[m] for k in keys]
            varrs = [vals[n][0]._eager[m] for n in vals]
            # per-dtype merger identities: an int value column accumulates
            # as ints and decodes as ints, exactly like the lazy dict path
            # (the old [0.0]*n seed floated every aggregate)
            idents = [
                wt.merge_identity("+", wt.dtype_to_weld(v.dtype))
                for v in varrs
            ]
            packed = list(zip(*karrs))
            out: dict = {}
            for row_idx, kt in enumerate(packed):
                # single-key groups use the bare scalar, like the lazy
                # path's dict decode — not a 1-tuple
                kt = tuple(x.item() for x in kt)
                kt = kt[0] if len(kt) == 1 else kt
                slotv = out.setdefault(kt, list(idents) + [0])
                for j, v in enumerate(varrs):
                    slotv[j] += v[row_idx]
                slotv[-1] += 1
            return {
                k: tuple(x.item() if isinstance(x, np.generic) else x
                         for x in v)
                for k, v in out.items()
            }

        names = list(vals)
        deps: List[WeldObject] = []
        ids: List[ir.Expr] = []
        seen: Dict[str, int] = {}

        def slot(arr: weldnp.ndarray) -> int:
            if arr.obj.obj_id not in seen:
                seen[arr.obj.obj_id] = len(ids)
                deps.append(arr.obj)
                ids.append(ir.Ident(arr.obj.obj_id, arr.obj.weld_type()))
            return seen[arr.obj.obj_id]

        key_slots = [slot(k) for k in keys]
        val_slots = [slot(vals[n][0]) for n in names]
        pred_slot = slot(self.pred) if self.pred is not None else None
        ops = {vals[n][1] for n in names} | {"+"}
        assert ops == {"+"}, "grouped aggregates support sum/count"

        key_ty = wt.Struct(tuple(_ety(s, ids) for s in key_slots)) \
            if len(key_slots) > 1 else _ety(key_slots[0], ids)
        val_ty = wt.Struct(
            tuple(_ety(s, ids) for s in val_slots) + (wt.I64,)
        )
        bt = wt.DictMerger(key_ty, val_ty, "+")
        elem_ty = (
            wt.Struct(tuple(_ety(i, ids) for i in range(len(ids))))
            if len(ids) > 1 else _ety(0, ids)
        )
        b = ir.Ident(ir.fresh("b"), bt)
        i = ir.Ident(ir.fresh("i"), wt.I64)
        x = ir.Ident(ir.fresh("x"), elem_ty)

        def field(k: int) -> ir.Expr:
            return ir.GetField(x, k) if len(ids) > 1 else x

        key_expr = (
            ir.MakeStruct(tuple(field(s) for s in key_slots))
            if len(key_slots) > 1 else field(key_slots[0])
        )
        val_expr = ir.MakeStruct(
            tuple(field(s) for s in val_slots) + (ir.Literal(1, wt.I64),)
        )
        merged = ir.Merge(b, ir.MakeStruct((key_expr, val_expr)))
        body: ir.Expr = merged if pred_slot is None else ir.If(
            field(pred_slot), merged, b
        )
        loop = ir.For(
            tuple(ir.Iter(idn) for idn in ids),
            ir.NewBuilder(bt, arg=ir.Literal(capacity, wt.I64)),
            ir.Lambda((b, i, x), body),
        )
        obj = NewWeldObject(deps, ir.Result(loop))
        return self._finish(
            obj, lambda v: v,
            kernelize=kernelize, kernel_impl=kernel_impl,
            collect_stats=collect_stats)


def _ety(k: int, ids: List[ir.Expr]) -> wt.Scalar:
    t = ids[k].ty
    assert isinstance(t, wt.Vec)
    return t.elem
