"""Kernel planner: route optimized IR loops onto registered CUDA kernels.

Runs AFTER the optimizer (fusion/predication/CSE have already collapsed
library chains into single loops) and BEFORE the backend emitter.  It
pattern-matches the fused loop shapes the optimizer produces —

* ``result(for(V.., merger[+], .. merge(b, select(p, v, 0))))``  and the
  struct-of-mergers form weldrel's ``agg`` emits        → filter_reduce
* ``result(for(V.., vecmerger[+](base), merge(b, {i,v})))``
  (PageRank's edge scan)                                → segment_sum
* ``result(for([K,V], dictmerger[+](cap), merge(b,{k,v})))``
  with dense int keys                                   → segment_sum
  and with sparse or struct keys (and every probed dict) → hash_to_slot
* ``result(for(V.., {vecbuilder..}, if(cond, {merge(b.$k, ..)..}, b)))``
  probing a let-bound dict (weldrel's horizontally fused join
  probe: inner/left/anti, scalar or struct keys)        → dict_probe
* a probed ``groupbuilder`` (the m:n join build side)   → group_build
  and its ``grouplookup`` expansion loop                → group_probe
* ``cudf[linalg.matmul] / cudf[linalg.matvec]``
  (the tiling pass raises dot loops to these)           → tiled_matmul
* ``result(for(V.., vecbuilder, merge(b, f(x))))`` with a nontrivial
  elementwise body the map-chain generator can emit     → map_elementwise

— and replaces each matched subtree with an ``ir.KernelCall`` node
carrying the iter sources as args and the per-element bodies as staged
lambdas.  Everything unmatched lowers exactly as before; a program with
no matches is returned unchanged.

This is the copy of the JAX package's planner for the routes the port
has, with its hooks: capacities (symbolic ones included) resolve through
weldbound's ``static_size``; a candidate whose length is unknown is
priced at the midpoint of its weldbound row interval; a route in the
quarantine (``quarantine``) is rejected up front on the CPU, even under
``"always"``, and on a card raises under ``"always"`` and warns under
``"auto"``; every decision is a ``kernelplan.candidate`` event; and
the planned program is verified (``check.checkpoint("kernelplan")``).
A map chain whose body the CUDA generator cannot emit is refused at
match time (the spec's ``refuse`` hook): the loop stays on the generic
emitter and the reason is recorded under
``stats["kernelplan"]["refused"]``.

Soundness rules (checked per match, conservative):

* every iter source must be *statically dense* — a program input, a
  let-bound map-like loop over dense sources, or a dense-producing
  kernel call — so staged bodies see unpadded columns;
* staged bodies must be elementwise-safe: no nested loops, builders,
  CUDF calls, or lookups into per-element collections (gathers from
  whole program inputs are fine);
* the planner never rewrites inside a ``for`` body.

Routing modes (``plan_kernels(mode=...)``):

* ``"always"`` — route every sound match;
* ``"auto"`` — price each match through :mod:`.cost` and keep the
  generic lowering when the kernel route cannot win.  Unknown sizes
  reject conservatively.  This is the process default.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import ir
from .. import obs as _obs
from .. import wtypes as wt
from ..backend.torchgen import match_group_probe as _group_probe_shape
from . import cost as _cost
from . import registry as reg

#: minimum compute-node count for a map chain to be worth a kernel launch.
MIN_MAP_OPS = 2

#: shape map: dense name -> statically known shape tuple (or None when
#: the name is provably dense but its length is not statically known).
Shapes = Dict[str, Optional[tuple]]


# ---------------------------------------------------------------------------
# small predicates
# ---------------------------------------------------------------------------


def _is_ident(e: ir.Expr, name: str) -> bool:
    return isinstance(e, ir.Ident) and e.name == name


#: kernels whose vector result is padded (count-carrying), NOT dense.
_PADDED_RESULT_KERNELS = frozenset({"hash_probe", "group_probe"})


def _dense_expr(e: ir.Expr, dense: Shapes) -> bool:
    if isinstance(e, ir.Ident):
        return e.name in dense
    if isinstance(e, ir.KernelCall):
        return (isinstance(e.ret_ty, wt.Vec)
                and e.kernel not in _PADDED_RESULT_KERNELS)
    return False


def _iter_ok(it: ir.Iter, dense: Shapes) -> bool:
    return it.is_plain and _dense_expr(it.data, dense)


def _value_dense(e: ir.Expr, dense: Shapes) -> bool:
    """Is a let-bound value a dense vector (no padding/count)?"""
    if _dense_expr(e, dense):
        return True
    if isinstance(e, ir.CUDF):
        return isinstance(e.ret_ty, wt.Vec)
    if isinstance(e, ir.MakeVec):
        return True
    if isinstance(e, ir.Result) and isinstance(e.builder, ir.For):
        loop = e.builder
        nb = loop.builder
        if isinstance(nb, ir.NewBuilder) and isinstance(nb.ty, wt.VecMerger):
            return True
        if isinstance(nb, ir.NewBuilder) and isinstance(nb.ty, wt.VecBuilder):
            from ..passes.fusion import _merges_unconditionally_once

            pb = loop.func.params[0]
            return _merges_unconditionally_once(
                loop.func.body, pb.name
            ) and all(_iter_ok(it, dense) for it in loop.iters)
    return False


def _elementwise_ok(e: ir.Expr, banned: set, per_elem: set,
                    allow_lookup: bool = True) -> bool:
    """Can `e` be staged as a whole-column jnp evaluation of the element?"""

    def rec(x: ir.Expr) -> bool:
        if isinstance(x, (ir.For, ir.Lambda, ir.Merge, ir.NewBuilder,
                          ir.Result, ir.Iter, ir.MakeVec, ir.CUDF,
                          ir.KeyExists, ir.Len, ir.Let, ir.KernelCall)):
            return False
        if isinstance(x, ir.Ident):
            return x.name not in banned
        if isinstance(x, ir.Lookup):
            if not allow_lookup:
                return False
            if not isinstance(x.expr, ir.Ident):
                return False
            if x.expr.name in per_elem or x.expr.name in banned:
                return False
            return rec(x.index) and (x.default is None or rec(x.default))
        return all(rec(c) for c in x.children())

    return rec(e)


def _scalar_kind_ok(ty: wt.WeldType, spec: reg.KernelSpec) -> bool:
    return isinstance(ty, wt.Scalar) and ty.kind in spec.elem_kinds


def _static_cap(e: Optional[ir.Expr], dense: Shapes) -> Optional[int]:
    """Resolve a capacity / size-hint expression to a concrete int:
    literals and symbolic forms over input lengths (``max(len(r), 1)``,
    ``len(l)*len(r)``) from the host-count-free join path."""
    from ..analysis.bounds import static_size

    return static_size(e, dense)


def _is_plus_identity(e: ir.Expr, elem: wt.Scalar) -> bool:
    return (
        isinstance(e, ir.Literal)
        and e.ty == elem
        and e.value == wt.merge_identity("+", elem)
    )


def _compute_ops(e: ir.Expr) -> int:
    return ir.count_nodes(
        e, lambda n: isinstance(n, (ir.BinOp, ir.UnaryOp, ir.Select, ir.Cast))
    )


def _destructure_pair(mval: ir.Expr) -> Tuple[ir.Expr, ir.Expr]:
    """Split a struct-producing merge value into its two fields."""
    if isinstance(mval, ir.MakeStruct) and len(mval.items) == 2:
        return mval.items[0], mval.items[1]
    return ir.GetField(mval, 0), ir.GetField(mval, 1)


# ---------------------------------------------------------------------------
# per-pattern matchers — each returns a KernelCall or None
# ---------------------------------------------------------------------------


def _match_filter_reduce(loop: ir.For, dense: Shapes) -> Optional[ir.KernelCall]:
    spec = reg.available("filter_reduce_sum")
    if spec is None:
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    nb = loop.builder

    def merger_ok(nbx) -> bool:
        return (
            isinstance(nbx, ir.NewBuilder)
            and isinstance(nbx.ty, wt.Merger)
            and nbx.ty.op == "+"
            and nbx.arg is None
            and _scalar_kind_ok(nbx.ty.elem, spec)
        )

    vals: List[Tuple[wt.Scalar, ir.Expr]] = []
    cond: Optional[ir.Expr] = None
    struct = False

    if merger_ok(nb):
        elem = nb.ty.elem
        if isinstance(body, ir.Merge) and _is_ident(body.builder, b.name):
            v = body.value
            if isinstance(v, ir.Select) and _is_plus_identity(v.on_false, elem):
                cond, v = v.cond, v.on_true  # post-predication form
            vals.append((elem, v))
        elif (
            isinstance(body, ir.If)
            and isinstance(body.on_true, ir.Merge)
            and _is_ident(body.on_true.builder, b.name)
            and _is_ident(body.on_false, b.name)
        ):
            cond = body.cond  # pre-predication form
            vals.append((elem, body.on_true.value))
        else:
            return None
    elif isinstance(nb, ir.MakeStruct) and nb.items and all(
        merger_ok(p) for p in nb.items
    ):
        struct = True
        core = body
        if isinstance(body, ir.If):
            if not _is_ident(body.on_false, b.name):
                return None
            cond, core = body.cond, body.on_true
        if not (isinstance(core, ir.MakeStruct)
                and len(core.items) == len(nb.items)):
            return None
        for k, item in enumerate(core.items):
            if not (
                isinstance(item, ir.Merge)
                and isinstance(item.builder, ir.GetField)
                and item.builder.index == k
                and _is_ident(item.builder.expr, b.name)
            ):
                return None
            vals.append((nb.items[k].ty.elem, item.value))
    else:
        return None

    per_elem = {i.name, x.name}
    for _, v in vals:
        if not _elementwise_ok(v, {b.name}, per_elem):
            return None
    if cond is not None and not _elementwise_ok(cond, {b.name}, per_elem):
        return None

    fns = [ir.Lambda((i, x), v) for _, v in vals]
    if cond is not None:
        fns.append(ir.Lambda((i, x), cond))
    ret: wt.WeldType = (
        wt.Struct(tuple(e for e, _ in vals)) if struct else vals[0][0]
    )
    return ir.KernelCall(
        kernel=spec.name,
        args=tuple(it.data for it in loop.iters),
        ret_ty=ret,
        params=(("n_aggs", len(vals)), ("has_pred", cond is not None),
                ("struct", struct)),
        fns=tuple(fns),
    )


def _match_vecmerger(loop: ir.For, dense: Shapes) -> Optional[ir.KernelCall]:
    spec = reg.available("vecmerger_segment_sum")
    if spec is None:
        return None
    nb = loop.builder
    if not (
        isinstance(nb, ir.NewBuilder)
        and isinstance(nb.ty, wt.VecMerger)
        and nb.ty.op == "+"
        and nb.arg is not None
        and _scalar_kind_ok(nb.ty.elem, spec)
        and _value_dense(nb.arg, dense)
    ):
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    if not (isinstance(body, ir.Merge) and _is_ident(body.builder, b.name)):
        return None
    idx_e, val_e = _destructure_pair(body.value)
    per_elem = {i.name, x.name}
    if not (_elementwise_ok(idx_e, {b.name}, per_elem)
            and _elementwise_ok(val_e, {b.name}, per_elem)):
        return None
    return ir.KernelCall(
        kernel=spec.name,
        args=(nb.arg,) + tuple(it.data for it in loop.iters),
        ret_ty=wt.Vec(nb.ty.elem),
        fns=(ir.Lambda((i, x), idx_e), ir.Lambda((i, x), val_e)),
    )


def _match_dict_group(loop: ir.For, dense: Shapes) -> Optional[ir.KernelCall]:
    spec = reg.available("dict_group_sum")
    if spec is None:
        return None
    nb = loop.builder
    if not (
        isinstance(nb, ir.NewBuilder)
        and isinstance(nb.ty, wt.DictMerger)
        and nb.ty.op == "+"
    ):
        return None
    kt, vt = nb.ty.key, nb.ty.val
    if not (isinstance(kt, wt.Scalar) and kt.is_int):
        return None
    if not _scalar_kind_ok(vt, spec):
        return None
    cap = _static_cap(nb.arg, dense)
    if cap is None:
        return None  # capacity must be statically resolvable
    if spec.max_segments is not None and cap > spec.max_segments:
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    cond: Optional[ir.Expr] = None
    if (
        isinstance(body, ir.If)
        and isinstance(body.on_true, ir.Merge)
        and _is_ident(body.on_false, b.name)
    ):
        # filtered group-by: the predicate becomes the adapter's row mask
        cond, body = body.cond, body.on_true
    if not (isinstance(body, ir.Merge) and _is_ident(body.builder, b.name)):
        return None
    key_e, val_e = _destructure_pair(body.value)
    per_elem = {i.name, x.name}
    if not (_elementwise_ok(key_e, {b.name}, per_elem)
            and _elementwise_ok(val_e, {b.name}, per_elem)):
        return None
    if cond is not None and not _elementwise_ok(cond, {b.name}, per_elem):
        return None
    fns = [ir.Lambda((i, x), key_e), ir.Lambda((i, x), val_e)]
    if cond is not None:
        fns.append(ir.Lambda((i, x), cond))
    return ir.KernelCall(
        kernel=spec.name,
        args=tuple(it.data for it in loop.iters),
        ret_ty=wt.DictType(kt, vt),
        params=(("capacity", cap), ("key_np", str(kt.np_dtype.__name__)),
                ("has_pred", cond is not None)),
        fns=tuple(fns),
    )


def _match_hash_build(loop: ir.For, dense: Shapes) -> Optional[ir.KernelCall]:
    """Dictmerger build via the open-addressing hash route: int keys of
    ANY value (no dense [0, capacity) requirement) — scalar OR a struct
    of int columns (multi-column join keys, packed 32 bits per column
    into the shared 64-bit key space) — with scalar or struct-of-scalars
    values.  Matched for probed dicts (hash-join build side) and as the
    fallback when the dense segment route declines."""
    spec = reg.available("dict_hash_build")
    if spec is None:
        return None
    nb = loop.builder
    if not (
        isinstance(nb, ir.NewBuilder)
        and isinstance(nb.ty, wt.DictMerger)
        and nb.ty.op == "+"
    ):
        return None
    kt, vt = nb.ty.key, nb.ty.val
    key_tys = kt.fields if isinstance(kt, wt.Struct) else (kt,)
    if not all(isinstance(t, wt.Scalar) and t.is_int for t in key_tys):
        return None
    val_tys = vt.fields if isinstance(vt, wt.Struct) else (vt,)
    if not all(_scalar_kind_ok(t, spec) for t in val_tys):
        return None
    cap = _static_cap(nb.arg, dense)
    if cap is None:
        return None  # capacity must be statically resolvable
    if spec.max_segments is not None and cap > spec.max_segments:
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    cond: Optional[ir.Expr] = None
    if (
        isinstance(body, ir.If)
        and isinstance(body.on_true, ir.Merge)
        and _is_ident(body.on_false, b.name)
    ):
        cond, body = body.cond, body.on_true
    if not (isinstance(body, ir.Merge) and _is_ident(body.builder, b.name)):
        return None
    key_e, val_e = _destructure_pair(body.value)
    if isinstance(kt, wt.Struct):
        if not (isinstance(key_e, ir.MakeStruct)
                and len(key_e.items) == len(key_tys)):
            return None
        key_exprs = list(key_e.items)
    else:
        key_exprs = [key_e]
    struct_val = isinstance(vt, wt.Struct)
    if struct_val:
        if not (isinstance(val_e, ir.MakeStruct)
                and len(val_e.items) == len(val_tys)):
            return None
        val_exprs = list(val_e.items)
    else:
        val_exprs = [val_e]
    per_elem = {i.name, x.name}
    for e2 in key_exprs + val_exprs:
        if not _elementwise_ok(e2, {b.name}, per_elem):
            return None
    if cond is not None and not _elementwise_ok(cond, {b.name}, per_elem):
        return None
    fns = [ir.Lambda((i, x), k) for k in key_exprs]
    fns += [ir.Lambda((i, x), v) for v in val_exprs]
    if cond is not None:
        fns.append(ir.Lambda((i, x), cond))
    return ir.KernelCall(
        kernel=spec.name,
        args=tuple(it.data for it in loop.iters),
        ret_ty=wt.DictType(kt, vt),
        params=(("capacity", cap), ("n_keys", len(key_exprs)),
                ("key_nps", tuple(
                    str(t.np_dtype.__name__) for t in key_tys)),
                ("n_vals", len(val_exprs)), ("struct_val", struct_val),
                ("has_pred", cond is not None)),
        fns=tuple(fns),
    )


def _split_probe_cond(cond: ir.Expr, dname_ok) -> Optional[Tuple[
        ir.KeyExists, Optional[ir.Expr], bool]]:
    """Split a probe loop's condition into (KeyExists(dict, k), pred?,
    negated).  Accepts `keyexists(d, k)`, its negation (anti joins), or
    a single `&&` with the (possibly negated) keyexists on either side
    (the shapes weldrel's filtered joins emit)."""

    def as_ke(e: ir.Expr):
        if isinstance(e, ir.KeyExists) and dname_ok(e.expr):
            return e, False
        if (isinstance(e, ir.UnaryOp) and e.op == "not"
                and isinstance(e.expr, ir.KeyExists)
                and dname_ok(e.expr.expr)):
            return e.expr, True
        return None

    hit = as_ke(cond)
    if hit is not None:
        return hit[0], None, hit[1]
    if isinstance(cond, ir.BinOp) and cond.op == "&&":
        for side, pred in ((cond.left, cond.right),
                           (cond.right, cond.left)):
            hit = as_ke(side)
            if hit is not None:
                return hit[0], pred, hit[1]
    return None


def _match_hash_probe(loop: ir.For, dense: Shapes) -> Optional[ir.KernelCall]:
    """Gather-style dict probe: filter rows to key matches and emit
    either a looked-up value (right/build column) or an elementwise
    expression over the probe row (left column).

        result(for(V.., vecbuilder,
                   (b,i,x) => if([p &&] keyexists(d, k),
                              merge(b, lookup(d,k)[.j] | f(x)), b)))

    The dict is a let-bound value (kernelized or generic — both arrive
    as a WDict at execution time)."""
    spec = reg.available("hash_probe")
    if spec is None:
        return None
    nb = loop.builder
    if not (
        isinstance(nb, ir.NewBuilder)
        and isinstance(nb.ty, wt.VecBuilder)
        and _scalar_kind_ok(nb.ty.elem, spec)
    ):
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    if not (
        isinstance(body, ir.If)
        and isinstance(body.on_true, ir.Merge)
        and _is_ident(body.on_true.builder, b.name)
        and _is_ident(body.on_false, b.name)
    ):
        return None

    def dname_ok(e: ir.Expr) -> bool:
        return isinstance(e, ir.Ident) and isinstance(e.ty, wt.DictType)

    split = _split_probe_cond(body.cond, dname_ok)
    if split is None:
        return None
    ke, pred, negated = split
    if negated:
        return None  # anti probes arrive in the fused struct form only
    d_id = ke.expr
    key_e = ke.key
    kt = d_id.ty.key
    if not (isinstance(kt, wt.Scalar) and kt.is_int):
        return None
    per_elem = {i.name, x.name}
    banned = {b.name, d_id.name}
    if not _elementwise_ok(key_e, banned, per_elem):
        return None
    if pred is not None and not _elementwise_ok(pred, banned, per_elem):
        return None

    val = body.on_true.value
    field = -1
    gather = False
    if isinstance(val, ir.GetField) and isinstance(val.expr, ir.Lookup):
        lk, field = val.expr, val.index
        gather = True
    elif isinstance(val, ir.Lookup):
        lk = val
        gather = True
    if gather:
        if not (_is_ident(lk.expr, d_id.name)
                and ir.canon_key(lk.index) == ir.canon_key(key_e)):
            return None
        fns = [ir.Lambda((i, x), key_e)]
    else:
        if not _elementwise_ok(val, banned, per_elem):
            return None
        fns = [ir.Lambda((i, x), key_e), ir.Lambda((i, x), val)]
    if pred is not None:
        fns.append(ir.Lambda((i, x), pred))
    return ir.KernelCall(
        kernel=spec.name,
        args=(d_id,) + tuple(it.data for it in loop.iters),
        ret_ty=wt.Vec(nb.ty.elem),
        params=(("gather", gather), ("field", field),
                ("has_pred", pred is not None)),
        fns=tuple(fns),
    )


def _match_hash_probe_fused(loop: ir.For,
                            dense: Shapes) -> Optional[ir.KernelCall]:
    """Horizontally fused join probe: ONE loop merging every output
    column into a struct of vecbuilders (the form weldrel's join emits),
    so an N-column join takes ONE ``hash_probe`` launch instead of N.

        result(for(V.., {vecbuilder..},
               (b,i,x) => if(cond, {merge(b.$k, v_k)..}, b)))

    ``cond``/values encode the join flavor:

    * inner — cond carries ``keyexists(d, k)``; right columns gather
      ``lookup(d, k)[.j]``;
    * left  — no keyexists in cond (an optional elementwise predicate
      only); right columns gather ``lookup(d, k, fill)[.j]`` — the
      single-probe miss form;
    * anti  — cond carries ``not(keyexists(d, k))``; left columns only.

    Keys may be scalar ints or a struct of int columns (packed in the
    adapter exactly like the dict build side)."""
    spec = reg.available("hash_probe")
    if spec is None:
        return None
    nb = loop.builder
    if not (isinstance(nb, ir.MakeStruct) and nb.items and all(
            isinstance(p, ir.NewBuilder) and isinstance(p.ty, wt.VecBuilder)
            and _scalar_kind_ok(p.ty.elem, spec) for p in nb.items)):
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    cond: Optional[ir.Expr] = None
    if isinstance(body, ir.If):
        if not _is_ident(body.on_false, b.name):
            return None
        cond, body = body.cond, body.on_true
    if not (isinstance(body, ir.MakeStruct)
            and len(body.items) == len(nb.items)):
        return None
    vals: List[ir.Expr] = []
    for k, item in enumerate(body.items):
        if not (
            isinstance(item, ir.Merge)
            and isinstance(item.builder, ir.GetField)
            and item.builder.index == k
            and _is_ident(item.builder.expr, b.name)
        ):
            return None
        vals.append(item.value)

    def dname_ok(e: ir.Expr) -> bool:
        return isinstance(e, ir.Ident) and isinstance(e.ty, wt.DictType)

    d_id: Optional[ir.Ident] = None
    key_e: Optional[ir.Expr] = None
    pred: Optional[ir.Expr] = None
    if cond is not None:
        split = _split_probe_cond(cond, dname_ok)
        if split is not None:
            ke, pred, negated = split
            d_id, key_e = ke.expr, ke.key
            how = "anti" if negated else "inner"
        else:
            pred, how = cond, "left"
    else:
        how = "left"

    # classify output columns; left joins discover the dict/key from the
    # gathers (their condition carries no keyexists)
    cols: List[Tuple[str, int]] = []
    fills: List[object] = []
    exprs: List[ir.Expr] = []
    for v in vals:
        lk, fld = v, -1
        if isinstance(lk, ir.GetField) and isinstance(lk.expr, ir.Lookup):
            lk, fld = lk.expr, lk.index
        if isinstance(lk, ir.Lookup) and dname_ok(lk.expr):
            if how == "anti":
                return None  # anti joins carry no build-side columns
            if d_id is None:
                d_id, key_e = lk.expr, lk.index
            if not (_is_ident(lk.expr, d_id.name)
                    and ir.canon_key(lk.index) == ir.canon_key(key_e)):
                return None  # every gather must share ONE dict + key
            if how == "left":
                dflt = lk.default
                if dflt is None:
                    return None
                f = dflt.items[fld] if isinstance(dflt, ir.MakeStruct) \
                    else dflt
                if not isinstance(f, ir.Literal):
                    return None
                fills.append(f.value)
            else:
                if lk.default is not None:
                    return None
                fills.append(None)
            cols.append(("gather", fld))
        else:
            cols.append(("expr", len(exprs)))
            exprs.append(v)
            fills.append(None)
    if d_id is None:
        return None  # no dict anywhere: a plain filter, not a probe
    kt = d_id.ty.key
    if isinstance(kt, wt.Struct):
        if not all(isinstance(f, wt.Scalar) and f.is_int
                   for f in kt.fields):
            return None
        if not (isinstance(key_e, ir.MakeStruct)
                and len(key_e.items) == len(kt.fields)):
            return None
        key_parts = list(key_e.items)
    elif isinstance(kt, wt.Scalar) and kt.is_int:
        key_parts = [key_e]
    else:
        return None
    per_elem = {i.name, x.name}
    banned = {b.name, d_id.name}
    for e2 in key_parts + exprs:
        if not _elementwise_ok(e2, banned, per_elem):
            return None
    if pred is not None and not _elementwise_ok(pred, banned, per_elem):
        return None
    fns = [ir.Lambda((i, x), p) for p in key_parts]
    fns += [ir.Lambda((i, x), v) for v in exprs]
    if pred is not None:
        fns.append(ir.Lambda((i, x), pred))
    return ir.KernelCall(
        kernel=spec.name,
        args=(d_id,) + tuple(it.data for it in loop.iters),
        ret_ty=wt.Struct(tuple(wt.Vec(p.ty.elem) for p in nb.items)),
        params=(("how", how), ("n_keys", len(key_parts)),
                ("cols", tuple(cols)), ("fills", tuple(fills)),
                ("has_pred", pred is not None)),
        fns=tuple(fns),
    )


def _match_group_build(loop: ir.For, dense: Shapes) -> Optional[ir.KernelCall]:
    """Groupbuilder build (key -> growing vector of row payloads) via the
    hash route: hash-to-slot + CSR slot-histogram compaction — the m:n
    hash-join build side.  Keys are scalar ints or a struct of int
    columns (packed like the dictmerger hash build); the payload is one
    scalar (the join stores the build-row index)."""
    spec = reg.available("group_build")
    if spec is None:
        return None
    nb = loop.builder
    if not (
        isinstance(nb, ir.NewBuilder)
        and isinstance(nb.ty, wt.GroupBuilder)
    ):
        return None
    kt, vt = nb.ty.key, nb.ty.val
    key_tys = kt.fields if isinstance(kt, wt.Struct) else (kt,)
    if not all(isinstance(t, wt.Scalar) and t.is_int for t in key_tys):
        return None
    if not _scalar_kind_ok(vt, spec):
        return None
    cap = _static_cap(nb.arg, dense)
    if cap is None:
        return None  # capacity must be statically resolvable
    if spec.max_segments is not None and cap > spec.max_segments:
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    cond: Optional[ir.Expr] = None
    if (
        isinstance(body, ir.If)
        and isinstance(body.on_true, ir.Merge)
        and _is_ident(body.on_false, b.name)
    ):
        cond, body = body.cond, body.on_true
    if not (isinstance(body, ir.Merge) and _is_ident(body.builder, b.name)):
        return None
    key_e, val_e = _destructure_pair(body.value)
    if isinstance(kt, wt.Struct):
        if not (isinstance(key_e, ir.MakeStruct)
                and len(key_e.items) == len(key_tys)):
            return None
        key_exprs = list(key_e.items)
    else:
        key_exprs = [key_e]
    per_elem = {i.name, x.name}
    for e2 in key_exprs + [val_e]:
        if not _elementwise_ok(e2, {b.name}, per_elem):
            return None
    if cond is not None and not _elementwise_ok(cond, {b.name}, per_elem):
        return None
    fns = [ir.Lambda((i, x), k) for k in key_exprs]
    fns.append(ir.Lambda((i, x), val_e))
    if cond is not None:
        fns.append(ir.Lambda((i, x), cond))
    return ir.KernelCall(
        kernel=spec.name,
        args=tuple(it.data for it in loop.iters),
        ret_ty=wt.DictType(kt, wt.Vec(vt)),
        params=(("capacity", cap), ("n_keys", len(key_exprs)),
                ("key_nps", tuple(
                    str(t.np_dtype.__name__) for t in key_tys)),
                ("has_pred", cond is not None)),
        fns=tuple(fns),
    )


def _match_group_probe(loop: ir.For,
                       dense: Shapes) -> Optional[ir.KernelCall]:
    """The m:n join fan-out probe: the canonical variable-length
    expansion loop (see torchgen ``match_group_probe`` for the exact
    shape) routed as ONE ``group_probe`` launch — membership and the
    per-row match-count pass fused into a single search kernel, with
    every output column sharing the expansion index the adapter builds
    from it.  The static output capacity comes from the vecbuilders'
    size hints (weldrel stamps the exact unfiltered expansion size)."""
    spec = reg.available("group_probe")
    if spec is None:
        return None
    shape = _group_probe_shape(loop)
    if shape is None:
        return None
    if not all(p.ty.elem.kind in spec.elem_kinds for p in shape.builders):
        return None
    out_cap = _static_cap(shape.builders[0].size_hint, dense)
    if out_cap is None:
        return None  # output capacity must be static to size the buffers
    kt = shape.d.ty.key
    key_tys = kt.fields if isinstance(kt, wt.Struct) else (kt,)
    if not all(isinstance(t, wt.Scalar) and t.is_int for t in key_tys):
        return None
    if len(shape.key_parts) != len(key_tys):
        return None
    b, i, x = loop.func.params
    per_elem = {i.name, x.name}
    banned = {b.name, shape.d.name}
    for e2 in shape.key_parts:
        if not _elementwise_ok(e2, banned, per_elem):
            return None
    if shape.pred is not None and not _elementwise_ok(
            shape.pred, banned, per_elem):
        return None
    args: List[ir.Expr] = [shape.d] + [it.data for it in loop.iters]
    cols: List[Tuple[str, int]] = []
    exprs: List[ir.Expr] = []
    fills: List[object] = []
    for (kind, payload), fl in zip(shape.cols, shape.fills):
        if kind == "gather":
            # build columns are gathered outside the kernel: they must
            # be dense program inputs the adapter can index directly
            if not (isinstance(payload, ir.Ident)
                    and payload.name in dense):
                return None
            cols.append(("gather", len(args)))
            args.append(payload)
            fills.append(None if fl is None else fl.value)
        else:
            if not _elementwise_ok(payload, banned, per_elem):
                return None
            cols.append(("expr", len(exprs)))
            exprs.append(payload)
            fills.append(None)
    fns = [ir.Lambda((i, x), p) for p in shape.key_parts]
    fns += [ir.Lambda((i, x), v) for v in exprs]
    if shape.pred is not None:
        fns.append(ir.Lambda((i, x), shape.pred))
    return ir.KernelCall(
        kernel=spec.name,
        args=tuple(args),
        ret_ty=wt.Struct(tuple(wt.Vec(p.ty.elem) for p in shape.builders)),
        params=(("how", shape.how), ("n_keys", len(shape.key_parts)),
                ("n_iters", len(loop.iters)), ("cols", tuple(cols)),
                ("fills", tuple(fills)), ("out_cap", out_cap),
                ("has_pred", shape.pred is not None)),
        fns=tuple(fns),
    )


def _match_map_chain(loop: ir.For, dense: Shapes,
                     refusals: Optional[List[Tuple[str, str]]] = None
                     ) -> Optional[ir.KernelCall]:
    spec = reg.available("map_elementwise")
    if spec is None:
        return None
    nb = loop.builder
    if not (
        isinstance(nb, ir.NewBuilder)
        and isinstance(nb.ty, wt.VecBuilder)
        and _scalar_kind_ok(nb.ty.elem, spec)
    ):
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    if not (isinstance(body, ir.Merge) and _is_ident(body.builder, b.name)):
        return None
    val = body.value
    per_elem = {i.name, x.name}
    # the staged body runs INSIDE the kernel: gathers into whole arrays
    # (Lookup) and the loop index are unavailable there.
    if not _elementwise_ok(val, {b.name}, per_elem, allow_lookup=False):
        return None
    if i.name in ir.free_vars(val):
        return None
    if _compute_ops(val) < MIN_MAP_OPS:
        return None  # trivial map: the generic emitter handles it
    lam = ir.Lambda((i, x), val)
    why = spec.refuse(lam) if spec.refuse is not None else None
    if why is not None:
        if refusals is not None:
            refusals.append((spec.name, why))
        return None
    return ir.KernelCall(
        kernel=spec.name,
        args=tuple(it.data for it in loop.iters),
        ret_ty=wt.Vec(nb.ty.elem),
        fns=(lam,),
    )


def _match_loop(e: ir.Result, dense: Shapes,
                probed: bool = False,
                refusals: Optional[List[Tuple[str, str]]] = None
                ) -> Optional[ir.KernelCall]:
    loop = e.builder
    if not isinstance(loop, ir.For) or not loop.iters:
        return None
    if not all(_iter_ok(it, dense) for it in loop.iters):
        return None
    if len(loop.func.params) != 3:
        return None
    nb = loop.builder
    if isinstance(nb, ir.NewBuilder):
        if isinstance(nb.ty, wt.Merger):
            return _match_filter_reduce(loop, dense)
        if isinstance(nb.ty, wt.VecMerger):
            return _match_vecmerger(loop, dense)
        if isinstance(nb.ty, wt.DictMerger):
            if probed:
                # a probed dict (join build side) must preserve exact
                # keys: only the hash route is sound, never the dense
                # [0, capacity) segment route
                return _match_hash_build(loop, dense)
            return (_match_dict_group(loop, dense)
                    or _match_hash_build(loop, dense))
        if isinstance(nb.ty, wt.GroupBuilder):
            # group builds are only routed when probed (the m:n join
            # build side); a standalone groupbuilder result decodes on
            # the host and keeps the generic keyed finalize
            return _match_group_build(loop, dense) if probed else None
        if isinstance(nb.ty, wt.VecBuilder):
            return (_match_map_chain(loop, dense, refusals)
                    or _match_hash_probe(loop, dense))
    if isinstance(nb, ir.MakeStruct):
        return (_match_filter_reduce(loop, dense)
                or _match_hash_probe_fused(loop, dense)
                or _match_group_probe(loop, dense))
    return None


def _match_cudf(e: ir.CUDF) -> Optional[ir.KernelCall]:
    name = {"linalg.matmul": "matmul", "linalg.matvec": "matvec"}.get(e.name)
    if name is None:
        return None
    spec = reg.available(name)
    if spec is None:
        return None
    for a in e.args:
        try:
            ty = ir.typeof(a)
        except Exception:
            return None
        base = ty
        while isinstance(base, wt.Vec):
            base = base.elem
        if not _scalar_kind_ok(base, spec):
            return None
    return ir.KernelCall(kernel=name, args=e.args, ret_ty=e.ret_ty)


# ---------------------------------------------------------------------------
# static shape inference (feeds the cost model)
# ---------------------------------------------------------------------------


def _shape_of(e: ir.Expr, dense: Shapes) -> Optional[tuple]:
    """Statically-known shape of a dense expression, if any."""
    if isinstance(e, ir.Ident):
        return dense.get(e.name)
    if isinstance(e, ir.MakeVec):
        return (len(e.items),)
    if isinstance(e, ir.KernelCall):
        if e.kernel == "vecmerger_segment_sum":
            return _shape_of(e.args[0], dense)
        if e.kernel == "map_elementwise":
            return _shape_of(e.args[0], dense)
        if e.kernel == "matmul":
            a = _shape_of(e.args[0], dense)
            b = _shape_of(e.args[1], dense)
            if a and b and len(a) == 2 and len(b) == 2:
                return (a[0], b[1])
            return None
        if e.kernel == "matvec":
            a = _shape_of(e.args[0], dense)
            return (a[0],) if a else None
        return None
    if isinstance(e, ir.Result) and isinstance(e.builder, ir.For):
        loop = e.builder
        nb = loop.builder
        if isinstance(nb, ir.NewBuilder) and isinstance(nb.ty, wt.VecMerger):
            return _shape_of(nb.arg, dense)
        if loop.iters:  # map-like: output length == iter length
            src = _shape_of(loop.iters[0].data, dense)
            return (src[0],) if src else None
    return None


def _len_of(e: ir.Expr, dense: Shapes) -> Optional[int]:
    shp = _shape_of(e, dense)
    return int(shp[0]) if shp else None


_elem_bytes = wt.elem_bytes  # shared with the emitter's memory accounting


def _np_dtype_of(ty: wt.WeldType):
    if isinstance(ty, wt.Vec):
        return _np_dtype_of(ty.elem)
    if isinstance(ty, wt.Struct):
        return _np_dtype_of(ty.fields[0]) if ty.fields else np.float64
    if isinstance(ty, wt.DictType):
        return _np_dtype_of(ty.val)
    if isinstance(ty, wt.Scalar):
        return np.dtype(ty.np_dtype)
    return np.float64


def _call_meta(kc: ir.KernelCall, dense: Shapes,
               dict_caps: Optional[Dict[str, int]] = None) -> dict:
    """Static description of a matched call for cost.py."""
    spec = reg.available(kc.kernel)
    params = dict(kc.params)
    meta: dict = {"kernel": kc.kernel}
    if kc.kernel == "filter_reduce_sum":
        meta["n"] = next(
            (v for v in (_len_of(a, dense) for a in kc.args) if v), None
        )
        meta["cols"] = len(kc.args)
        meta["n_aggs"] = params.get("n_aggs", 1)
        meta["has_pred"] = bool(params.get("has_pred", True))
        meta["ops"] = sum(_compute_ops(f.body) for f in kc.fns) or 1
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel == "vecmerger_segment_sum":
        meta["n"] = next(
            (v for v in (_len_of(a, dense) for a in kc.args[1:]) if v), None
        )
        meta["k"] = _len_of(kc.args[0], dense)
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel == "dict_group_sum":
        meta["n"] = next(
            (v for v in (_len_of(a, dense) for a in kc.args) if v), None
        )
        meta["k"] = params.get("capacity")
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel == "dict_hash_build":
        meta["n"] = next(
            (v for v in (_len_of(a, dense) for a in kc.args) if v), None
        )
        meta["k"] = params.get("capacity")
        meta["n_vals"] = params.get("n_vals", 1)
        meta["n_keys"] = params.get("n_keys", 1)
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel == "hash_probe":
        meta["n"] = next(
            (v for v in (_len_of(a, dense) for a in kc.args[1:]) if v), None
        )
        d = kc.args[0]
        meta["k"] = (dict_caps or {}).get(
            d.name if isinstance(d, ir.Ident) else "")
        # fused probes carry every output column through ONE launch; the
        # cost model prices the shared membership tile against them all
        meta["cols"] = max(len(params.get("cols", ())), 1)
        # build-side columns gathered at the found positions
        meta["gathers"] = (
            sum(kind != "expr" for kind, _ in params["cols"])
            if "cols" in params else int(bool(params.get("gather"))))
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel == "group_build":
        meta["n"] = next(
            (v for v in (_len_of(a, dense) for a in kc.args) if v), None
        )
        meta["k"] = params.get("capacity")
        meta["n_keys"] = params.get("n_keys", 1)
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel == "group_probe":
        n_iters = params.get("n_iters", 1)
        meta["n"] = next(
            (v for v in (_len_of(a, dense)
                         for a in kc.args[1:1 + n_iters]) if v), None
        )
        d = kc.args[0]
        meta["k"] = (dict_caps or {}).get(
            d.name if isinstance(d, ir.Ident) else "")
        meta["cols"] = max(len(params.get("cols", ())), 1)
        # the expansion factor: both routes pay the repeated/gathered
        # output traffic, priced off the static expansion capacity
        meta["out"] = params.get("out_cap")
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel in ("matmul", "matvec"):
        a = _shape_of(kc.args[0], dense)
        b = _shape_of(kc.args[1], dense)
        if a and len(a) == 2:
            if kc.kernel == "matvec":
                # rhs is a vector: the output column count is 1 by shape
                meta["dims"] = (a[0], a[1], 1)
                meta["n"] = a[0]
            elif b and len(b) == 2:
                meta["dims"] = (a[0], a[1], b[1])
                meta["n"] = a[0]
            # else: rhs shape unknown — leave dims unset so the cost
            # model rejects conservatively instead of pricing a guess
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    elif kc.kernel == "map_elementwise":
        meta["n"] = next(
            (v for v in (_len_of(a, dense) for a in kc.args) if v), None
        )
        meta["cols"] = len(kc.args)
        meta["ops"] = sum(_compute_ops(f.body) for f in kc.fns) or 1
        meta["elem_bytes"] = _elem_bytes(kc.ret_ty)
    if spec is not None and spec.cost_meta is not None:
        meta.update(spec.cost_meta(kc))
    meta["dtype"] = str(np.dtype(_np_dtype_of(kc.ret_ty)))
    return meta


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def plan_kernels(
    e: ir.Expr,
    input_shapes: Optional[Dict[str, tuple]] = None,
    stats: Optional[Dict[str, int]] = None,
    mode: str = "always",
    impl: Optional[str] = None,
) -> ir.Expr:
    """Annotate matched loops with KernelCall nodes.  Identity on programs
    with no matches; never rewrites inside ``for`` bodies.

    ``mode="always"`` routes every sound match; ``mode="auto"`` prices
    each candidate through the roofline cost model and keeps the generic
    lowering when the kernel route loses.  Decisions (with both cost
    estimates) are recorded under ``stats["kernelplan"]``.
    """
    if mode not in ("always", "auto"):
        raise ValueError(f"plan_kernels mode must be always/auto, got {mode!r}")
    stats = stats if stats is not None else {}
    stats.setdefault("kernelize.matched", 0)
    kplan = stats.setdefault(
        "kernelplan",
        {"mode": mode, "routed": {}, "rejected": {}, "costs": []},
    )
    dense: Shapes = {
        k: tuple(v) if v is not None else None
        for k, v in (input_shapes or {}).items()
    }
    #: let-bound dict values (kernelized or generic) -> static capacity,
    #: which prices the probe side of a hash join.
    dict_caps: Dict[str, int] = {}
    #: weldbound [lo, hi] row intervals for let-bound intermediates
    #: whose exact length is unknown — the cost model prices those
    #: candidates at the interval midpoint instead of bailing
    nbounds: Dict[str, Tuple[int, Optional[int]]] = {}
    try:
        from ..analysis import bounds as _bounds

        if _bounds.enabled():
            nbounds = _bounds.analyze(e).name_bounds(input_shapes)
    except Exception:
        nbounds = {}

    def _quarantined(kc: ir.KernelCall, meta: dict) -> bool:
        """Whether the route is quarantined.  On a card, where the
        generic lowering may not stand in for the kernel unseen, a
        quarantined route raises under "always" and warns under
        "auto"."""
        from . import quarantine

        dtype = _np_dtype_of(kc.ret_ty)
        if not quarantine.is_quarantined(kc.kernel, impl=impl, dtype=dtype,
                                         n=meta.get("n")):
            return False
        if quarantine.on_card():
            what = (f"kernel {kc.kernel!r} is quarantined on "
                    f"{quarantine.device_name()} (dtype "
                    f"{np.dtype(dtype).name}, n={meta.get('n')})")
            if mode == "always":
                from ..errors import KernelQuarantinedError

                raise KernelQuarantinedError(
                    f"{what}; kernelize='always' will not run it on the "
                    f"generic lowering: fix the kernel and call "
                    f"kernelplan.quarantine.clear()",
                    kernel=kc.kernel, impl=impl, dtype=str(np.dtype(dtype)),
                    n=meta.get("n"))
            warnings.warn(f"{what}: the planner keeps the generic lowering "
                          f"for it", RuntimeWarning, stacklevel=2)
        return True

    def consider(kc: ir.KernelCall, orig: ir.Expr) -> ir.Expr:
        meta = _call_meta(kc, dense, dict_caps)
        if meta.get("n") is None and nbounds:
            mid = _midpoint_n(kc, nbounds)
            if mid is not None:
                meta["n"] = mid
                kplan["midpoint_priced"] = (
                    kplan.get("midpoint_priced", 0) + 1)
        if _quarantined(kc, meta):
            # a route that failed to build or launch before is rejected
            # up front (even under "always") — re-paying a known failure
            # would just bounce off the recovery fallback again
            kplan["rejected"][kc.kernel] = (
                kplan["rejected"].get(kc.kernel, 0) + 1
            )
            kplan["costs"].append({
                "kernel": kc.kernel, "routed": False,
                "why": "quarantined", "kernel_us": 0.0, "jnp_us": 0.0,
            })
            _obs.event("kernelplan.candidate", kernel=kc.kernel,
                       n=meta.get("n"), routed=False, why="quarantined")
            return orig
        if kc.kernel in ("hash_probe", "group_probe"):
            # the reference's rule (its one-hot tile is block x
            # capacity): an unknown or oversized dict keeps the generic
            # probe even under "always"
            spec = reg.available(kc.kernel)
            k = meta.get("k")
            if k is None or (spec is not None
                             and spec.max_segments is not None
                             and k > spec.max_segments):
                return orig
        if mode == "auto":
            est = _cost.estimate(reg.get(kc.kernel), dict(meta, impl=impl))
            kplan["costs"].append({"kernel": kc.kernel, **est.as_stats()})
            _obs.event("kernelplan.candidate", kernel=kc.kernel,
                       n=meta.get("n"), **est.as_stats())
            if not est.routed:
                kplan["rejected"][kc.kernel] = (
                    kplan["rejected"].get(kc.kernel, 0) + 1
                )
                return orig
        else:
            # "always" routes unconditionally; the roofline price still
            # rides along in the plan
            est = _cost.estimate(reg.get(kc.kernel), dict(meta, impl=impl))
            _obs.event("kernelplan.candidate", kernel=kc.kernel,
                       n=meta.get("n"), routed=True, why="mode=always")
        kplan["routed"][kc.kernel] = kplan["routed"].get(kc.kernel, 0) + 1
        stats["kernelize.matched"] += 1
        key = f"kernelize.{kc.kernel}"
        stats[key] = stats.get(key, 0) + 1
        n = meta.get("n")
        extra: Tuple[Tuple[str, object], ...] = (
            ("n_rows", int(n) if n else -1),
        )
        if est.kernel_s and est.kernel_s != float("inf"):
            extra += (("predicted_ns", int(est.kernel_s * 1e9)),)
        if meta.get("dims"):
            extra += (("dims", tuple(int(d) for d in meta["dims"])),)
        if meta.get("k") and "capacity" not in dict(kc.params):
            extra += (("k", int(meta["k"])),)
        return ir.KernelCall(
            kernel=kc.kernel,
            args=kc.args,
            ret_ty=kc.ret_ty,
            params=kc.params + extra,
            fns=kc.fns,
        )

    def rec_let_value(v: ir.Expr, probed: bool) -> ir.Expr:
        """Plan a let-bound value.  A dict build whose result is probed
        downstream (Lookup/KeyExists — the hash-join build side) may
        ONLY take the hash route: the dense segment route would poison
        sparse keys the generic lowering handles fine."""
        if probed and isinstance(v, ir.Result) \
                and isinstance(v.builder, ir.For) \
                and isinstance(v.builder.builder, ir.NewBuilder) \
                and isinstance(v.builder.builder.ty,
                               (wt.DictMerger, wt.GroupBuilder)):
            v2 = v.map_children(rec)  # plan nested subtrees only
            kc = _match_loop(v2, dense, probed=True)
            if kc is not None:
                return consider(kc, v2)
            return v2
        return rec(v)

    def rec(x: ir.Expr) -> ir.Expr:
        if isinstance(x, ir.Lambda):
            return x  # loop bodies are off-limits
        if isinstance(x, ir.Let):
            v = rec_let_value(x.value, _probed_as_dict(x.name, x.body))
            if _value_dense(v, dense):
                dense[x.name] = _shape_of(v, dense)
            cap = _dict_cap_of(v, dense)
            if cap is not None:
                dict_caps[x.name] = cap
            return ir.Let(x.name, v, rec(x.body))
        x = x.map_children(rec)
        if isinstance(x, ir.Result):
            refusals: List[Tuple[str, str]] = []
            kc = _match_loop(x, dense, refusals=refusals)
            for name, why in refusals:
                # a sound match whose body the kernel cannot take: the
                # loop stays generic, and the plan says why
                kplan.setdefault("refused", {}).setdefault(
                    name, []).append(why)
            if kc is not None:
                return consider(kc, x)
        if isinstance(x, ir.CUDF):
            kc = _match_cudf(x)
            if kc is not None:
                return consider(kc, x)
        return x

    planned = rec(e)
    # self-verify the planned program: a bad rewrite here (stale ident
    # type, unregistered kernel, capacity mismatch between build and
    # probe) would otherwise only surface as a cryptic launch error
    from .. import check

    check.checkpoint("kernelplan", planned, stats=stats,
                     shapes=input_shapes)
    return planned


def _midpoint_n(kc: ir.KernelCall,
                nbounds: Dict[str, Tuple[int, Optional[int]]]
                ) -> Optional[int]:
    """Midpoint of the derived [lo, hi] length interval of the call's
    driving argument — only consulted when the exact length is unknown,
    and only when the interval's upper bound is finite."""
    if kc.kernel in ("matmul", "matvec"):
        return None  # dims-driven: a guessed n would misprice the tiles
    args = (kc.args[1:] if kc.kernel in ("hash_probe", "group_probe")
            else kc.args)
    for a in args:
        if isinstance(a, ir.Ident) and a.name in nbounds:
            lo, hi = nbounds[a.name]
            if hi is None:
                continue
            return max(1, (int(lo) + int(hi) + 1) // 2)
    return None


def _probed_as_dict(name: str, body: ir.Expr) -> bool:
    """Does `body` consume `name` through dict probes (Lookup/KeyExists/
    GroupLookup)?"""
    return any(
        isinstance(n, (ir.Lookup, ir.KeyExists, ir.GroupLookup))
        and _is_ident(n.expr, name)
        for n in ir.walk(body)
    )


def _dict_cap_of(v: ir.Expr, dense: Shapes) -> Optional[int]:
    """Static capacity of a let-bound dict value, kernelized or not.
    Symbolic capacities (the host-count-free join path) resolve against
    the bound input shapes like any other static size."""
    if isinstance(v, ir.KernelCall) and v.kernel in (
            "dict_group_sum", "dict_hash_build", "group_build"):
        cap = dict(v.params).get("capacity")
        return int(cap) if cap is not None else None
    if isinstance(v, ir.Result) and isinstance(v.builder, ir.For):
        nb = v.builder.builder
        if isinstance(nb, ir.NewBuilder) \
                and isinstance(nb.ty, (wt.DictMerger, wt.GroupBuilder)):
            return _static_cap(nb.arg, dense)
    return None
