"""Loop fusion (paper Table 3).

Two rules, mirroring the paper:

* **Vertical** — `for(result(for(V, vecbuilder, F1)), B, F2)` where the
  consumer iterates over the materialized output of a producer loop: the
  producer's `merge(b1, e)` sites are rewritten to run the consumer body on
  `e` directly, eliminating the intermediate vector entirely.

* **Horizontal** — multiple loops over the *same* iteration space with
  independent builders are combined into one loop over a struct of
  builders (Listing 3), so a single pass over the data produces all
  results ("fuses multiple passes over the same vector").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import ir
from .. import wtypes as wt


# ---------------------------------------------------------------------------
# Vertical fusion
# ---------------------------------------------------------------------------


def _merge_sites(body: ir.Expr, bname: str) -> Optional[List[ir.Merge]]:
    """Collect Merge sites into builder `bname` if the body has the simple
    'builder-flow' shape: an expression over {Ident(b), Merge, If, Let}
    where the builder flows linearly.  Returns None if the body is too
    complex to fuse (nested loops over the builder, builder in Select...)."""
    sites: List[ir.Merge] = []

    def rec(x: ir.Expr) -> bool:
        # returns True if x is a builder-typed expression in the flow
        if isinstance(x, ir.Ident):
            return x.name == bname
        if isinstance(x, ir.Merge):
            if rec(x.builder):
                sites.append(x)
                return True
            return False
        if isinstance(x, ir.If):
            t = rec(x.on_true)
            f = rec(x.on_false)
            return t and f
        if isinstance(x, ir.Let):
            # allow lets of pure values around the flow
            if _uses(x.value, bname):
                return False
            return rec(x.body)
        return False

    ok = rec(body)
    return sites if ok else None


def _uses(e: ir.Expr, name: str) -> bool:
    return any(isinstance(n, ir.Ident) and n.name == name for n in ir.walk(e))


def _merges_unconditionally_once(body: ir.Expr, bname: str) -> bool:
    """True if every control path merges exactly once (map-like)."""

    def rec(x: ir.Expr) -> Optional[int]:
        if isinstance(x, ir.Ident) and x.name == bname:
            return 0
        if isinstance(x, ir.Merge):
            inner = rec(x.builder)
            return None if inner is None else inner + 1
        if isinstance(x, ir.If):
            t, f = rec(x.on_true), rec(x.on_false)
            if t is None or f is None or t != f:
                return None
            return t
        if isinstance(x, ir.Let):
            return rec(x.body)
        return None

    return rec(body) == 1


def try_vertical_fuse(consumer: ir.For, stats: Dict[str, int]) -> Optional[ir.Expr]:
    if len(consumer.iters) != 1 or not consumer.iters[0].is_plain:
        return None
    src = consumer.iters[0].data
    if not isinstance(src, ir.Result):
        return None
    prod = src.builder
    if not isinstance(prod, ir.For):
        return None
    if not isinstance(prod.builder, ir.NewBuilder) or not isinstance(
        prod.builder.ty, wt.VecBuilder
    ):
        return None

    pb, pi, px = prod.func.params
    cb, ci, cx = consumer.func.params
    if _merge_sites(prod.func.body, pb.name) is None:
        return None
    map_like = _merges_unconditionally_once(prod.func.body, pb.name)
    consumer_uses_index = _uses(consumer.func.body, ci.name)
    if consumer_uses_index and not map_like:
        return None  # indices would not align across a filter

    nb = ir.Ident(ir.fresh("b"), ir.typeof(consumer.builder, _builder_env(consumer)))

    def xf(x: ir.Expr) -> ir.Expr:
        """Rewrite the producer body: builder refs become the consumer's
        builder; each merge site becomes an inlined consumer body."""
        if isinstance(x, ir.Ident) and x.name == pb.name:
            return nb
        if isinstance(x, ir.Merge):
            inner = xf(x.builder)
            cbody = ir.rename_binders(
                ir.Lambda((cb, ci, cx), consumer.func.body)
            )
            cb2, ci2, cx2 = cbody.params
            sub = {
                cb2.name: inner,
                cx2.name: x.value,
                ci2.name: pi if map_like else ir.Literal(0, wt.I64),
            }
            return ir.substitute(cbody.body, sub)
        if isinstance(x, ir.If):
            return ir.If(x.cond, xf(x.on_true), xf(x.on_false))
        if isinstance(x, ir.Let):
            return ir.Let(x.name, x.value, xf(x.body))
        raise AssertionError("unreachable: _merge_sites validated the shape")

    new_body = xf(prod.func.body)
    stats["fusion.vertical"] = stats.get("fusion.vertical", 0) + 1
    return ir.For(
        prod.iters,
        consumer.builder,
        ir.Lambda((nb, pi, px), new_body),
    )


def _builder_env(loop: ir.For) -> Dict[str, wt.WeldType]:
    # builder exprs inside loops may reference enclosing params; fall back
    # to Ident-carried types (typeof resolves unknown names from Ident.ty)
    return {}


# ---------------------------------------------------------------------------
# Zip fusion: a consumer iterating MULTIPLE producers (the paper's
# single-pass dataframe traversal: zip of filtered/mapped columns).
# ---------------------------------------------------------------------------


def _classify_producer(it: ir.Iter):
    """Classify one consumer iter: ('raw', iter) | ('map', ...) |
    ('filter', ...).  Producers must be simple vecbuilder loops with a
    single (possibly conditional) merge and no lets."""
    if not it.is_plain:
        return None
    src = it.data
    if not (isinstance(src, ir.Result) and isinstance(src.builder, ir.For)):
        return ("raw", it, None, None, None)
    loop = src.builder
    nb = loop.builder
    if not (isinstance(nb, ir.NewBuilder) and isinstance(nb.ty, wt.VecBuilder)):
        return None
    if not all(i.is_plain for i in loop.iters):
        return None
    pb, pi, px = loop.func.params
    body = loop.func.body
    if _uses(body, pi.name):
        return None
    if isinstance(body, ir.Merge):
        if not (isinstance(body.builder, ir.Ident)
                and body.builder.name == pb.name):
            return None
        return ("map", it, loop, None, body.value)
    if isinstance(body, ir.If) and isinstance(body.on_true, ir.Merge) \
            and isinstance(body.on_false, ir.Ident) \
            and body.on_false.name == pb.name:
        m = body.on_true
        if not (isinstance(m.builder, ir.Ident)
                and m.builder.name == pb.name):
            return None
        return ("filter", it, loop, body.cond, m.value)
    return None


def _normalized_cond_key(cond: ir.Expr, loop: ir.For) -> str:
    """Canonical key of a producer's condition with element-field
    references rewritten to the canonical keys of their SOURCE vectors —
    two producers with equal keys filter in lockstep."""
    px = loop.func.params[2]
    sources = [ir.canon_key(i.data) for i in loop.iters]

    def rewrite(x: ir.Expr) -> ir.Expr:
        if isinstance(x, ir.GetField) and isinstance(x.expr, ir.Ident) \
                and x.expr.name == px.name:
            return ir.Ident(f"<src:{sources[x.index]}>", None)
        if isinstance(x, ir.Ident) and x.name == px.name:
            return ir.Ident(f"<src:{sources[0]}>", None)
        return x.map_children(rewrite)

    return ir.canon_key(rewrite(cond))


def try_zip_fuse(consumer: ir.For, input_shapes,
                 stats: Dict[str, int]) -> Optional[ir.Expr]:
    """Fuse a multi-iter consumer with its (aligned) producers."""
    if len(consumer.iters) < 1:
        return None
    infos = [_classify_producer(it) for it in consumer.iters]
    if any(i is None for i in infos):
        return None
    kinds = {i[0] for i in infos}
    if kinds == {"raw"}:
        return None  # nothing to fuse
    cb, ci, cx = consumer.func.params
    uses_index = _uses(consumer.func.body, ci.name)
    if "filter" in kinds:
        # every stream must be an identically-conditioned filter
        if kinds != {"filter"} or uses_index:
            return None
        keys = {_normalized_cond_key(i[3], i[2]) for i in infos}
        if len(keys) != 1:
            return None
    # all underlying sources must have statically equal lengths (or the
    # consumer has a single producer, where alignment is intrinsic)
    all_src_iters: List[ir.Iter] = []
    for kind, it, loop, cond, val in infos:
        all_src_iters.extend(loop.iters if loop is not None else [it])
    lens = {_static_len(i, input_shapes) for i in all_src_iters}
    if len(infos) > 1 or len(all_src_iters) > 1:
        if None in lens or len(lens) != 1:
            return None

    # union of source iters
    union: List[ir.Iter] = []
    union_keys: List[str] = []

    def upos(it: ir.Iter) -> int:
        key = ir.canon_key(it)
        if key in union_keys:
            return union_keys.index(key)
        union_keys.append(key)
        union.append(it)
        return len(union) - 1

    elem_tys: List[wt.WeldType] = []

    def _ety(it: ir.Iter):
        t = ir.typeof(it.data)
        return t.elem

    # rewritten per-stream value + (single) condition on the union elem
    fx_tys: List[wt.WeldType] = []
    vals: List[ir.Expr] = []
    cond_u: Optional[ir.Expr] = None
    fi = ir.Ident(ir.fresh("i"), wt.I64)

    # placeholder for the union elem (typed after union is complete)
    fx_name = ir.fresh("x")

    def rewrite_stream(expr: ir.Expr, loop: Optional[ir.For],
                       it: ir.Iter) -> ir.Expr:
        if loop is None:  # raw stream: value is the element itself
            p = upos(it)
            return ir.GetField(ir.Ident(fx_name, None), p)
        px = loop.func.params[2]
        pi = loop.func.params[1]
        positions = [upos(i) for i in loop.iters]

        def rec(x: ir.Expr) -> ir.Expr:
            if isinstance(x, ir.GetField) and isinstance(x.expr, ir.Ident) \
                    and x.expr.name == px.name:
                return ir.GetField(ir.Ident(fx_name, None),
                                   positions[x.index])
            if isinstance(x, ir.Ident) and x.name == px.name:
                return ir.GetField(ir.Ident(fx_name, None), positions[0])
            if isinstance(x, ir.Ident) and x.name == pi.name:
                return fi
            return x.map_children(rec)

        return rec(ir.rename_binders(ir.Lambda((), expr)).body)

    for kind, it, loop, cond, val in infos:
        if kind == "raw":
            vals.append(rewrite_stream(None, None, it))
        else:
            vals.append(rewrite_stream(val, loop, it))
            if kind == "filter" and cond_u is None:
                cond_u = rewrite_stream(cond, loop, it)

    if len(union) < 1:
        return None
    if len(union) == 1:
        # single-source union: the loop elem IS the element (no struct)
        union_elem = _ety(union[0])

        def strip(x: ir.Expr) -> ir.Expr:
            if isinstance(x, ir.GetField) and isinstance(x.expr, ir.Ident) \
                    and x.expr.name == fx_name:
                return ir.Ident(fx_name, union_elem)
            return x.map_children(strip)

        vals = [strip(v) for v in vals]
        cond_u = strip(cond_u) if cond_u is not None else None
    else:
        union_elem = wt.Struct(tuple(_ety(i) for i in union))
    fx = ir.Ident(fx_name, union_elem)

    nb = ir.Ident(ir.fresh("b"),
                  ir.typeof(consumer.builder, _builder_env(consumer)))
    celem = vals[0] if len(vals) == 1 else ir.MakeStruct(tuple(vals))
    cbody = ir.rename_binders(ir.Lambda((cb, ci, cx), consumer.func.body))
    cb2, ci2, cx2 = cbody.params
    sub = {cb2.name: nb, cx2.name: celem,
           ci2.name: fi if not uses_index else fi}
    new_body = ir.substitute(cbody.body, sub)
    if cond_u is not None:
        new_body = ir.If(cond_u, new_body, nb)

    # retype the placeholder element refs now that union_elem is known
    def retype(x: ir.Expr) -> ir.Expr:
        if isinstance(x, ir.Ident) and x.name == fx_name:
            return fx
        return x.map_children(retype)

    new_body = retype(new_body)
    stats["fusion.zip"] = stats.get("fusion.zip", 0) + 1
    return ir.For(
        tuple(union),
        consumer.builder,
        ir.Lambda((nb, fi, fx), new_body),
    )


# ---------------------------------------------------------------------------
# Horizontal fusion
# ---------------------------------------------------------------------------


def _same_iters(a: Tuple[ir.Iter, ...], b: Tuple[ir.Iter, ...]) -> bool:
    if len(a) != len(b):
        return False
    return all(ir.canon_key(x) == ir.canon_key(y) for x, y in zip(a, b))


def _fusable_loop(e: ir.Expr) -> Optional[ir.For]:
    """Result(For(..., NewBuilder-or-MakeStruct(NewBuilders), f))"""
    if not isinstance(e, ir.Result):
        return None
    loop = e.builder
    if not isinstance(loop, ir.For):
        return None
    b = loop.builder
    if isinstance(b, ir.NewBuilder):
        return loop
    if isinstance(b, ir.MakeStruct) and all(
        isinstance(i, ir.NewBuilder) for i in b.items
    ):
        return loop
    return None


def _builder_parts(loop: ir.For) -> List[ir.NewBuilder]:
    b = loop.builder
    return list(b.items) if isinstance(b, ir.MakeStruct) else [b]


def _static_len(it: ir.Iter, input_shapes) -> Optional[int]:
    """Statically-known iteration length, if resolvable."""
    if not it.is_plain:
        return None
    d = it.data
    if isinstance(d, ir.Ident) and input_shapes and d.name in input_shapes:
        shp = input_shapes[d.name]
        return int(shp[0]) if len(shp) >= 1 else None
    if isinstance(d, ir.MakeVec):
        return len(d.items)
    return None


def _loops_compatible(a: ir.For, b: ir.For, input_shapes) -> bool:
    """Same iteration space: identical iters, or all iters of both loops
    have statically-equal lengths (sound union fusion)."""
    if _same_iters(a.iters, b.iters):
        return True
    lens = [_static_len(it, input_shapes) for it in a.iters + b.iters]
    return all(l is not None for l in lens) and len(set(lens)) == 1


def try_horizontal_fuse(
    loops: List[Tuple[str, ir.For]],
) -> Optional[Tuple[ir.For, List[Tuple[str, int, int]]]]:
    """Fuse Result(For)s over a compatible iteration space.  `loops` is a
    list of (bound_name, loop).  The fused loop iterates the UNION of the
    input loops' iter sources (deduplicated structurally); each body's
    element accesses are remapped into the union struct.  Returns the
    fused loop and, per input, (name, field_offset, width) to rebuild its
    result."""
    if len(loops) < 2:
        return None

    # union of iter sources (dedup by structure)
    union: List[ir.Iter] = []
    union_keys: List[str] = []
    pos_of: List[List[int]] = []  # per loop: union position per its iter
    for _, loop in loops:
        positions = []
        for it in loop.iters:
            key = ir.canon_key(it)
            if key in union_keys:
                positions.append(union_keys.index(key))
            else:
                union_keys.append(key)
                union.append(it)
                positions.append(len(union) - 1)
        pos_of.append(positions)

    all_builders: List[ir.NewBuilder] = []
    layout: List[Tuple[str, int, int]] = []
    for name, loop in loops:
        parts = _builder_parts(loop)
        layout.append((name, len(all_builders), len(parts)))
        all_builders.extend(parts)

    elem_tys = []
    for it in union:
        try:
            t = ir.typeof(it.data)
        except Exception:
            return None
        if not isinstance(t, wt.Vec):
            return None
        elem_tys.append(t.elem)
    union_elem_ty = (
        elem_tys[0] if len(union) == 1 else wt.Struct(tuple(elem_tys))
    )

    fused_bt = wt.StructBuilder(tuple(nb.ty for nb in all_builders))
    fb = ir.Ident(ir.fresh("b"), fused_bt)
    fi = ir.Ident(ir.fresh("i"), wt.I64)
    fx = ir.Ident(ir.fresh("x"), union_elem_ty)

    def elem_for(positions: List[int]) -> ir.Expr:
        def field(p: int) -> ir.Expr:
            return fx if len(union) == 1 else ir.GetField(fx, p)

        if len(positions) == 1:
            return field(positions[0])
        return ir.MakeStruct(tuple(field(p) for p in positions))

    # Chain the bodies: each consumes its slice of the struct and produces
    # the full updated struct; thread the struct through a let-chain.
    cur: ir.Expr = fb
    bindings: List[Tuple[str, ir.Expr]] = []
    for (name, loop), (_, off, width), positions in zip(loops, layout,
                                                        pos_of):
        f = ir.rename_binders(loop.func)
        b_p, i_p, x_p = f.params
        body = ir.substitute(
            f.body, {i_p.name: fi, x_p.name: elem_for(positions)})
        body = _retarget_into_struct(body, b_p.name, cur, off, width,
                                     len(all_builders))
        nxt = ir.Ident(ir.fresh("bs"), fused_bt)
        bindings.append((nxt.name, body))
        cur = nxt
    fused_body: ir.Expr = cur
    for bname, bval in reversed(bindings):
        fused_body = ir.Let(bname, bval, fused_body)

    fused = ir.For(
        tuple(union),
        ir.MakeStruct(tuple(all_builders)),
        ir.Lambda((fb, fi, fx), fused_body),
    )
    return fused, layout


def _retarget_into_struct(body: ir.Expr, bname: str, struct_expr: ir.Expr,
                          off: int, width: int, total: int) -> ir.Expr:
    """Make `body` (which returns this loop's builder, possibly a struct of
    `width` builders) return the FULL struct of `total` builders instead."""
    # First rewrite builder references to components of struct_expr.
    # Bind struct_expr once to keep linearity.
    s_in = ir.Ident(ir.fresh("sin"), _struct_ty(struct_expr, total))

    def sub_refs(x: ir.Expr) -> ir.Expr:
        if isinstance(x, ir.Ident) and x.name == bname:
            if width == 1:
                return ir.GetField(s_in, off)
            return ir.MakeStruct(
                tuple(ir.GetField(s_in, off + k) for k in range(width))
            )
        if isinstance(x, ir.GetField) and isinstance(x.expr, ir.Ident) \
                and x.expr.name == bname:
            return ir.GetField(s_in, off + x.index)
        if isinstance(x, ir.Lambda):
            if any(p.name == bname for p in x.params):
                return x
            return ir.Lambda(x.params, sub_refs(x.body))
        if isinstance(x, ir.Let):
            return ir.Let(x.name, sub_refs(x.value), sub_refs(x.body))
        return x.map_children(sub_refs)

    new_body = sub_refs(body)
    # result of new_body: builder (width==1) or struct of width builders.
    out = ir.Ident(ir.fresh("out"), None)
    rebuilt_items: List[ir.Expr] = []
    for k in range(total):
        if off <= k < off + width:
            if width == 1:
                rebuilt_items.append(ir.Ident(out.name, None))
            else:
                rebuilt_items.append(ir.GetField(ir.Ident(out.name, None), k - off))
        else:
            rebuilt_items.append(ir.GetField(s_in, k))
    rebuilt = ir.MakeStruct(tuple(rebuilt_items))
    return ir.Let(
        s_in.name, struct_expr, ir.Let(out.name, new_body, rebuilt)
    )


def _struct_ty(e: ir.Expr, total: int):
    try:
        return ir.typeof(e)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _propagate_lengths(e: ir.Expr, input_shapes) -> Dict[str, tuple]:
    """Extend input shapes with lengths of let-bound map-like loop results
    (a mask column has its source's length, etc.)."""
    known = dict(input_shapes or {})
    cur = e
    while isinstance(cur, ir.Let):
        v = cur.value
        loop = _fusable_loop(v) if isinstance(v, ir.Result) else None
        if loop is not None and isinstance(loop.builder, ir.NewBuilder) \
                and isinstance(loop.builder.ty, wt.VecBuilder):
            pb = loop.func.params[0]
            if _merges_unconditionally_once(loop.func.body, pb.name):
                lens = {_static_len(it, known) for it in loop.iters}
                if None not in lens and len(lens) == 1:
                    known[cur.name] = (lens.pop(),)
        cur = cur.body
    return known


def fuse_loops(e: ir.Expr, stats: Dict[str, int],
               input_shapes=None) -> ir.Expr:
    known = _propagate_lengths(e, input_shapes)
    e = _vertical(e, stats, known)
    e = _horizontal(e, stats, known)
    return e


def _vertical(e: ir.Expr, stats: Dict[str, int],
              input_shapes=None) -> ir.Expr:
    def rec(x: ir.Expr) -> ir.Expr:
        x = x.map_children(rec)
        if isinstance(x, ir.For):
            fused = try_vertical_fuse(x, stats)
            if fused is not None:
                return rec(fused)
            fused = try_zip_fuse(x, input_shapes, stats)
            if fused is not None:
                return rec(fused)
        if isinstance(x, ir.Len):
            # len(result(for(V, vb, map-like))) == len(V)
            inner = x.expr
            if isinstance(inner, ir.Result) and isinstance(inner.builder, ir.For):
                loop = inner.builder
                if isinstance(loop.builder, ir.NewBuilder) and isinstance(
                    loop.builder.ty, wt.VecBuilder
                ):
                    pb = loop.func.params[0]
                    if _merges_unconditionally_once(loop.func.body, pb.name):
                        stats["fusion.len"] = stats.get("fusion.len", 0) + 1
                        return _iter_len(loop.iters[0])
        return x

    return rec(e)


def _iter_len(it: ir.Iter) -> ir.Expr:
    if it.is_plain:
        return ir.Len(it.data)
    start = it.start or ir.Literal(0, wt.I64)
    end = it.end or ir.Len(it.data)
    stride = it.stride or ir.Literal(1, wt.I64)
    span = ir.BinOp("-", end, start)
    # ceil-div
    num = ir.BinOp("+", span, ir.BinOp("-", stride, ir.Literal(1, wt.I64)))
    return ir.BinOp("/", num, stride)


def _horizontal(e: ir.Expr, stats: Dict[str, int],
                input_shapes=None) -> ir.Expr:
    """Find runs of let-bound fusable loops over compatible iteration
    spaces and combine them (classic shape after DAG stitching: one let
    per library operator)."""

    def rec(x: ir.Expr) -> ir.Expr:
        x = x.map_children(rec)
        if not isinstance(x, ir.Let):
            return x
        # collect a maximal run of let-bound fusable loops
        run: List[Tuple[str, ir.For]] = []
        cursor: ir.Expr = x
        while isinstance(cursor, ir.Let):
            loop = _fusable_loop(cursor.value)
            if loop is None:
                break
            # later loops must not depend on earlier results in the run
            if any(_uses(cursor.value, nm) for nm, _ in run):
                break
            run.append((cursor.name, loop))
            cursor = cursor.body
        if len(run) < 2:
            return x
        # group by iteration-space compatibility, preserving order
        groups: List[List[Tuple[str, ir.For]]] = []
        for name, loop in run:
            placed = False
            for g in groups:
                if _loops_compatible(g[0][1], loop, input_shapes):
                    g.append((name, loop))
                    placed = True
                    break
            if not placed:
                groups.append([(name, loop)])
        if all(len(g) < 2 for g in groups):
            return x
        body = cursor
        # rebuild: fused groups first, then leftover singles (order-safe:
        # loops in the run are mutually independent)
        for g in groups:
            if len(g) >= 2:
                fused = try_horizontal_fuse(g)
                if fused is None:
                    continue
                floop, layout = fused
                stats["fusion.horizontal"] = stats.get(
                    "fusion.horizontal", 0
                ) + (len(g) - 1)
                tmp = ir.fresh("hf")
                tmp_ty = ir.typeof(floop).result_type()
                inner = body
                for name, off, width in reversed(layout):
                    if width == 1:
                        val: ir.Expr = ir.GetField(
                            ir.Ident(tmp, tmp_ty), off
                        )
                    else:
                        val = ir.MakeStruct(
                            tuple(
                                ir.GetField(ir.Ident(tmp, tmp_ty), off + k)
                                for k in range(width)
                            )
                        )
                    inner = ir.Let(name, val, inner)
                body = ir.Let(tmp, ir.Result(floop), inner)
            else:
                name, loop = g[0]
                body = ir.Let(name, ir.Result(loop), body)
        return body

    return rec(e)
