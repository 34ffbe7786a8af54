"""Loop tiling (paper Table 3), adapted for TPU.

On x86 the paper blocks nested loops so a tile of the inner data stays in
cache.  On TPU the equivalent is to (a) *raise* recognized dot-shaped
nested loops onto the MXU (a matmul feeds the systolic array from VMEM in
hardware-managed tiles), and (b) tile explicitly in the Pallas kernels via
BlockSpec, where the kernel author controls VMEM residency.

This pass performs (a): it recognizes

    for(M : vec[vec[T]], vecbuilder,
        (b,i,row) => merge(b, result(for([row, w], merger[+],
                                         (b2,_,xy) => merge(b2, x*y)))))

— the shape Listing 4's ``itertools.map(vecs, v -> numpy.dot(v, x))``
reaches after vertical fusion — and raises it to an internal ``matvec``
node.  The backend lowers raised nodes to ``jnp.dot`` (MXU) or the Pallas
``tiled_matmul`` kernel; without this pass they run as per-row VPU
reductions (the un-tiled form), which benchmarks show is several times
slower for large widths.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .. import ir
from .. import wtypes as wt


def _match_dot(e: ir.Expr) -> Optional[Tuple[ir.Expr, ir.Expr, wt.Scalar]]:
    """Match result(for([a, b], merger[+], (bb,i,xy) => merge(bb, x*y)))."""
    if not isinstance(e, ir.Result):
        return None
    loop = e.builder
    if not isinstance(loop, ir.For) or len(loop.iters) != 2:
        return None
    if not all(it.is_plain for it in loop.iters):
        return None
    nb = loop.builder
    if not (
        isinstance(nb, ir.NewBuilder)
        and isinstance(nb.ty, wt.Merger)
        and nb.ty.op == "+"
        and nb.arg is None
    ):
        return None
    bb, ii, xy = loop.func.params
    body = loop.func.body
    if not (isinstance(body, ir.Merge) and isinstance(body.builder, ir.Ident)
            and body.builder.name == bb.name):
        return None
    v = body.value
    if not (isinstance(v, ir.BinOp) and v.op == "*"):
        return None
    def _is_field(x, k):
        return (
            isinstance(x, ir.GetField)
            and x.index == k
            and isinstance(x.expr, ir.Ident)
            and x.expr.name == xy.name
        )
    if not (
        (_is_field(v.left, 0) and _is_field(v.right, 1))
        or (_is_field(v.left, 1) and _is_field(v.right, 0))
    ):
        return None
    elem = nb.ty.elem
    if not isinstance(elem, wt.Scalar):
        return None
    return loop.iters[0].data, loop.iters[1].data, elem


def raise_tiled_ops(e: ir.Expr, stats: Dict[str, int]) -> ir.Expr:
    def rec(x: ir.Expr) -> ir.Expr:
        x = x.map_children(rec)
        # vec . vec  ->  dot   (whole Result(For) replaced by a value node)
        m = _match_dot(x)
        if m is not None:
            a, b, elem = m
            stats["tiling.dot"] = stats.get("tiling.dot", 0) + 1
            return ir.CUDF("linalg.dot", (a, b), elem)
        # row-wise dot over a matrix -> matvec (the tiled/MXU form)
        if isinstance(x, ir.Result) and isinstance(x.builder, ir.For):
            mv = _match_matvec(x.builder)
            if mv is not None:
                mat, vec, elem = mv
                stats["tiling.matvec"] = stats.get("tiling.matvec", 0) + 1
                return _matvec(mat, vec, elem)
        return x

    return rec(e)


def _match_matvec(loop: ir.For) -> Optional[Tuple[ir.Expr, ir.Expr, wt.WeldType]]:
    if len(loop.iters) != 1 or not loop.iters[0].is_plain:
        return None
    nb = loop.builder
    if not (isinstance(nb, ir.NewBuilder) and isinstance(nb.ty, wt.VecBuilder)):
        return None
    pb, pi, row = loop.func.params
    body = loop.func.body
    if not (
        isinstance(body, ir.Merge)
        and isinstance(body.builder, ir.Ident)
        and body.builder.name == pb.name
    ):
        return None
    val = body.value
    if not (isinstance(val, ir.CUDF) and val.name == "linalg.dot"):
        return None
    a, b = val.args
    if not (isinstance(a, ir.Ident) and a.name == row.name):
        a, b = b, a
    if not (isinstance(a, ir.Ident) and a.name == row.name):
        return None
    if any(isinstance(n, ir.Ident) and n.name == row.name for n in ir.walk(b)):
        return None
    mat = loop.iters[0].data
    try:
        mt = ir.typeof(mat)
    except Exception:
        return None
    if isinstance(mt, wt.Vec) and isinstance(mt.elem, wt.Vec):
        return mat, b, val.ret_ty
    return None


def _matvec(mat: ir.Expr, vec: ir.Expr, elem: wt.WeldType) -> ir.Expr:
    return ir.CUDF("linalg.matvec", (mat, vec), wt.Vec(elem))
