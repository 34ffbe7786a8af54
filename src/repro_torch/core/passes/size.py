"""Size analysis (paper Table 3): infer output vector sizes statically.

Map-like loops (exactly one unconditional merge per iteration) produce
exactly `len(iter)` elements; their vecbuilders get a `size_hint`, letting
the backend preallocate dense storage (and, on TPU, lower to whole-array
ops with no append machinery at all).
"""
from __future__ import annotations

from typing import Dict

from .. import ir
from .. import wtypes as wt
from .fusion import _merges_unconditionally_once, _iter_len


def size_analysis(e: ir.Expr, stats: Dict[str, int]) -> ir.Expr:
    def rec(x: ir.Expr) -> ir.Expr:
        x = x.map_children(rec)
        if not isinstance(x, ir.For):
            return x
        nb = x.builder
        if not (
            isinstance(nb, ir.NewBuilder)
            and isinstance(nb.ty, wt.VecBuilder)
            and nb.size_hint is None
        ):
            return x
        pb = x.func.params[0]
        if not _merges_unconditionally_once(x.func.body, pb.name):
            return x
        hint = _iter_len(x.iters[0])
        # hints are metadata (preallocation / memory-limit estimation): a
        # hint must be cheap — never duplicate a loop into it
        if any(isinstance(n, ir.For) for n in ir.walk(hint)):
            return x
        stats["size.hints"] = stats.get("size.hints", 0) + 1
        return ir.For(
            x.iters,
            ir.NewBuilder(nb.ty, arg=nb.arg, size_hint=hint),
            x.func,
        )

    return rec(e)
