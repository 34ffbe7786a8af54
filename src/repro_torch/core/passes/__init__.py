"""Weld optimizer (paper §5, Table 3).

Passes are pattern-matching rewrites over the AST, applied in the paper's
static order — loop fusion first, then size analysis, then loop tiling,
then vectorization/predication, finally CSE — with each level's rules
applied repeatedly until the AST no longer changes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .. import ir
from .inline import inline_lets
from .fusion import fuse_loops
from .size import size_analysis
from .tiling import raise_tiled_ops
from .predication import predicate
from .cse import cse

#: paper order (vectorization itself happens in the backend; predication is
#: its IR-level enabling transform).
DEFAULT_PASSES = (
    "inline",
    "fusion",
    "size",
    "tiling",
    "predication",
    "cse",
)

_PASS_FNS = {
    "inline": inline_lets,
    "fusion": fuse_loops,
    "size": size_analysis,
    "tiling": raise_tiled_ops,
    "predication": predicate,
    "cse": cse,
}

MAX_FIXPOINT_ITERS = 6


def optimize(
    e: ir.Expr,
    passes: Optional[Sequence[str]] = None,
    stats: Optional[Dict[str, int]] = None,
    input_shapes: Optional[Dict[str, tuple]] = None,
) -> ir.Expr:
    """Run the optimizer; `passes` selects/disables passes (for ablations).

    `input_shapes` (name -> shape), when available, lets horizontal
    fusion soundly merge loops over *different equal-length* vectors
    (the paper's single-pass dataframe traversal)."""
    names = list(passes if passes is not None else DEFAULT_PASSES)
    stats = stats if stats is not None else {}
    from . import fusion as _fusion

    from .. import check, obs

    verifying = check.enabled()
    for it in range(MAX_FIXPOINT_ITERS):
        before = ir.canon_key(e)
        for name in names:
            with obs.span(f"pass.{name}", iteration=it):
                if name == "fusion":
                    e = _fusion.fuse_loops(e, stats,
                                           input_shapes=input_shapes)
                else:
                    e = _PASS_FNS[name](e, stats)
            if verifying:
                check.checkpoint(f"pass.{name}", e, stats=stats,
                                 shapes=input_shapes)
        stats["iterations"] = it + 1
        if ir.canon_key(e) == before:
            break
    return e


def loop_count(e: ir.Expr) -> int:
    """Number of For loops (== passes over data) — the fusion metric."""
    return ir.count_nodes(e, lambda n: isinstance(n, ir.For))
