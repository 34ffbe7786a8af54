"""WV5xx: bounds-analysis lints (the weldbound family).

Cross-checks every declared size (vecbuilder hint, group-probe
``out_cap``) against the interval the weldbound abstract interpreter
derives for it, and — when a ``memory_limit`` is supplied — the
whole-plan peak-memory certificate against that limit:

* **WV501** — a declared size below the derived *lower* bound: the
  buffer provably truncates (a size-analysis or planner bug);
* **WV502** — a declared size above the derived *upper* bound: the
  allocation provably wastes budget (and inflates the certificate);
* **WV503** — the certificate itself exceeds ``memory_limit``: the
  plan would be rejected at admission, so a cached executable carrying
  it is a contradiction.

Dict/group *capacities* are deliberately not compared here: a capacity
legitimately exceeds the derived key-count bound (group-by defaults a
generous table), and the runtime's regrow ladder owns undersized ones.
Both comparisons fire only when BOTH sides resolve (symbolic sizes
need ``shapes``); an unresolvable side is not a diagnostic.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .. import ir
from .. import wtypes as wt
from ..analysis import bounds as _bounds
from ..analysis import domain as _dom
from . import facts as F
from .diagnostics import Diagnostic


def lint_bounds(
    e: ir.Expr,
    types: Dict[int, wt.WeldType],
    shapes: Optional[dict] = None,
    memory_limit: Optional[int] = None,
    facts: Optional[F.Facts] = None,
) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if memory_limit is None and not _declares_a_size(
            facts if facts is not None else F.scan(e)):
        return diags  # nothing the analysis could contradict
    try:
        rep = _bounds.analyze(e)
    except Exception:
        return diags  # mutants may be arbitrarily broken: never crash
    shp = {k: tuple(v) for k, v in (shapes or {}).items() if v}
    for bb in rep.builders:
        if bb.role not in ("hint", "out_cap") or bb.declared is None:
            continue
        declared = _dom.evaluate(bb.declared, shp)
        if declared is None or declared == _dom.INF:
            continue
        declared = int(declared)
        lo = bb.rows.lo_val(shp)
        hi = bb.rows.hi_val(shp)
        if declared < lo:
            diags.append(Diagnostic(
                "WV501",
                f"{bb.kind} declares {bb.role}={declared} but the derived "
                f"lower bound is {lo} rows "
                f"(interval {bb.rows.render(rep.rename)}) — the buffer "
                f"provably truncates",
                bb.node, analysis="bounds",
                data={"declared": declared, "lo": lo}))
        elif hi != _dom.INF and declared > int(hi):
            diags.append(Diagnostic(
                "WV502",
                f"{bb.kind} declares {bb.role}={declared} but the derived "
                f"upper bound is {int(hi)} rows "
                f"(interval {bb.rows.render(rep.rename)}) — the allocation "
                f"provably wastes budget",
                bb.node, analysis="bounds",
                data={"declared": declared, "hi": int(hi)}))
    if memory_limit is not None:
        peak = rep.peak(shp)
        if peak > int(memory_limit):
            diags.append(Diagnostic(
                "WV503",
                f"peak-memory certificate {rep.certificate()} = {peak} "
                f"bytes exceeds memory_limit={int(memory_limit)} — the "
                f"plan contradicts its admission limit",
                e, analysis="bounds",
                data={"peak": peak, "limit": int(memory_limit)}))
    return diags


def _declares_a_size(facts: F.Facts) -> bool:
    """True when the program holds a site the analysis reports with a
    declared size: a hinted vecbuilder or a ``group_probe`` with an
    ``out_cap`` (without either, and without a ``memory_limit``, the
    lint has nothing to compare)."""
    for ev in facts.events:
        if ev[0] == F.NB:
            nb = ev[1]
            if type(nb.ty) is wt.VecBuilder and nb.size_hint is not None:
                return True
        elif ev[0] == F.KC and ev[1].kernel == "group_probe" \
                and dict(ev[1].params).get("out_cap") is not None:
            return True
    return False
