"""Analysis 4: capacity / poison soundness.

Dict and group builders carry static capacity literals; the runtime's
poison convention (negative counts on overflow) plus the recovery
ladder's geometric regrow depend on those literals being well-formed and
mutually consistent:

* **WV401** — a dict/group ``NewBuilder`` capacity literal must be a
  positive integer: zero/negative capacities poison unconditionally and
  regrowing them (``cap * factor``) is not monotone.
* **WV402** — a ``KernelCall``'s capacity-like params (``capacity``,
  ``k``, ``out_cap``) must be positive, and a probe call's segment width
  must agree with the static capacity of the let-bound dict it probes —
  a shrunk build capacity with a stale probe plan scans the wrong tile.
* **WV403** — a vecbuilder ``size_hint`` must not be negative and must
  not duplicate a loop (hints are metadata; the backend may evaluate
  them for preallocation).
* **WV404** — differential: a capacity rewrite (recovery's
  ``regrow_capacities``) must be monotone — every capacity in the new
  program ≥ its counterpart in the old one (checked by
  :func:`check_regrow_monotone`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .. import ir
from .. import wtypes as wt
from . import facts as F
from .diagnostics import Diagnostic

#: kernels whose first arg is a probed dict and whose segment width must
#: match that dict's build capacity
_PROBE_KERNELS = ("hash_probe", "group_probe")
#: kernels that build a dict and carry its capacity as a param
_BUILD_KERNELS = ("dict_hash_build", "group_build", "dict_group_sum")


def lint_capacity(
    e: ir.Expr,
    types: Dict[int, Optional[wt.WeldType]],
    facts: Optional[F.Facts] = None,
) -> List[Diagnostic]:
    if facts is None:
        facts = F.scan(e)
    diags: List[Diagnostic] = []
    #: let-bound name -> static capacity of the dict it holds
    dict_caps: Dict[str, int] = {}
    for ev in facts.events:
        kind = ev[0]
        if kind == F.LET:
            cap = _static_dict_cap(ev[1].value)
            if cap is not None:
                dict_caps[ev[1].name] = cap
        elif kind == F.NB:
            _lint_newbuilder(ev[1], diags)
        elif kind == F.KC:
            _lint_kernelcall(ev[1], dict_caps, diags)
    return diags


def _static_dict_cap(v: ir.Expr) -> Optional[int]:
    """Static capacity of a let-bound dict value (kernelized or not) —
    mirrors the planner's ``_dict_cap_of``."""
    if isinstance(v, ir.KernelCall) and v.kernel in _BUILD_KERNELS:
        cap = dict(v.params).get("capacity")
        return int(cap) if cap is not None else None
    if isinstance(v, ir.Result) and isinstance(v.builder, ir.For):
        nb = v.builder.builder
        if isinstance(nb, ir.NewBuilder) \
                and isinstance(nb.ty, (wt.DictMerger, wt.GroupBuilder)) \
                and isinstance(nb.arg, ir.Literal):
            return int(nb.arg.value)
    return None


def _lint_newbuilder(nb: ir.NewBuilder, diags: List[Diagnostic]) -> None:
    if isinstance(nb.ty, (wt.DictMerger, wt.GroupBuilder)) \
            and isinstance(nb.arg, ir.Literal):
        v = nb.arg.value
        ok_kind = isinstance(nb.arg.ty, wt.Scalar) and nb.arg.ty.is_int
        if not ok_kind or not isinstance(v, (int,)) or v <= 0:
            diags.append(Diagnostic(
                "WV401",
                f"dict/group capacity must be a positive int literal, "
                f"got {v!r}:{nb.arg.ty}",
                nb, analysis="capacity", data={"capacity": v}))
    if nb.size_hint is not None:
        if isinstance(nb.size_hint, ir.Literal) \
                and isinstance(nb.size_hint.value, int) \
                and nb.size_hint.value < 0:
            diags.append(Diagnostic(
                "WV403",
                f"negative size hint {nb.size_hint.value}",
                nb, analysis="capacity",
                data={"hint": nb.size_hint.value}))
        elif any(isinstance(n, ir.For) for n in ir.walk(nb.size_hint)):
            diags.append(Diagnostic(
                "WV403",
                "size hint duplicates a loop — hints must be cheap "
                "metadata, never recomputation",
                nb, analysis="capacity"))


def _lint_kernelcall(kc: ir.KernelCall, dict_caps: Dict[str, int],
                     diags: List[Diagnostic]) -> None:
    params = dict(kc.params)
    for key in ("capacity", "k", "out_cap"):
        v = params.get(key)
        if v is None:
            continue
        # out_cap is an *output* size bound: 0 is legal (empty probe side)
        floor = 0 if key == "out_cap" else 1
        if not isinstance(v, int) or v < floor:
            diags.append(Diagnostic(
                "WV402",
                f"kernel {kc.kernel!r} param {key}={v!r} must be an int "
                f">= {floor}",
                kc, analysis="capacity", data={key: v}))
    if kc.kernel in _PROBE_KERNELS and kc.args:
        d = kc.args[0]
        seg = params.get("k", params.get("capacity"))
        if isinstance(d, ir.Ident) and d.name in dict_caps \
                and isinstance(seg, int):
            built = dict_caps[d.name]
            if seg != built:
                diags.append(Diagnostic(
                    "WV402",
                    f"probe kernel {kc.kernel!r} scans segment width "
                    f"{seg} but dict {d.name} was built with capacity "
                    f"{built}",
                    kc, analysis="capacity",
                    data={"segment": seg, "built": built}))


def check_regrow_monotone(
    before: ir.Expr, after: ir.Expr,
) -> List[Diagnostic]:
    """WV404: every dict/group capacity literal in ``after`` must
    dominate its positional counterpart in ``before`` — the recovery
    regrow rewrite preserves structure, so capacities align by preorder
    position."""

    def caps(e: ir.Expr):
        out = []
        for n in ir.walk(e):
            if isinstance(n, ir.NewBuilder) \
                    and isinstance(n.ty, (wt.DictMerger, wt.GroupBuilder)) \
                    and isinstance(n.arg, ir.Literal):
                out.append((n, n.arg.value))
        return out

    b, a = caps(before), caps(after)
    diags: List[Diagnostic] = []
    if len(b) != len(a):
        diags.append(Diagnostic(
            "WV404",
            f"capacity rewrite changed builder count "
            f"({len(b)} -> {len(a)})",
            after, analysis="capacity"))
        return diags
    for (_, old), (node, new) in zip(b, a):
        if new < old:
            diags.append(Diagnostic(
                "WV404",
                f"capacity rewrite shrank a capacity ({old} -> {new}); "
                f"regrow must be monotone",
                node, analysis="capacity",
                data={"old": old, "new": new}))
    return diags
