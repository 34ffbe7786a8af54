"""Pretty-printer for Weld IR (debugging / test goldens / diagnostics).

Every node has a **stable anchor** — ``#n<k>`` where ``k`` is the node's
preorder position in the tree — so a diagnostic can name the exact
subexpression it is about instead of dumping the whole program:

* ``pretty(e, anchors=True)`` prefixes structural nodes (lets, loops,
  builders, merges, kernel calls, ...) with their anchor;
* ``pretty(e, highlight=node)`` wraps that one subexpression (matched by
  identity) in ``>>> ... <<<`` markers;
* ``anchor_of(root, node)`` returns the anchor string for any node.

With neither argument the output is byte-identical to the historical
format (tests keep their goldens).
"""
from __future__ import annotations

from typing import Optional

from . import ir

#: KernelCall params shown beside the kernel's name: the reference's tile
#: shapes and the port's grid cap
TUNED_PARAMS = ("block", "bm", "bn", "bk", "max_blocks")

#: node kinds that carry a visible anchor under ``anchors=True`` — the
#: "statement-shaped" nodes a diagnostic is most likely to point at.
_ANCHORED = None  # initialised lazily to avoid import-order issues


def _anchored_types():
    global _ANCHORED
    if _ANCHORED is None:
        _ANCHORED = (
            ir.Let, ir.For, ir.NewBuilder, ir.Merge, ir.Result,
            ir.KernelCall, ir.If, ir.Select, ir.Lookup, ir.GroupLookup,
            ir.KeyExists, ir.CUDF,
        )
    return _ANCHORED


def _number(root: "ir.Expr") -> dict:
    """id(node) -> preorder index (first occurrence wins, so anchors are
    stable across prints even when hash-consed subtrees are shared)."""
    idx: dict = {}
    for i, n in enumerate(ir.walk(root)):
        idx.setdefault(id(n), i)
    return idx


def anchor_of(root: "ir.Expr", node: "ir.Expr") -> Optional[str]:
    """Stable anchor (``#n17``) of ``node`` within ``root``, or None."""
    if node is None:
        return None
    i = _number(root).get(id(node))
    return None if i is None else f"#n{i}"


def short(e: "ir.Expr", limit: int = 120) -> str:
    """One-line pretty form, truncated — for error messages."""
    s = " ".join(pretty(e).split())
    return s if len(s) <= limit else s[: limit - 3] + "..."


def pretty(
    e: "ir.Expr",
    indent: int = 0,
    anchors: bool = False,
    highlight: Optional["ir.Expr"] = None,
) -> str:
    idx = _number(e) if (anchors or highlight is not None) else None
    hi_id = id(highlight) if highlight is not None else None

    def deco(x, s: str) -> str:
        if idx is not None and anchors and isinstance(x, _anchored_types()):
            i = idx.get(id(x))
            if i is not None:
                s = f"#n{i}:{s}"
        if hi_id is not None and id(x) == hi_id:
            s = f">>> {s} <<<"
        return s

    def go(x, ind: int) -> str:
        pad = "  " * ind

        def p(y):
            return go(y, ind)

        if isinstance(x, ir.Literal):
            out = f"{x.value}{'' if x.ty.kind in ('i64',) else ':' + x.ty.kind}"
        elif isinstance(x, ir.Ident):
            out = x.name
        elif isinstance(x, ir.Let):
            out = f"(let {x.name} = {p(x.value)};\n{pad} {go(x.body, ind)})"
        elif isinstance(x, ir.BinOp):
            out = f"({p(x.left)} {x.op} {p(x.right)})"
        elif isinstance(x, ir.UnaryOp):
            out = f"{x.op}({p(x.expr)})"
        elif isinstance(x, ir.Cast):
            out = f"{x.ty}({p(x.expr)})"
        elif isinstance(x, ir.If):
            out = f"if({p(x.cond)}, {p(x.on_true)}, {p(x.on_false)})"
        elif isinstance(x, ir.Select):
            out = f"select({p(x.cond)}, {p(x.on_true)}, {p(x.on_false)})"
        elif isinstance(x, ir.MakeStruct):
            out = "{" + ", ".join(p(i) for i in x.items) + "}"
        elif isinstance(x, ir.GetField):
            out = f"{p(x.expr)}.${x.index}"
        elif isinstance(x, ir.MakeVec):
            out = "[" + ", ".join(p(i) for i in x.items) + "]"
        elif isinstance(x, ir.Len):
            out = f"len({p(x.expr)})"
        elif isinstance(x, ir.Lookup):
            if x.default is not None:
                out = f"lookup({p(x.expr)}, {p(x.index)}, {p(x.default)})"
            else:
                out = f"lookup({p(x.expr)}, {p(x.index)})"
        elif isinstance(x, ir.KeyExists):
            out = f"keyexists({p(x.expr)}, {p(x.key)})"
        elif isinstance(x, ir.GroupLookup):
            out = f"grouplookup({p(x.expr)}, {p(x.key)})"
        elif isinstance(x, ir.CUDF):
            out = f"cudf[{x.name}](" + ", ".join(p(a) for a in x.args) + ")"
        elif isinstance(x, ir.KernelCall):
            # tuned launch parameters surface next to the kernel name so a
            # plan dump shows what the autotuner chose per call (the
            # port's is the grid cap, max_blocks)
            blocks = [(k, v) for k, v in x.params if k in TUNED_PARAMS]
            rest = [(k, v) for k, v in x.params if k not in TUNED_PARAMS]
            tag = f"kernel[{x.kernel}]"
            if blocks:
                tag += "@{" + ",".join(f"{k}={v}" for k, v in blocks) + "}"
            parts = [p(a) for a in x.args]
            parts += [f"{k}={v}" for k, v in rest]
            parts += [p(f) for f in x.fns]
            out = tag + "(" + ", ".join(parts) + ")"
        elif isinstance(x, ir.Lambda):
            params = ",".join(f"{q.name}:{q.ty}" for q in x.params)
            out = f"|{params}| {go(x.body, ind + 1)}"
        elif isinstance(x, ir.NewBuilder):
            arg = f"({p(x.arg)})" if x.arg is not None else ""
            hint = f"@size={p(x.size_hint)}" if x.size_hint is not None else ""
            out = f"{x.ty}{arg}{hint}"
        elif isinstance(x, ir.Merge):
            out = f"merge({p(x.builder)}, {p(x.value)})"
        elif isinstance(x, ir.Result):
            out = f"result({p(x.builder)})"
        elif isinstance(x, ir.Iter):
            if x.is_plain:
                out = p(x.data)
            else:
                parts = [p(x.data)]
                for y in (x.start, x.end, x.stride):
                    parts.append(p(y) if y is not None else "_")
                out = f"iter({', '.join(parts)})"
        elif isinstance(x, ir.For):
            its = ", ".join(p(i) for i in x.iters)
            out = (
                f"for([{its}],\n{pad}    {go(x.builder, ind + 1)},"
                f"\n{pad}    {go(x.func, ind + 1)})"
            )
        else:
            out = f"<{type(x).__name__}>"
        return deco(x, out)

    return go(e, indent)
