"""Weld intermediate representation (paper §3).

A small, functional, expression-oriented IR: arithmetic, let-bindings,
conditionals, collection lookups, external C-function calls, plus the two
parallel constructs — the `For` loop and builders.

Nodes are frozen dataclasses (hashable, structurally comparable) so the
optimizer can pattern-match and hash-cons subtrees.  All binders introduce
globally-unique names (see `fresh`), which keeps substitution capture-free.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, fields, replace
from typing import Callable, Dict, Optional, Tuple

from . import wtypes as wt
from .wtypes import WeldType, WeldTypeError


_counter = itertools.count()


def fresh(prefix: str = "t") -> str:
    """Globally-unique identifier name."""
    return f"{prefix}%{next(_counter)}"


#: field annotations that never hold an Expr or a tuple of them
_LEAF_FIELD_TYPES = frozenset({"str", "int", "WeldType", "wt.Scalar",
                               "wt.BuilderType"})
_child_fields: Dict[type, Tuple[str, ...]] = {}


def child_fields(cls: type) -> Tuple[str, ...]:
    """The names of the fields of ``cls`` that may hold an Expr or a tuple
    of them, in field order: computed once per class (``fields`` on every
    visit was most of a tree walk's time)."""
    names = _child_fields.get(cls)
    if names is None:
        names = _child_fields[cls] = tuple(
            f.name for f in fields(cls) if f.type not in _LEAF_FIELD_TYPES)
    return names


_field_names: Dict[type, Tuple[str, ...]] = {}


def field_names(cls: type) -> Tuple[str, ...]:
    """The names of all the fields of ``cls``, in field order (what
    ``dataclasses.fields`` gives, kept per class)."""
    names = _field_names.get(cls)
    if names is None:
        names = _field_names[cls] = tuple(f.name for f in fields(cls))
    return names


class Expr:
    """Base class for IR expressions."""

    def children(self) -> Tuple["Expr", ...]:
        # kept on the node once computed: nodes are frozen, so their
        # children never change (a rewrite builds a new node)
        kids = self.__dict__.get("_children")
        if kids is None:
            out = []
            for name in child_fields(type(self)):
                v = getattr(self, name)
                if isinstance(v, Expr):
                    out.append(v)
                elif isinstance(v, tuple):
                    out.extend(c for c in v if isinstance(c, Expr))
            kids = tuple(out)
            object.__setattr__(self, "_children", kids)
        return kids

    def map_children(self, fn: Callable[["Expr"], "Expr"]) -> "Expr":
        changes = {}
        for name in child_fields(type(self)):
            v = getattr(self, name)
            if isinstance(v, Expr):
                nv = fn(v)
                if nv is not v:
                    changes[name] = nv
            elif isinstance(v, tuple) and any(isinstance(c, Expr) for c in v):
                nv = tuple(fn(c) if isinstance(c, Expr) else c for c in v)
                if any(a is not b for a, b in zip(nv, v)):
                    changes[name] = nv
        return replace(self, **changes) if changes else self

    def __str__(self) -> str:
        from .pretty import pretty

        return pretty(self)


# ---------------------------------------------------------------------------
# Leaf / scalar expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Literal(Expr):
    value: object
    ty: wt.Scalar


@dataclass(frozen=True)
class Ident(Expr):
    name: str
    ty: WeldType


@dataclass(frozen=True)
class Let(Expr):
    name: str
    value: Expr
    body: Expr


BINOPS = {
    "+", "-", "*", "/", "%", "min", "max", "pow",
    "==", "!=", "<", "<=", ">", ">=", "&&", "||",
}
CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}

UNARYOPS = {
    "neg", "not", "exp", "log", "sqrt", "erf", "sin", "cos",
    "tanh", "abs", "sigmoid", "floor", "rsqrt",
}


@dataclass(frozen=True)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def __post_init__(self):
        if self.op not in BINOPS:
            raise WeldTypeError(f"unknown binop {self.op}")


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str
    expr: Expr

    def __post_init__(self):
        if self.op not in UNARYOPS:
            raise WeldTypeError(f"unknown unaryop {self.op}")


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    ty: wt.Scalar


@dataclass(frozen=True)
class If(Expr):
    """Control-flow conditional (may produce builders)."""

    cond: Expr
    on_true: Expr
    on_false: Expr


@dataclass(frozen=True)
class Select(Expr):
    """Data conditional: both sides evaluated (predication target)."""

    cond: Expr
    on_true: Expr
    on_false: Expr


# ---------------------------------------------------------------------------
# Structs, vectors, dictionaries
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MakeStruct(Expr):
    items: Tuple[Expr, ...]


@dataclass(frozen=True)
class GetField(Expr):
    expr: Expr
    index: int


@dataclass(frozen=True)
class MakeVec(Expr):
    items: Tuple[Expr, ...]
    elem_ty: WeldType


@dataclass(frozen=True)
class Len(Expr):
    expr: Expr


@dataclass(frozen=True)
class Lookup(Expr):
    """vec[i] or dict[k].

    Dict lookups may carry a miss ``default``: ``lookup(d, k, v)`` yields
    the stored value when ``k`` exists and ``v`` otherwise — the
    single-probe form of ``if(keyexists(d,k), lookup(d,k), v)`` that
    left joins lower through (one hash probe, no second pass)."""

    expr: Expr
    index: Expr
    default: Optional[Expr] = None


@dataclass(frozen=True)
class KeyExists(Expr):
    expr: Expr
    key: Expr


@dataclass(frozen=True)
class GroupLookup(Expr):
    """``grouplookup(d, k)``: the group vector for key ``k`` in a
    groupbuilder result (``dict[K, vec[V]]``).  A missing key yields the
    EMPTY vector — the single-pass probe form m:n hash joins iterate
    (a probe row with no build-side match simply expands to zero rows,
    no separate ``keyexists`` pass needed)."""

    expr: Expr
    key: Expr


@dataclass(frozen=True)
class CUDF(Expr):
    """Call to an external (C in the paper; host-registered here) function."""

    name: str
    args: Tuple[Expr, ...]
    ret_ty: WeldType


# ---------------------------------------------------------------------------
# Parallel constructs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Lambda(Expr):
    params: Tuple[Ident, ...]
    body: Expr


@dataclass(frozen=True)
class NewBuilder(Expr):
    ty: wt.BuilderType
    #: optional argument: merger initial value, vecmerger base vector,
    #: dictmerger/groupbuilder capacity literal.
    arg: Optional[Expr] = None
    #: filled by size analysis for vecbuilders with statically-known length.
    size_hint: Optional[Expr] = None


@dataclass(frozen=True)
class Merge(Expr):
    builder: Expr
    value: Expr


@dataclass(frozen=True)
class Result(Expr):
    builder: Expr


@dataclass(frozen=True)
class Iter(Expr):
    """Iteration descriptor: strided view over a vector."""

    data: Expr
    start: Optional[Expr] = None
    end: Optional[Expr] = None
    stride: Optional[Expr] = None

    @property
    def is_plain(self) -> bool:
        return self.start is None and self.end is None and self.stride is None


@dataclass(frozen=True)
class For(Expr):
    """for(iters, builder, (b, i, x) => ...) -> builder"""

    iters: Tuple[Iter, ...]
    builder: Expr
    func: Lambda


# ---------------------------------------------------------------------------
# Kernel calls (planner output)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelCall(Expr):
    """A matched IR subtree lowered onto a registered accelerator kernel.

    Produced only by the kernel planner (``repro.core.kernelplan``) after
    optimization; never built by frames.  ``args`` are ordinary IR
    expressions evaluated by the backend before the kernel runs; ``fns``
    are per-element lambdas (over the loop's ``(i, x)`` params) the
    backend stages into jnp-traceable callables; ``params`` are static
    kwargs baked into the call (hashable, part of the compile-cache key).
    """

    kernel: str
    args: Tuple[Expr, ...]
    ret_ty: WeldType
    params: Tuple[Tuple[str, object], ...] = ()
    fns: Tuple[Lambda, ...] = ()


# ---------------------------------------------------------------------------
# Traversal utilities
# ---------------------------------------------------------------------------


def postorder_map(e: Expr, fn: Callable[[Expr], Expr]) -> Expr:
    """Apply `fn` bottom-up over the tree."""

    def rec(x: Expr) -> Expr:
        return fn(x.map_children(rec))

    return rec(e)


def walk(e: Expr):
    """Every node of ``e`` in preorder, children left to right (from an
    explicit stack: nested generators cost each node its depth)."""
    stack = [e]
    while stack:
        x = stack.pop()
        yield x
        stack.extend(reversed(x.children()))


def count_nodes(e: Expr, pred=None) -> int:
    return sum(1 for n in walk(e) if pred is None or pred(n))


def free_vars(e: Expr) -> Dict[str, WeldType]:
    out: Dict[str, WeldType] = {}

    def rec(x: Expr, bound: frozenset):
        if isinstance(x, Ident):
            if x.name not in bound:
                out.setdefault(x.name, x.ty)
            return
        if isinstance(x, Let):
            rec(x.value, bound)
            rec(x.body, bound | {x.name})
            return
        if isinstance(x, Lambda):
            inner = bound | {p.name for p in x.params}
            rec(x.body, inner)
            return
        for c in x.children():
            rec(c, bound)

    rec(e, frozenset())
    return out


def substitute(e: Expr, mapping: Dict[str, Expr]) -> Expr:
    """Capture-free substitution (binder names are globally unique)."""
    if not mapping:
        return e

    def rec(x: Expr, mapping: Dict[str, Expr]) -> Expr:
        if isinstance(x, Ident):
            return mapping.get(x.name, x)
        if isinstance(x, Let):
            m2 = {k: v for k, v in mapping.items() if k != x.name}
            return Let(x.name, rec(x.value, mapping), rec(x.body, m2))
        if isinstance(x, Lambda):
            names = {p.name for p in x.params}
            m2 = {k: v for k, v in mapping.items() if k not in names}
            return Lambda(x.params, rec(x.body, m2))
        return x.map_children(lambda c: rec(c, mapping))

    return rec(e, dict(mapping))


def rename_binders(e: Expr) -> Expr:
    """Alpha-rename every binder to a fresh name (used when duplicating
    subtrees, e.g. during fusion, to preserve global binder uniqueness)."""

    def rec(x: Expr, env: Dict[str, str]) -> Expr:
        if isinstance(x, Ident):
            if x.name in env:
                return Ident(env[x.name], x.ty)
            return x
        if isinstance(x, Let):
            nn = fresh(x.name.split("%")[0])
            return Let(nn, rec(x.value, env), rec(x.body, {**env, x.name: nn}))
        if isinstance(x, Lambda):
            new_params = []
            env2 = dict(env)
            for p in x.params:
                nn = fresh(p.name.split("%")[0])
                env2[p.name] = nn
                new_params.append(Ident(nn, p.ty))
            return Lambda(tuple(new_params), rec(x.body, env2))
        return x.map_children(lambda c: rec(c, env))

    return rec(e, {})


# ---------------------------------------------------------------------------
# Alpha-invariant canonical key (CSE, compile cache)
# ---------------------------------------------------------------------------


def canon_key(e: Expr, name_map: Optional[Dict[str, object]] = None) -> str:
    """Structural key, invariant under renaming of bound variables (de
    Bruijn-style).  Free variables keep their names unless `name_map`
    supplies a positional alias (the compile cache passes input positions
    so two rebuilds of the same workflow share one executable)."""
    parts: list = []
    name_map = name_map or {}

    def rec(x: Expr, depth: Dict[str, int], level: int):
        if isinstance(x, Ident):
            if x.name in depth:
                parts.append(f"@{level - depth[x.name]}")
            else:
                parts.append(f"${name_map.get(x.name, x.name)}")
            return
        if isinstance(x, Literal):
            parts.append(f"L{x.value!r}:{x.ty}")
            return
        if isinstance(x, Let):
            parts.append("(let")
            rec(x.value, depth, level)
            rec(x.body, {**depth, x.name: level + 1}, level + 1)
            parts.append(")")
            return
        if isinstance(x, Lambda):
            parts.append(f"(lam{len(x.params)}")
            d2 = dict(depth)
            lvl = level
            for p in x.params:
                lvl += 1
                d2[p.name] = lvl
            rec(x.body, d2, lvl)
            parts.append(")")
            return
        tag = type(x).__name__
        parts.append(f"({tag}")
        for name in field_names(type(x)):
            v = getattr(x, name)
            if isinstance(v, Expr):
                rec(v, depth, level)
            elif isinstance(v, tuple) and any(isinstance(c, Expr) for c in v):
                parts.append(f"[{len(v)}")
                for c in v:
                    if isinstance(c, Expr):
                        rec(c, depth, level)
                    else:
                        parts.append(f"|{c}")
                parts.append("]")
            else:
                parts.append(f"|{v}")
        parts.append(")")

    rec(e, {}, 0)
    return "".join(parts)


# ---------------------------------------------------------------------------
# Type checking
# ---------------------------------------------------------------------------


def _binop_type(op: str, lt: WeldType, rt: WeldType) -> WeldType:
    if lt != rt:
        raise WeldTypeError(f"binop {op} on mismatched types {lt} vs {rt}")
    if op in CMP_OPS:
        return wt.Bool
    if op in ("&&", "||"):
        if lt != wt.Bool:
            raise WeldTypeError(f"{op} requires bool, got {lt}")
        return wt.Bool
    if not isinstance(lt, wt.Scalar):
        raise WeldTypeError(f"binop {op} on non-scalar {lt}")
    return lt


def typeof(e: Expr, env: Optional[Dict[str, WeldType]] = None) -> WeldType:
    """Whole-program type inference, closed over ``Let``/``Lambda``/``For``
    environments.  On failure the raised :class:`WeldTypeError` carries the
    pretty-printed offending subexpression and the innermost enclosing
    binder name (``err.node`` / ``err.binder`` hold them structurally)."""
    env = dict(env or {})

    def rec(x: Expr, env: Dict[str, WeldType],
            binder: Optional[str] = None) -> WeldType:
        try:
            return _typeof_node(x, env, binder, rec)
        except WeldTypeError as err:
            if getattr(err, "node", None) is None:
                from .pretty import short

                err.node = x
                err.binder = binder
                where = f" [in {binder}]" if binder else ""
                err.args = (f"{err.args[0]}{where} at: {short(x)}",)
            raise

    return rec(e, env)


def _typeof_node(x: Expr, env: Dict[str, WeldType],
                 binder: Optional[str], rec0) -> WeldType:
    def rec(y: Expr, env2, b=None) -> WeldType:
        return rec0(y, env2, b if b is not None else binder)

    if True:
        if isinstance(x, Literal):
            return x.ty
        if isinstance(x, Ident):
            ty = env.get(x.name, x.ty)
            if ty is None:
                raise WeldTypeError(
                    f"identifier {x.name} carries no type and is not "
                    f"bound in the environment"
                )
            return ty
        if isinstance(x, Let):
            vt = rec(x.value, env, x.name)
            return rec(x.body, {**env, x.name: vt}, x.name)
        if isinstance(x, BinOp):
            return _binop_type(x.op, rec(x.left, env), rec(x.right, env))
        if isinstance(x, UnaryOp):
            t = rec(x.expr, env)
            if x.op == "not":
                if t != wt.Bool:
                    raise WeldTypeError(f"not requires bool, got {t}")
                return wt.Bool
            if not isinstance(t, wt.Scalar):
                raise WeldTypeError(f"unary {x.op} on non-scalar {t}")
            return t
        if isinstance(x, Cast):
            rec(x.expr, env)
            return x.ty
        if isinstance(x, (If, Select)):
            ct = rec(x.cond, env)
            if ct != wt.Bool:
                raise WeldTypeError(f"condition must be bool, got {ct}")
            tt = rec(x.on_true, env)
            ft = rec(x.on_false, env)
            if tt != ft:
                raise WeldTypeError(f"branch types differ: {tt} vs {ft}")
            return tt
        if isinstance(x, MakeStruct):
            tys = tuple(rec(i, env) for i in x.items)
            if any(isinstance(t, wt.BuilderType) for t in tys):
                if not all(isinstance(t, wt.BuilderType) for t in tys):
                    raise WeldTypeError("cannot mix builders and values in struct")
                return wt.StructBuilder(tys)  # Listing 3: {merge(bs.0,..), ..}
            return wt.Struct(tys)
        if isinstance(x, GetField):
            st = rec(x.expr, env)
            if isinstance(st, (wt.Struct, wt.StructBuilder)):
                flds = st.fields if isinstance(st, wt.Struct) else st.builders
                if not (0 <= x.index < len(flds)):
                    raise WeldTypeError(
                        f"getfield index {x.index} out of range for {st}"
                    )
                return flds[x.index]
            raise WeldTypeError(f"getfield on non-struct {st}")
        if isinstance(x, MakeVec):
            for i in x.items:
                it = rec(i, env)
                if it != x.elem_ty:
                    raise WeldTypeError(f"makevec elem {it} != {x.elem_ty}")
            return wt.Vec(x.elem_ty)
        if isinstance(x, Len):
            vt = rec(x.expr, env)
            if not isinstance(vt, wt.Vec):
                raise WeldTypeError(f"len of non-vec {vt}")
            return wt.I64
        if isinstance(x, Lookup):
            ct = rec(x.expr, env)
            it = rec(x.index, env)
            if isinstance(ct, wt.Vec):
                if x.default is not None:
                    raise WeldTypeError("vec lookup takes no default")
                if not (isinstance(it, wt.Scalar) and it.is_int):
                    raise WeldTypeError("vec lookup index must be int")
                return ct.elem
            if isinstance(ct, wt.DictType):
                if it != ct.key:
                    raise WeldTypeError("dict lookup key type mismatch")
                if x.default is not None:
                    dt = rec(x.default, env)
                    if dt != ct.val:
                        raise WeldTypeError(
                            f"dict lookup default {dt} != value type {ct.val}"
                        )
                return ct.val
            raise WeldTypeError(f"lookup on {ct}")
        if isinstance(x, KeyExists):
            ct = rec(x.expr, env)
            if not isinstance(ct, wt.DictType):
                raise WeldTypeError("keyexists on non-dict")
            rec(x.key, env)
            return wt.Bool
        if isinstance(x, GroupLookup):
            ct = rec(x.expr, env)
            if not (isinstance(ct, wt.DictType)
                    and isinstance(ct.val, wt.Vec)):
                raise WeldTypeError(
                    f"grouplookup requires dict[K, vec[V]], got {ct}"
                )
            kt = rec(x.key, env)
            if kt != ct.key:
                raise WeldTypeError(
                    f"grouplookup key type {kt} != dict key {ct.key}"
                )
            return ct.val
        if isinstance(x, CUDF):
            for a in x.args:
                rec(a, env)
            return x.ret_ty
        if isinstance(x, Lambda):
            env2 = dict(env)
            for p in x.params:
                env2[p.name] = p.ty
            return wt.Fn(tuple(p.ty for p in x.params), rec(x.body, env2))
        if isinstance(x, NewBuilder):
            if x.arg is not None:
                rec(x.arg, env)
            return x.ty
        if isinstance(x, Merge):
            bt = rec(x.builder, env)
            if not isinstance(bt, wt.BuilderType):
                raise WeldTypeError(f"merge into non-builder {bt}")
            vt = rec(x.value, env)
            expect = merge_arg_type(bt)
            if vt != expect:
                raise WeldTypeError(f"merge type {vt}, builder wants {expect}")
            return bt
        if isinstance(x, Result):
            bt = rec(x.builder, env)
            if not isinstance(bt, wt.BuilderType):
                raise WeldTypeError(f"result of non-builder {bt}")
            return bt.result_type()
        if isinstance(x, Iter):
            dt = rec(x.data, env)
            if not isinstance(dt, wt.Vec):
                raise WeldTypeError(f"iter over non-vec {dt}")
            return dt
        if isinstance(x, KernelCall):
            for a in x.args:
                rec(a, env)
            return x.ret_ty
        if isinstance(x, For):
            bt = rec(x.builder, env)
            if not isinstance(bt, wt.BuilderType):
                raise WeldTypeError("for-loop builder arg is not a builder")
            elem_tys = []
            for it in x.iters:
                vt = rec(it, env)
                elem_tys.append(vt.elem)
            elem = elem_tys[0] if len(elem_tys) == 1 else wt.Struct(tuple(elem_tys))
            ft = rec(x.func, env)
            want = (bt, wt.I64, elem)
            if tuple(ft.params) != want:
                raise WeldTypeError(
                    f"for func params {tuple(map(str, ft.params))} != "
                    f"{tuple(map(str, want))}"
                )
            if ft.ret != bt:
                raise WeldTypeError(f"for func returns {ft.ret}, builder is {bt}")
            return bt
        raise WeldTypeError(f"cannot type {type(x).__name__}")


def merge_arg_type(bt: wt.BuilderType) -> WeldType:
    if isinstance(bt, wt.VecBuilder):
        return bt.elem
    if isinstance(bt, wt.Merger):
        return bt.elem
    if isinstance(bt, (wt.DictMerger, wt.VecMerger, wt.GroupBuilder)):
        return bt.merge_type()
    if isinstance(bt, wt.StructBuilder):
        raise WeldTypeError("cannot merge directly into a struct of builders")
    raise WeldTypeError(f"unknown builder {bt}")


# ---------------------------------------------------------------------------
# Linearity check (paper §3.2): each builder consumed exactly once per path.
# Best-effort structural check used in tests and on frames-generated IR.
# ---------------------------------------------------------------------------


def check_linearity(e: Expr) -> None:
    """Raises WeldTypeError if a builder-typed let/param is consumed more
    than once along a control path (conservative, syntactic)."""

    def uses(x: Expr, name: str) -> int:
        if isinstance(x, Ident):
            return 1 if x.name == name else 0
        if isinstance(x, If):
            # one consumption per control path: max over branches
            return uses(x.cond, name) + max(
                uses(x.on_true, name), uses(x.on_false, name)
            )
        if isinstance(x, Let) and x.name == name:
            return uses(x.value, name)
        if isinstance(x, Lambda) and any(p.name == name for p in x.params):
            return 0
        return sum(uses(c, name) for c in x.children())

    def rec(x: Expr, env: Dict[str, WeldType]):
        if isinstance(x, Let):
            rec(x.value, env)
            try:
                vt = typeof(x.value, env)
            except WeldTypeError:
                vt = None
            if vt is not None and wt.is_builder(vt):
                n = uses(x.body, x.name)
                if n != 1:
                    raise WeldTypeError(
                        f"builder {x.name} consumed {n} times (must be 1)"
                    )
            rec(x.body, {**env, x.name: vt} if vt is not None else env)
            return
        if isinstance(x, Lambda):
            env2 = dict(env)
            for p in x.params:
                env2[p.name] = p.ty
                if wt.is_builder(p.ty):
                    n = uses(x.body, p.name)
                    if n != 1:
                        raise WeldTypeError(
                            f"builder param {p.name} consumed {n} times"
                        )
            rec(x.body, env2)
            return
        for c in x.children():
            rec(c, env)

    rec(e, {})
