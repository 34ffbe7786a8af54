"""Analysis 1: whole-program type/shape re-verification.

A non-throwing re-implementation of ``ir.typeof`` that closes over
``Let``/``Lambda``/``For`` environments from the program roots, annotates
every node with its inferred type (``id(node) -> WeldType``), and records
:class:`Diagnostic` objects instead of raising — so one broken
subexpression doesn't hide the rest, and so the later analyses
(linearity, races, capacity) can reuse the type map without re-running
inference per binding.

Unknowns propagate as ``None``: a node whose operand failed to type
yields no *cascading* diagnostics, only the root cause is reported.

The same walk (:func:`walk`) gathers what the lints read of the tree
(``facts``), so one verify visits each node once; the typing rules are
looked up by node class.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import ir
from .. import wtypes as wt
from . import facts as F
from .diagnostics import Diagnostic

MAX_DIAGS = 25

_INT_KINDS = ("i8", "i32", "i64")


def annotate(
    e: ir.Expr,
    env: Optional[Dict[str, wt.WeldType]] = None,
) -> Tuple[Dict[int, Optional[wt.WeldType]], List[Diagnostic]]:
    """Returns ``(types, diagnostics)`` — the per-node type map (by
    ``id``) and every type violation found, root causes only."""
    types, diags, _ = walk(e, env)
    return types, diags


def walk(
    e: ir.Expr,
    env: Optional[Dict[str, wt.WeldType]] = None,
) -> Tuple[Dict[int, Optional[wt.WeldType]], List[Diagnostic], F.Facts]:
    """:func:`annotate`, gathering on the way the lints' events
    (``facts.scan``'s, equal to them): one walk of the tree where there
    were two.  ``facts.free`` is None where the walk cannot give it as
    ``ir.free_vars`` does (a free name annotated two ways, or a subtree
    left untyped)."""
    w = _Walk()
    w.rec(e, dict(env or {}), None)
    facts = w.facts
    if w.free_unsure:
        facts.free = None
    return w.types, w.diags, facts


class _Walk:
    """The state of one :func:`walk`: the types and diagnostics, and the
    facts gathered in the same visits; the typing rules recurse through
    :meth:`rec`."""

    __slots__ = ("types", "diags", "facts", "names", "ev",
                 "inner", "loop", "free_unsure", "rec")

    def __init__(self):
        self.types: Dict[int, Optional[wt.WeldType]] = {}
        self.diags: List[Diagnostic] = []
        self.facts = F.Facts()
        self.names = self.facts.names
        #: where the events go (the For rule parks its builder's)
        self.ev = self.facts.events
        #: name -> how many binders of the tree enclose the visit
        self.inner: Dict[str, int] = {}
        #: the ordinal of the loop whose function is visited next
        self.loop = None
        self.free_unsure = False
        self.rec = self._recursion()

    def _recursion(self):
        types, names, free, inner = (
            self.types, self.names, self.facts.free, self.inner)
        starts, ends = self.facts.starts, self.facts.ends
        rules, builder, bad = _RULES, wt.BuilderType, self.bad
        ident, literal = ir.Ident, ir.Literal

        def rec(x: ir.Expr, env: Dict[str, Optional[wt.WeldType]],
                binder: Optional[str]) -> Optional[wt.WeldType]:
            cls = type(x)
            if cls is ident:
                name, ty = x.name, x.ty
                names.append(name)
                if name not in inner:
                    seen = free.setdefault(name, ty)
                    if seen is not ty and seen != ty:
                        self.free_unsure = True
                if isinstance(ty, builder):
                    self.ev.append((F.TY, x))
                if name in env:
                    t = env[name]
                    if t is not None and ty is not None and ty is not t \
                            and ty != t:
                        bad("WV102",
                            f"identifier {name} annotated {ty} but bound "
                            f"as {t}" + (f" (in {binder})" if binder else ""),
                            x, annotated=str(ty), bound=str(t))
                    if t is None:
                        t = ty
                else:
                    if ty is None:
                        bad("WV101",
                            f"identifier {name} carries no type and is not "
                            f"bound", x)
                    t = ty
            elif cls is literal:
                t = x.ty
            else:
                s = len(names)
                kind = _PRE_EVENT.get(cls)
                if kind is not None:
                    if kind == F.READ:
                        ev = [F.READ, x, s, s]
                        self.ev.append(ev)
                    else:
                        if kind == F.NB and isinstance(x.ty, builder):
                            self.ev.append((F.TY, x))
                        self.ev.append((kind, x))
                t = rules.get(cls, _t_unknown)(x, env, binder, self)
                starts[id(x)] = s
                ends[id(x)] = len(names)
                if kind == F.READ:
                    target = getattr(x, F.READ_TARGET[cls])
                    ev[3] = (s + 1 if type(target) is ident
                             else ends.get(id(target), s))
            types[id(x)] = t
            return t

        return rec

    def bad(self, code: str, msg: str, node: ir.Expr, **data) -> None:
        if len(self.diags) < MAX_DIAGS:
            self.diags.append(Diagnostic(code, msg, node, analysis="types",
                                         data=data))

    def bind(self, names) -> None:
        for n in names:
            self.inner[n] = self.inner.get(n, 0) + 1

    def unbind(self, names) -> None:
        for n in names:
            left = self.inner[n] - 1
            if left:
                self.inner[n] = left
            else:
                del self.inner[n]

    def lambda_body(self, x: ir.Lambda, env, binder):
        """A Lambda's body, with the parameters' and the body's events
        (around a loop's marks when the Lambda is a For's function)."""
        loop, self.loop = self.loop, None
        ev = self.ev
        for p in x.params:
            self.names.append(p.name)
            if isinstance(p.ty, wt.BuilderType):
                ev.append((F.TY, p))
        lam = [F.LAM, x, len(self.names), None]
        ev.append(lam)
        if loop is not None:
            ev.append((F.LOOP, loop))
        params = [p.name for p in x.params]
        self.bind(params)
        t = self.rec(x.body, env, binder)
        self.unbind(params)
        if loop is not None:
            self.ev.append((F.END, loop))
        lam[3] = len(self.names)
        return t

    def untyped(self, x: ir.Expr) -> None:
        """A subtree the typing rules leave: its events all the same."""
        self.free_unsure = True
        F.scan_into(self.facts, self.ev, x, frozenset(self.inner))


#: the events a node gives before its children's
_PRE_EVENT = {ir.NewBuilder: F.NB, ir.KernelCall: F.KC, ir.Merge: F.MERGE,
              **{cls: F.READ for cls in F.READ_TARGET}}


def _t_let(x, env, binder, w):
    s = len(w.names)
    vt = w.rec(x.value, env, x.name)
    ev = [F.LET, x, s, len(w.names), None]
    w.ev.append(ev)
    w.bind((x.name,))
    t = w.rec(x.body, {**env, x.name: vt}, x.name)
    w.unbind((x.name,))
    ev[4] = len(w.names)
    return t


def _t_binop(x, env, binder, w):
    lt = w.rec(x.left, env, binder)
    rt = w.rec(x.right, env, binder)
    if lt is None or rt is None:
        return None
    if lt != rt:
        w.bad("WV101", f"binop {x.op} on mismatched types {lt} vs {rt}", x)
        return None
    if x.op in ir.CMP_OPS:
        return wt.Bool
    if x.op in ("&&", "||"):
        if lt != wt.Bool:
            w.bad("WV101", f"{x.op} requires bool, got {lt}", x)
        return wt.Bool
    if not isinstance(lt, wt.Scalar):
        w.bad("WV101", f"binop {x.op} on non-scalar {lt}", x)
        return None
    return lt


def _t_unaryop(x, env, binder, w):
    t = w.rec(x.expr, env, binder)
    if t is None:
        return None
    if x.op == "not":
        if t != wt.Bool:
            w.bad("WV101", f"not requires bool, got {t}", x)
        return wt.Bool
    if not isinstance(t, wt.Scalar):
        w.bad("WV101", f"unary {x.op} on non-scalar {t}", x)
        return None
    return t


def _t_cast(x, env, binder, w):
    w.rec(x.expr, env, binder)
    return x.ty


def _t_if(x, env, binder, w):
    ct = w.rec(x.cond, env, binder)
    if ct is not None and ct != wt.Bool:
        w.bad("WV101", f"condition must be bool, got {ct}", x.cond)
    tt = w.rec(x.on_true, env, binder)
    ft = w.rec(x.on_false, env, binder)
    if tt is not None and ft is not None and tt != ft:
        w.bad("WV101", f"branch types differ: {tt} vs {ft}", x)
        return None
    return tt if tt is not None else ft


def _t_makestruct(x, env, binder, w):
    tys = tuple(w.rec(i, env, binder) for i in x.items)
    if any(t is None for t in tys):
        return None
    if any(isinstance(t, wt.BuilderType) for t in tys):
        if not all(isinstance(t, wt.BuilderType) for t in tys):
            w.bad("WV101", "cannot mix builders and values in struct", x)
            return None
        return wt.StructBuilder(tys)
    return wt.Struct(tys)


def _t_getfield(x, env, binder, w):
    st = w.rec(x.expr, env, binder)
    if st is None:
        return None
    if isinstance(st, (wt.Struct, wt.StructBuilder)):
        flds = st.fields if isinstance(st, wt.Struct) else st.builders
        if not (0 <= x.index < len(flds)):
            w.bad("WV101",
                f"getfield index {x.index} out of range for {st}", x)
            return None
        return flds[x.index]
    w.bad("WV101", f"getfield on non-struct {st}", x)
    return None


def _t_makevec(x, env, binder, w):
    for i in x.items:
        it = w.rec(i, env, binder)
        if it is not None and it != x.elem_ty:
            w.bad("WV101", f"makevec elem {it} != {x.elem_ty}", i)
    return wt.Vec(x.elem_ty)


def _t_len(x, env, binder, w):
    vt = w.rec(x.expr, env, binder)
    if vt is not None and not isinstance(vt, wt.Vec):
        w.bad("WV101", f"len of non-vec {vt}", x)
    return wt.I64


def _t_lookup(x, env, binder, w):
    ct = w.rec(x.expr, env, binder)
    it = w.rec(x.index, env, binder)
    if ct is None:
        if x.default is not None:
            w.rec(x.default, env, binder)
        return None
    if isinstance(ct, wt.Vec):
        if x.default is not None:
            w.bad("WV101", "vec lookup takes no default", x)
            w.untyped(x.default)
        if it is not None and not (isinstance(it, wt.Scalar)
                                   and it.is_int):
            w.bad("WV101", f"vec lookup index must be int, got {it}", x)
        return ct.elem
    if isinstance(ct, wt.DictType):
        if it is not None and it != ct.key:
            w.bad("WV101",
                f"dict lookup key type {it} != dict key {ct.key}", x)
        if x.default is not None:
            dt = w.rec(x.default, env, binder)
            if dt is not None and dt != ct.val:
                w.bad("WV101",
                    f"dict lookup default {dt} != value type {ct.val}",
                    x)
        return ct.val
    w.bad("WV101", f"lookup on {ct}", x)
    if x.default is not None:
        w.untyped(x.default)
    return None


def _t_keyexists(x, env, binder, w):
    ct = w.rec(x.expr, env, binder)
    if ct is not None and not isinstance(ct, wt.DictType):
        w.bad("WV101", f"keyexists on non-dict {ct}", x)
    w.rec(x.key, env, binder)
    return wt.Bool


def _t_grouplookup(x, env, binder, w):
    ct = w.rec(x.expr, env, binder)
    kt = w.rec(x.key, env, binder)
    if ct is None:
        return None
    if not (isinstance(ct, wt.DictType) and isinstance(ct.val, wt.Vec)):
        w.bad("WV101", f"grouplookup requires dict[K, vec[V]], got {ct}", x)
        return None
    if kt is not None and kt != ct.key:
        w.bad("WV101",
            f"grouplookup key type {kt} != dict key {ct.key}", x)
    return ct.val


def _t_cudf(x, env, binder, w):
    for a in x.args:
        w.rec(a, env, binder)
    return x.ret_ty


def _t_lambda(x, env, binder, w):
    env2 = dict(env)
    for p in x.params:
        env2[p.name] = p.ty
    bt = w.lambda_body(x, env2, binder)
    if bt is None or any(p.ty is None for p in x.params):
        return None
    return wt.Fn(tuple(p.ty for p in x.params), bt)


def _t_newbuilder(x, env, binder, w):
    if x.arg is not None:
        at = w.rec(x.arg, env, binder)
        _check_builder_arg(x, at, w.bad)
    if x.size_hint is not None:
        ht = w.rec(x.size_hint, env, binder)
        if ht is not None and not (isinstance(ht, wt.Scalar)
                                   and ht.is_int):
            w.bad("WV104",
                f"size hint must be an int scalar, got {ht}",
                x.size_hint)
    return x.ty


def _t_merge(x, env, binder, w):
    bt = w.rec(x.builder, env, binder)
    vt = w.rec(x.value, env, binder)
    if bt is None:
        return None
    if not isinstance(bt, wt.BuilderType):
        w.bad("WV101", f"merge into non-builder {bt}", x)
        return None
    try:
        expect = ir.merge_arg_type(bt)
    except wt.WeldTypeError as err:
        w.bad("WV101", str(err), x)
        return bt
    if vt is not None and vt != expect:
        w.bad("WV101",
            f"merge type {vt}, builder wants {expect}", x)
    return bt


def _t_result(x, env, binder, w):
    bt = w.rec(x.builder, env, binder)
    if bt is None:
        return None
    if not isinstance(bt, wt.BuilderType):
        w.bad("WV101", f"result of non-builder {bt}", x)
        return None
    return bt.result_type()


def _t_iter(x, env, binder, w):
    dt = w.rec(x.data, env, binder)
    for bound in (x.start, x.end, x.stride):
        if bound is not None:
            bt = w.rec(bound, env, binder)
            if bt is not None and not (isinstance(bt, wt.Scalar)
                                       and bt.is_int):
                w.bad("WV101",
                    f"iter bound must be an int scalar, got {bt}",
                    bound)
    if dt is None:
        return None
    if not isinstance(dt, wt.Vec):
        w.bad("WV101", f"iter over non-vec {dt}", x)
        return None
    return dt


def _t_kernelcall(x, env, binder, w):
    for a in x.args:
        w.rec(a, env, binder)
    for f in x.fns:
        w.rec(f, env, binder)
    _check_kernel_known(x, w.bad)
    return x.ret_ty


def _t_for(x, env, binder, w):
    k = w.facts.loops
    w.facts.loops += 1
    outer = w.ev
    outer.append((F.FOR, x, k))
    # typed builder first, as ever; its events follow the iters' (the
    # lints read them in preorder)
    w.ev = []
    bt = w.rec(x.builder, env, binder)
    built, w.ev = w.ev, outer
    elem_tys = []
    for it in x.iters:
        vt = w.rec(it, env, binder)
        elem_tys.append(vt.elem if isinstance(vt, wt.Vec) else None)
    outer.extend(built)
    if type(x.func) is ir.Lambda:
        w.loop = k
    ft = w.rec(x.func, env, binder)
    if bt is not None and not isinstance(bt, wt.BuilderType):
        w.bad("WV101", f"for-loop builder arg is not a builder: {bt}", x)
        return None
    if ft is None or bt is None or any(t is None for t in elem_tys):
        return bt
    elem = (elem_tys[0] if len(elem_tys) == 1
            else wt.Struct(tuple(elem_tys)))
    want = (bt, wt.I64, elem)
    if not isinstance(ft, wt.Fn):
        w.bad("WV101", f"for func is not a function: {ft}", x.func)
        return bt
    if tuple(ft.params) != want:
        w.bad("WV101",
            f"for func params {tuple(map(str, ft.params))} != "
            f"{tuple(map(str, want))}", x.func)
    elif ft.ret != bt:
        w.bad("WV101",
            f"for func returns {ft.ret}, builder is {bt}", x.func)
    return bt


def _t_unknown(x, env, binder, w):
    # a subclass of a node class takes its base's rule, as the chain of
    # isinstance tests this table replaces gave it
    for base in type(x).__mro__[1:]:
        rule = _RULES.get(base)
        if rule is not None:
            return rule(x, env, binder, w)
    w.bad("WV101", f"cannot type {type(x).__name__}", x)
    for c in x.children():
        w.untyped(c)
    return None


#: node class -> its typing rule
_RULES = {
    ir.Let: _t_let,
    ir.BinOp: _t_binop,
    ir.UnaryOp: _t_unaryop,
    ir.Cast: _t_cast,
    ir.If: _t_if,
    ir.Select: _t_if,
    ir.MakeStruct: _t_makestruct,
    ir.GetField: _t_getfield,
    ir.MakeVec: _t_makevec,
    ir.Len: _t_len,
    ir.Lookup: _t_lookup,
    ir.KeyExists: _t_keyexists,
    ir.GroupLookup: _t_grouplookup,
    ir.CUDF: _t_cudf,
    ir.Lambda: _t_lambda,
    ir.NewBuilder: _t_newbuilder,
    ir.Merge: _t_merge,
    ir.Result: _t_result,
    ir.Iter: _t_iter,
    ir.KernelCall: _t_kernelcall,
    ir.For: _t_for,
}


def _check_builder_arg(nb: ir.NewBuilder, at, bad) -> None:
    """WV104: the optional NewBuilder argument must fit the builder —
    merger initial value, vecmerger base vector, dict/group capacity."""
    if at is None:
        return
    bt = nb.ty
    if isinstance(bt, wt.Merger):
        if at != bt.elem:
            bad("WV104",
                f"merger init {at} != element type {bt.elem}", nb)
    elif isinstance(bt, wt.VecMerger):
        if at != wt.Vec(bt.elem):
            bad("WV104",
                f"vecmerger base {at} != vec[{bt.elem}]", nb)
    elif isinstance(bt, (wt.DictMerger, wt.GroupBuilder)):
        if not (isinstance(at, wt.Scalar) and at.is_int):
            bad("WV104",
                f"dict/group capacity must be an int scalar, got {at}", nb)


def _check_kernel_known(kc: ir.KernelCall, bad) -> None:
    """WV103: a planned kernel must exist in the registry."""
    try:
        from ..kernelplan import registry as reg
    except Exception:  # pragma: no cover - kernels lib unavailable
        return
    if reg.available(kc.kernel) is None:
        bad("WV103", f"kernel {kc.kernel!r} is not registered", kc)
