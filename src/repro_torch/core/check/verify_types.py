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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import ir
from .. import wtypes as wt
from .diagnostics import Diagnostic

MAX_DIAGS = 25

_INT_KINDS = ("i8", "i32", "i64")


def annotate(
    e: ir.Expr,
    env: Optional[Dict[str, wt.WeldType]] = None,
) -> Tuple[Dict[int, Optional[wt.WeldType]], List[Diagnostic]]:
    """Returns ``(types, diagnostics)`` — the per-node type map (by
    ``id``) and every type violation found, root causes only."""
    types: Dict[int, Optional[wt.WeldType]] = {}
    diags: List[Diagnostic] = []

    def bad(code: str, msg: str, node: ir.Expr, **data) -> None:
        if len(diags) < MAX_DIAGS:
            diags.append(Diagnostic(code, msg, node, analysis="types",
                                    data=data))

    def rec(x: ir.Expr, env: Dict[str, Optional[wt.WeldType]],
            binder: Optional[str]) -> Optional[wt.WeldType]:
        t = _infer(x, env, binder, rec, bad)
        types[id(x)] = t
        return t

    rec(e, dict(env or {}), None)
    return types, diags


def _infer(x, env, binder, rec, bad) -> Optional[wt.WeldType]:
    if isinstance(x, ir.Literal):
        return x.ty
    if isinstance(x, ir.Ident):
        if x.name in env:
            t = env[x.name]
            if t is not None and x.ty is not None and x.ty != t:
                bad("WV102",
                    f"identifier {x.name} annotated {x.ty} but bound as {t}"
                    + (f" (in {binder})" if binder else ""),
                    x, annotated=str(x.ty), bound=str(t))
            return t if t is not None else x.ty
        if x.ty is None:
            bad("WV101",
                f"identifier {x.name} carries no type and is not bound",
                x)
        return x.ty
    if isinstance(x, ir.Let):
        vt = rec(x.value, env, x.name)
        return rec(x.body, {**env, x.name: vt}, x.name)
    if isinstance(x, ir.BinOp):
        lt = rec(x.left, env, binder)
        rt = rec(x.right, env, binder)
        if lt is None or rt is None:
            return None
        if lt != rt:
            bad("WV101", f"binop {x.op} on mismatched types {lt} vs {rt}", x)
            return None
        if x.op in ir.CMP_OPS:
            return wt.Bool
        if x.op in ("&&", "||"):
            if lt != wt.Bool:
                bad("WV101", f"{x.op} requires bool, got {lt}", x)
            return wt.Bool
        if not isinstance(lt, wt.Scalar):
            bad("WV101", f"binop {x.op} on non-scalar {lt}", x)
            return None
        return lt
    if isinstance(x, ir.UnaryOp):
        t = rec(x.expr, env, binder)
        if t is None:
            return None
        if x.op == "not":
            if t != wt.Bool:
                bad("WV101", f"not requires bool, got {t}", x)
            return wt.Bool
        if not isinstance(t, wt.Scalar):
            bad("WV101", f"unary {x.op} on non-scalar {t}", x)
            return None
        return t
    if isinstance(x, ir.Cast):
        rec(x.expr, env, binder)
        return x.ty
    if isinstance(x, (ir.If, ir.Select)):
        ct = rec(x.cond, env, binder)
        if ct is not None and ct != wt.Bool:
            bad("WV101", f"condition must be bool, got {ct}", x.cond)
        tt = rec(x.on_true, env, binder)
        ft = rec(x.on_false, env, binder)
        if tt is not None and ft is not None and tt != ft:
            bad("WV101", f"branch types differ: {tt} vs {ft}", x)
            return None
        return tt if tt is not None else ft
    if isinstance(x, ir.MakeStruct):
        tys = tuple(rec(i, env, binder) for i in x.items)
        if any(t is None for t in tys):
            return None
        if any(isinstance(t, wt.BuilderType) for t in tys):
            if not all(isinstance(t, wt.BuilderType) for t in tys):
                bad("WV101", "cannot mix builders and values in struct", x)
                return None
            return wt.StructBuilder(tys)
        return wt.Struct(tys)
    if isinstance(x, ir.GetField):
        st = rec(x.expr, env, binder)
        if st is None:
            return None
        if isinstance(st, (wt.Struct, wt.StructBuilder)):
            flds = st.fields if isinstance(st, wt.Struct) else st.builders
            if not (0 <= x.index < len(flds)):
                bad("WV101",
                    f"getfield index {x.index} out of range for {st}", x)
                return None
            return flds[x.index]
        bad("WV101", f"getfield on non-struct {st}", x)
        return None
    if isinstance(x, ir.MakeVec):
        for i in x.items:
            it = rec(i, env, binder)
            if it is not None and it != x.elem_ty:
                bad("WV101", f"makevec elem {it} != {x.elem_ty}", i)
        return wt.Vec(x.elem_ty)
    if isinstance(x, ir.Len):
        vt = rec(x.expr, env, binder)
        if vt is not None and not isinstance(vt, wt.Vec):
            bad("WV101", f"len of non-vec {vt}", x)
        return wt.I64
    if isinstance(x, ir.Lookup):
        ct = rec(x.expr, env, binder)
        it = rec(x.index, env, binder)
        if ct is None:
            if x.default is not None:
                rec(x.default, env, binder)
            return None
        if isinstance(ct, wt.Vec):
            if x.default is not None:
                bad("WV101", "vec lookup takes no default", x)
            if it is not None and not (isinstance(it, wt.Scalar)
                                       and it.is_int):
                bad("WV101", f"vec lookup index must be int, got {it}", x)
            return ct.elem
        if isinstance(ct, wt.DictType):
            if it is not None and it != ct.key:
                bad("WV101",
                    f"dict lookup key type {it} != dict key {ct.key}", x)
            if x.default is not None:
                dt = rec(x.default, env, binder)
                if dt is not None and dt != ct.val:
                    bad("WV101",
                        f"dict lookup default {dt} != value type {ct.val}",
                        x)
            return ct.val
        bad("WV101", f"lookup on {ct}", x)
        return None
    if isinstance(x, ir.KeyExists):
        ct = rec(x.expr, env, binder)
        if ct is not None and not isinstance(ct, wt.DictType):
            bad("WV101", f"keyexists on non-dict {ct}", x)
        rec(x.key, env, binder)
        return wt.Bool
    if isinstance(x, ir.GroupLookup):
        ct = rec(x.expr, env, binder)
        kt = rec(x.key, env, binder)
        if ct is None:
            return None
        if not (isinstance(ct, wt.DictType) and isinstance(ct.val, wt.Vec)):
            bad("WV101", f"grouplookup requires dict[K, vec[V]], got {ct}", x)
            return None
        if kt is not None and kt != ct.key:
            bad("WV101",
                f"grouplookup key type {kt} != dict key {ct.key}", x)
        return ct.val
    if isinstance(x, ir.CUDF):
        for a in x.args:
            rec(a, env, binder)
        return x.ret_ty
    if isinstance(x, ir.Lambda):
        env2 = dict(env)
        for p in x.params:
            env2[p.name] = p.ty
        bt = rec(x.body, env2, binder)
        if bt is None or any(p.ty is None for p in x.params):
            return None
        return wt.Fn(tuple(p.ty for p in x.params), bt)
    if isinstance(x, ir.NewBuilder):
        if x.arg is not None:
            at = rec(x.arg, env, binder)
            _check_builder_arg(x, at, bad)
        if x.size_hint is not None:
            ht = rec(x.size_hint, env, binder)
            if ht is not None and not (isinstance(ht, wt.Scalar)
                                       and ht.is_int):
                bad("WV104",
                    f"size hint must be an int scalar, got {ht}",
                    x.size_hint)
        return x.ty
    if isinstance(x, ir.Merge):
        bt = rec(x.builder, env, binder)
        vt = rec(x.value, env, binder)
        if bt is None:
            return None
        if not isinstance(bt, wt.BuilderType):
            bad("WV101", f"merge into non-builder {bt}", x)
            return None
        try:
            expect = ir.merge_arg_type(bt)
        except wt.WeldTypeError as err:
            bad("WV101", str(err), x)
            return bt
        if vt is not None and vt != expect:
            bad("WV101",
                f"merge type {vt}, builder wants {expect}", x)
        return bt
    if isinstance(x, ir.Result):
        bt = rec(x.builder, env, binder)
        if bt is None:
            return None
        if not isinstance(bt, wt.BuilderType):
            bad("WV101", f"result of non-builder {bt}", x)
            return None
        return bt.result_type()
    if isinstance(x, ir.Iter):
        dt = rec(x.data, env, binder)
        for bound in (x.start, x.end, x.stride):
            if bound is not None:
                bt = rec(bound, env, binder)
                if bt is not None and not (isinstance(bt, wt.Scalar)
                                           and bt.is_int):
                    bad("WV101",
                        f"iter bound must be an int scalar, got {bt}",
                        bound)
        if dt is None:
            return None
        if not isinstance(dt, wt.Vec):
            bad("WV101", f"iter over non-vec {dt}", x)
            return None
        return dt
    if isinstance(x, ir.KernelCall):
        for a in x.args:
            rec(a, env, binder)
        for f in x.fns:
            rec(f, env, binder)
        _check_kernel_known(x, bad)
        return x.ret_ty
    if isinstance(x, ir.For):
        bt = rec(x.builder, env, binder)
        elem_tys = []
        for it in x.iters:
            vt = rec(it, env, binder)
            elem_tys.append(vt.elem if isinstance(vt, wt.Vec) else None)
        ft = rec(x.func, env, binder)
        if bt is not None and not isinstance(bt, wt.BuilderType):
            bad("WV101", f"for-loop builder arg is not a builder: {bt}", x)
            return None
        if ft is None or bt is None or any(t is None for t in elem_tys):
            return bt
        elem = (elem_tys[0] if len(elem_tys) == 1
                else wt.Struct(tuple(elem_tys)))
        want = (bt, wt.I64, elem)
        if not isinstance(ft, wt.Fn):
            bad("WV101", f"for func is not a function: {ft}", x.func)
            return bt
        if tuple(ft.params) != want:
            bad("WV101",
                f"for func params {tuple(map(str, ft.params))} != "
                f"{tuple(map(str, want))}", x.func)
        elif ft.ret != bt:
            bad("WV101",
                f"for func returns {ft.ret}, builder is {bt}", x.func)
        return bt
    bad("WV101", f"cannot type {type(x).__name__}", x)
    return None


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
