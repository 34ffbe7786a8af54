"""Pure-Python reference interpreter for Weld IR.

This is the *semantic oracle*: it executes the IR directly on Python
lists/scalars/dicts with no optimization and no JAX.  Property tests check
that the optimizer + JAX backend agree with this interpreter on random
programs.  It is deliberately simple and slow.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from . import ir
from . import wtypes as wt
from .cudf import lookup_cudf_host


class _VecBuilderState:
    def __init__(self, bt):
        self.bt, self.items = bt, []

    def merge(self, v):
        self.items.append(v)

    def result(self):
        return list(self.items)


def _apply_op(op, a, b):
    if op == "+":
        return a + b
    if op == "*":
        return a * b
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    raise ValueError(op)


class _MergerState:
    def __init__(self, bt, init=None):
        self.bt = bt
        self.acc = init if init is not None else _default_acc(bt)

    def merge(self, v):
        self.acc = _merge_val(self.bt.elem, self.bt.op, self.acc, v)

    def result(self):
        return self.acc


def _default_acc(bt):
    return _identity_of(bt.elem, bt.op)


def _identity_of(ty, op):
    if isinstance(ty, wt.Struct):
        return tuple(_identity_of(f, op) for f in ty.fields)
    return wt.merge_identity(op, ty)


def _merge_val(ty, op, a, b):
    if isinstance(ty, wt.Struct):
        return tuple(
            _merge_val(f, op, x, y) for f, x, y in zip(ty.fields, a, b)
        )
    return _apply_op(op, a, b)


class _DictMergerState:
    def __init__(self, bt):
        self.bt, self.d = bt, {}

    def merge(self, kv):
        k, v = kv
        k = _hashable(k)
        if k in self.d:
            self.d[k] = _merge_val(self.bt.val, self.bt.op, self.d[k], v)
        else:
            self.d[k] = v

    def result(self):
        return dict(self.d)


class _GroupBuilderState:
    def __init__(self, bt):
        self.bt, self.d = bt, {}

    def merge(self, kv):
        k, v = kv
        k = _hashable(k)
        self.d.setdefault(k, []).append(v)

    def result(self):
        return {k: list(v) for k, v in self.d.items()}


class _VecMergerState:
    def __init__(self, bt, base):
        self.bt = bt
        self.vec = list(base)

    def merge(self, iv):
        i, v = iv
        self.vec[int(i)] = _apply_op(self.bt.op, self.vec[int(i)], v)

    def result(self):
        return list(self.vec)


def _hashable(k):
    return tuple(k) if isinstance(k, (list, tuple)) else k


class _Closure:
    def __init__(self, lam: ir.Lambda, env: Dict[str, object]):
        self.lam, self.env = lam, env


_UNARY_FNS = {
    "neg": lambda x: -x,
    "not": lambda x: not x,
    "exp": math.exp,
    "log": math.log,
    "sqrt": math.sqrt,
    "erf": math.erf,
    "sin": math.sin,
    "cos": math.cos,
    "tanh": math.tanh,
    "abs": abs,
    "sigmoid": lambda x: 1.0 / (1.0 + math.exp(-x)),
    "floor": math.floor,
    "rsqrt": lambda x: 1.0 / math.sqrt(x),
}


def _new_builder_state(bt, arg):
    if isinstance(bt, wt.VecBuilder):
        return _VecBuilderState(bt)
    if isinstance(bt, wt.Merger):
        return _MergerState(bt, init=arg)
    if isinstance(bt, wt.DictMerger):
        return _DictMergerState(bt)
    if isinstance(bt, wt.GroupBuilder):
        return _GroupBuilderState(bt)
    if isinstance(bt, wt.VecMerger):
        if arg is None:
            raise ValueError("vecmerger needs a base vector")
        return _VecMergerState(bt, arg)
    if isinstance(bt, wt.StructBuilder):
        raise ValueError("struct builders are created via MakeStruct")
    raise ValueError(f"unknown builder {bt}")


def interpret(e: ir.Expr, env: Dict[str, object] | None = None):
    """Evaluate `e` in `env`; vectors are Python lists, dicts are dicts,
    structs are tuples, builders are internal state objects."""
    env = dict(env or {})

    def rec(x: ir.Expr, env):
        if isinstance(x, ir.Literal):
            return x.value
        if isinstance(x, ir.Ident):
            if x.name not in env:
                raise NameError(f"unbound {x.name}")
            return env[x.name]
        if isinstance(x, ir.Let):
            v = rec(x.value, env)
            return rec(x.body, {**env, x.name: v})
        if isinstance(x, ir.BinOp):
            a, b = rec(x.left, env), rec(x.right, env)
            if x.op == "&&":
                return bool(a) and bool(b)
            if x.op == "||":
                return bool(a) or bool(b)
            if x.op in ir.CMP_OPS:
                return {
                    "==": a == b, "!=": a != b, "<": a < b,
                    "<=": a <= b, ">": a > b, ">=": a >= b,
                }[x.op]
            if x.op == "/":
                if isinstance(a, int) and isinstance(b, int):
                    # C-style truncating integer division
                    return int(a / b) if b != 0 else 0
                return a / b
            if x.op == "%":
                return a % b
            if x.op == "pow":
                return a ** b
            return _apply_op(x.op, a, b) if x.op in ("min", "max") else {
                "+": a + b, "-": a - b, "*": a * b,
            }[x.op]
        if isinstance(x, ir.UnaryOp):
            return _UNARY_FNS[x.op](rec(x.expr, env))
        if isinstance(x, ir.Cast):
            v = rec(x.expr, env)
            return x.ty.np_dtype(v).item()
        if isinstance(x, (ir.If, ir.Select)):
            if isinstance(x, ir.Select):
                t = rec(x.on_true, env)
                f = rec(x.on_false, env)
                return t if rec(x.cond, env) else f
            return rec(x.on_true if rec(x.cond, env) else x.on_false, env)
        if isinstance(x, ir.MakeStruct):
            return tuple(rec(i, env) for i in x.items)
        if isinstance(x, ir.GetField):
            return rec(x.expr, env)[x.index]
        if isinstance(x, ir.MakeVec):
            return [rec(i, env) for i in x.items]
        if isinstance(x, ir.Len):
            return len(rec(x.expr, env))
        if isinstance(x, ir.Lookup):
            c = rec(x.expr, env)
            i = rec(x.index, env)
            if isinstance(c, dict):
                k = _hashable(i)
                if x.default is not None and k not in c:
                    return rec(x.default, env)
                return c[k]
            return c[int(i)]
        if isinstance(x, ir.KeyExists):
            return _hashable(rec(x.key, env)) in rec(x.expr, env)
        if isinstance(x, ir.GroupLookup):
            d = rec(x.expr, env)
            k = _hashable(rec(x.key, env))
            return list(d.get(k, []))  # miss -> EMPTY vector
        if isinstance(x, ir.CUDF):
            fn = lookup_cudf_host(x.name)
            return fn(*[rec(a, env) for a in x.args])
        if isinstance(x, ir.Lambda):
            return _Closure(x, dict(env))
        if isinstance(x, ir.NewBuilder):
            arg = rec(x.arg, env) if x.arg is not None else None
            if isinstance(x.ty, (wt.DictMerger, wt.GroupBuilder)):
                arg = None  # capacity hint: irrelevant to reference semantics
            return _new_builder_state(x.ty, arg)
        if isinstance(x, ir.Merge):
            b = rec(x.builder, env)
            b.merge(rec(x.value, env))
            return b
        if isinstance(x, ir.Result):
            b = rec(x.builder, env)
            if isinstance(b, tuple):  # struct of builders
                return tuple(s.result() for s in b)
            return b.result()
        if isinstance(x, ir.Iter):
            data = rec(x.data, env)
            start = int(rec(x.start, env)) if x.start is not None else 0
            end = int(rec(x.end, env)) if x.end is not None else len(data)
            stride = int(rec(x.stride, env)) if x.stride is not None else 1
            return data[start:end:stride]
        if isinstance(x, ir.For):
            seqs = [rec(it, env) for it in x.iters]
            n = min(len(s) for s in seqs)
            b = rec(x.builder, env)
            clo = rec(x.func, env)
            for i in range(n):
                elem = seqs[0][i] if len(seqs) == 1 else tuple(s[i] for s in seqs)
                b = _call(clo, [b, i, elem])
            return b
        raise ValueError(f"cannot interpret {type(x).__name__}")

    def _call(clo: _Closure, args: List[object]):
        env2 = dict(clo.env)
        for p, a in zip(clo.lam.params, args):
            env2[p.name] = a
        return rec(clo.lam.body, env2)

    return rec(e, env)


def _guess_ty(v):
    if isinstance(v, bool):
        return wt.Bool
    if isinstance(v, int):
        return wt.I64
    if isinstance(v, float):
        return wt.F64
    return wt.F64


def to_python(value, ty: wt.WeldType):
    """Convert a backend (numpy/torch) value into interpreter-land types."""
    if isinstance(ty, wt.Scalar):
        return np.asarray(value).item()
    if isinstance(ty, wt.Vec):
        return [to_python(v, ty.elem) for v in np.asarray(value).tolist()] \
            if isinstance(ty.elem, wt.Struct) else np.asarray(value).tolist()
    if isinstance(ty, wt.Struct):
        return tuple(to_python(v, f) for v, f in zip(value, ty.fields))
    raise ValueError(f"cannot convert {ty}")
