"""Python UDF → Weld IR translator (paper §4.4, Listing 6).

Walks the Python AST of a decorated function and emits a Weld lambda.
Supports the expression subset the paper's translator handles: arithmetic,
comparisons, boolean ops, conditional expressions, math calls, and names
from the closure (which become extra dependencies).

    @weld("(f64) => f64")
    def increment(x): return x + 1.0
"""
from __future__ import annotations

import ast
import inspect
import re
import textwrap
from typing import Callable, Dict, List

from ..core import ir, wtypes as wt

_TY = {
    "bool": wt.Bool, "i8": wt.I8, "i32": wt.I32, "i64": wt.I64,
    "f32": wt.F32, "f64": wt.F64,
}

_MATH_FNS = {"exp", "log", "sqrt", "erf", "sin", "cos", "tanh", "abs",
             "floor"}


def parse_signature(sig: str):
    m = re.match(r"\(([^)]*)\)\s*=>\s*(\w+)", sig.strip())
    if not m:
        raise ValueError(f"bad weld signature {sig!r}")
    params = [p.strip() for p in m.group(1).split(",") if p.strip()]
    return [_TY[p] for p in params], _TY[m.group(2)]


class WeldUDF:
    def __init__(self, fn: Callable, param_tys, ret_ty):
        self.fn = fn
        self.param_tys = param_tys
        self.ret_ty = ret_ty
        self._ast = _fn_body_ast(fn)
        self.__name__ = fn.__name__

    def __call__(self, *args):  # still a normal python function
        return self.fn(*args)

    def to_ir(self, args: List[ir.Expr]) -> ir.Expr:
        """Instantiate the UDF body with the given argument expressions."""
        names = list(inspect.signature(self.fn).parameters)
        env: Dict[str, ir.Expr] = dict(zip(names, args))
        closure = inspect.getclosurevars(self.fn)
        consts = {**closure.globals, **closure.nonlocals}
        return _emit(self._ast, env, consts, self.ret_ty)


def weld(signature: str):
    param_tys, ret_ty = parse_signature(signature)

    def deco(fn):
        return WeldUDF(fn, param_tys, ret_ty)

    return deco


def _fn_body_ast(fn) -> ast.expr:
    src = textwrap.dedent(inspect.getsource(fn))
    # strip decorators
    tree = ast.parse(src)
    fdef = tree.body[0]
    assert isinstance(fdef, ast.FunctionDef)
    if len(fdef.body) != 1 or not isinstance(fdef.body[0], ast.Return):
        raise ValueError("UDF must be a single return expression")
    return fdef.body[0].value


_BINOP = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/", ast.Mod: "%",
    ast.Pow: "pow",
}
_CMP = {
    ast.Gt: ">", ast.GtE: ">=", ast.Lt: "<", ast.LtE: "<=",
    ast.Eq: "==", ast.NotEq: "!=",
}


def _emit(node: ast.expr, env, consts, ret_ty) -> ir.Expr:
    def rec(n) -> ir.Expr:
        if isinstance(n, ast.BinOp):
            op = _BINOP.get(type(n.op))
            if op is None:
                raise ValueError(f"unsupported operator {ast.dump(n.op)}")
            return ir.BinOp(op, rec(n.left), rec(n.right))
        if isinstance(n, ast.Compare):
            if len(n.ops) != 1:
                raise ValueError("chained comparisons unsupported")
            return ir.BinOp(_CMP[type(n.ops[0])], rec(n.left),
                            rec(n.comparators[0]))
        if isinstance(n, ast.BoolOp):
            op = "&&" if isinstance(n.op, ast.And) else "||"
            out = rec(n.values[0])
            for v in n.values[1:]:
                out = ir.BinOp(op, out, rec(v))
            return out
        if isinstance(n, ast.UnaryOp):
            if isinstance(n.op, ast.USub):
                return ir.UnaryOp("neg", rec(n.operand))
            if isinstance(n.op, ast.Not):
                return ir.UnaryOp("not", rec(n.operand))
            raise ValueError("unsupported unary op")
        if isinstance(n, ast.IfExp):
            return ir.Select(rec(n.test), rec(n.body), rec(n.orelse))
        if isinstance(n, ast.Call):
            fname = None
            if isinstance(n.func, ast.Attribute):  # math.exp(...)
                fname = n.func.attr
            elif isinstance(n.func, ast.Name):
                fname = n.func.id
            if fname in _MATH_FNS:
                return ir.UnaryOp(fname, _as_float(rec(n.args[0])))
            if fname in ("min", "max"):
                return ir.BinOp(fname, rec(n.args[0]), rec(n.args[1]))
            raise ValueError(f"unsupported call {fname}")
        if isinstance(n, ast.Constant):
            v = n.value
            if isinstance(v, bool):
                return ir.Literal(v, wt.Bool)
            if isinstance(v, int):
                # match the UDF's float context when the constant mixes
                # with float math — emit f64 for float returns
                if ret_ty.is_float:
                    return ir.Literal(float(v), wt.F64)
                return ir.Literal(v, wt.I64)
            if isinstance(v, float):
                return ir.Literal(v, wt.F64)
            raise ValueError(f"unsupported constant {v!r}")
        if isinstance(n, ast.Name):
            if n.id in env:
                return env[n.id]
            if n.id in consts:
                v = consts[n.id]
                if isinstance(v, (int, float, bool)):
                    return rec(ast.Constant(v))
            raise ValueError(f"unbound name {n.id}")
        raise ValueError(f"unsupported syntax {ast.dump(n)[:60]}")

    return rec(node)


def _as_float(e: ir.Expr) -> ir.Expr:
    try:
        t = ir.typeof(e)
    except Exception:
        return e
    if isinstance(t, wt.Scalar) and not t.is_float:
        return ir.Cast(e, wt.F64)
    return e
