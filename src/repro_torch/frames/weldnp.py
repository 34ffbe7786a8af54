"""weldnp — the NumPy integration (paper §6).

A lazy ndarray wrapper: every operator returns a new `ndarray` holding a
WeldObject; printing / `.to_numpy()` / `.item()` force evaluation of the
whole accumulated workflow as ONE fused program.  Mirrors the paper's
integration style: ported operators accept either a plain numpy array or a
wrapper, and return wrappers with the inputs as dependencies.

`eager=True` arrays compute with real NumPy per call — the paper's
"native library" baseline (each operator is an optimized C kernel, results
materialize between calls).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np

from ..core import ir, macros as M, wtypes as wt
from ..core.lazy import Evaluate, NewWeldObject, WeldObject

Number = Union[int, float, bool]


def _scalar_lit(v: Number, like_ty: wt.Scalar) -> ir.Expr:
    if like_ty.is_float:
        return ir.Literal(float(v), like_ty)
    if like_ty == wt.Bool:
        return ir.Literal(bool(v), like_ty)
    return ir.Literal(int(v), like_ty)


class ndarray:
    """Lazily evaluated array.  1-D general; 2-D supported for linear
    algebra (dot/matvec/matmul) and row-wise maps."""

    def __init__(self, obj: WeldObject, shape: tuple, dtype, eager_data=None):
        self.obj = obj
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._eager = eager_data  # numpy array when in eager mode

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_numpy(arr: np.ndarray, eager: bool = False) -> "ndarray":
        arr = np.asarray(arr)
        if eager:
            return ndarray(None, arr.shape, arr.dtype, eager_data=arr)
        obj = NewWeldObject(arr, None)
        return ndarray(obj, arr.shape, arr.dtype)

    @property
    def is_eager(self) -> bool:
        return self._eager is not None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _ident(self) -> ir.Expr:
        return ir.Ident(self.obj.obj_id, self.obj.weld_type())

    @property
    def weld_elem_ty(self) -> wt.Scalar:
        return wt.dtype_to_weld(self.dtype)

    # -- evaluation points ---------------------------------------------------

    def evaluate(self, kernelize=None, kernel_impl=None, **kw):
        """Force evaluation of the accumulated workflow as one program.

        ``kernelize`` selects the planner mode — the default ``"auto"``
        routes matched fused loops through the CUDA kernel library
        whenever the roofline cost model favors them, ``"always"``/True
        forces every match, ``"off"``/False bypasses the planner
        (``repro_torch.core.kernelplan``); ``kernel_impl`` selects
        "cuda" / "ref" for the routed kernel calls.
        """
        if self.is_eager:
            return self._eager
        res = Evaluate(self.obj, kernelize=kernelize,
                       kernel_impl=kernel_impl, **kw)
        return res.value

    def to_numpy(self, **kw) -> np.ndarray:
        v = np.asarray(self.evaluate(**kw))
        if self.ndim == 2 and v.ndim == 1:
            v = v.reshape(self.shape)
        return v

    def item(self):
        return self.to_numpy().item()

    def __str__(self) -> str:  # print() is an evaluation point (paper §4)
        return str(self.to_numpy())

    def __len__(self) -> int:
        return self.shape[0]

    # -- elementwise operators ----------------------------------------------

    def _binop(self, other, op: str, reverse: bool = False) -> "ndarray":
        if self.is_eager:
            o = other._eager if isinstance(other, ndarray) else other
            a, b = (o, self._eager) if reverse else (self._eager, o)
            out = _np_result(op, a, b)
            return ndarray(None, out.shape, out.dtype, eager_data=out)
        if isinstance(other, ndarray):
            assert other.shape == self.shape, "weldnp: shape mismatch"
            out_dt = np.promote_types(self.dtype, other.dtype) \
                if op not in _CMP else np.dtype(bool)
            sid, oid = self._ident(), other._ident()
            l, r = (oid, sid) if reverse else (sid, oid)
            lt = other.weld_elem_ty if reverse else self.weld_elem_ty
            rt = self.weld_elem_ty if reverse else other.weld_elem_ty
            tgt = wt.dtype_to_weld(np.promote_types(self.dtype, other.dtype))
            expr = M.zip_map(
                [l, r],
                lambda x, y: ir.BinOp(op, _coerce(x, lt, tgt), _coerce(y, rt, tgt)),
            )
            obj = NewWeldObject([self.obj, other.obj], expr)
            return ndarray(obj, self.shape, out_dt)
        # scalar operand
        out_dt = np.promote_types(self.dtype, np.result_type(other)) \
            if op not in _CMP else np.dtype(bool)
        tgt = wt.dtype_to_weld(np.promote_types(self.dtype, np.result_type(other)))
        lit = _scalar_lit(other, tgt)
        me = self.weld_elem_ty
        fn = (lambda x: ir.BinOp(op, lit, _coerce(x, me, tgt))) if reverse \
            else (lambda x: ir.BinOp(op, _coerce(x, me, tgt), lit))
        expr = M.map_(self._ident(), fn)
        obj = NewWeldObject([self.obj], expr)
        return ndarray(obj, self.shape, out_dt)

    def __add__(self, o):
        return self._binop(o, "+")

    def __radd__(self, o):
        return self._binop(o, "+", reverse=True)

    def __sub__(self, o):
        return self._binop(o, "-")

    def __rsub__(self, o):
        return self._binop(o, "-", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "*")

    def __rmul__(self, o):
        return self._binop(o, "*", reverse=True)

    def __truediv__(self, o):
        return self._binop(o, "/")

    def __rtruediv__(self, o):
        return self._binop(o, "/", reverse=True)

    def __gt__(self, o):
        return self._binop(o, ">")

    def __ge__(self, o):
        return self._binop(o, ">=")

    def __lt__(self, o):
        return self._binop(o, "<")

    def __le__(self, o):
        return self._binop(o, "<=")

    def __eq__(self, o):  # type: ignore[override]
        return self._binop(o, "==")

    def __ne__(self, o):  # type: ignore[override]
        return self._binop(o, "!=")

    def __and__(self, o):
        return self._binop(o, "&&")

    def __or__(self, o):
        return self._binop(o, "||")

    def __neg__(self):
        return self._unary("neg")

    def __hash__(self):
        return id(self)

    def _unary(self, op: str, out_float: bool = False) -> "ndarray":
        if self.is_eager:
            out = np.asarray(_np_unary(op, self._eager))
            return ndarray(None, out.shape, out.dtype, eager_data=out)
        expr = M.map_(self._ident(), lambda x: ir.UnaryOp(op, x))
        obj = NewWeldObject([self.obj], expr)
        dt = self.dtype
        if op in ("exp", "log", "sqrt", "erf", "sin", "cos", "tanh",
                  "sigmoid", "rsqrt"):
            dt = np.promote_types(self.dtype, np.float64) \
                if self.dtype.kind in "iub" else self.dtype
        return ndarray(obj, self.shape, dt)

    # -- reductions & linalg ---------------------------------------------------

    def sum(self) -> "ndarray":
        return self._reduce("+")

    def prod(self) -> "ndarray":
        return self._reduce("*")

    def min(self) -> "ndarray":
        return self._reduce("min")

    def max(self) -> "ndarray":
        return self._reduce("max")

    def _reduce(self, op: str) -> "ndarray":
        if self.is_eager:
            fn = {"+": np.sum, "*": np.prod, "min": np.min, "max": np.max}[op]
            out = np.asarray(fn(self._eager))
            return ndarray(None, (), out.dtype, eager_data=out)
        expr = M.reduce_(self._ident(), op)
        obj = NewWeldObject([self.obj], expr)
        return ndarray(obj, (), self.dtype)

    def dot(self, other: "ndarray") -> "ndarray":
        if self.is_eager:
            return ndarray(None, np.dot(self._eager, other._eager).shape, None,
                           eager_data=np.dot(self._eager, other._eager))
        if self.ndim == 1 and other.ndim == 1:
            expr = M.dot(self._ident(), other._ident())
            obj = NewWeldObject([self.obj, other.obj], expr)
            return ndarray(obj, (), np.promote_types(self.dtype, other.dtype))
        if self.ndim == 2 and other.ndim == 1:
            expr = ir.CUDF(
                "linalg.matvec", (self._ident(), other._ident()),
                wt.Vec(wt.dtype_to_weld(np.promote_types(self.dtype, other.dtype))),
            )
            obj = NewWeldObject([self.obj, other.obj], expr)
            return ndarray(obj, (self.shape[0],),
                           np.promote_types(self.dtype, other.dtype))
        if self.ndim == 2 and other.ndim == 2:
            expr = ir.CUDF(
                "linalg.matmul", (self._ident(), other._ident()),
                wt.Vec(wt.Vec(wt.dtype_to_weld(
                    np.promote_types(self.dtype, other.dtype)))),
            )
            obj = NewWeldObject([self.obj, other.obj], expr)
            return ndarray(obj, (self.shape[0], other.shape[1]),
                           np.promote_types(self.dtype, other.dtype))
        raise ValueError("unsupported dot shapes")

    def astype(self, dtype) -> "ndarray":
        dtype = np.dtype(dtype)
        if self.is_eager:
            return ndarray(None, self.shape, dtype,
                           eager_data=self._eager.astype(dtype))
        ty = wt.dtype_to_weld(dtype)
        expr = M.map_(self._ident(), lambda x: ir.Cast(x, ty))
        return ndarray(NewWeldObject([self.obj], expr), self.shape, dtype)


_CMP = {"==", "!=", "<", "<=", ">", ">="}


def _coerce(x: ir.Expr, have: wt.Scalar, want: wt.Scalar) -> ir.Expr:
    return x if have == want else ir.Cast(x, want)


def _np_result(op, a, b):
    return {
        "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
        ">": np.greater, ">=": np.greater_equal, "<": np.less,
        "<=": np.less_equal, "==": np.equal, "!=": np.not_equal,
        "&&": np.logical_and, "||": np.logical_or,
    }[op](a, b)


def _np_unary(op, a):
    try:
        from scipy.special import erf as _erf  # pragma: no cover
    except Exception:
        _erf = np.vectorize(math.erf)
    return {
        "neg": np.negative, "not": np.logical_not, "exp": np.exp,
        "log": np.log, "sqrt": np.sqrt, "erf": _erf, "sin": np.sin,
        "cos": np.cos, "tanh": np.tanh, "abs": np.abs,
        "sigmoid": lambda x: 1 / (1 + np.exp(-x)), "floor": np.floor,
        "rsqrt": lambda x: 1 / np.sqrt(x),
    }[op](a)


# -- module-level API (numpy-like) ------------------------------------------


def array(data, dtype=None, eager: bool = False) -> ndarray:
    arr = np.asarray(data, dtype=dtype)
    return ndarray.from_numpy(arr, eager=eager)


def exp(a: ndarray) -> ndarray:
    return a._unary("exp")


def log(a: ndarray) -> ndarray:
    return a._unary("log")


def sqrt(a: ndarray) -> ndarray:
    return a._unary("sqrt")


def erf(a: ndarray) -> ndarray:
    return a._unary("erf")


def tanh(a: ndarray) -> ndarray:
    return a._unary("tanh")


def sigmoid(a: ndarray) -> ndarray:
    return a._unary("sigmoid")


def abs(a: ndarray) -> ndarray:  # noqa: A001
    return a._unary("abs")


def dot(a: ndarray, b: ndarray) -> ndarray:
    return a.dot(b)


def sum(a: ndarray) -> ndarray:  # noqa: A001
    return a.sum()


def minimum(a: ndarray, o: Number) -> ndarray:
    return a._binop(o, "min")


def maximum(a: ndarray, o: Number) -> ndarray:
    return a._binop(o, "max")


def where(cond: ndarray, a, b) -> ndarray:
    """Elementwise select (predicated — no branch)."""
    if cond.is_eager:
        av = a._eager if isinstance(a, ndarray) else a
        bv = b._eager if isinstance(b, ndarray) else b
        out = np.where(cond._eager, av, bv)
        return ndarray(None, out.shape, out.dtype, eager_data=out)
    deps = [cond.obj]
    ids = [ir.Ident(cond.obj.obj_id, cond.obj.weld_type())]
    sels = []
    for v in (a, b):
        if isinstance(v, ndarray):
            deps.append(v.obj)
            ids.append(v._ident())
            sels.append(None)
        else:
            sels.append(v)
    dt = np.promote_types(
        a.dtype if isinstance(a, ndarray) else np.result_type(a),
        b.dtype if isinstance(b, ndarray) else np.result_type(b),
    )
    tgt = wt.dtype_to_weld(dt)

    def body(*xs):
        c = xs[0]
        vals = list(xs[1:])
        out = []
        for v in (a, b):
            if isinstance(v, ndarray):
                out.append(_coerce(vals.pop(0), v.weld_elem_ty, tgt))
            else:
                out.append(_scalar_lit(v, tgt))
        return ir.Select(c, out[0], out[1])

    expr = M.zip_map(ids, body)
    return ndarray(NewWeldObject(deps, expr), cond.shape, dt)
