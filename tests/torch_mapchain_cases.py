"""Map bodies that exercise every node and operator the map-chain
generator covers (``repro_torch.kernels.map_chain``), with numpy columns
made from a seed.  Shared by the CPU test that compiles each generated
body as host C++ (``test_torch_arrays.py``) and the card's test that
launches it (``test_torch_cuda.py``).  Imports nothing of JAX.

Each case is ``(columns, body, exactness, free scalars)``: ``columns``
lists (numpy dtype, data kind); ``exactness`` is "bitwise" for IEEE-exact
arithmetic (+ - * /, %, min/max, neg/abs/floor, casts, selects,
literals), "libm" for transcendental calls and ``pow`` (held to f64 rtol
1e-12, f32 rtol 1e-5), "sqrt" for bodies whose only inexact step is
``sqrt`` (IEEE on the card; PyTorch's vectorized CPU kernel is 1 ulp off
on some inputs, so the CPU holds it as libm), and "exact" for integers
and bools.  The names in ``CARD_ONLY`` (integer zero divisors) run only
on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ir as t_ir
from repro_torch.core import wtypes as t_wt

F64, F32, I64, I32, I8, BOOL = (np.float64, np.float32, np.int64, np.int32,
                                np.int8, np.bool_)
_KIND = {F64: "f64", F32: "f32", I64: "i64", I32: "i32", I8: "i8",
         BOOL: "bool"}


def column(rng, dtype, n, kind):
    if dtype == BOOL:
        return rng.rand(n) < 0.5
    if np.issubdtype(dtype, np.floating):
        v = rng.randn(n) * 3.0
        if kind == "special":
            v[::7] = np.nan
            v[1::11] = np.inf
            v[2::13] = -np.inf
            v[3::5] = 0.0
            v[4::17] = -0.0
        return v.astype(dtype)
    lo, hi = {I8: (-100, 100), I32: (-50_000, 50_000),
              I64: (-10**12, 10**12)}[dtype]
    if kind == "small":
        lo, hi = -9, 10
    v = rng.randint(lo, hi, n).astype(dtype)
    if kind == "divisor":  # no zero divisor (the CPU generic path raises)
        v[v == 0] = 1
        v[::9] = -1
    if kind == "zero_divisor":  # the card's cases only
        v[::9] = -1
        v[1::4] = 0
    if kind == "huge" and dtype != I8:
        v = (rng.randint(-2**31 + 1, 2**31 - 1, n)).astype(dtype) * (
            2**31 if dtype == I64 else 1)
    return v


def _lit(v, kind):
    return t_ir.Literal(v, t_wt.Scalar(kind))


def _un(op, e):
    return t_ir.UnaryOp(op, e)


def _bin(op, a, b):
    return t_ir.BinOp(op, a, b)


#: name -> (column (dtype, kind) list, body(cols) builder, exactness,
#: free scalars {name: (value, struct type or None)})
GEN_CASES = {}
#: cases only the card runs: an integer zero divisor traps on a host CPU
#: and the generic emitter's CPU path raises, while PyTorch's CUDA integer
#: div and fmod return the card's value, which the kernel must match
CARD_ONLY = set()


def _case(name, cols, exact, scalars=None):
    def deco(fn):
        GEN_CASES[name] = (cols, fn, exact, scalars or {})
        return fn
    return deco


for _dt in (F64, F32):
    _k = _KIND[_dt]

    @_case(f"arith_{_k}", [(_dt, "special"), (_dt, "plain")], "bitwise")
    def _arith(c, k=_k):
        a, b = c
        return _bin("-", _bin("*", _bin("+", a, b), a),
                    _bin("/", b, _bin("+", _bin("*", a, a), _lit(1.0, k))))

    @_case(f"sqrt_{_k}", [(_dt, "plain"), (_dt, "special")], "sqrt")
    def _sqrt(c):
        return _un("sqrt", _bin("+", _bin("*", c[0], c[0]),
                                _bin("*", c[1], c[1])))

    for _op in ("exp", "log", "erf", "sin", "cos", "tanh", "sigmoid",
                "rsqrt"):
        @_case(f"{_op}_{_k}", [(_dt, "special")], "libm")
        def _float_unary(c, op=_op):
            return _bin("*", _un(op, c[0]), c[0])

    for _op in ("neg", "abs", "floor"):
        @_case(f"{_op}_{_k}", [(_dt, "special")], "bitwise")
        def _plain_unary(c, op=_op):
            return _bin("+", _un(op, c[0]), c[0])

    @_case(f"rem_{_k}", [(_dt, "special"), (_dt, "special")], "bitwise")
    def _rem(c):
        return _bin("%", c[0], c[1])

    @_case(f"pow_{_k}", [(_dt, "plain"), (_dt, "plain")], "libm")
    def _pow(c):
        return _bin("pow", _un("abs", c[0]), c[1])

    @_case(f"minmax_nan_{_k}", [(_dt, "special"), (_dt, "special")],
           "bitwise")
    def _minmax(c, k=_k):
        return _bin("+", _bin("min", c[0], c[1]),
                    _bin("max", c[1], _lit(0.5, k)))

for _dt in (I64, I32, I8):
    _k = _KIND[_dt]

    @_case(f"int_div_mod_{_k}", [(_dt, "plain"), (_dt, "divisor")], "exact")
    def _int_div_mod(c):
        return _bin("+", _bin("/", c[0], c[1]), _bin("%", c[0], c[1]))

    @_case(f"int_div_mod_zero_{_k}", [(_dt, "plain"), (_dt, "zero_divisor")],
           "exact")
    def _int_div_mod_zero(c):
        return _bin("+", _bin("/", c[0], c[1]), _bin("%", c[0], c[1]))

    CARD_ONLY.add(f"int_div_mod_zero_{_k}")

    @_case(f"int_wrap_{_k}", [(_dt, "huge"), (_dt, "huge")], "exact")
    def _int_wrap(c):
        return _bin("-", _bin("*", c[0], c[1]), _bin("+", c[0], c[1]))

    @_case(f"int_unary_{_k}", [(_dt, "plain")], "exact")
    def _int_unary(c):
        return _bin("+", _un("neg", c[0]),
                    _bin("*", _un("abs", c[0]), _un("floor", c[0])))

    @_case(f"int_minmax_pow_{_k}", [(_dt, "small"), (_dt, "small")], "exact")
    def _int_minmax_pow(c):
        return _bin("+", _bin("pow", c[0], c[1]),
                    _bin("max", _bin("min", c[0], c[1]), c[1]))

    @_case(f"int_to_float_{_k}", [(_dt, "plain"), (F32, "plain")], "libm")
    def _int_to_float(c):
        # the generic emitter computes exp/sqrt/sigmoid of an integer in
        # f64, then promotes against the f32 column
        return _bin("+", _bin("*", _un("sigmoid", c[0]), c[1]),
                    _un("sqrt", _un("abs", c[0])))


@_case("compare_logic", [(F64, "special"), (F64, "plain"), (BOOL, "plain")],
       "exact")
def _compare_logic(c):
    a, b, p = c
    acc = _lit(0, "i64")
    for k, op in enumerate(("==", "!=", "<", "<=", ">", ">=")):
        bit = t_ir.Select(_bin(op, a, b), _lit(1 << k, "i64"), _lit(0, "i64"))
        acc = _bin("+", acc, bit)
    both = _bin("&&", p, _bin(">", a, _lit(0.0, "f64")))
    either = _bin("||", _un("not", p), _bin("<", b, _lit(0.0, "f64")))
    return _bin("+", acc, _bin("+", t_ir.Cast(both, t_wt.Scalar("i64")),
                               _bin("*", t_ir.Cast(either, t_wt.Scalar("i64")),
                                    _lit(100, "i64"))))


@_case("casts", [(F64, "plain"), (I64, "plain"), (I32, "plain")], "exact")
def _casts(c):
    a, i, j = c
    S = t_wt.Scalar
    parts = [
        t_ir.Cast(a, S("i64")),                       # truncation
        t_ir.Cast(t_ir.Cast(a, S("i32")), S("i64")),
        t_ir.Cast(t_ir.Cast(i, S("i8")), S("i64")),   # wrap
        t_ir.Cast(t_ir.Cast(a, S("bool")), S("i64")),
        t_ir.Cast(j, S("i64")),
        t_ir.Cast(t_ir.Cast(t_ir.Cast(i, S("f32")), S("f64")), S("i64")),
        t_ir.Cast(t_ir.Cast(t_ir.Cast(a, S("f32")), S("f64")), S("i64")),
    ]
    out = parts[0]
    for p in parts[1:]:
        out = _bin("+", _bin("*", out, _lit(3, "i64")), p)
    return out


@_case("select_if_bool", [(F64, "plain"), (BOOL, "plain"), (I32, "plain")],
       "bitwise")
def _select_if(c):
    a, p, j = c
    sel = t_ir.Select(p, a, _un("neg", a))
    iff = t_ir.If(_bin("&&", p, _lit(True, "bool")),
                  t_ir.Cast(j, t_wt.Scalar("f64")),
                  t_ir.Cast(_lit(False, "bool"), t_wt.Scalar("f64")))
    return _bin("+", sel, _bin("*", iff, t_ir.Cast(p, t_wt.Scalar("f64"))))


@_case("literals", [(F64, "plain"), (F32, "plain"), (I64, "plain")],
       "bitwise")
def _literals(c):
    a, f, i = c
    f64, S = t_wt.F64, t_wt.Scalar
    t1 = _bin("+", _bin("*", a, _lit(0.1, "f64")), _lit(1e-300, "f64"))
    t2 = t_ir.Cast(_bin("+", f, _lit(0.1, "f32")), f64)
    nan = _lit(float("nan"), "f32")
    t3 = t_ir.Cast(_bin("!=", nan, nan), f64)
    imin = _lit(-2**63, "i64")
    t4 = t_ir.Cast(_bin("==", _bin("min", i, imin), imin), f64)
    t5 = t_ir.Cast(_bin("max", i, imin), f64)
    minus_inf = _bin("/", _lit(1.0, "f64"), _lit(-0.0, "f64"))
    t6 = t_ir.Select(_bin("<", a, minus_inf), a, _lit(2.0, "f64"))
    t7 = t_ir.Cast(_bin(">", _lit(float("inf"), "f64"), a), S("f64"))
    out = t1
    for t in (t2, t3, t4, t5, t6, t7):
        out = _bin("+", out, t)
    return out


@_case("free_scalars", [(F64, "plain"), (I64, "plain")], "bitwise",
       scalars={"bias": (np.float64(0.25), None),
                "pair": ((np.int64(3), np.float64(-1.5)),
                         t_wt.Struct((t_wt.I64, t_wt.F64)))})
def _free_scalars(c):
    a, i = c
    bias = t_ir.Ident("bias", t_wt.F64)
    pair = t_ir.Ident("pair", t_wt.Struct((t_wt.I64, t_wt.F64)))
    scaled = _bin("*", t_ir.Cast(_bin("*", i, t_ir.GetField(pair, 0)),
                                 t_wt.F64), t_ir.GetField(pair, 1))
    return _bin("+", _bin("+", a, bias), scaled)


def gen_lambda(cols, fn):
    kinds = [t_wt.Scalar(_KIND[dt]) for dt, _ in cols]
    xty = kinds[0] if len(kinds) == 1 else t_wt.Struct(tuple(kinds))
    i = t_ir.Ident("i%gen", t_wt.I64)
    x = t_ir.Ident("x%gen", xty)
    leaves = [x] if len(kinds) == 1 else [t_ir.GetField(x, k)
                                          for k in range(len(kinds))]
    return t_ir.Lambda((i, x), fn(leaves))


def plain_env(scalars: dict, device) -> dict:
    """The free scalars of a case as the generic emitter's env holds them
    (0-dim tensors; a struct as a tuple of them)."""
    return {k: (tuple(torch.tensor(x, device=device) for x in v)
                if ty is not None else torch.tensor(v, device=device))
            for k, (v, ty) in scalars.items()}
