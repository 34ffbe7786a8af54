"""Symbolic sizes and the interval lattice for weldbound.

A ``Sym`` is a tiny symbolic integer expression over input lengths
(``len(in_k)``), constants, and the arithmetic the IR's static size
evaluator understands (``+ - * / min max``).  ``evaluate`` mirrors the
backend's ``_static_eval`` exactly — same operator set, same truncating
division, same "unresolvable -> None" contract — so a certificate
evaluated at bind time charges byte-for-byte what the emitter would
charge at trace time.

``Interval`` is the nonnegative-size abstract domain ``[lo, hi]`` the
bounds interpreter computes in: ``lo`` is a proven lower bound (unknown
degrades to 0), ``hi`` a proven upper bound (unknown degrades to +inf).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

#: sentinel for "unbounded" — compares/propagates like IEEE infinity.
INF = math.inf

Shapes = Dict[str, Tuple[int, ...]]


class Sym:
    """Base class for symbolic size expressions."""

    __slots__ = ()


@dataclass(frozen=True)
class SConst(Sym):
    value: float  # int or INF


@dataclass(frozen=True)
class SLen(Sym):
    """``len(name)`` — leading dimension of the input bound to ``name``."""

    name: str


@dataclass(frozen=True)
class SOp(Sym):
    op: str  # + - * / min max
    left: Sym
    right: Sym


class SCall(Sym):
    """An opaque kernel-footprint term: a closure over the registry's
    footprint hook, resolved only when concrete shapes are bound.  Kept
    out of the dataclass family on purpose — equality is identity (two
    calls to the same kernel are distinct charges)."""

    __slots__ = ("kernel", "fn", "display")

    def __init__(self, kernel: str, fn: Callable[[Shapes], int],
                 display: Optional[Sym] = None):
        self.kernel = kernel
        self.fn = fn
        self.display = display


# -- folding constructors -------------------------------------------------


def const(v: Union[int, float]) -> SConst:
    return SConst(INF if v == INF else int(v))


def length(name: str) -> SLen:
    return SLen(name)


def _is_const(s: Sym, v: Optional[float] = None) -> bool:
    return isinstance(s, SConst) and (v is None or s.value == v)


def add(a: Sym, b: Sym) -> Sym:
    if isinstance(a, SConst) and isinstance(b, SConst):
        return const(a.value + b.value)
    if _is_const(a, 0):
        return b
    if _is_const(b, 0):
        return a
    return SOp("+", a, b)


def sub(a: Sym, b: Sym) -> Sym:
    if isinstance(a, SConst) and isinstance(b, SConst):
        return const(a.value - b.value)
    if _is_const(b, 0):
        return a
    return SOp("-", a, b)


def mul(a: Sym, b: Sym) -> Sym:
    if _is_const(a, 0) or _is_const(b, 0):
        return const(0)
    if isinstance(a, SConst) and isinstance(b, SConst):
        return const(a.value * b.value)
    if _is_const(a, 1):
        return b
    if _is_const(b, 1):
        return a
    return SOp("*", a, b)


def div(a: Sym, b: Sym) -> Sym:
    if isinstance(a, SConst) and isinstance(b, SConst):
        return const(_apply("/", a.value, b.value))
    return SOp("/", a, b)


def smin(a: Sym, b: Sym) -> Sym:
    if a == b:
        return a
    if isinstance(a, SConst) and isinstance(b, SConst):
        return const(min(a.value, b.value))
    if _is_const(a, INF):
        return b
    if _is_const(b, INF):
        return a
    return SOp("min", a, b)


def smax(a: Sym, b: Sym) -> Sym:
    if a == b:
        return a
    if isinstance(a, SConst) and isinstance(b, SConst):
        return const(max(a.value, b.value))
    if _is_const(a, INF) or _is_const(b, INF):
        return const(INF)
    # sizes are nonnegative, so max(x, 0) = x
    if _is_const(a, 0):
        return b
    if _is_const(b, 0):
        return a
    return SOp("max", a, b)


# -- evaluation (mirrors torchgen._static_eval) -----------------------------


def _apply(op: str, a: float, b: float) -> float:
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        # interval arithmetic can pair 0 with INF (zero iterations of an
        # unbounded body): the product of sizes is still 0
        if a == 0 or b == 0:
            return 0
        v = a * b
        return v if v == INF or v == -INF else int(v)
    if op == "/":
        if b == 0:
            return 0  # mirror: the emitter's static eval yields 0 on /0
        if a == INF:
            return INF
        if b == INF:
            return 0
        return int(a / b)
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    raise ValueError(f"unknown sym op {op}")


def evaluate(s: Sym, shapes: Shapes) -> Optional[float]:
    """Resolve ``s`` against concrete input shapes.  Returns an int (or
    ``INF`` for unbounded constants), or None when a referenced input is
    absent from ``shapes`` — the same "can't resolve" answer the
    emitter's ``_static_eval`` gives, under which it charges nothing."""
    if isinstance(s, SConst):
        return s.value
    if isinstance(s, SLen):
        shp = shapes.get(s.name)
        if shp is None or not len(shp):
            return None
        return int(shp[0])
    if isinstance(s, SOp):
        a = evaluate(s.left, shapes)
        b = evaluate(s.right, shapes)
        if a is None or b is None:
            return None
        return _apply(s.op, a, b)
    if isinstance(s, SCall):
        try:
            return int(s.fn(shapes))
        except Exception:
            return 0  # mirror: the emitter swallows footprint errors as 0
    return None


def render(s: Sym, rename: Optional[Dict[str, str]] = None) -> str:
    """Human-readable form: ``len(in0)*len(in1)`` / ``min(a, b)`` /
    ``fp[hash_probe](len(in0))``."""
    rename = rename or {}
    if isinstance(s, SConst):
        return "inf" if s.value == INF else str(int(s.value))
    if isinstance(s, SLen):
        return f"len({rename.get(s.name, s.name)})"
    if isinstance(s, SOp):
        a, b = render(s.left, rename), render(s.right, rename)
        if s.op in ("min", "max"):
            return f"{s.op}({a}, {b})"
        if isinstance(s.left, SOp) and s.left.op not in ("min", "max"):
            a = f"({a})"
        if isinstance(s.right, SOp) and s.right.op not in ("min", "max"):
            b = f"({b})"
        return f"{a}{s.op}{b}"
    if isinstance(s, SCall):
        inner = render(s.display, rename) if s.display is not None else "..."
        return f"fp[{s.kernel}]({inner})"
    return "?"


# -- the interval domain --------------------------------------------------


@dataclass(frozen=True)
class Interval:
    """``[lo, hi]`` over nonnegative sizes, both bounds symbolic."""

    lo: Sym
    hi: Sym

    def add(self, other: "Interval") -> "Interval":
        return Interval(add(self.lo, other.lo), add(self.hi, other.hi))

    def mul(self, other: "Interval") -> "Interval":
        # both operands nonnegative: lo*lo / hi*hi are the extremes
        return Interval(mul(self.lo, other.lo), mul(self.hi, other.hi))

    def join(self, other: "Interval") -> "Interval":
        return Interval(smin(self.lo, other.lo), smax(self.hi, other.hi))

    def lo_val(self, shapes: Shapes) -> int:
        """Concrete sound lower bound (unknown degrades to 0)."""
        v = evaluate(self.lo, shapes)
        if v is None or v == INF:
            return 0
        return max(0, int(v))

    def hi_val(self, shapes: Shapes) -> float:
        """Concrete sound upper bound (unknown degrades to +inf)."""
        v = evaluate(self.hi, shapes)
        if v is None:
            return INF
        return v if v == INF else max(0, int(v))

    def render(self, rename: Optional[Dict[str, str]] = None) -> str:
        return f"[{render(self.lo, rename)}, {render(self.hi, rename)}]"


def point(s: Sym) -> Interval:
    return Interval(s, s)


def top() -> Interval:
    return Interval(const(0), const(INF))


ZERO = point(const(0))
ONE = point(const(1))
