"""Weld type system (paper §3.1, Table 1).

Scalars, variable-length vectors, structs and dictionaries, plus the five
builder types. Types are immutable, hashable dataclasses so they can key
compile caches and be embedded in IR nodes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np


class WeldType:
    """Base class for all Weld types."""

    def __str__(self) -> str:  # pragma: no cover - overridden
        return self.__class__.__name__


class WeldTypeError(TypeError):
    pass


# ---------------------------------------------------------------------------
# Value types
# ---------------------------------------------------------------------------

_SCALAR_KINDS = ("bool", "i8", "i32", "i64", "f32", "f64")

_NUMPY_DTYPES = {
    "bool": np.bool_,
    "i8": np.int8,
    "i32": np.int32,
    "i64": np.int64,
    "f32": np.float32,
    "f64": np.float64,
}


@dataclass(frozen=True)
class Scalar(WeldType):
    kind: str

    def __post_init__(self):
        if self.kind not in _SCALAR_KINDS:
            raise WeldTypeError(f"unknown scalar kind {self.kind!r}")

    @property
    def is_float(self) -> bool:
        return self.kind in ("f32", "f64")

    @property
    def is_int(self) -> bool:
        return self.kind in ("i8", "i32", "i64")

    @property
    def np_dtype(self):
        return _NUMPY_DTYPES[self.kind]

    def __str__(self) -> str:
        return self.kind


Bool = Scalar("bool")
I8 = Scalar("i8")
I32 = Scalar("i32")
I64 = Scalar("i64")
F32 = Scalar("f32")
F64 = Scalar("f64")


@dataclass(frozen=True)
class Vec(WeldType):
    elem: WeldType

    def __str__(self) -> str:
        return f"vec[{self.elem}]"


@dataclass(frozen=True)
class Struct(WeldType):
    fields: Tuple[WeldType, ...]

    def __str__(self) -> str:
        return "{" + ",".join(str(f) for f in self.fields) + "}"


@dataclass(frozen=True)
class DictType(WeldType):
    key: WeldType
    val: WeldType

    def __str__(self) -> str:
        return f"dict[{self.key},{self.val}]"


@dataclass(frozen=True)
class Fn(WeldType):
    params: Tuple[WeldType, ...]
    ret: WeldType

    def __str__(self) -> str:
        return "(" + ",".join(str(p) for p in self.params) + f")=>{self.ret}"


# ---------------------------------------------------------------------------
# Builder types (Table 1).  Builders are linear: consumed exactly once per
# control path.  `result_type()` gives the type produced by result(b).
# ---------------------------------------------------------------------------

#: Commutative merge functions supported by merger-family builders.
MERGE_OPS = ("+", "*", "min", "max")


class BuilderType(WeldType):
    def result_type(self) -> WeldType:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass(frozen=True)
class VecBuilder(BuilderType):
    """Builds vec[elem] by appending merged values."""

    elem: WeldType

    def result_type(self) -> WeldType:
        return Vec(self.elem)

    def __str__(self) -> str:
        return f"vecbuilder[{self.elem}]"


@dataclass(frozen=True)
class Merger(BuilderType):
    """Builds a scalar/struct of type `elem` by commutative `op`."""

    elem: WeldType
    op: str = "+"

    def __post_init__(self):
        if self.op not in MERGE_OPS:
            raise WeldTypeError(f"merger op {self.op!r} not commutative")

    def result_type(self) -> WeldType:
        return self.elem

    def __str__(self) -> str:
        return f"merger[{self.elem},{self.op}]"


@dataclass(frozen=True)
class DictMerger(BuilderType):
    """Builds dict[key,val] merging {k,v} pairs with commutative `op`."""

    key: WeldType
    val: WeldType
    op: str = "+"

    def __post_init__(self):
        if self.op not in MERGE_OPS:
            raise WeldTypeError(f"dictmerger op {self.op!r} not commutative")

    def merge_type(self) -> WeldType:
        return Struct((self.key, self.val))

    def result_type(self) -> WeldType:
        return DictType(self.key, self.val)

    def __str__(self) -> str:
        return f"dictmerger[{self.key},{self.val},{self.op}]"


@dataclass(frozen=True)
class VecMerger(BuilderType):
    """Builds vec[elem] by merging {index, elem} into existing cells."""

    elem: WeldType
    op: str = "+"

    def __post_init__(self):
        if self.op not in MERGE_OPS:
            raise WeldTypeError(f"vecmerger op {self.op!r} not commutative")

    def merge_type(self) -> WeldType:
        return Struct((I64, self.elem))

    def result_type(self) -> WeldType:
        return Vec(self.elem)

    def __str__(self) -> str:
        return f"vecmerger[{self.elem},{self.op}]"


@dataclass(frozen=True)
class GroupBuilder(BuilderType):
    """Builds dict[key, vec[val]] grouping {k,v} pairs by key."""

    key: WeldType
    val: WeldType

    def merge_type(self) -> WeldType:
        return Struct((self.key, self.val))

    def result_type(self) -> WeldType:
        return DictType(self.key, Vec(self.val))

    def __str__(self) -> str:
        return f"groupbuilder[{self.key},{self.val}]"


@dataclass(frozen=True)
class StructBuilder(BuilderType):
    """A struct of builders: a single for-loop can merge into several."""

    builders: Tuple[BuilderType, ...]

    def result_type(self) -> WeldType:
        return Struct(tuple(b.result_type() for b in self.builders))

    def __str__(self) -> str:
        return "{" + ",".join(str(b) for b in self.builders) + "}"


def is_builder(ty: WeldType) -> bool:
    return isinstance(ty, BuilderType)


def elem_bytes(ty: WeldType) -> int:
    """Widest scalar element width (bytes) reachable in a value type —
    the byte-per-element figure the kernel planner's cost model and the
    emitter's memory accounting both price traffic with."""
    if isinstance(ty, Struct):
        return max((elem_bytes(f) for f in ty.fields), default=8)
    if isinstance(ty, Vec):
        return elem_bytes(ty.elem)
    if isinstance(ty, DictType):
        return elem_bytes(ty.val)
    if isinstance(ty, Scalar):
        return int(np.dtype(ty.np_dtype).itemsize)
    return 8


def merge_identity(op: str, ty: Scalar):
    """Identity element of a commutative merge op, as a python scalar."""
    if op == "+":
        return False if ty.kind == "bool" else ty.np_dtype(0).item()
    if op == "*":
        return True if ty.kind == "bool" else ty.np_dtype(1).item()
    info = (np.finfo if ty.is_float else np.iinfo)(ty.np_dtype)
    if op == "min":
        return float(info.max) if ty.is_float else int(info.max)
    if op == "max":
        return float(info.min) if ty.is_float else int(info.min)
    raise WeldTypeError(f"no identity for op {op}")


def dtype_to_weld(dt) -> Scalar:
    dt = np.dtype(dt)
    table = {
        np.dtype(np.bool_): Bool,
        np.dtype(np.int8): I8,
        np.dtype(np.int32): I32,
        np.dtype(np.int64): I64,
        np.dtype(np.float32): F32,
        np.dtype(np.float64): F64,
    }
    if dt in table:
        return table[dt]
    # bf16 arrives from jax; treat as f32 at the IR level.
    if dt.name == "bfloat16":
        return F32
    if dt == np.dtype(np.float16):
        return F32
    if dt in (np.dtype(np.uint8),):
        return I32
    raise WeldTypeError(f"unsupported dtype {dt}")
