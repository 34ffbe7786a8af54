"""Fused elementwise map chains: one CUDA kernel generated per IR body.

The Weld optimizer collapses a chain of library map operators into ONE
loop; the planner routes that loop here so the whole chain runs as a
single pass over its columns:

    result(for(v1..vk, vecbuilder, (b,i,x) => merge(b, f(x))))

The port of the TPU kernel ``map_elementwise`` (repro/kernels/map_chain.py:
``map_elementwise`` :33, body :52, ``pallas_call`` :57).  A fixed CUDA
kernel cannot take an arbitrary body, so :func:`emit_source` turns the
body (an ``ir.Lambda`` ``(i, x) => f(x)``) into C source: one
``__global__`` with a grid-stride loop over a 64-bit index, k input
pointers of their columns' own types, the loop's free scalars as device
pointers read once, one output, and the body in registers — no
intermediate touches device memory (the paper's fusion argument).  Bound
on the H100: bytes (k inputs read once, one output written), unless the
body is long in transcendental calls.

Semantics follow the generic emitter (``torchgen``) exactly: operands
promote as ``torch.promote_types`` with no weak scalars; integers turn
into f64 before ``exp log sqrt erf sin cos tanh sigmoid rsqrt``; integer
``+ - *`` wrap, integer ``/`` truncates toward zero and integer ``%`` is
``fmod``, each C's ``/`` or ``%`` in a function of its own, as in
PyTorch's CUDA kernels (so a zero divisor, whose value C leaves to the
machine, gives the card's value on both routes; the generic emitter's
CPU path raises there); float ``%`` is ``torch.remainder`` (``fmod``,
plus the divisor when the signs differ); ``min``/``max`` propagate NaN as
``torch.minimum``/``torch.maximum`` do; ``sigmoid`` is
``1/(1+exp(-x))`` and ``rsqrt`` ``1/sqrt(x)``.  Every node gets an
explicit C type.  A body the generator cannot emit raises
:class:`Unsupported`; the planner asks at match time and leaves such a
loop to the generic emitter.

Each body is emitted with a qualifier macro (``WELD_QUAL``), so the same
text compiles as host C++ with ``-DWELD_MC_HOST`` (the CPU tests do so).
On the card it is built by ``nvcc`` for ``sm_90a`` with ``-fmad=false``
and without fast math (``_build.build_generated``: one shared library
per source, cached on disk by the source's hash and in process, bounded
as the compile cache is), when the program is compiled.  The wrapper
counts launches in ``.launches`` and plain-version calls in
``.plain_calls``.
"""
from __future__ import annotations

import ctypes
import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import ir
from ..core import wtypes as wt
from . import _build, _count
from .ref import map_elementwise as map_elementwise_plain

THREADS = 256
#: the default grid cap (the kernel strides over the rows by its grid)
MAX_BLOCKS = 4096
#: the caps the autotuner times (kernelplan/registry.py): 2, 4, 8 and 16
#: blocks an SM of the H100's 132, and the default
GRID_CAPS = (264, 528, 1056, 2112, MAX_BLOCKS)

_TORCH_OF_KIND = {
    "bool": torch.bool, "i8": torch.int8, "i32": torch.int32,
    "i64": torch.int64, "f32": torch.float32, "f64": torch.float64,
}
C_TYPE = {
    torch.bool: "bool", torch.int8: "int8_t", torch.int32: "int32_t",
    torch.int64: "int64_t", torch.float32: "float", torch.float64: "double",
}
_UNSIGNED = {torch.int8: "uint8_t", torch.int32: "uint32_t",
             torch.int64: "uint64_t"}
#: ops the generic emitter computes in floating point (ints -> f64 first)
_FLOAT_UNARY = ("exp", "log", "sqrt", "erf", "sin", "cos", "tanh",
                "sigmoid", "rsqrt")
_LIBM = {"exp": "exp", "log": "log", "sqrt": "sqrt", "erf": "erf",
         "sin": "sin", "cos": "cos", "tanh": "tanh", "floor": "floor",
         "abs": "fabs"}
_CMP = ("==", "!=", "<", "<=", ">", ">=")


class Unsupported(ValueError):
    """The body holds a node the generator does not emit."""


@dataclass(frozen=True)
class MapSource:
    text: str
    #: sha256 of the text (the build cache key)
    tag: str
    col_dtypes: Tuple[torch.dtype, ...]
    #: free scalar leaves: (name, field path) in parameter order
    scalars: Tuple[Tuple[str, Tuple[int, ...]], ...]
    scalar_dtypes: Tuple[torch.dtype, ...]
    out_dtype: torch.dtype
    #: distinct operations the kernel does per element (the body after
    #: common-subexpression sharing; literals and loads not counted)
    ops: int


_PRELUDE = r"""// Generated by repro_torch.kernels.map_chain from one Weld IR body.
#include <math.h>
#include <stdint.h>
#include <string.h>
#ifdef WELD_MC_HOST
#define WELD_QUAL static inline
#define WELD_NOINLINE static __attribute__((noinline))
#else
#include <cuda_runtime.h>
#define WELD_QUAL __device__ __forceinline__
#define WELD_NOINLINE __device__ __noinline__
#endif

WELD_QUAL double weld_f64(uint64_t bits) {
  double d;
  memcpy(&d, &bits, sizeof d);
  return d;
}
WELD_QUAL float weld_f32(uint32_t bits) {
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
}
// torch.minimum / torch.maximum: NaN in, NaN out
template <typename T> WELD_QUAL T weld_fmin(T a, T b) {
  return (a != a) ? a : (b != b) ? b : (b < a ? b : a);
}
template <typename T> WELD_QUAL T weld_fmax(T a, T b) {
  return (a != a) ? a : (b != b) ? b : (a < b ? b : a);
}
// torch.remainder on floats
WELD_QUAL double weld_rem(double a, double b) {
  double m = fmod(a, b);
  if (m != 0 && ((b < 0) != (m < 0))) m += b;
  return m;
}
WELD_QUAL float weld_rem(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0 && ((b < 0) != (m < 0))) m += b;
  return m;
}
// integer a / b and a % b: C's truncation, which PyTorch's CUDA div
// (rounding_mode="trunc") and fmod compute.  Each is a call of its own, as
// each is a kernel of its own there, so a zero divisor gives the card's
// value as PyTorch's does: inlined side by side, the compiler derives the
// remainder from the quotient, which gives another value.  The divisor -1
// is taken apart so that the minimum value wraps instead of trapping.
template <typename T, typename U> WELD_NOINLINE T weld_idiv(T a, T b) {
  return b == -1 ? static_cast<T>(U(0) - static_cast<U>(a))
                 : static_cast<T>(a / b);
}
template <typename T> WELD_NOINLINE T weld_imod(T a, T b) {
  return b == -1 ? T(0) : static_cast<T>(a % b);
}
// torch.pow on integers (ATen powi: negative exponents truncate)
template <typename T, typename U> WELD_QUAL T weld_powi(T a, T b) {
  if (b < 0) {
    if (a == 1) return 1;
    if (a == -1) return ((-b) % 2) ? T(-1) : T(1);
    return 0;
  }
  U r = 1, x = static_cast<U>(a);
  while (b) {
    if (b & 1) r = static_cast<U>(r * x);
    b /= 2;
    x = static_cast<U>(x * x);
  }
  return static_cast<T>(r);
}
"""


def _dtype_of(ty) -> torch.dtype:
    if not isinstance(ty, wt.Scalar):
        raise Unsupported(f"non-scalar value of type {ty}")
    return _TORCH_OF_KIND[ty.kind]


def _literal(value, dt: torch.dtype) -> str:
    if dt == torch.bool:
        return "true" if bool(value) else "false"
    if dt.is_floating_point:
        x = float(value)
        if dt == torch.float32:
            f = np.float32(x)
            if np.isfinite(f):
                return f"{float(f).hex()}f"
            return f"weld_f32({int(f.view(np.uint32))}u)"
        if np.isfinite(x):
            return float(x).hex()
        return f"weld_f64({int(np.float64(x).view(np.uint64))}ull)"
    v = int(value)
    info = torch.iinfo(dt)
    if not info.min <= v <= info.max:
        raise Unsupported(f"literal {v} does not fit {dt}")
    if dt == torch.int64:
        if v == info.min:
            return "(-INT64_C(9223372036854775807) - 1)"
        return f"INT64_C({v})"
    return f"(({C_TYPE[dt]}){v})"


class _Emitter:
    def __init__(self, lam: ir.Lambda, col_dtypes, scalar_dtypes):
        if len(lam.params) != 2:
            raise Unsupported("map body must be a lambda (i, x)")
        self.i, self.x = lam.params
        xty = self.x.ty
        if isinstance(xty, wt.Struct):
            kinds = xty.fields
        else:
            kinds = (xty,)
        if col_dtypes is None:
            col_dtypes = tuple(_dtype_of(k) for k in kinds)
        if len(col_dtypes) != len(kinds):
            raise Unsupported("column count differs from the element type")
        self.struct_elem = isinstance(xty, wt.Struct)
        self.col_dtypes = tuple(col_dtypes)
        self.scalar_override = scalar_dtypes
        self.scalars: List[Tuple[str, Tuple[int, ...]]] = []
        self.scalar_dtypes: List[torch.dtype] = []
        self.lines: List[str] = []
        self.count = 0
        self.ops = 0
        self.memo: Dict[str, Tuple[str, torch.dtype]] = {}

    # -- helpers -------------------------------------------------------------

    def tmp(self, dt: torch.dtype, expr: str) -> Tuple[str, torch.dtype]:
        name = f"t{self.count}"
        self.count += 1
        self.lines.append(f"  const {C_TYPE[dt]} {name} = {expr};")
        return name, dt

    @staticmethod
    def conv(v: Tuple[str, torch.dtype], dt: torch.dtype) -> str:
        name, src = v
        if src == dt:
            return name
        if dt == torch.bool:
            return f"({name} != 0)"
        return f"(({C_TYPE[dt]}){name})"

    def scalar_leaf(self, name: str, path: Tuple[int, ...], ty):
        key = (name, path)
        if key not in self.scalars:
            self.scalars.append(key)
            k = len(self.scalar_dtypes)
            if self.scalar_override is not None:
                if k >= len(self.scalar_override):
                    raise Unsupported("scalar dtype list too short")
                self.scalar_dtypes.append(self.scalar_override[k])
            else:
                self.scalar_dtypes.append(_dtype_of(ty))
        k = self.scalars.index(key)
        return f"s{k}", self.scalar_dtypes[k]

    def leaf(self, e: ir.Expr):
        """Column or free scalar that ``e`` (an Ident or GetField chain
        of one) names, or None."""
        path: List[int] = []
        root = e
        while isinstance(root, ir.GetField):
            path.append(root.index)
            root = root.expr
        if not isinstance(root, ir.Ident):
            return None
        path.reverse()
        if root.name == self.i.name:
            raise Unsupported("the loop index is not available to the kernel")
        if root.name == self.x.name:
            if self.struct_elem:
                if len(path) != 1:
                    raise Unsupported("element must be read field by field")
                k = path[0]
            else:
                if path:
                    raise Unsupported("field of a scalar element")
                k = 0
            return f"c{k}", self.col_dtypes[k]
        ty = root.ty
        for p in path:
            if not isinstance(ty, wt.Struct):
                raise Unsupported(f"field of non-struct {root.name}")
            ty = ty.fields[p]
        if not isinstance(ty, wt.Scalar):
            raise Unsupported(f"free value {root.name} is not a scalar")
        return self.scalar_leaf(root.name, tuple(path), ty)

    # -- nodes ---------------------------------------------------------------

    def rec(self, e: ir.Expr) -> Tuple[str, torch.dtype]:
        # the optimizer inlines shared subexpressions (Black-Scholes' d1
        # appears in d2 and in both cnd calls): emit each distinct pure
        # subtree once.  The key is the structural key, which tells
        # 0.0 from -0.0 (dataclass equality does not).
        key = ir.canon_key(e)
        got = self.memo.get(key)
        if got is None:
            got = self.memo[key] = self.node(e)
        return got

    def node(self, e: ir.Expr) -> Tuple[str, torch.dtype]:
        if isinstance(e, (ir.BinOp, ir.UnaryOp, ir.Cast, ir.Select, ir.If)):
            self.ops += 1
        if isinstance(e, (ir.Ident, ir.GetField)):
            if isinstance(e, ir.GetField) and isinstance(e.expr, ir.MakeStruct):
                return self.rec(e.expr.items[e.index])
            got = self.leaf(e)
            if got is None:
                raise Unsupported(f"{type(e).__name__} of a computed struct")
            return got
        if isinstance(e, ir.Literal):
            dt = _dtype_of(e.ty)
            return self.tmp(dt, _literal(e.value, dt))
        if isinstance(e, ir.Cast):
            v = self.rec(e.expr)
            dt = _dtype_of(e.ty)
            return self.tmp(dt, self.conv(v, dt))
        if isinstance(e, (ir.Select, ir.If)):
            c = self.rec(e.cond)
            t = self.rec(e.on_true)
            f = self.rec(e.on_false)
            dt = torch.promote_types(t[1], f[1])
            return self.tmp(dt, f"{self.conv(c, torch.bool)} ? "
                                f"{self.conv(t, dt)} : {self.conv(f, dt)}")
        if isinstance(e, ir.UnaryOp):
            return self.unary(e.op, self.rec(e.expr))
        if isinstance(e, ir.BinOp):
            return self.binop(e.op, self.rec(e.left), self.rec(e.right))
        raise Unsupported(f"{type(e).__name__} node")

    def unary(self, op: str, v):
        name, dt = v
        if op == "not":
            return self.tmp(torch.bool, f"!{self.conv(v, torch.bool)}")
        if op in _FLOAT_UNARY:
            if not dt.is_floating_point:  # torchgen's _to_float
                name, dt = self.conv(v, torch.float64), torch.float64
            t, f = C_TYPE[dt], "f" if dt == torch.float32 else ""
            if op == "sigmoid":
                return self.tmp(dt, f"{t}(1) / ({t}(1) + exp{f}(-{name}))")
            if op == "rsqrt":
                return self.tmp(dt, f"{t}(1) / sqrt{f}({name})")
            return self.tmp(dt, f"{_LIBM[op]}{f}({name})")
        if dt == torch.bool:
            raise Unsupported(f"{op} of a bool")
        if dt.is_floating_point:
            f = "f" if dt == torch.float32 else ""
            if op == "neg":
                return self.tmp(dt, f"-{name}")
            return self.tmp(dt, f"{_LIBM[op]}{f}({name})")
        u = _UNSIGNED[dt]
        neg = f"({C_TYPE[dt]})(({u})0 - ({u}){name})"
        if op == "neg":
            return self.tmp(dt, neg)
        if op == "abs":
            return self.tmp(dt, f"{name} < 0 ? {neg} : {name}")
        if op == "floor":
            return self.tmp(dt, name)
        raise Unsupported(f"unary {op}")

    def binop(self, op: str, a, b):
        if op in ("&&", "||"):
            return self.tmp(torch.bool, f"{self.conv(a, torch.bool)} {op} "
                                        f"{self.conv(b, torch.bool)}")
        dt = torch.promote_types(a[1], b[1])
        x, y = self.conv(a, dt), self.conv(b, dt)
        if op in _CMP:
            return self.tmp(torch.bool, f"{x} {op} {y}")
        t = C_TYPE[dt]
        if op == "min":
            if dt.is_floating_point:
                return self.tmp(dt, f"weld_fmin<{t}>({x}, {y})")
            return self.tmp(dt, f"{y} < {x} ? {y} : {x}")
        if op == "max":
            if dt.is_floating_point:
                return self.tmp(dt, f"weld_fmax<{t}>({x}, {y})")
            return self.tmp(dt, f"{x} < {y} ? {y} : {x}")
        if dt == torch.bool:
            if op == "+":
                return self.tmp(dt, f"{x} || {y}")
            if op == "*":
                return self.tmp(dt, f"{x} && {y}")
            raise Unsupported(f"bool {op}")
        if dt.is_floating_point:
            if op in ("+", "-", "*", "/"):
                return self.tmp(dt, f"{x} {op} {y}")
            if op == "%":
                return self.tmp(dt, f"weld_rem({x}, {y})")
            if op == "pow":
                f = "f" if dt == torch.float32 else ""
                return self.tmp(dt, f"pow{f}({x}, {y})")
            raise Unsupported(f"binop {op}")
        u = _UNSIGNED[dt]
        if op in ("+", "-", "*"):
            # two's-complement wrap, as torch's integer kernels do
            return self.tmp(dt, f"({t})(({u}){x} {op} ({u}){y})")
        if op == "/":
            return self.tmp(dt, f"weld_idiv<{t}, {u}>({x}, {y})")
        if op == "%":
            return self.tmp(dt, f"weld_imod<{t}>({x}, {y})")
        if op == "pow":
            return self.tmp(dt, f"weld_powi<{t}, {u}>({x}, {y})")
        raise Unsupported(f"binop {op}")


def emit_source(lam: ir.Lambda,
                col_dtypes: Optional[Sequence[torch.dtype]] = None,
                scalar_dtypes: Optional[Sequence[torch.dtype]] = None
                ) -> MapSource:
    """C/CUDA source of one map body.  Column and scalar dtypes default to
    the IR's types; a caller whose tensors differ passes their dtypes."""
    em = _Emitter(lam, col_dtypes, scalar_dtypes)
    res = em.rec(lam.body)
    out_dtype = res[1]
    out_t = C_TYPE[out_dtype]
    cts = [C_TYPE[d] for d in em.col_dtypes]
    sts = [C_TYPE[d] for d in em.scalar_dtypes]
    body = "\n".join(em.lines)
    col_params = ", ".join(f"{t} c{j}" for j, t in enumerate(cts))
    sc_params = "".join(f", {t} s{j}" for j, t in enumerate(sts))
    sc_args = "".join(f", v{j}" for j in range(len(sts)))
    # host loop: typed reads of the void* column and scalar arrays
    cols_read = ", ".join(f"static_cast<const {t}*>(cols[{j}])[i]"
                          for j, t in enumerate(cts))
    sc_read = "".join(f"  const {t} v{j} = *static_cast<const {t}*>"
                      f"(scalars[{j}]);\n" for j, t in enumerate(sts))
    # kernel: typed pointer parameters, the scalars read once per thread
    kern_cols = ", ".join(f"const {t}* __restrict__ a{j}"
                          for j, t in enumerate(cts))
    kern_sc = "".join(f", const {t}* __restrict__ p{j}"
                      for j, t in enumerate(sts))
    kern_sc_read = "".join(f"  const {t} v{j} = *p{j};\n"
                           for j, t in enumerate(sts))
    kern_cols_read = ", ".join(f"a{j}[i]" for j in range(len(cts)))
    launch_cols = ", ".join(f"static_cast<const {t}*>(cols[{j}])"
                            for j, t in enumerate(cts))
    launch_sc = "".join(f", static_cast<const {t}*>(scalars[{j}])"
                        for j, t in enumerate(sts))
    text = f"""{_PRELUDE}
WELD_QUAL {out_t} weld_body({col_params}{sc_params}) {{
{body}
  return {em.conv(res, out_dtype)};
}}

#ifdef WELD_MC_HOST
extern "C" void weld_map_host(const void* const* cols,
                              const void* const* scalars, void* out,
                              long long n) {{
{sc_read}  for (long long i = 0; i < n; ++i) {{
    static_cast<{out_t}*>(out)[i] = weld_body({cols_read}{sc_args});
  }}
}}
#else
__global__ void __launch_bounds__({THREADS})
weld_map_kernel({kern_cols}{kern_sc}, {out_t}* __restrict__ out, int64_t n) {{
{kern_sc_read}  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {{
    out[i] = weld_body({kern_cols_read}{sc_args});
  }}
}}

// {len(cts)} columns, {len(sts)} scalars (device pointers);
// launches on `stream`, allocates nothing, does not synchronise; returns
// the CUDA error of the launch (0 = success).
extern "C" int weld_map_launch(const void* const* cols,
                               const void* const* scalars, void* out,
                               long long n, int blocks, void* stream) {{
  if (n <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  weld_map_kernel<<<blocks, {THREADS}, 0, static_cast<cudaStream_t>(stream)>>>(
      {launch_cols}{launch_sc}, static_cast<{out_t}*>(out), n);
  return static_cast<int>(cudaGetLastError());
}}
#endif
"""
    return MapSource(
        text=text, tag=hashlib.sha256(text.encode()).hexdigest()[:16],
        col_dtypes=em.col_dtypes, scalars=tuple(em.scalars),
        scalar_dtypes=tuple(em.scalar_dtypes), out_dtype=out_dtype,
        ops=em.ops)


def check_emittable(lam: ir.Lambda) -> Optional[str]:
    """None when the generator emits ``lam``, else the reason it does not."""
    try:
        source_for(lam)
    except Unsupported as exc:
        return str(exc)
    return None


# ---------------------------------------------------------------------------
# build cache and launch
# ---------------------------------------------------------------------------

_lock = threading.Lock()
#: (id of a lambda, column dtypes, scalar dtypes) -> (that lambda,
#: MapSource).  Keyed by identity: the planner, the prepare hook and every
#: launch of a compiled program hold the same lambda, while its
#: structural key walks the whole inlined tree (8,673 nodes for
#: Black-Scholes), too slow for every launch (``chip_smoke.py`` logs its
#: host time).  The entry holds the lambda, so its id is not reused while
#: it is cached.
_sources: "OrderedDict[tuple, Tuple[ir.Lambda, MapSource]]" = OrderedDict()
#: source tag -> (loaded library, what its load did)
_libs: "OrderedDict[str, Tuple[ctypes.CDLL, dict]]" = OrderedDict()


def _cached(cache: OrderedDict, key, make):
    """``cache[key]``, made by ``make()`` (outside the lock, so that
    several bodies can build at once) on a miss.  Both caches are
    least-recently-used and hold at most the compile cache's bound
    (``$WELD_COMPILE_CACHE_MAX``).  An evicted library stays loaded,
    since ctypes never unloads one; its next use loads it again from
    disk, which returns the same handle."""
    from ..core.runtime import cache_max

    with _lock:
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit
    value = make()
    with _lock:
        value = cache.setdefault(key, value)
        cache.move_to_end(key)
        while len(cache) > cache_max():
            cache.popitem(last=False)
    return value


def source_for(lam: ir.Lambda, col_dtypes=None,
               scalar_dtypes=None) -> MapSource:
    key = (id(lam),
           None if col_dtypes is None else tuple(col_dtypes),
           None if scalar_dtypes is None else tuple(scalar_dtypes))
    return _cached(_sources, key, lambda: (
        lam, emit_source(lam, col_dtypes, scalar_dtypes)))[1]


def _load(src: MapSource) -> Tuple[ctypes.CDLL, dict]:
    lib, info = _build.build_generated(src.text, "weldmap")
    P = ctypes.c_void_p
    lib.weld_map_launch.argtypes = [
        ctypes.POINTER(P), ctypes.POINTER(P), P, ctypes.c_longlong,
        ctypes.c_int, P]
    lib.weld_map_launch.restype = ctypes.c_int
    return lib, info


def library_for(src: MapSource) -> ctypes.CDLL:
    """The built library of one source (nvcc at the first call for it in
    this checkout, then from disk, then from memory)."""
    return _cached(_libs, src.tag, lambda: _load(src))[0]


def build_info() -> Dict[str, dict]:
    """What the load of each cached library did, by source tag."""
    with _lock:
        return {tag: dict(info) for tag, (_, info) in _libs.items()}


def prepare(lam: ir.Lambda) -> MapSource:
    """Emit and build the kernel of one body at the IR's dtypes (called
    when a program that routes it is compiled for the card)."""
    src = source_for(lam)
    library_for(src)
    return src


def stage_plain(lam: ir.Lambda, env: Optional[dict], device) -> callable:
    """The body as the generic emitter stages it: a torch closure over
    whole columns, the loop index bound to a dummy scalar."""
    from ..core.backend.torchgen import Emitter

    fn = Emitter({}, torch.device(device))._stage_elem_fn(lam, env or {})
    dummy = torch.zeros((), dtype=torch.int64, device=device)

    def body(*cols):
        return fn(dummy, cols[0] if len(cols) == 1 else tuple(cols))

    return body


def scalar_value(env: dict, name: str, path: Tuple[int, ...]):
    """A free scalar of a body as a 0-dim tensor.  A scalar program input
    arrives as a one-element column (the runtime encodes every input as
    an array of at least one dimension), which the generic emitter
    broadcasts like a scalar."""
    if name not in env:
        raise ValueError(f"map chain: free scalar {name} is not bound")
    v = env[name]
    for p in path:
        v = v[p]
    v = torch.as_tensor(v)
    if v.numel() != 1:
        raise ValueError(f"map_elementwise kernel: free value {name} has "
                         f"shape {tuple(v.shape)}, not a scalar")
    return v.reshape(())


def map_elementwise(fn, arrays: Sequence[torch.Tensor],
                    lam: Optional[ir.Lambda] = None,
                    env: Optional[dict] = None,
                    max_blocks: Optional[int] = None) -> torch.Tensor:
    """out[i] = body(a1[i], ..., ak[i]) over equal-length 1-D columns.

    ``fn`` is the body staged as a whole-column torch closure (the plain
    version, taken for CPU tensors); ``lam`` is the same body as IR, from
    which the CUDA route generates its kernel, and ``env`` binds the
    body's free scalars.  Columns longer than the shortest are read up to
    the shortest, as the generic loop does.  ``max_blocks`` caps the grid
    (default :data:`MAX_BLOCKS`); every element is computed alike
    whatever the grid."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("map_elementwise needs at least one column")
    if arrays[0].device.type == "cpu":
        _count.bump(map_elementwise, "plain_calls")
        return map_elementwise_plain(fn, arrays)
    dev = arrays[0].device
    if dev.type != "cuda" or any(a.device != dev for a in arrays):
        raise ValueError("map_elementwise kernel takes CUDA columns on one "
                         "device")
    if lam is None:
        raise ValueError("map_elementwise kernel needs the body's IR (lam)")
    if any(a.ndim != 1 for a in arrays):
        raise ValueError("map_elementwise kernel takes 1-D columns")
    if any(a.dtype not in C_TYPE for a in arrays):
        raise TypeError(f"map_elementwise kernel takes bool/i8/i32/i64/f32/"
                        f"f64 columns, got {[a.dtype for a in arrays]}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("map_elementwise kernel takes contiguous columns")
    src = source_for(lam)
    values = [scalar_value(env or {}, name, path)
              for name, path in src.scalars]
    col_dt = tuple(a.dtype for a in arrays)
    sc_dt = tuple(v.dtype for v in values)
    if col_dt != src.col_dtypes or sc_dt != src.scalar_dtypes:
        # the tensors' dtypes differ from the IR's (an upstream generic
        # op promoted): generate for what the tensors hold
        src = source_for(lam, col_dt, sc_dt)
    n = min(a.shape[0] for a in arrays)
    out = torch.empty((n,), dtype=src.out_dtype, device=dev)
    if n == 0:
        return out
    values = [v.to(dev).contiguous() for v in values]
    lib = library_for(src)
    P = ctypes.c_void_p
    cols = (P * len(arrays))(*[a.data_ptr() for a in arrays])
    scal = (P * max(len(values), 1))(*[v.data_ptr() for v in values])
    cap = MAX_BLOCKS if max_blocks is None else int(max_blocks)
    if cap < 1:
        raise ValueError(f"map_elementwise grid cap must be >= 1, got {cap}")
    blocks = max(1, min(cap, -(-n // THREADS)))
    with torch.cuda.device(dev):
        rc = lib.weld_map_launch(cols, scal, out.data_ptr(), n, blocks,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "map_elementwise kernel launch")
    _count.bump(map_elementwise, "launches")
    return out


map_elementwise.launches = 0
map_elementwise.plain_calls = 0
