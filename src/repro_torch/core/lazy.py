"""Weld runtime API (paper §4, Table 2).

`WeldObject` represents either external in-memory data or a lazily
evaluated sub-computation; objects form a DAG across library boundaries.
`Evaluate` walks the DAG, stitches the IR fragments into a single program,
optimizes it, compiles it through the PyTorch backend and runs it on the
application's in-memory data (numpy arrays, copied once to the device).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import ir
from . import wtypes as wt

_obj_ids = itertools.count()


# ---------------------------------------------------------------------------
# Encoders (paper §4.2): marshal native objects <-> Weld values.
# ---------------------------------------------------------------------------


class Encoder:
    """Bidirectional marshaller between a library's native format and Weld."""

    def encode(self, obj):  # native -> weld-usable (numpy array)
        return obj

    def decode(self, value, ty: wt.WeldType):  # weld result -> native
        return value

    def weld_type(self, obj) -> wt.WeldType:
        raise NotImplementedError


class ArrayEncoder(Encoder):
    """Encoder for numpy arrays (the NumPy ndarray case from the paper:
    the buffer is already a packed array of primitives)."""

    def encode(self, obj):
        return obj  # the runtime moves it to the device at execution

    def decode(self, value, ty):
        return value

    def weld_type(self, obj) -> wt.WeldType:
        arr = np.asarray(obj) if not hasattr(obj, "dtype") else obj
        base: wt.WeldType = wt.dtype_to_weld(arr.dtype)
        for _ in range(arr.ndim):
            base = wt.Vec(base)
        return base


class ScalarEncoder(Encoder):
    def weld_type(self, obj) -> wt.WeldType:
        if isinstance(obj, bool):
            return wt.Bool
        if isinstance(obj, (int, np.integer)):
            return wt.I64
        return wt.F64

    def decode(self, value, ty):
        return np.asarray(value).item()


# ---------------------------------------------------------------------------
# WeldObject
# ---------------------------------------------------------------------------


@dataclass
class WeldResult:
    """Handle returned by Evaluate (paper Table 2)."""

    value: object
    ty: wt.WeldType
    compile_ms: float
    run_ms: float
    from_cache: bool = False
    _freed: bool = False

    def free(self) -> None:  # parity with FreeWeldResult; torch GC does the work
        self._freed = True
        self.value = None


class WeldObject:
    """A lazily-evaluated computation or a wrapped external value.

    Data objects:  `expr` is an Ident referring to themselves; `data` holds
    the native value.  Computation objects: `expr` is Weld IR whose free
    variables refer to entries of `deps`.
    """

    def __init__(
        self,
        expr: ir.Expr,
        deps: Dict[str, "WeldObject"],
        encoder: Encoder,
        data: object = None,
        ty: Optional[wt.WeldType] = None,
    ):
        self.obj_id = f"obj{next(_obj_ids):010d}"  # padded: lex == numeric
        self.expr = expr
        self.deps = dict(deps)
        self.encoder = encoder
        self.data = data
        self._ty = ty
        self._freed = False

    # -- paper API ---------------------------------------------------------

    @property
    def is_data(self) -> bool:
        return self.data is not None or not self.deps and isinstance(self.expr, ir.Ident)

    def weld_type(self) -> wt.WeldType:
        if self._ty is not None:
            return self._ty
        env = {name: dep.weld_type() for name, dep in self.deps.items()}
        self._ty = ir.typeof(self.expr, env)
        return self._ty

    def evaluate(self, memory_limit: Optional[int] = None,
                 **kw) -> WeldResult:
        return Evaluate(self, memory_limit=memory_limit, **kw)

    def free(self) -> None:
        """FreeWeldObject: drops internal state, not deps (paper §4.1)."""
        self._freed = True
        self.expr = None
        self.deps = {}
        self.data = None

    def __repr__(self) -> str:
        kind = "data" if self.is_data else "lazy"
        return f"<WeldObject {self.obj_id} {kind} : {self.weld_type()}>"


def NewWeldObject(
    deps_or_data,
    expr_or_type,
    encoder: Optional[Encoder] = None,
) -> WeldObject:
    """The two variants from Table 2.

    * ``NewWeldObject(data, type_or_none, encoder)`` — wrap external data.
    * ``NewWeldObject([deps], expr, encoder)`` — wrap a sub-computation.
    """
    if isinstance(deps_or_data, (list, tuple)) and all(
        isinstance(d, WeldObject) for d in deps_or_data
    ) and isinstance(expr_or_type, ir.Expr):
        deps_list: List[WeldObject] = list(deps_or_data)
        expr: ir.Expr = expr_or_type
        deps = {d.obj_id: d for d in deps_list}
        # free vars of expr must be declared deps (paper §4.1)
        fv = ir.free_vars(expr)
        for name in fv:
            if name not in deps:
                raise ValueError(
                    f"IR references {name} which is not among declared deps"
                )
        return WeldObject(expr, deps, encoder or ArrayEncoder())
    # data variant
    data = deps_or_data
    encoder = encoder or (
        ScalarEncoder() if np.isscalar(data) else ArrayEncoder()
    )
    ty = expr_or_type if isinstance(expr_or_type, wt.WeldType) else encoder.weld_type(data)
    obj = WeldObject(ir.Ident("<self>", ty), {}, encoder, data=data, ty=ty)
    obj.expr = ir.Ident(obj.obj_id, ty)
    return obj


def GetObjectType(o: WeldObject) -> wt.WeldType:
    return o.weld_type()


def FreeWeldObject(o: WeldObject) -> None:
    o.free()


def FreeWeldResult(r: WeldResult) -> None:
    r.free()


# ---------------------------------------------------------------------------
# DAG -> single program
# ---------------------------------------------------------------------------


@dataclass
class Program:
    """A stitched whole-workflow Weld program ready for the optimizer."""

    expr: ir.Expr
    #: name -> (weld type, encoder, native value)
    inputs: Dict[str, Tuple[wt.WeldType, Encoder, object]]
    out_ty: wt.WeldType = None  # type: ignore

    def evaluate(
        self,
        optimize: bool = True,
        memory_limit: Optional[int] = None,
        passes=None,
        kernelize=None,
        kernel_impl: Optional[str] = None,
    ):
        """Compile + run this program directly (no WeldObject wrapper).

        Returns ``(value, compile_ms, from_cache, stats)``;
        ``kernelize`` selects the planner mode — ``"auto"`` (default:
        cost-gated), ``"always"``/``True``, or ``"off"``/``False``
        (see ``repro_torch.core.kernelplan``).
        """
        from .runtime import compile_and_run  # local import: needs torch

        return compile_and_run(
            self,
            optimize=optimize,
            memory_limit=memory_limit,
            passes=passes,
            kernelize=kernelize,
            kernel_impl=kernel_impl,
        )


def build_program(root: WeldObject) -> Program:
    """Topologically stitch the DAG below `root` into one IR expression.

    Data leaves become program inputs; every internal object's expr is
    let-bound under its obj_id so downstream fragments can reference it.
    Shared sub-computations are bound once (this is where cross-library
    common-subexpression sharing falls out of the DAG structure).
    """
    order: List[WeldObject] = []
    seen = set()

    def topo(o: WeldObject):
        if o.obj_id in seen:
            return
        seen.add(o.obj_id)
        for dep in o.deps.values():
            topo(dep)
        order.append(o)

    topo(root)

    inputs: Dict[str, Tuple[wt.WeldType, Encoder, object]] = {}
    bindings: List[Tuple[str, ir.Expr]] = []
    for o in order:
        if o._freed:
            raise RuntimeError(f"{o.obj_id} was freed before evaluation")
        if o.data is not None:
            inputs[o.obj_id] = (o.weld_type(), o.encoder, o.data)
        else:
            bindings.append((o.obj_id, o.expr))

    if root.data is not None:
        body: ir.Expr = ir.Ident(root.obj_id, root.weld_type())
    else:
        body = ir.Ident(root.obj_id, root.weld_type())
    # nest lets innermost-last so later bindings can see earlier ones
    for name, expr in reversed(bindings):
        body = ir.Let(name, expr, body)

    env = {k: v[0] for k, v in inputs.items()}
    out_ty = ir.typeof(body, env)
    return Program(expr=body, inputs=inputs, out_ty=out_ty)


# ---------------------------------------------------------------------------
# Evaluate
# ---------------------------------------------------------------------------

def Evaluate(
    o: WeldObject,
    memory_limit: Optional[int] = None,
    optimize: bool = True,
    passes=None,
    backend: str = "torch",
    collect_stats: Optional[dict] = None,
    kernelize=None,
    kernel_impl: Optional[str] = None,
) -> WeldResult:
    """Optimize + compile + run the whole DAG under `o` (paper Table 2).

    `memory_limit` bounds Weld-owned temporary allocation (estimated from
    size analysis, including kernel padding/scratch footprints); exceeded
    limits raise before execution.  `passes` selects a subset of optimizer
    passes (ablation benchmarks).  `kernelize` selects the kernel-planner
    mode: ``"auto"`` (the process default — matched loops route onto the
    CUDA kernel library only when the roofline cost model favors them),
    ``"always"``/``True`` (route every match), ``"off"``/``False``
    (bypass the planner; see ``repro_torch.core.kernelplan``).
    `kernel_impl` picks "cuda" / "ref" for the routed kernel calls (by
    default, the device decides).  Runs on ``repro_torch``'s default
    device, which raises when it is CUDA and no card is present.
    """
    from .runtime import compile_and_run  # local import: needs torch

    # no global lock here: the runtime's compile cache is single-flight
    # (one thread compiles a key, peers wait) and compiles serialize on
    # the runtime's compile lock — concurrent Evaluates of already-
    # compiled programs execute in parallel
    prog = build_program(o)
    t0 = time.perf_counter()
    value, compile_ms, from_cache, stats = compile_and_run(
        prog,
        optimize=optimize,
        memory_limit=memory_limit,
        passes=passes,
        kernelize=kernelize,
        kernel_impl=kernel_impl,
    )
    run_ms = (time.perf_counter() - t0) * 1e3 - compile_ms
    if collect_stats is not None:
        collect_stats.update(stats)
    native = o.encoder.decode(value, prog.out_ty)
    return WeldResult(
        value=native,
        ty=prog.out_ty,
        compile_ms=compile_ms,
        run_ms=max(run_ms, 0.0),
        from_cache=from_cache,
    )
