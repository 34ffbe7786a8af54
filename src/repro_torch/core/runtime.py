"""Evaluation: lower → optimize → plan → emit → execute → decode.

One `Evaluate` call runs the whole stitched workflow as one program on
the default device (the paper's evaluation point).  "Compiling" a
program means running the optimizer passes, the kernel planner and the
autotuner over its IR, building the routed kernels and the emitter's
closure; the result is cached by alpha-invariant structure + input
signature, so a re-evaluation of the same workflow shape skips straight
to execution (the paper's §7.8: compile cost amortizes).

The pipeline is split into explicit AOT stages, as the JAX package's is,
so a serving tier can hold a compiled plan and re-bind same-shape inputs
without paying a recompile:

* :func:`lower` → :class:`LoweredProgram` — inputs encoded onto the
  default device, the compile-cache key formed (nothing optimized yet);
* ``LoweredProgram.optimize()`` → :class:`OptimizedProgram` — optimizer
  passes, kernel planning, autotuning, weldbound admission;
* ``OptimizedProgram.compile()`` / ``LoweredProgram.compile()`` /
  :func:`compile_program` → :class:`CompiledProgram` — the reusable AOT
  handle with ``.stats`` and ``.run(arrays)``.

The compile cache is a bounded, locked, single-flight LRU
(``$WELD_COMPILE_CACHE_MAX``, default 256): one thread compiles a given
key while peers wait on the in-flight slot, eviction is
least-recently-used, and hit/miss/evict/wait counters surface in every
result's ``stats["cache.*"]``.

``compile_and_run`` (what `Evaluate` calls) drives the same stages under
the recovery ladder (``core/recovery.py``): a poisoned result regrows the
builder capacities and retries, then degrades to the generic lowering; a
kernel that fails to build (or whose ``kernel.<route>`` fault fires) is
quarantined, and the program re-runs on the generic lowering on the CPU
and raises on a card.

Along the way: with ``WELD_VERIFY=1`` the input program, every pass's
output, the planned and the tuned programs are verified
(``check.checkpoint``); weldbound admission evaluates the plan's
peak-memory certificate against ``memory_limit`` before anything is
built or launched (:func:`_admit`); the build step (each generated
kernel's ``nvcc``, the emitter's closure) runs under the ``jit_compile``
span; and with tracing on, a kernelized evaluation is replayed once with
every kernel call timed (:func:`_measured_replay`), which writes the cost
ledger.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check
from . import faults
from . import ir
from . import obs
from . import wtypes as wt
from ..device import default_device, shared_use, sole_use
from .analysis import bounds as _bounds
from .backend.torchgen import emit_program
from .backend.values import WDict, WGroup, WVec
from .errors import CapacityError, ResourceError
from .lazy import Program
from .passes import loop_count, optimize as run_passes

ENV_CACHE_MAX = "WELD_COMPILE_CACHE_MAX"
DEFAULT_CACHE_MAX = 256

#: Serializes the optimize→plan→autotune→emit compile body (the
#: optimizer, planner and autotune cache touch process-global state);
#: executions of compiled programs run WITHOUT this lock, so concurrent
#: serving only serializes on compiles.
_compile_lock = threading.RLock()


def cache_max() -> int:
    """Bound on cached programs (``$WELD_COMPILE_CACHE_MAX``, ≥1)."""
    try:
        return max(1, int(os.environ.get(ENV_CACHE_MAX, DEFAULT_CACHE_MAX)))
    except ValueError:
        return DEFAULT_CACHE_MAX


class _Flight:
    """In-flight compile slot: the leader resolves it, waiters block on
    the event and take the entry from the flight itself."""

    __slots__ = ("event", "entry", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.entry: Optional[Tuple[object, dict]] = None
        self.error: Optional[BaseException] = None


class _CompileCache:
    """Bounded, locked, single-flight LRU of compiled programs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[object, dict]]" = OrderedDict()
        self._flights: Dict[str, _Flight] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.waits = 0

    def lookup_or_begin(self, key: str):
        """('hit', entry) | ('wait', flight) | ('lead', flight)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return "hit", ent
            fl = self._flights.get(key)
            if fl is not None:
                self.waits += 1
                return "wait", fl
            fl = _Flight()
            self._flights[key] = fl
            self.misses += 1
            return "lead", fl

    def fill(self, key: str, entry: Tuple[object, dict],
             store_key: Optional[str] = None) -> None:
        """Store the compiled entry and resolve any waiters.

        The entry is stored ONLY under ``store_key`` (defaults to
        ``key``).  When first-encounter tuning refreshed the autotune
        fingerprint mid-compile, ``store_key`` is the refreshed key and
        the pre-tuning ``key`` is deliberately NOT filed: its fingerprint
        can never match a future lookup, so filing it would leak one
        unreachable entry per first-encounter tuning."""
        store = store_key if store_key is not None else key
        with self._lock:
            self._entries[store] = entry
            self._entries.move_to_end(store)
            limit = cache_max()
            while len(self._entries) > limit:
                self._entries.popitem(last=False)
                self.evictions += 1
            fl = self._flights.pop(key, None)
        if fl is not None:
            fl.entry = entry
            fl.event.set()

    def abandon(self, key: str, error: BaseException) -> None:
        """Leader failed: release the flight so waiters can retry (and
        surface the same error if they fail the same way)."""
        with self._lock:
            fl = self._flights.pop(key, None)
        if fl is not None:
            fl.error = error
            fl.event.set()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = self.waits = 0

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def counters(self) -> dict:
        with self._lock:
            return {
                "cache.hits": self.hits,
                "cache.misses": self.misses,
                "cache.evictions": self.evictions,
                "cache.waits": self.waits,
                "cache.size": len(self._entries),
                "cache.max": cache_max(),
            }


_cache = _CompileCache()


def _copy_stats(v):
    """Copy the stats containers (dicts/lists) while keeping leaf values
    by reference, so callers cannot poison the cached entry."""
    if isinstance(v, dict):
        return {k: _copy_stats(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_stats(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_copy_stats(x) for x in v)
    return v


def clear_cache() -> None:
    _cache.clear()


def cache_size() -> int:
    return _cache.size()


def cache_stats() -> dict:
    return _cache.counters()


def _export_stats(stats: dict, from_cache: bool) -> dict:
    out = _copy_stats(stats)
    out.update(_cache.counters())
    out["cache.hit"] = from_cache
    return out


def _as_input(data, device: torch.device) -> torch.Tensor:
    """One encoded input as a contiguous tensor on ``device``: a tensor
    already there is taken as it is (no copy), anything else goes
    through numpy."""
    if isinstance(data, torch.Tensor):
        return data.to(device).contiguous()
    host = np.ascontiguousarray(np.asarray(data))
    return torch.from_numpy(host).to(device)


def _signature(arrays) -> str:
    return ",".join(f"{a.dtype}:{tuple(a.shape)}" for a in arrays)


# ---------------------------------------------------------------------------
# staged AOT pipeline
# ---------------------------------------------------------------------------


@dataclass
class LoweredProgram:
    """Stage 1: inputs encoded onto the default device, compile-cache key
    formed.

    ``opt``/``memory_limit``/``passes``/``mode``/``kernel_impl`` are the
    resolved compile options (``kernel_impl`` named by the device when
    the planner runs, so the key names it); ``arrays`` are the encoded
    inputs in ``input_names`` order — the positional binding every
    same-key execution re-binds against."""

    prog: Program
    opt: bool
    memory_limit: Optional[int]
    passes: Optional[tuple]
    mode: str
    kernel_impl: Optional[str]
    device: torch.device
    input_names: List[str] = field(default_factory=list)
    arrays: list = field(default_factory=list)
    shapes: Dict[str, tuple] = field(default_factory=dict)
    types: Dict[str, wt.WeldType] = field(default_factory=dict)
    sig: str = ""
    kreg: str = ""
    key: str = ""
    encode_ms: float = 0.0

    @property
    def kernelize_on(self) -> bool:
        return self.mode != "off"

    def refresh_kreg(self) -> str:
        return _kreg_fingerprint() if self.kernelize_on else ""

    def cache_key(self, kreg_now: Optional[str] = None) -> str:
        # positional input aliasing: rebuilt workflows (fresh obj ids)
        # share one compiled program as long as structure matches.  Armed
        # faults join the key too (empty when none): an injected fault
        # must never be defeated by a cached program
        name_map = {n: f"in{i}" for i, n in enumerate(self.input_names)}
        kreg_now = self.kreg if kreg_now is None else kreg_now
        return (
            ir.canon_key(self.prog.expr, name_map)
            + f"|opt={self.opt}|mem={self.memory_limit}|passes={self.passes}"
            + f"|kz={self.mode}|kimpl={self.kernel_impl}|kreg={kreg_now}"
            + f"|dev={self.device}|flt={faults.fingerprint()}|{self.sig}"
        )

    def optimize(self) -> "OptimizedProgram":
        """Stage 2: optimizer passes + kernel planning + autotuning +
        weldbound admission.  Uncached — callers wanting the shared
        cache go through :meth:`compile` / :func:`compile_program`."""
        with _compile_lock:
            return _optimize_stage(self)

    def compile(self) -> "CompiledProgram":
        """Stages 2+3 through the shared single-flight cache."""
        fn, stats, from_cache = _compile_handle(self)
        return CompiledProgram(self, fn, stats, from_cache)


def _kreg_fingerprint() -> str:
    """The kernel registry, the autotuner's tunings and the quarantine
    state: registering a spec, a new tuning, and quarantining or clearing
    a kernel must never be served by a stale compiled program."""
    from .kernelplan import autotune, fingerprint, quarantine

    return (fingerprint() + "/" + autotune.fingerprint()
            + "/" + quarantine.fingerprint())


def _resolve(kernelize, kernel_impl):
    """(mode, kernel_impl): the planner's mode, and the kernel entries'
    impl named by the default device when the planner runs ("cuda" on a
    card, "ref" on the CPU)."""
    from .kernelplan import normalize_kernelize
    from .kernelplan.autotune import resolve_impl

    mode = normalize_kernelize(kernelize)
    if mode != "off":
        kernel_impl = resolve_impl(kernel_impl)
    return mode, kernel_impl


def lower(
    prog: Program,
    optimize: bool = True,
    memory_limit: Optional[int] = None,
    passes=None,
    kernelize=None,
    kernel_impl: Optional[str] = None,
) -> LoweredProgram:
    """Public stage-1 entry: resolve options, encode the inputs onto the
    default device, form the key."""
    mode, kernel_impl = _resolve(kernelize, kernel_impl)
    return _lower(prog, optimize, memory_limit, passes, mode, kernel_impl,
                  default_device())


def _lower(prog, optimize, memory_limit, passes, mode, kernel_impl,
           device) -> LoweredProgram:
    low = LoweredProgram(prog=prog, opt=optimize, memory_limit=memory_limit,
                         passes=passes, mode=mode, kernel_impl=kernel_impl,
                         device=device)
    low.input_names = sorted(prog.inputs)
    t0 = time.perf_counter()
    with obs.span("encode", inputs=len(low.input_names)):
        for name in low.input_names:
            ty, enc, data = prog.inputs[name]
            arr = _as_input(enc.encode(data), device)
            low.arrays.append(arr)
            low.shapes[name] = tuple(arr.shape)
            low.types[name] = ty
    low.encode_ms = (time.perf_counter() - t0) * 1e3
    low.sig = _signature(low.arrays)
    if low.kernelize_on:
        # register/unregister, new tunings and quarantine changes must
        # invalidate the cache: a stale program must never serve a newly
        # tuned plan or a newly quarantined kernel route
        low.kreg = _kreg_fingerprint()
    low.key = low.cache_key()
    return low


@dataclass
class OptimizedProgram:
    """Stage 2 result: the planned IR + stats, ready to build."""

    lowered: LoweredProgram
    expr: ir.Expr
    stats: dict
    optimize_ms: float = 0.0

    def compile(self) -> "CompiledProgram":
        """Stage 3: build the routed kernels and emit the program, then
        file it in the shared cache (under the refreshed autotune
        fingerprint's key when first-encounter tuning bumped it — the
        stale pre-tuning key is never stored, so it cannot leak)."""
        low = self.lowered
        with _compile_lock:
            fn = _jit_stage(low, self.expr, self.stats, self.optimize_ms)
        store_key = low.key
        if low.kernelize_on:
            kreg_now = low.refresh_kreg()
            if kreg_now != low.kreg:
                store_key = low.cache_key(kreg_now)
        _cache.fill(low.key, (fn, self.stats), store_key=store_key)
        return CompiledProgram(low, fn, self.stats, from_cache=False)


def _optimize_stage(low: LoweredProgram) -> OptimizedProgram:
    t0 = time.perf_counter()
    expr = low.prog.expr
    stats: dict = {}
    stats["loops.before"] = loop_count(expr)
    # verify the frontend's program before any rewrite touches it: a
    # pre-existing violation must be blamed on the input, not on
    # whichever pass happens to run first
    check.checkpoint("input", expr, env=low.types, stats=stats,
                     shapes=low.shapes)
    if low.opt:
        with obs.span("optimize"):
            expr = run_passes(expr, passes=low.passes, stats=stats,
                              input_shapes=low.shapes)
    stats["loops.after"] = loop_count(expr)
    if low.kernelize_on:
        from .kernelplan import autotune, plan_kernels

        with obs.span("kernelplan", mode=low.mode) as sp:
            expr = plan_kernels(expr, input_shapes=low.shapes, stats=stats,
                                mode=low.mode, impl=low.kernel_impl)
            sp.set("matched", stats.get("kernelize.matched", 0))
        if stats.get("kernelize.matched"):
            with obs.span("autotune"):
                expr = autotune.tune_plan(expr, impl=low.kernel_impl,
                                          stats=stats)
            check.checkpoint("autotune", expr, stats=stats,
                             shapes=low.shapes)
    # the planned IR and its input binding ride along in the cached
    # stats, so the measured replay reaches the program that ran
    stats["plan.ir"] = expr
    stats["plan.inputs"] = (list(low.input_names), dict(low.types),
                            dict(low.shapes))
    _admit(expr, low.shapes, low.memory_limit, stats)
    return OptimizedProgram(lowered=low, expr=expr, stats=stats,
                            optimize_ms=(time.perf_counter() - t0) * 1e3)


def _admit(expr: ir.Expr, shapes, memory_limit, stats: dict) -> None:
    """Weldbound admission: evaluate the plan's symbolic peak-memory
    certificate against the bound inputs and reject BEFORE building — a
    rejected plan costs zero kernel launches and is never cached.
    Analysis OR certificate-evaluation failures only disable admission
    (the emitter's own charging still guards execution)."""
    if not _bounds.enabled():
        return
    tb0 = time.perf_counter()
    admitted = True
    brep = None
    with obs.span("bounds") as sp:
        try:
            brep = _bounds.analyze(expr)
        except Exception:
            brep = None
        if brep is not None:
            try:
                peak = brep.peak(shapes)
                certificate = brep.certificate()
                builders = brep.builder_lines(shapes)
                out_rows = brep.result_rows(shapes)
            except Exception as e:
                # the certificate failed to evaluate at these shapes —
                # same contract as an analysis failure: fall back to the
                # emitter's charging, never kill the compile
                brep = None
                stats["bounds.degraded"] = f"{type(e).__name__}: {e}"
                sp.set("degraded", stats["bounds.degraded"])
        if brep is not None:
            admitted = memory_limit is None or peak <= int(memory_limit)
            stats["bounds.certificate"] = certificate
            stats["bounds.peak_bytes"] = peak
            stats["bounds.builders"] = builders
            stats["bounds.out_rows"] = out_rows
            stats["bounds.admitted"] = admitted
            sp.set("peak_bytes", peak)
            sp.set("admitted", admitted)
    stats["bounds.ms"] = round((time.perf_counter() - tb0) * 1e3, 3)
    if brep is not None and not admitted:
        raise ResourceError(
            f"plan rejected at admission: peak-memory certificate "
            f"{stats['bounds.certificate']} = "
            f"{stats['bounds.peak_bytes']} bytes exceeds "
            f"memory_limit={int(memory_limit)} (builder size hints + "
            f"kernel scratch footprints provably do not fit; nothing "
            f"was built or launched)")


def _jit_stage(low: LoweredProgram, expr: ir.Expr, stats: dict,
               optimize_ms: float):
    """Build what the routed calls need before the first row (the
    generated map-chain kernels, on a card) and emit the program's
    closure; ``compile_ms`` counts the optimize stage and this one."""
    t0 = time.perf_counter()
    with obs.span("jit_compile"):
        if low.kernelize_on and low.device.type == "cuda":
            from .kernelplan.registry import prepare_kernels

            t1 = time.perf_counter()
            prepare_kernels(expr, impl=low.kernel_impl)
            stats["kernels.prepare_ms"] = (time.perf_counter() - t1) * 1e3
        fn = emit_program(expr, low.input_names, low.types, low.shapes,
                          low.device, low.memory_limit,
                          kernel_impl=low.kernel_impl)
    stats["compile_ms"] = optimize_ms + (time.perf_counter() - t0) * 1e3
    return fn


def _compile_handle(low: LoweredProgram) -> Tuple[object, dict, bool]:
    """The cached, single-flight compile driver: one thread compiles a
    key, peers wait on the flight and receive the entry from it."""
    while True:
        with obs.span("cache.lookup") as sp:
            kind, payload = _cache.lookup_or_begin(low.key)
            sp.set("hit", kind == "hit")
        if kind == "hit":
            fn, stats = payload
            return fn, stats, True
        if kind == "wait":
            with obs.span("cache.wait"):
                payload.event.wait()
            if payload.entry is not None:
                fn, stats = payload.entry
                return fn, stats, True
            continue  # leader failed: this thread may lead the retry
        try:
            with _compile_lock:
                handle = low.optimize().compile()  # fills the cache
        except BaseException as e:
            _cache.abandon(low.key, e)
            raise
        return handle._fn, handle._cached_stats, False


def _execute(fn, arrays, device: torch.device):
    """Run a compiled program; the ``execute`` span ends when the card is
    done, not when the launches are queued.  Executions share the card
    (``device.shared_use``): a tuning or a measured replay waits for
    them and holds new ones off."""
    with obs.span("execute"), shared_use():
        out = fn(*arrays)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out


def _replay_if_traced(stats: dict, low: LoweredProgram, arrays) -> None:
    if obs.enabled() and stats.get("kernelize.matched"):
        pnames, ptypes, pshapes = stats["plan.inputs"]
        _measured_replay(stats["plan.ir"], pnames, ptypes, pshapes,
                         low.device, low.memory_limit, low.kernel_impl,
                         arrays)


def _decode_checked(out, ty: wt.WeldType):
    faults.maybe_raise("decode")
    if faults.poisoned("decode"):
        raise CapacityError("fault injected at decode: result poisoned")
    return decode_value(out, ty)


class CompiledProgram:
    """Stage-3 AOT handle: one compiled (plan, shape-signature) program
    plus its compile-time stats.  ``run()`` re-binds same-shape inputs
    with zero recompiles; data-dependent capacity poison at decode still
    climbs the full recovery ladder."""

    def __init__(self, lowered: LoweredProgram, fn, stats: dict,
                 from_cache: bool) -> None:
        self._low = lowered
        self._fn = fn
        self._cached_stats = stats
        self.from_cache = from_cache

    @property
    def key(self) -> str:
        return self._low.key

    @property
    def out_ty(self) -> wt.WeldType:
        return self._low.prog.out_ty

    @property
    def input_names(self) -> List[str]:
        return list(self._low.input_names)

    @property
    def stats(self) -> dict:
        return _export_stats(self._cached_stats, self.from_cache)

    def signature(self) -> str:
        """dtype:shape signature the program was compiled against."""
        return self._low.sig

    def bind(self, arrays) -> list:
        """``arrays`` (encoded, positional) as tensors on the program's
        device — a tensor already there is not copied — checked against
        the compiled signature."""
        low = self._low
        bound = [_as_input(a, low.device) for a in arrays]
        sig = _signature(bound)
        if sig != low.sig:
            raise ValueError(
                f"CompiledProgram.run: bound inputs {sig} do not match the "
                f"compiled signature {low.sig}; re-lower and compile for "
                f"new shapes/dtypes")
        return bound

    def run(self, arrays=None, *, recover: bool = True):
        """Execute against ``arrays`` (encoded, positional; None = the
        inputs the handle was lowered with) and decode the result.

        Same shapes and dtypes are the caller's contract (checked against
        the compiled signature).  On capacity poison — re-bound data
        overflowing the plan's builder capacities — the full recovery
        ladder re-runs the program with regrown capacities."""
        low = self._low
        arrays = low.arrays if arrays is None else self.bind(arrays)
        stats = self._cached_stats
        with obs.span("weld.run", from_cache=self.from_cache):
            out = _execute(self._fn, arrays, low.device)
            _replay_if_traced(stats, low, arrays)
            with obs.span("decode"):
                try:
                    return _decode_checked(out, low.prog.out_ty)
                except CapacityError:
                    from . import recovery

                    if not recover or not recovery.enabled():
                        raise
        # capacity poison under recovery: rebuild a Program bound to
        # THESE arrays and climb the full ladder (regrow → fallback)
        prog2 = Program(
            expr=low.prog.expr,
            inputs={name: (low.types[name], low.prog.inputs[name][1],
                           arrays[i])
                    for i, name in enumerate(low.input_names)},
            out_ty=low.prog.out_ty,
        )
        value, _, _, _ = compile_and_run(
            prog2, optimize=low.opt, memory_limit=low.memory_limit,
            passes=low.passes, kernelize=low.mode,
            kernel_impl=low.kernel_impl)
        return value


def compile_program(
    prog: Program,
    optimize: bool = True,
    memory_limit: Optional[int] = None,
    passes=None,
    kernelize=None,
    kernel_impl: Optional[str] = None,
) -> CompiledProgram:
    """AOT entry: lower → (cached, single-flight) optimize + compile.
    Nothing is executed; the returned handle's ``run()`` re-binds
    same-shape inputs against the cached program."""
    low = lower(prog, optimize=optimize, memory_limit=memory_limit,
                passes=passes, kernelize=kernelize, kernel_impl=kernel_impl)
    with obs.span("weld.compile", kernelize=low.mode,
                  impl=low.kernel_impl) as sp:
        fn, stats, from_cache = _compile_handle(low)
        sp.set("from_cache", from_cache)
    return CompiledProgram(low, fn, stats, from_cache)


# ---------------------------------------------------------------------------
# end-to-end driver (Evaluate path)
# ---------------------------------------------------------------------------


def compile_and_run(
    prog: Program,
    optimize: bool = True,
    memory_limit: Optional[int] = None,
    passes=None,
    kernelize=None,
    kernel_impl: Optional[str] = None,
):
    """Returns (value, compile_ms, from_cache, stats).

    ``kernelize`` selects the kernel-planner mode — ``"auto"`` (the
    process default: roofline-cost-gated routing), ``"always"``
    (``True``: route every match), or ``"off"`` (``False``).
    ``kernel_impl`` is ``"cuda"``, ``"ref"`` or None (by device); it must
    agree with the device (see ``repro_torch.kernels.ops``).

    A poisoned result (negative count) climbs the recovery ladder: the
    builder capacities regrow ×2 up to ``recovery.MAX_REGROW`` times,
    then the program degrades to the generic ``kernelize="off"``
    lowering; the stats of a recovered run carry ``recovery.*``.  With
    recovery disabled (``WELD_RECOVERY=0``) the typed ``CapacityError``
    surfaces at decode.
    """
    from .recovery import run_with_recovery

    mode, kernel_impl = _resolve(kernelize, kernel_impl)
    with obs.span("weld.evaluate", kernelize=mode, impl=kernel_impl) as root:
        return run_with_recovery(
            _compile_and_run, prog, optimize=optimize,
            memory_limit=memory_limit, passes=passes, mode=mode,
            kernel_impl=kernel_impl, root=root,
        )


def _compile_and_run(prog, optimize, memory_limit, passes, mode,
                     kernelize_on, kernel_impl, root):
    del kernelize_on  # carried by mode
    device = default_device()
    # the generic fallback rung runs "off" with the impl it was given
    low = _lower(prog, optimize, memory_limit, passes, mode,
                 kernel_impl if mode != "off" else None, device)
    fn, stats, from_cache = _compile_handle(low)
    compile_ms = 0.0 if from_cache else stats.get("compile_ms", 0.0)
    root.set("from_cache", from_cache)
    t0 = time.perf_counter()
    out = _execute(fn, low.arrays, device)
    _replay_if_traced(stats, low, low.arrays)
    with obs.span("decode"):
        value = _decode_checked(out, prog.out_ty)
    run_ms = (time.perf_counter() - t0) * 1e3
    exported = _export_stats(stats, from_cache)
    # host clock: the copy to the device, and execution through the
    # decode's copy back to the host
    exported["encode_ms"] = low.encode_ms
    exported["run_ms"] = run_ms
    return value, compile_ms, from_cache, exported


def _measured_replay(expr, input_names, types, shapes, device,
                     memory_limit, kernel_impl, arrays) -> None:
    """Re-run the planned program with every ``KernelCall`` timed, so
    each gets its own ``kernel.<name>`` span and a cost-ledger record
    (``emit_program(measure=True)``).  Runs only when tracing is on and
    a kernel was routed; an untraced evaluation never reaches here.
    Best-effort: a replay failure is recorded on the ``measure.replay``
    span, never raised.  Serialized under the compile lock, like the
    reference's eager replay, with the card to itself
    (``device.sole_use``): another thread's kernels must not run inside a
    timed call."""
    with obs.span("measure.replay") as sp:
        try:
            faults.maybe_raise("measure.replay")
            with _compile_lock, sole_use():
                fn = emit_program(expr, input_names, types, shapes, device,
                                  memory_limit, kernel_impl=kernel_impl,
                                  measure=True)
                fn(*arrays)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        except Exception as e:
            sp.set("error", f"{type(e).__name__}: {e}")


def decode_value(v, ty: wt.WeldType):
    """Backend value -> natural host value (numpy arrays / dicts / tuples);
    a poisoned vector, dict or group raises ``CapacityError``."""
    if isinstance(v, (WVec, WDict, WGroup)):
        return v.to_numpy()
    if isinstance(v, tuple):
        if isinstance(ty, wt.Struct):
            return tuple(
                decode_value(x, f) for x, f in zip(v, ty.fields)
            )
        return tuple(decode_value(x, None) for x in v)
    if isinstance(v, torch.Tensor):
        host = v.detach().cpu().numpy()
        return host.item() if host.shape == () else host
    if hasattr(v, "shape") and getattr(v, "shape", None) == ():
        return np.asarray(v).item()
    return np.asarray(v)
