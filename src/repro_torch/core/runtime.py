"""Evaluation: lower → optimize → plan → emit → execute → decode.

One `Evaluate` call runs the whole stitched workflow as one program on
the default device (the paper's evaluation point).  "Compiling" a
program means running the optimizer passes and the kernel planner over
its IR and building the emitter's closure; the result is cached by
alpha-invariant structure + input signature, so a re-evaluation of the
same workflow shape skips straight to execution.

The compile cache is a bounded, locked, single-flight LRU
(``$WELD_COMPILE_CACHE_MAX``, default 256): one thread compiles a given
key while peers wait on the in-flight slot, eviction is
least-recently-used, and hit/miss/evict/wait counters surface in every
result's ``stats["cache.*"]``.

``compile_and_run`` (what `Evaluate` calls) runs under the recovery
ladder (``core/recovery.py``): a poisoned result regrows the builder
capacities and retries, then degrades to the generic lowering; a kernel
that fails to build (or whose ``kernel.<route>`` fault fires) is
quarantined, and the program re-runs on the generic lowering on the CPU
and raises on a card.

Along the way: with ``WELD_VERIFY=1`` the input program, every pass's
output and the planned program are verified (``check.checkpoint``);
weldbound admission evaluates the plan's peak-memory certificate
against ``memory_limit`` before anything is built or launched
(:func:`_admit`); the build step (each generated kernel's ``nvcc``, the
emitter's closure) runs under the ``jit_compile`` span; and with
tracing on, a kernelized evaluation is replayed once with every kernel
call timed (:func:`_measured_replay`), which writes the cost ledger.

Left for a later slice (ROADMAP A): the AOT staging API.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check
from . import faults
from . import ir
from . import obs
from . import wtypes as wt
from ..device import default_device
from .analysis import bounds as _bounds
from .backend.torchgen import emit_program
from .backend.values import WDict, WGroup, WVec
from .errors import CapacityError, ResourceError
from .lazy import Program
from .passes import loop_count, optimize as run_passes

ENV_CACHE_MAX = "WELD_COMPILE_CACHE_MAX"
DEFAULT_CACHE_MAX = 256

#: Serializes the optimize→plan→emit compile body (the optimizer and
#: planner touch process-global state); executions of compiled programs
#: run WITHOUT this lock.
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

    def fill(self, key: str, entry: Tuple[object, dict]) -> None:
        """Store the compiled entry and resolve any waiters."""
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
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


def _encode(prog: Program, device: torch.device):
    """Inputs in sorted-name order as tensors on ``device``."""
    names = sorted(prog.inputs)
    arrays, shapes, types = [], {}, {}
    for name in names:
        ty, enc, data = prog.inputs[name]
        host = np.ascontiguousarray(np.asarray(enc.encode(data)))
        arr = torch.from_numpy(host).to(device)
        arrays.append(arr)
        shapes[name] = tuple(arr.shape)
        types[name] = ty
    return names, arrays, shapes, types


def _cache_key(prog: Program, names: List[str], arrays, opt: bool,
               memory_limit, passes, mode: str, kernel_impl,
               device: torch.device) -> str:
    # positional input aliasing: rebuilt workflows (fresh obj ids) share
    # one compiled program as long as structure matches
    name_map = {n: f"in{i}" for i, n in enumerate(names)}
    sig = ",".join(f"{a.dtype}:{tuple(a.shape)}" for a in arrays)
    kreg = _kreg_fingerprint() if mode != "off" else ""
    return (
        ir.canon_key(prog.expr, name_map)
        + f"|opt={opt}|mem={memory_limit}|passes={passes}"
        + f"|kz={mode}|kimpl={kernel_impl}|kreg={kreg}|dev={device}"
        + f"|flt={faults.fingerprint()}|{sig}"
    )


def _kreg_fingerprint() -> str:
    """The kernel registry and the quarantine state: registering or
    unregistering a spec, and quarantining or clearing a kernel, must
    never be served by a stale compiled program."""
    from .kernelplan import fingerprint, quarantine

    return fingerprint() + "/" + quarantine.fingerprint()


def _compile(prog: Program, names, shapes, types, opt: bool, memory_limit,
             passes, mode: str, kernel_impl, device) -> Tuple[object, dict]:
    """Optimize + plan + admit + emit one program."""
    t0 = time.perf_counter()
    expr = prog.expr
    stats: dict = {}
    stats["loops.before"] = loop_count(expr)
    # verify the frontend's program before any rewrite touches it: a
    # pre-existing violation must be blamed on the input, not on
    # whichever pass happens to run first
    check.checkpoint("input", expr, env=types, stats=stats, shapes=shapes)
    if opt:
        with obs.span("optimize"):
            expr = run_passes(expr, passes=passes, stats=stats,
                              input_shapes=shapes)
    stats["loops.after"] = loop_count(expr)
    if mode != "off":
        from .kernelplan import plan_kernels

        with obs.span("kernelplan", mode=mode) as sp:
            expr = plan_kernels(expr, input_shapes=shapes, stats=stats,
                                mode=mode, impl=kernel_impl)
            sp.set("matched", stats.get("kernelize.matched", 0))
    # the planned IR and its input binding ride along in the cached
    # stats, so the measured replay reaches the program that ran
    stats["plan.ir"] = expr
    stats["plan.inputs"] = (list(names), dict(types), dict(shapes))
    _admit(expr, shapes, memory_limit, stats)
    with obs.span("jit_compile"):
        if mode != "off" and torch.device(device).type == "cuda":
            # build what the routed calls need before the first row (the
            # generated map-chain kernels); counted in compile_ms
            from .kernelplan.registry import prepare_kernels

            t1 = time.perf_counter()
            prepare_kernels(expr, impl=kernel_impl)
            stats["kernels.prepare_ms"] = (time.perf_counter() - t1) * 1e3
        fn = emit_program(expr, names, types, shapes, device, memory_limit,
                          kernel_impl=kernel_impl)
    stats["compile_ms"] = (time.perf_counter() - t0) * 1e3
    return fn, stats


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


def _compile_cached(key: str, build) -> Tuple[object, dict, bool]:
    """The cached, single-flight compile path: one thread compiles a
    key, peers wait on the flight and receive the entry from it."""
    while True:
        with obs.span("cache.lookup") as sp:
            kind, payload = _cache.lookup_or_begin(key)
            sp.set("hit", kind == "hit")
        if kind == "hit":
            fn, stats = payload
            return fn, stats, True
        if kind == "wait":
            payload.event.wait()
            if payload.entry is not None:
                fn, stats = payload.entry
                return fn, stats, True
            continue  # leader failed: this thread may lead the retry
        try:
            with _compile_lock:
                entry = build()
        except BaseException as e:
            _cache.abandon(key, e)
            raise
        _cache.fill(key, entry)
        return entry[0], entry[1], False


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
    from .kernelplan import normalize_kernelize
    from .recovery import run_with_recovery

    mode = normalize_kernelize(kernelize)
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
    t0 = time.perf_counter()
    with obs.span("encode", inputs=len(prog.inputs)):
        names, arrays, shapes, types = _encode(prog, device)
    encode_ms = (time.perf_counter() - t0) * 1e3
    key = _cache_key(prog, names, arrays, optimize, memory_limit, passes,
                     mode, kernel_impl, device)
    fn, stats, from_cache = _compile_cached(
        key, lambda: _compile(prog, names, shapes, types, optimize,
                              memory_limit, passes, mode, kernel_impl,
                              device))
    compile_ms = 0.0 if from_cache else stats.get("compile_ms", 0.0)
    root.set("from_cache", from_cache)
    t0 = time.perf_counter()
    with obs.span("execute"):
        out = fn(*arrays)
        if device.type == "cuda":
            # the span ends when the card is done, not when the launches
            # are queued
            torch.cuda.synchronize(device)
    if obs.enabled() and stats.get("kernelize.matched"):
        pnames, ptypes, pshapes = stats["plan.inputs"]
        _measured_replay(stats["plan.ir"], pnames, ptypes, pshapes,
                         device, memory_limit, kernel_impl, arrays)
    with obs.span("decode"):
        faults.maybe_raise("decode")
        if faults.poisoned("decode"):
            raise CapacityError("fault injected at decode: result poisoned")
        value = decode_value(out, prog.out_ty)
    run_ms = (time.perf_counter() - t0) * 1e3
    exported = _copy_stats(stats)
    exported.update(_cache.counters())
    exported["cache.hit"] = from_cache
    # host clock: the copy to the device, and execution through the
    # decode's copy back to the host
    exported["encode_ms"] = encode_ms
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
    reference's eager replay."""
    with obs.span("measure.replay") as sp:
        try:
            faults.maybe_raise("measure.replay")
            with _compile_lock:
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
