"""Empirical launch-parameter autotuner for planned kernel calls.

Four of the port's kernel routes take a launch parameter at run time:
the grid cap ``max_blocks`` of ``filter_reduce`` (B1, B2),
``segment_reduce`` (B4, B5) and the generated map chains (B3), whose
default is the cap each kernel module uses untuned.  The best cap is a
function of dtype, problem size and card.  On the *first encounter* of a
``(kernel, dtype, size-bucket, impl, device)`` key the tuner times the
spec's ``tune_space`` on a synthetic workload of the same bucket
(``spec.make_bench``, tensors on the card), memoizes the winner in an
on-disk JSON cache, and every later compile reuses it for free.  The
default is always a candidate, so a tuned plan can only match or beat
the default by the tuner's clock.

The cache defaults to ``~/.cache/weld-repro/autotune.json``, overridable
via ``$WELD_AUTOTUNE_CACHE``; its :func:`fingerprint` participates in
the runtime's compile-cache key, so a newly tuned plan can never be
served by a stale compiled program.

Where the port departs from the reference's tuner, and why:

* the key names the card (``torch.cuda.get_device_name`` or ``cpu``,
  as the quarantine's does): a tuning from another card is never
  served;
* ``impl=None`` resolves by the default device *before* the
  short-circuit — ``"cuda"`` on a card, ``"ref"`` on the CPU — and only
  ``"ref"`` (the plain versions, which take no grid) returns the
  defaults untimed;
* a candidate is timed as device work: CUDA events around each rep on
  a private stream of a synchronized card (the host clock around an
  asynchronous launch would time the enqueueing); 1 warm-up, the
  minimum of 3 reps.  The timing holds the card alone
  (``device.sole_use``): a serving thread's kernels would otherwise run
  between a candidate's events;
* a candidate replaces the default only when it is faster by more than
  the clock's spread: :data:`MIN_GAIN`, or the default's own spread over
  its reps where that is larger.  B1, B2, B4 and B5 round by their
  grid, so noise must not pick the rounding of every later result;
* only the injected ``autotune.time`` fault skips a candidate (no kernel
  ran).  Every candidate in a space is a valid launch, so a C entry's
  refusal, a CUDA error or an out-of-memory error while a candidate is
  built or timed raises as it is: nothing stands in for a kernel;
* the timing runs' launches are counted aside (``kernels/_count.aside``),
  so the wrappers' counts hold a program's own calls only.

``tune_plan`` is the planner-side entry: it walks a planned program and
appends the chosen parameters to each ``KernelCall``'s static params
(where the registry adapters forward them to ``kernels/ops.py`` and
``pretty.py`` displays them).  The cache is guarded by a lock: serving
threads read its fingerprint while a compile may be tuning.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ...kernels import _count
from .. import ir
from .. import obs
from .. import wtypes as wt
from . import registry as reg

ENV_CACHE = "WELD_AUTOTUNE_CACHE"
ENV_DISABLE = "WELD_AUTOTUNE_DISABLE"

#: timing schedule per candidate: warmup + timed reps (min).
WARMUP = 1
REPS = 3

#: the least share of the default's time a candidate must save to
#: replace it (the tuner's clock varies by a few per cent between reps)
MIN_GAIN = 0.05

#: floor bucket so micro sizes don't fragment the cache.
MIN_BUCKET = 1024

_lock = threading.RLock()
_cache: Optional[Dict[str, dict]] = None  # lazily loaded from disk
_generation = 0  # bumps on every mutation (part of fingerprint)


def cache_path() -> str:
    return os.environ.get(ENV_CACHE) or os.path.join(
        os.path.expanduser("~"), ".cache", "weld-repro", "autotune.json"
    )


def _load() -> Dict[str, dict]:
    global _cache
    with _lock:
        if _cache is None:
            path = cache_path()
            try:
                with open(path) as f:
                    _cache = json.load(f)
                if not isinstance(_cache, dict):
                    raise ValueError("cache root is not an object")
            except OSError:
                _cache = {}  # no cache yet: normal first run
            except ValueError as e:
                # a corrupt or truncated file must not break the compile:
                # start empty and re-tune; the next _save overwrites it
                warnings.warn(
                    f"autotune cache {path} is corrupt ({e}); ignoring it "
                    "and re-tuning from scratch — delete the file to "
                    "silence this warning",
                    RuntimeWarning, stacklevel=2,
                )
                _cache = {}
        return _cache


def _save() -> None:
    from .. import faults

    path = cache_path()
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        # the io.autotune_cache failpoint proves persistence really is
        # best-effort: an injected OSError must leave tuning in-process
        faults.maybe_raise("io.autotune_cache", exc=OSError)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _lock:
            text = json.dumps(_cache, indent=1, sort_keys=True)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)  # atomic: readers never see a partial file
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        # tuning still applies in-process; persistence is best-effort


def clear_cache(disk: bool = True) -> None:
    """Reset tunings (tests / after a platform change)."""
    global _cache, _generation
    with _lock:
        _cache = {}
        _generation += 1
    if disk:
        try:
            os.remove(cache_path())
        except OSError:
            pass


def invalidate(kernel: Optional[str] = None) -> int:
    """Drop cached tunings for one kernel (or all); returns drop count."""
    global _generation
    with _lock:
        c = _load()
        keys = [k for k in c if kernel is None or k.startswith(f"{kernel}|")]
        for k in keys:
            del c[k]
        if keys:
            _generation += 1
    if keys:
        _save()
    return len(keys)


def fingerprint() -> str:
    """Stable digest of the tuning state for the compile-cache key."""
    import zlib

    with _lock:
        c = _load()
        items = ";".join(
            f"{k}={sorted(v.get('params', {}).items())}"
            for k, v in sorted(c.items()))
        return f"g{_generation}n{len(c)}h{zlib.crc32(items.encode()):08x}"


def size_bucket(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def device_name() -> str:
    """The default device's name: the card's, or ``"cpu"``."""
    from .quarantine import device_name as _name

    return _name()


def resolve_impl(impl: Optional[str]) -> str:
    """``impl`` as the kernel entries will take it: None means the
    default device's (``"cuda"`` on a card, ``"ref"`` on the CPU)."""
    if impl is not None:
        return impl
    from ...device import default_device

    return "cuda" if default_device().type == "cuda" else "ref"


def _key(kernel: str, dtype, n: int, impl: str,
         k: Optional[int] = None, dims: Optional[tuple] = None) -> str:
    """Cache key.  K (segment width) and matmul dims shape the launch as
    much as n does, so they are part of the key; the device's name ends
    it, so one card's tuning is never served on another."""
    extra = f"|k{size_bucket(int(k))}" if k else ""
    if dims:
        extra += "|d" + "x".join(str(size_bucket(int(d))) for d in dims)
    return (f"{kernel}|{np.dtype(dtype).name}|{size_bucket(int(n))}{extra}"
            f"|{impl}|{device_name()}")


def _grid(space: Dict[str, tuple]) -> Iterable[Dict[str, int]]:
    names = sorted(space)
    points = [{}]
    for name in names:
        points = [dict(p, **{name: v}) for p in points for v in space[name]]
    return points


class _Timing(float):
    """A candidate's time (seconds, the minimum of its reps) carrying
    ``spread``: (slowest - fastest) / fastest over the reps."""

    spread = 0.0


def _time_candidate(go) -> float:
    """Seconds of one launch of ``go``, the minimum of :data:`REPS` after
    :data:`WARMUP`: on a card the device time between CUDA events
    recorded around it on a private stream after a synchronize, on the
    CPU the host clock.  The result's ``spread`` is the reps' spread."""
    from ...device import default_device

    dev = default_device()
    cuda = dev.type == "cuda"
    times = []
    with contextlib.ExitStack() as stack:
        if cuda:
            torch.cuda.synchronize(dev)
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
        for _ in range(WARMUP):
            go()
        for _ in range(REPS):
            if cuda:
                torch.cuda.synchronize(dev)
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                go()
                ev1.record()
                ev1.synchronize()
                times.append(ev0.elapsed_time(ev1) / 1e3)
            else:
                t0 = time.perf_counter()
                go()
                times.append(time.perf_counter() - t0)
        if cuda:
            torch.cuda.synchronize(dev)
    out = _Timing(min(times))
    out.spread = (max(times) - out) / out if out > 0 else 0.0
    return out


def lookup(kernel: str, dtype, n: int, impl: str,
           k: Optional[int] = None,
           dims: Optional[tuple] = None) -> Optional[Dict[str, int]]:
    ent = entry(kernel, dtype, n, impl, k=k, dims=dims)
    return dict(ent["params"]) if ent else None


def entry(kernel: str, dtype, n: int, impl: str, k: Optional[int] = None,
          dims: Optional[tuple] = None) -> Optional[dict]:
    """The cached record of one key: ``params``, and the winner's and the
    default's times by the tuner's clock (``us``, ``default_us``)."""
    with _lock:
        ent = _load().get(_key(kernel, dtype, n, resolve_impl(impl), k=k,
                               dims=dims))
        return dict(ent) if ent else None


def tune(spec: "reg.KernelSpec", meta: dict, impl: Optional[str],
         force: bool = False) -> Tuple[Dict[str, int], bool]:
    """Resolve tuned params for one call site.

    Returns ``(params, from_cache)``.  Returns the spec's defaults
    (without timing or cache writes) when tuning cannot help: no tunable
    space, no bench, unknown size, the plain versions (``impl="ref"``, or
    None on the CPU), or tuning disabled.
    """
    global _generation
    from .. import faults
    from ..errors import InjectedFault

    n = meta.get("n") or 0
    k, dims = meta.get("k"), meta.get("dims")
    defaults = dict(spec.tune_defaults)
    if not spec.tune_space or n <= 0:
        return defaults, False
    impl = resolve_impl(impl)
    if impl == "ref" or os.environ.get(ENV_DISABLE):
        return defaults, False
    dtype = meta.get("dtype", "f8")
    cached = None if force else lookup(spec.name, dtype, n, impl, k=k,
                                       dims=dims)
    if cached is not None:
        return cached, True
    if spec.make_bench is None:
        return defaults, False
    # time the space on a synthetic same-bucket workload
    from ...device import sole_use

    bench_meta = dict(meta, n=size_bucket(n))
    timed = []
    with obs.span("autotune.tune", kernel=spec.name, n=size_bucket(n),
                  impl=impl) as tsp, sole_use():
        for cand in sorted(_grid(spec.tune_space), key=lambda c: c != defaults):
            try:
                faults.maybe_raise("autotune.time")
            except InjectedFault:
                # the injected timer fault: no kernel ran, skip the point
                obs.event("autotune.candidate", kernel=spec.name,
                          skipped=True, **cand)
                continue
            # anything else (a C entry's refusal, a CUDA error, an
            # out-of-memory error) raises as it is.  The timing runs'
            # launches are counted aside, not as the program's own
            with _count.aside():
                t = _time_candidate(spec.make_bench(bench_meta, cand, impl))
            obs.event("autotune.candidate", kernel=spec.name,
                      us=round(t * 1e6, 2), **cand)
            timed.append((cand, t))
        best_params, best_t, default_t = _winner(timed, defaults)
        tsp.set("best", dict(best_params))
        if best_t < float("inf"):
            tsp.set("us", round(best_t * 1e6, 2))
    with _lock:
        c = _load()
        c[_key(spec.name, dtype, n, impl, k=k, dims=dims)] = {
            "params": best_params,
            "us": round(best_t * 1e6, 2) if best_t < float("inf") else None,
            "default_us": (round(default_t * 1e6, 2)
                           if default_t is not None else None),
        }
        _generation += 1
    _save()
    return dict(best_params), False


def _winner(timed, defaults):
    """(params, seconds, the default's seconds or None) of the tuned
    point: the fastest candidate that beats the default by more than the
    clock's spread (:data:`MIN_GAIN`, or the default's own spread), else
    the default; the fastest of all when the default was not timed."""
    default_t = next((t for c, t in timed if c == defaults), None)
    if default_t is None:
        best = min(timed, key=lambda ct: ct[1], default=(defaults,
                                                         float("inf")))
        return best[0], best[1], None
    gain = max(MIN_GAIN, getattr(default_t, "spread", 0.0))
    faster = [(c, t) for c, t in timed if t < default_t * (1.0 - gain)]
    best = min(faster, key=lambda ct: ct[1], default=(defaults, default_t))
    return best[0], best[1], default_t


# ---------------------------------------------------------------------------
# Plan-level entry: bake tuned params into KernelCall nodes
# ---------------------------------------------------------------------------


def _np_dtype_of(ty: wt.WeldType):
    if isinstance(ty, wt.Vec):
        return _np_dtype_of(ty.elem)
    if isinstance(ty, wt.Struct):
        return _np_dtype_of(ty.fields[0]) if ty.fields else np.float64
    if isinstance(ty, wt.DictType):
        return _np_dtype_of(ty.val)
    if isinstance(ty, wt.Scalar):
        return np.dtype(ty.np_dtype)
    return np.float64


def tune_plan(e: ir.Expr, impl: Optional[str],
              stats: Optional[dict] = None) -> ir.Expr:
    """Attach tuned (or default) launch parameters to every planned
    ``KernelCall`` whose spec has a tune space.  Identity when the
    program has no such call.  ``stats["kernelplan"]["autotune"]`` gets
    one event a call: kernel, n, the chosen params, whether they came
    from the cache, and the winner's and the default's times (µs, by the
    tuner's clock; None when nothing was timed)."""
    events = []

    def rec(x: ir.Expr) -> ir.Expr:
        x = x.map_children(rec)
        if not isinstance(x, ir.KernelCall):
            return x
        spec = reg.available(x.kernel)
        if spec is None or not spec.tune_space:
            return x
        params = dict(x.params)
        if any(k in params for k in spec.tune_space):
            return x  # already tuned (e.g. plan reuse)
        meta = {
            "kernel": x.kernel,
            "n": params.get("n_rows") if params.get("n_rows", -1) > 0 else None,
            "k": params.get("capacity") or params.get("k"),
            "dims": params.get("dims"),
            "dtype": _np_dtype_of(x.ret_ty),
        }
        chosen, from_cache = tune(spec, meta, impl)
        if not chosen:
            return x
        ent = (entry(x.kernel, meta["dtype"], meta["n"], impl, k=meta["k"],
                     dims=meta["dims"]) if meta["n"] else None) or {}
        events.append({
            "kernel": x.kernel,
            "n": meta["n"],
            "params": dict(chosen),
            "cached": from_cache,
            "us": ent.get("us"),
            "default_us": ent.get("default_us"),
        })
        return ir.KernelCall(
            kernel=x.kernel,
            args=x.args,
            ret_ty=x.ret_ty,
            params=x.params + tuple(sorted(chosen.items())),
            fns=x.fns,
        )

    out = rec(e)
    if stats is not None and events:
        stats.setdefault("kernelplan", {})["autotune"] = events
    return out
