"""weldserve: concurrent queries against AOT-compiled cached plans.

The paper's §7.8 economics — compile once, evaluate many times — only
pays off if something can actually *hold* the compiled plans and push
concurrent traffic through them.  :class:`QueryServer` is that driver:

* requests enter from N worker threads (a ``ThreadPoolExecutor``);
* same-plan-same-shape requests coalesce onto ONE executable through
  the runtime's bounded single-flight compile cache (one thread
  compiles a key, peers wait on the in-flight slot — never a duplicate
  compile);
* each request is admitted or shed BEFORE any kernel is built or
  launched: the runtime's weldbound admission gate evaluates the plan's
  symbolic peak-memory certificate against the request's bound shapes
  at the end of the optimize stage, and a provably over-budget query
  raises a typed :class:`~repro_torch.core.errors.ResourceError`, which
  the server accounts under the ``shed`` counter (a shed plan is never
  cached);
* executions of cached plans run concurrently — only compiles
  serialize (on the runtime's compile lock).  On a card every request's
  kernels and operators go to the device's current stream, so the
  threads overlap their host work (encoding, the adapters' Python,
  decoding) while the card runs one request's launches at a time.  A
  first-encounter tuning or a traced request's measured replay takes
  the card alone (``device.sole_use``): it waits for the executions in
  flight and holds new ones off, so no other request's kernels run
  inside its timing.

No request is retried on another route: a kernel failure, an
out-of-memory error or a C entry's refusal fails that request's future
with the error as it was raised (``serve.errors``).

Requests are duck-typed: a ``weldrel`` ``StagedQuery`` (anything with
``program()`` + ``finalize``), a raw :class:`~repro_torch.core.lazy.Program`,
or a ``WeldObject``.  This module deliberately does not import the
frames layer.  It is the JAX package's server over the port's own
runtime (``repro_torch.core.runtime``).

    with QueryServer(workers=8, memory_limit=1 << 30) as srv:
        futs = [srv.submit(Query(t).stage().join(r, on="k"))
                for _ in range(32)]
        tables = [f.result() for f in futs]
        print(srv.stats())   # requests/completed/shed + cache.* counters

The certificate is priced on the *planned* program (builder size hints
from the optimizer plus kernel scratch footprints from the planner —
an unoptimized program carries neither), so admission necessarily sits
inside the compile pipeline; it still precedes every expensive step.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

from . import obs
from . import runtime
from .errors import ResourceError
from .lazy import Program, build_program

__all__ = ["QueryServer"]


def _identity(v):
    return v


class QueryServer:
    """Thread-pooled serving driver over the AOT compile pipeline.

    ``memory_limit`` / ``kernelize`` / ``kernel_impl`` are server-wide
    defaults; a staged query's own settings (when not None) win.  Use as
    a context manager or call :meth:`close`."""

    def __init__(self, workers: int = 8,
                 memory_limit: Optional[int] = None,
                 kernelize=None, kernel_impl: Optional[str] = None):
        if workers < 1:
            raise ValueError("QueryServer needs at least one worker")
        self.workers = workers
        self.memory_limit = memory_limit
        self.kernelize = kernelize
        self.kernel_impl = kernel_impl
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="weldserve")
        self._lock = threading.Lock()
        self._counters = {
            "serve.requests": 0,
            "serve.completed": 0,
            "serve.shed": 0,
            "serve.errors": 0,
        }
        self._closed = False

    # -- request intake ------------------------------------------------------

    def submit(self, query) -> Future:
        """Enqueue one query; returns a ``concurrent.futures.Future``
        resolving to the query's natural result (a finalized weldrel
        value for staged queries, the decoded value otherwise).  A shed
        request fails the future with :class:`ResourceError`."""
        if self._closed:
            raise RuntimeError("QueryServer is closed")
        with self._lock:
            self._counters["serve.requests"] += 1
        return self._pool.submit(self._serve_one, query)

    def run(self, query):
        """Synchronous :meth:`submit`."""
        return self.submit(query).result()

    def map(self, queries) -> List[object]:
        """Submit every query, gather results in order (first error
        propagates after all futures settle)."""
        futs = [self.submit(q) for q in queries]
        out, first_err = [], None
        for f in futs:
            try:
                out.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                out.append(None)
                first_err = first_err or e
        if first_err is not None:
            raise first_err
        return out

    # -- lifecycle -----------------------------------------------------------

    def stats(self) -> dict:
        """Server counters merged with the runtime's ``cache.*``
        counters (hits/misses/evictions/waits/size)."""
        with self._lock:
            out = dict(self._counters)
        out.update(runtime.cache_stats())
        return out

    def close(self, wait: bool = True) -> None:
        self._closed = True
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the per-request pipeline -------------------------------------------

    def _serve_one(self, query):
        prog, finalize, op, limit, kz, ki = self._normalize(query)
        with obs.span("serve.request", op=op):
            try:
                handle = runtime.compile_program(
                    prog, memory_limit=limit, kernelize=kz, kernel_impl=ki)
                value = handle.run()
                result = finalize(value)
            except ResourceError as e:
                obs.event("serve.shed", op=op, reason=str(e))
                with self._lock:
                    self._counters["serve.shed"] += 1
                raise
            except BaseException:
                with self._lock:
                    self._counters["serve.errors"] += 1
                raise
            with self._lock:
                self._counters["serve.completed"] += 1
            return result

    def _normalize(self, query) -> Tuple[Program, Callable, str,
                                         Optional[int], object,
                                         Optional[str]]:
        """(program, finalize, op, memory_limit, kernelize, kernel_impl)
        for any accepted request shape."""
        prog_fn = getattr(query, "program", None)
        if callable(prog_fn) and hasattr(query, "finalize"):
            # weldrel StagedQuery (duck-typed: no frames import here)
            q_limit = getattr(query, "memory_limit", None)
            q_kz = getattr(query, "kernelize", None)
            q_ki = getattr(query, "kernel_impl", None)
            return (
                prog_fn(),
                query.finalize,
                getattr(query, "op", "staged"),
                q_limit if q_limit is not None else self.memory_limit,
                q_kz if q_kz is not None else self.kernelize,
                q_ki if q_ki is not None else self.kernel_impl,
            )
        if isinstance(query, Program):
            return (query, _identity, "program", self.memory_limit,
                    self.kernelize, self.kernel_impl)
        if hasattr(query, "obj_id") and hasattr(query, "expr"):
            # a lazy WeldObject DAG root
            return (build_program(query), _identity, "weldobject",
                    self.memory_limit, self.kernelize, self.kernel_impl)
        raise TypeError(
            f"QueryServer cannot serve {type(query).__name__}: expected "
            "a weldrel StagedQuery, a core.lazy.Program, or a WeldObject")
