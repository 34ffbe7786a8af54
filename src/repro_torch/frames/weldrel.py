"""weldrel — the Spark SQL integration (paper §6).

Column-store tables with relational operators (scan/filter/aggregate/
grouped-aggregate/hash join).  Mirrors the paper's port: *each operator emits its
own loop, independent of downstream operators*, and Weld's optimizer
fuses the chain into one pass.  Used for the TPC-H Q1/Q6 workloads.

``Query.stage()`` / ``compile()`` capture the next operator as a
:class:`StagedQuery` / :class:`CompiledQuery` (compile once, run many
times; ``core.serve.QueryServer`` serves staged queries), and
``Query.explain()`` reports its plan, tuned kernels and cost-gate
decisions as a :class:`PlanReport`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import faults, ir, wtypes as wt
from ..core.errors import CapacityError
from ..core.lazy import Evaluate, NewWeldObject, WeldObject, build_program
from . import weldnp


class Table:
    def __init__(self, columns: Dict[str, np.ndarray], eager: bool = False):
        self.eager = eager
        self.cols = {
            k: weldnp.array(np.asarray(v), eager=eager)
            for k, v in columns.items()
        }

    def col(self, name: str) -> weldnp.ndarray:
        return self.cols[name]


class Query:
    """A chain of relational operators over a table.  Each operator appends
    an independent IR fragment; the aggregate is the evaluation point."""

    def __init__(self, table: Table):
        self.table = table
        self.pred: Optional[weldnp.ndarray] = None
        #: set by the stage()/compile() proxies: operator tails return a
        #: StagedQuery instead of evaluating
        self._staged = False

    def filter(self, pred: weldnp.ndarray) -> "Query":
        self.pred = pred if self.pred is None else (self.pred & pred)
        return self

    def stage(self) -> "_Stage":
        """Capture the *next* operator as a :class:`StagedQuery` instead
        of evaluating it::

            sq = Query(t).filter(p).stage().join(r, on="key")

        The staged query binds the operator's tables and IR but compiles
        nothing; hand it to ``core.serve.QueryServer.submit`` or call
        ``sq.compile()`` for the AOT handle.  Lazy tables only."""
        return _Stage(self)

    def compile(self, collect_stats: Optional[dict] = None) -> "_Compile":
        """AOT-compile the *next* operator::

            cq = Query(t).compile().join(r, on="key")   # CompiledQuery
            out1 = cq.run()                   # the staged tables
            out2 = cq.run(table=t2, right=r2)  # same shapes, 0 recompiles

        Returns a proxy; calling an operator on it yields a
        :class:`CompiledQuery` with ``.stats``, ``.explain()`` and
        ``.run(**tables)``.  Compilation goes through the runtime's
        bounded single-flight cache, so repeated compiles of the same
        (plan, shape) are free."""
        return _Compile(self, collect_stats)

    def explain(self, analyze: bool = False) -> "_Explain":
        """EXPLAIN [ANALYZE] the *next* operator instead of returning its
        result.  Call an operator on the returned proxy exactly as you
        would on the query::

            rep = Query(t).explain().join(r, on="key")
            rep = Query(t).explain(analyze=True).agg({...})
            print(rep)

        The report shows the fused IR after planning, every routed
        kernel with its tuned launch parameters and roofline estimate,
        the autotuner's choices, and the cost gate's route/reject
        decisions with their source (roofline or measured).  With
        ``analyze=True`` the query also runs with tracing enabled, adding
        per-span measured times and predicted-vs-measured ratios per
        kernel launch (the operator's result is still computed and
        available as ``rep.result``)."""
        return _Explain(self, analyze)

    def _finish(self, obj: WeldObject, finalize: Callable, *, op: str,
                tables: Dict[str, "Table"], memory_limit=None,
                kernelize=None, kernel_impl=None, collect_stats=None):
        """Common tail of every lazy operator: evaluate now (the normal
        path) or, under stage()/compile(), capture the program plus the
        result finalizer as a :class:`StagedQuery`."""
        if self._staged:
            return StagedQuery(op=op, obj=obj, finalize=finalize,
                               tables=dict(tables),
                               memory_limit=memory_limit,
                               kernelize=kernelize,
                               kernel_impl=kernel_impl)
        res = Evaluate(obj, memory_limit=memory_limit, kernelize=kernelize,
                       kernel_impl=kernel_impl, collect_stats=collect_stats)
        return finalize(res.value)

    # -- ungrouped aggregate ---------------------------------------------------

    def agg(self, exprs: Dict[str, Tuple[weldnp.ndarray, str]],
            kernelize=None, kernel_impl=None,
            collect_stats: Optional[dict] = None):
        """exprs: name -> (value column expression, op).  Returns dict of
        scalars; single fused pass over the data.  Under the default
        ``kernelize="auto"`` the fused filter+reduce routes onto the
        CUDA kernel library when the cost gate favors it — all
        aggregates share one multi-output kernel launch; ``"always"``/
        True forces the route, ``"off"``/False disables it."""
        if self.table.eager:
            out = {}
            m = self.pred._eager if self.pred is not None else None
            for name, (col, op) in exprs.items():
                v = col._eager
                if m is not None:
                    v = v[m]
                # empty/fully-filtered input reduces to the merger
                # identity of the op, matching the lazy path (0 for "+",
                # 1 for "*", +/-inf-like extremes for min/max)
                out[name] = {
                    "+": np.sum, "min": np.min, "max": np.max, "*": np.prod,
                }[op](v) if v.size else wt.merge_identity(
                    op, wt.dtype_to_weld(v.dtype))
            return out

        names = list(exprs)
        deps: List[WeldObject] = []
        ids: List[ir.Expr] = []
        seen: Dict[str, int] = {}

        def slot(arr: weldnp.ndarray) -> int:
            if arr.obj.obj_id not in seen:
                seen[arr.obj.obj_id] = len(ids)
                deps.append(arr.obj)
                ids.append(ir.Ident(arr.obj.obj_id, arr.obj.weld_type()))
            return seen[arr.obj.obj_id]

        val_slots = [slot(exprs[n][0]) for n in names]
        pred_slot = slot(self.pred) if self.pred is not None else None

        builders = tuple(
            wt.Merger(exprs[n][0].weld_elem_ty, exprs[n][1]) for n in names
        )
        sbt = wt.StructBuilder(builders)
        elem_ty = (
            wt.Struct(tuple(_ety(i, ids) for i in range(len(ids))))
            if len(ids) > 1 else _ety(0, ids)
        )
        b = ir.Ident(ir.fresh("b"), sbt)
        i = ir.Ident(ir.fresh("i"), wt.I64)
        x = ir.Ident(ir.fresh("x"), elem_ty)

        def field(k: int) -> ir.Expr:
            return ir.GetField(x, k) if len(ids) > 1 else x

        cur: ir.Expr = b
        items = []
        for k, n in enumerate(names):
            items.append(ir.Merge(ir.GetField(b, k), field(val_slots[k])))
        merged = ir.MakeStruct(tuple(items))
        if pred_slot is not None:
            body: ir.Expr = ir.If(field(pred_slot), merged, b)
        else:
            body = merged
        loop = ir.For(
            tuple(ir.Iter(idn) for idn in ids),
            ir.MakeStruct(tuple(ir.NewBuilder(bt) for bt in builders)),
            ir.Lambda((b, i, x), body),
        )
        obj = NewWeldObject(deps, ir.Result(loop))
        return self._finish(
            obj, lambda v: {n: v[k] for k, n in enumerate(names)},
            op="agg", tables={"table": self.table},
            kernelize=kernelize, kernel_impl=kernel_impl,
            collect_stats=collect_stats)

    # -- grouped aggregate -------------------------------------------------------

    def group_agg(
        self,
        keys: Sequence[weldnp.ndarray],
        vals: Dict[str, Tuple[weldnp.ndarray, str]],
        capacity: int = 4096,
        kernelize=None,
        kernel_impl=None,
        collect_stats: Optional[dict] = None,
    ):
        """GROUP BY keys; all aggregates share ONE dictmerger pass.
        Returns {key_tuple: (agg,...)} (+ implicit count as last value).

        NOTE: grouped multi-aggregates build a struct-valued dictmerger,
        which the kernel planner does not yet route (ROADMAP: multi-agg
        fusion) — ``kernelize=True`` is accepted for API symmetry but
        currently always falls back to the generic sort-based path."""
        if self.table.eager:
            # same contract as the lazy path below: anything but "+"
            # must fail loudly instead of silently summing
            ops = {vals[n][1] for n in vals} | {"+"}
            assert ops == {"+"}, "grouped aggregates support sum/count"
            m = self.pred._eager if self.pred is not None else slice(None)
            karrs = [k._eager[m] for k in keys]
            varrs = [vals[n][0]._eager[m] for n in vals]
            # per-dtype merger identities: an int value column accumulates
            # as ints and decodes as ints, exactly like the lazy dict path
            # (the old [0.0]*n seed floated every aggregate)
            idents = [
                wt.merge_identity("+", wt.dtype_to_weld(v.dtype))
                for v in varrs
            ]
            packed = list(zip(*karrs))
            out: dict = {}
            for row_idx, kt in enumerate(packed):
                # single-key groups use the bare scalar, like the lazy
                # path's dict decode — not a 1-tuple
                kt = tuple(x.item() for x in kt)
                kt = kt[0] if len(kt) == 1 else kt
                slotv = out.setdefault(kt, list(idents) + [0])
                for j, v in enumerate(varrs):
                    slotv[j] += v[row_idx]
                slotv[-1] += 1
            return {
                k: tuple(x.item() if isinstance(x, np.generic) else x
                         for x in v)
                for k, v in out.items()
            }

        names = list(vals)
        deps: List[WeldObject] = []
        ids: List[ir.Expr] = []
        seen: Dict[str, int] = {}

        def slot(arr: weldnp.ndarray) -> int:
            if arr.obj.obj_id not in seen:
                seen[arr.obj.obj_id] = len(ids)
                deps.append(arr.obj)
                ids.append(ir.Ident(arr.obj.obj_id, arr.obj.weld_type()))
            return seen[arr.obj.obj_id]

        key_slots = [slot(k) for k in keys]
        val_slots = [slot(vals[n][0]) for n in names]
        pred_slot = slot(self.pred) if self.pred is not None else None
        ops = {vals[n][1] for n in names} | {"+"}
        assert ops == {"+"}, "grouped aggregates support sum/count"

        key_ty = wt.Struct(tuple(_ety(s, ids) for s in key_slots)) \
            if len(key_slots) > 1 else _ety(key_slots[0], ids)
        val_ty = wt.Struct(
            tuple(_ety(s, ids) for s in val_slots) + (wt.I64,)
        )
        bt = wt.DictMerger(key_ty, val_ty, "+")
        elem_ty = (
            wt.Struct(tuple(_ety(i, ids) for i in range(len(ids))))
            if len(ids) > 1 else _ety(0, ids)
        )
        b = ir.Ident(ir.fresh("b"), bt)
        i = ir.Ident(ir.fresh("i"), wt.I64)
        x = ir.Ident(ir.fresh("x"), elem_ty)

        def field(k: int) -> ir.Expr:
            return ir.GetField(x, k) if len(ids) > 1 else x

        key_expr = (
            ir.MakeStruct(tuple(field(s) for s in key_slots))
            if len(key_slots) > 1 else field(key_slots[0])
        )
        val_expr = ir.MakeStruct(
            tuple(field(s) for s in val_slots) + (ir.Literal(1, wt.I64),)
        )
        merged = ir.Merge(b, ir.MakeStruct((key_expr, val_expr)))
        body: ir.Expr = merged if pred_slot is None else ir.If(
            field(pred_slot), merged, b
        )
        loop = ir.For(
            tuple(ir.Iter(idn) for idn in ids),
            ir.NewBuilder(bt, arg=ir.Literal(capacity, wt.I64)),
            ir.Lambda((b, i, x), body),
        )
        obj = NewWeldObject(deps, ir.Result(loop))
        return self._finish(
            obj, lambda v: v,
            op="group_agg", tables={"table": self.table},
            kernelize=kernelize, kernel_impl=kernel_impl,
            collect_stats=collect_stats)

    # -- hash join ---------------------------------------------------------------

    def join(
        self,
        other: "Table",
        on,
        right_on=None,
        how: str = "inner",
        suffix: str = "_r",
        capacity: Optional[int] = None,
        validate: Optional[str] = None,
        precount: bool = True,
        memory_limit: Optional[int] = None,
        kernelize=None,
        kernel_impl=None,
        collect_stats: Optional[dict] = None,
    ) -> "Table":
        """Hash-join this query's (filtered) rows against `other` on one
        or two equality keys; evaluation point returning a new
        materialized :class:`Table`.

        ``on`` (and optionally ``right_on``) is a column name or a list
        of up to two names — multi-column keys share the backend's packed
        64-bit key space (32 bits per column; out-of-range int keys
        raise).  ``how`` selects the join semantics:

        * ``"inner"`` — every (probe row, matching build row) pair; a
          probe row with k build matches expands to k output rows,
          unmatched rows drop;
        * ``"left"``  — matched probe rows expand like ``"inner"``;
          unmatched rows survive ONCE with right columns filled by a
          per-dtype default (NaN for floats, 0 for ints, False for
          bools — sentinel fills, NOT pandas' float upcast);
        * ``"anti"``  — keep probe rows whose key does NOT exist; the
          output has only left columns.

        `other` is the BUILD side.  Duplicate build-side keys are
        supported for ``"inner"``/``"left"`` (an m:n join: output rows
        are ordered probe-row-major, matches within a probe row in
        build-row order); pass ``validate="m:1"`` to instead raise on
        duplicates with a row-count diagnostic (the pandas knob — and
        the old default, which rejected every duplicate).  ``"anti"``
        still requires unique build keys (membership with duplicates is
        an aggregation question: aggregate the right side first).
        Duplicate or missing keys on the probe side are always fine.
        NaN join keys raise on every path (the one NaN semantics all
        three paths share).  Output columns are every left column plus
        every right column except the key; a post-``suffix`` name
        collision raises instead of silently overwriting.

        Lazily the whole join is ONE fused program.  With unique build
        keys (m:1): a dictmerger build pass over the right side, then
        ONE horizontally-fused probe loop merging every output column
        into a struct of vecbuilders — misses lower through
        ``lookup(d, k, default)`` (a single probe, no second pass).
        With duplicates (m:n): a groupbuilder build (key -> growing
        vector of build-row indices, CSR on the backend) and a probe
        loop iterating ``grouplookup(d, k)`` — lowered as a two-phase
        expansion (per-row match counts, exclusive scan, repeat/gather)
        whose data-dependent output length lives in a static buffer
        sized by the host-computed unfiltered match total.  Under
        ``kernelize`` the planner lowers build + probe as a two-kernel
        plan (``dict_hash_build``+``hash_probe``, or ``group_build``+
        ``group_probe`` for m:n) — ALL output columns share one probe
        launch regardless of width (``repro_torch.core.kernelplan``).

        ``precount=False`` (lazy tables only) drops the host pre-count
        entirely: no distinct/duplicate scan, no match-total sum.
        Capacities and expansion buffers are instead *symbolic* IR
        expressions (``max(len(build), 1)`` for the group capacity,
        ``len(probe) * len(build)`` for the expansion buffer) that the
        weldbound interval analysis derives bounds for and the backend
        resolves against the bound input shapes.  Every join
        lowers through the m:n group path (duplicates cannot be ruled
        out without counting), so ``how="anti"``, ``validate="m:1"``
        and packed (float or multi-column) keys — all of which *need* a
        host value scan — raise under ``precount=False``.

        ``memory_limit`` (bytes, lazy only) arms compile-time admission
        control: the plan's symbolic peak-memory certificate is
        evaluated against the bound input shapes and a provably
        over-budget plan raises a typed
        :class:`~repro_torch.core.errors.ResourceError` *before* anything
        is built or launched (see ``repro_torch.core.analysis.bounds``).
        """
        if how not in ("inner", "left", "anti"):
            raise NotImplementedError(
                f"join how={how!r} (supported: inner, left, anti)"
            )
        if validate not in (None, "m:1"):
            raise ValueError(
                f"join validate={validate!r} (only 'm:1' is supported)"
            )
        if not isinstance(other, Table):
            raise TypeError("join build side must be a weldrel.Table")
        on_l = [on] if isinstance(on, str) else list(on)
        on_r = (
            ([right_on] if isinstance(right_on, str) else list(right_on))
            if right_on is not None else on_l
        )
        if not on_l or len(on_l) != len(on_r):
            raise ValueError(
                "join on/right_on must name the same number (>=1) of "
                "key columns"
            )
        if len(on_l) > 2:
            raise ValueError(
                "join supports at most 2 key columns (the packed-key "
                "space is 64-bit: 32 bits per column)"
            )
        nk = len(on_l)
        lk_host = [np.asarray(_host(self.table.cols[c])) for c in on_l]
        rk_host = [np.asarray(_host(other.cols[c])) for c in on_r]
        _check_join_keys(lk_host, rk_host, multi=nk > 1)
        # float keys compare through the f32 bitcast of the packed key
        # space on EVERY path (the dict paths have no alternative), so
        # the eager compare and the m:1 uniqueness check must use the
        # same packing — f64 build keys distinct only beyond f32
        # precision raise here instead of silently summing in the dict
        do_pack = nk > 1 or any(
            np.issubdtype(c.dtype, np.floating)
            for c in (lk_host[0], rk_host[0])
        )
        static_caps = (not precount) and not self.table.eager
        if static_caps:
            # weldbound static-capacity mode: no host counting at all.
            # Everything below that *requires* a value scan is rejected
            # up front; duplicates can't be ruled out, so every join
            # lowers through the m:n group path with symbolic sizes.
            if how == "anti":
                raise NotImplementedError(
                    "join precount=False cannot lower how='anti': anti "
                    "joins require host pre-counting (unique build "
                    "keys); pass precount=True"
                )
            if validate == "m:1":
                raise ValueError(
                    "join precount=False cannot honor validate='m:1': "
                    "duplicate detection is a host value scan; pass "
                    "precount=True"
                )
            if do_pack:
                raise ValueError(
                    "join precount=False supports single integer key "
                    "columns only: packed (float or multi-column) keys "
                    "need a host conflation scan; pass precount=True"
                )
            mn = True
            distinct = n_dup = 0  # never consulted on this path
        else:
            rk_packed = _pack_host(rk_host) if do_pack else rk_host[0]
            distinct = int(np.unique(rk_packed).size)
            n_dup = int(rk_packed.size) - distinct
            mn = n_dup > 0
        if not static_caps and do_pack and any(
            np.issubdtype(c.dtype, np.floating) for c in rk_host
        ):
            # m:n made duplicate build keys legal, so the uniqueness
            # guard no longer catches f64 keys that are distinct only
            # beyond the packed space's f32 precision — those would
            # silently fuse into one bogus group.  Keep that semantic
            # pinned: packed conflation of IEEE-distinct keys raises.
            # (np.unique matches the packed normalization: -0.0 == 0.0,
            # and NaN keys were already rejected above.)
            raw_distinct = int(np.unique(
                rk_host[0] if len(rk_host) == 1
                else np.rec.fromarrays(rk_host)
            ).size)
            if distinct < raw_distinct:
                raise ValueError(
                    "join build keys conflate in the packed (f32) key "
                    "space: keys distinct beyond f32 precision would "
                    "silently join as one key; cast or round the key "
                    "column before joining"
                )
        if n_dup and validate == "m:1":
            raise ValueError(
                f"join validate='m:1' violated: build side has {n_dup} "
                f"duplicate key rows ({rk_packed.size} rows, {distinct} "
                "distinct keys); aggregate the right side first"
            )
        if n_dup and how == "anti":
            raise NotImplementedError(
                "m:n anti joins pending (build side has duplicate "
                "keys); aggregate the right side first"
            )
        names_l = list(self.table.cols)
        names_r = (
            [] if how == "anti"
            else [c for c in other.cols if c not in on_r]
        )
        renamed_r = [c + suffix if c in names_l else c for c in names_r]
        out_names = names_l + renamed_r
        if len(set(out_names)) != len(out_names):
            seen: Dict[str, int] = {}
            for c in out_names:
                seen[c] = seen.get(c, 0) + 1
            dups = sorted(c for c, k in seen.items() if k > 1)
            raise ValueError(
                f"join output name collision after suffix {suffix!r}: "
                f"{dups}; rename columns or pick another suffix"
            )
        m = len(names_r)
        cap: Optional[int] = (
            int(capacity) if capacity is not None
            else (None if static_caps else max(distinct, 1))
        )
        injected_cap = faults.capacity_override("join.capacity")
        if injected_cap is not None:
            # fault injection: simulate a mis-estimated build capacity
            # (bypassing the guard below) so the runtime's poison ->
            # regrow -> fallback recovery ladder can be exercised
            cap = injected_cap
        elif static_caps:
            # no distinct count exists to guard against — an undersized
            # explicit capacity surfaces as runtime capacity poison and
            # rides the recovery regrow ladder instead
            pass
        elif cap < distinct:
            # an undersized dict poisons the build at decode time — on
            # an explicit user-passed capacity, fail loudly (and typed)
            # before compiling anything
            raise CapacityError(
                f"join capacity {cap} < {distinct} distinct build-side "
                "keys"
            )

        if self.table.eager:
            # the sort/searchsorted/repeat oracle, m:1 and m:n alike:
            # per-probe-row match counts via a left/right searchsorted
            # pair, then repeat/gather — matched build rows walk the
            # stable sort, so within a probe row output follows
            # build-row order (the ordering the lazy expansion shares)
            n_l = lk_host[0].shape[0]
            mrows = (self.pred._eager if self.pred is not None
                     else np.ones(n_l, bool))
            lk = _pack_host(lk_host) if do_pack else lk_host[0]
            rk = rk_packed
            if rk.size:
                order = np.argsort(rk, kind="stable")
                rks = rk[order]
                lo = np.searchsorted(rks, lk, side="left")
                hi = np.searchsorted(rks, lk, side="right")
                cnt = hi - lo
            else:
                order = lo = np.zeros(n_l, dtype=np.int64)
                cnt = np.zeros(n_l, dtype=np.int64)
            found = cnt > 0
            if how == "anti":
                mask = mrows & ~found
                return Table(
                    {c: self.table.col(c)._eager[mask] for c in names_l},
                    eager=True,
                )
            rep = np.where(
                mrows, cnt if how == "inner" else np.maximum(cnt, 1), 0
            )
            rows = np.repeat(np.arange(n_l), rep)
            offs = np.concatenate([[0], np.cumsum(rep)])
            t = np.arange(rows.size) - offs[rows]  # ordinal within a row
            frow = found[rows] if rows.size else np.zeros(0, bool)
            out = {c: self.table.col(c)._eager[rows] for c in names_l}
            if names_r:
                if rk.size:
                    gidx = order[np.where(frow, lo[rows] + t, 0)]
                for c, name in zip(names_r, renamed_r):
                    rcol = np.asarray(_host(other.cols[c]))
                    fill = rcol.dtype.type(_fill_of(rcol.dtype))
                    if rk.size:
                        v = rcol[gidx]
                        if how == "left":
                            v = np.where(frow, v, fill)
                    else:
                        v = np.full(rows.size, fill, rcol.dtype)
                    out[name] = v
            return Table(out, eager=True)

        # -- lazy: one fused program (build + ONE fused probe) -----------------
        lcols = {c: _as_lazy(self.table.cols[c]) for c in names_l}
        rkey_cols = [_as_lazy(other.cols[c]) for c in on_r]
        rcols = {c: _as_lazy(other.cols[c]) for c in names_r}
        kt: wt.WeldType = (
            wt.Struct(tuple(c.weld_elem_ty for c in rkey_cols))
            if nk > 1 else rkey_cols[0].weld_elem_ty
        )
        need_dict = m > 0 or how in ("inner", "anti")

        deps: List[WeldObject] = []
        seen_dep: Dict[str, WeldObject] = {}

        def dep(o: WeldObject) -> None:
            if o.obj_id not in seen_dep:
                seen_dep[o.obj_id] = o
                deps.append(o)

        if mn:
            # -- m:n: groupbuilder build (key -> growing vector of
            # build-row indices) + an expansion probe iterating
            # grouplookup(d, k) — ONE fused program whose output length
            # is data-dependent.  The static expansion buffer is sized
            # by the exact unfiltered match total (host-computed from
            # the same packed keys the dict compares); a predicate only
            # shrinks the in-program count.
            out_cap: Optional[int] = None
            if not static_caps:
                lk_packed = _pack_host(lk_host) if do_pack else lk_host[0]
                rks_h = np.sort(rk_packed)
                cnt_h = (np.searchsorted(rks_h, lk_packed, side="right")
                         - np.searchsorted(rks_h, lk_packed, side="left"))
                out_cap = int(cnt_h.sum() if how == "inner"
                              else np.maximum(cnt_h, 1).sum())

            r_objs = [c.obj for c in rkey_cols]
            r_ids = [ir.Ident(o.obj_id, o.weld_type()) for o in r_objs]
            # group capacity: the host distinct count when we have one,
            # else the proven-sufficient symbolic bound max(len(build),1)
            # — structurally >= the number of distinct keys, so the
            # symbolic path can never poison the build
            cap_node: ir.Expr = (
                ir.Literal(cap, wt.I64) if cap is not None
                else ir.BinOp("max", ir.Len(r_ids[0]),
                              ir.Literal(1, wt.I64))
            )
            b_elem = (
                wt.Struct(tuple(_ety(k, r_ids) for k in range(len(r_ids))))
                if len(r_ids) > 1 else _ety(0, r_ids)
            )
            bt = wt.GroupBuilder(kt, wt.I64)
            b = ir.Ident(ir.fresh("b"), bt)
            i = ir.Ident(ir.fresh("i"), wt.I64)
            x = ir.Ident(ir.fresh("x"), b_elem)

            def rfield(k: int) -> ir.Expr:
                return ir.GetField(x, k) if len(r_ids) > 1 else x

            kf: ir.Expr = (
                ir.MakeStruct(tuple(rfield(k) for k in range(nk)))
                if nk > 1 else rfield(0)
            )
            build = ir.For(
                tuple(ir.Iter(idn) for idn in r_ids),
                ir.NewBuilder(bt, arg=cap_node),
                ir.Lambda((b, i, x), ir.Merge(b, ir.MakeStruct((kf, i)))),
            )
            group_obj = NewWeldObject(r_objs, ir.Result(build))
            d_id = ir.Ident(group_obj.obj_id, group_obj.weld_type())
            dep(group_obj)
            rv_ids: Dict[str, ir.Ident] = {}
            for c in names_r:
                o = rcols[c].obj
                dep(o)
                rv_ids[c] = ir.Ident(o.obj_id, o.weld_type())

            pred_obj = self.pred.obj if self.pred is not None else None
            iter_objs: List[WeldObject] = []
            slots: Dict[str, int] = {}

            def slot(o: WeldObject) -> int:
                if o.obj_id not in slots:
                    slots[o.obj_id] = len(iter_objs)
                    iter_objs.append(o)
                return slots[o.obj_id]

            key_slots = [slot(lcols[c].obj) for c in on_l]
            col_slots = [slot(lcols[c].obj) for c in names_l]
            pred_slot = slot(pred_obj) if pred_obj is not None else None
            for o in iter_objs:
                dep(o)
            ids2 = [ir.Ident(o.obj_id, o.weld_type()) for o in iter_objs]
            elem = (
                wt.Struct(tuple(_ety(k, ids2) for k in range(len(ids2))))
                if len(ids2) > 1 else _ety(0, ids2)
            )
            out_tys = [lcols[c].weld_elem_ty for c in names_l] + \
                [rcols[c].weld_elem_ty for c in names_r]
            builders = tuple(wt.VecBuilder(t) for t in out_tys)
            sbt = wt.StructBuilder(builders)
            b2 = ir.Ident(ir.fresh("b"), sbt)
            i2 = ir.Ident(ir.fresh("i"), wt.I64)
            x2 = ir.Ident(ir.fresh("x"), elem)
            bi = ir.Ident(ir.fresh("b"), sbt)
            ii = ir.Ident(ir.fresh("i"), wt.I64)
            ri = ir.Ident(ir.fresh("r"), wt.I64)

            def field(k: int) -> ir.Expr:
                return ir.GetField(x2, k) if len(ids2) > 1 else x2

            key_expr: ir.Expr = (
                ir.MakeStruct(tuple(field(s) for s in key_slots))
                if nk > 1 else field(key_slots[0])
            )
            # the inner expansion loop: probe columns broadcast over the
            # group, build columns gather by the stored row index
            vals_in: List[ir.Expr] = [field(s) for s in col_slots]
            vals_in += [ir.Lookup(rv_ids[c], ri) for c in names_r]
            expand: ir.Expr = ir.For(
                (ir.Iter(ir.GroupLookup(d_id, key_expr)),),
                b2,
                ir.Lambda((bi, ii, ri), ir.MakeStruct(tuple(
                    ir.Merge(ir.GetField(bi, k), v)
                    for k, v in enumerate(vals_in)
                ))),
            )
            core: ir.Expr = expand
            if how == "left":
                miss_vals: List[ir.Expr] = [field(s) for s in col_slots]
                miss_vals += [
                    ir.Literal(
                        _fill_of(np.dtype(rcols[c].weld_elem_ty.np_dtype)),
                        rcols[c].weld_elem_ty,
                    )
                    for c in names_r
                ]
                miss = ir.MakeStruct(tuple(
                    ir.Merge(ir.GetField(b2, k), v)
                    for k, v in enumerate(miss_vals)
                ))
                core = ir.If(ir.KeyExists(d_id, key_expr), expand, miss)
            body2: ir.Expr = core if pred_slot is None else ir.If(
                field(pred_slot), core, b2
            )
            if out_cap is not None:
                hint_node: ir.Expr = ir.Literal(out_cap, wt.I64)
            else:
                # symbolic expansion bound: every probe row matches at
                # most len(build) rows (left joins emit at least one, so
                # max(len(build), 1) per row) — the weldbound interval
                # analysis tightens and certifies this, and the backend
                # resolves it against the bound input shapes
                per_row: ir.Expr = ir.Len(r_ids[0])
                if how == "left":
                    per_row = ir.BinOp("max", per_row,
                                       ir.Literal(1, wt.I64))
                hint_node = ir.BinOp("*", ir.Len(ids2[0]), per_row)
                dep(r_objs[0])  # the hint reads len(build keys)
            loop = ir.For(
                tuple(ir.Iter(idn) for idn in ids2),
                ir.MakeStruct(tuple(
                    ir.NewBuilder(bt2, size_hint=hint_node)
                    for bt2 in builders
                )),
                ir.Lambda((b2, i2, x2), body2),
            )
            obj = NewWeldObject(deps, ir.Result(loop))
            return self._finish(
                obj,
                lambda v: Table(
                    dict(zip(out_names, [np.asarray(a) for a in v])),
                    eager=False),
                op="join", tables={"table": self.table, "right": other},
                memory_limit=memory_limit, kernelize=kernelize,
                kernel_impl=kernel_impl, collect_stats=collect_stats)

        # bool value columns cannot ride the "+"-dictmerger directly —
        # they build as i8 and cast back to bool at the probe (build
        # keys are unique, so the stored i8 is always 0/1)
        rval_tys = [rcols[c].weld_elem_ty for c in names_r]
        enc_tys = [wt.I8 if t == wt.Bool else t for t in rval_tys]

        d_id: Optional[ir.Ident] = None
        if need_dict:
            # build side: dict[key, {v1..vm}] (or dict[key, v] /
            # dict[key, 1]); multi-column keys merge a struct key
            r_objs = [c.obj for c in rkey_cols] + \
                [rcols[c].obj for c in names_r]
            r_ids = [ir.Ident(o.obj_id, o.weld_type()) for o in r_objs]
            b_elem = (
                wt.Struct(tuple(_ety(k, r_ids) for k in range(len(r_ids))))
                if len(r_ids) > 1 else _ety(0, r_ids)
            )
            vt: wt.WeldType = (
                wt.Struct(tuple(enc_tys))
                if m > 1 else (enc_tys[0] if m == 1 else wt.I64)
            )
            bt = wt.DictMerger(kt, vt, "+")
            b = ir.Ident(ir.fresh("b"), bt)
            i = ir.Ident(ir.fresh("i"), wt.I64)
            x = ir.Ident(ir.fresh("x"), b_elem)

            def rfield(k: int) -> ir.Expr:
                return ir.GetField(x, k) if len(r_ids) > 1 else x

            def renc(j: int) -> ir.Expr:
                f = rfield(nk + j)
                return ir.Cast(f, wt.I8) if rval_tys[j] == wt.Bool else f

            kf: ir.Expr = (
                ir.MakeStruct(tuple(rfield(k) for k in range(nk)))
                if nk > 1 else rfield(0)
            )
            if m > 1:
                vf: ir.Expr = ir.MakeStruct(
                    tuple(renc(j) for j in range(m))
                )
            elif m == 1:
                vf = renc(0)
            else:
                vf = ir.Literal(1, wt.I64)
            build = ir.For(
                tuple(ir.Iter(idn) for idn in r_ids),
                ir.NewBuilder(bt, arg=ir.Literal(cap, wt.I64)),
                ir.Lambda((b, i, x), ir.Merge(b, ir.MakeStruct((kf, vf)))),
            )
            dict_obj = NewWeldObject(r_objs, ir.Result(build))
            d_id = ir.Ident(dict_obj.obj_id, dict_obj.weld_type())
            dep(dict_obj)

        pred_obj = self.pred.obj if self.pred is not None else None

        # ONE probe pass: every output column merges into its own
        # vecbuilder inside a single loop over the probe side — the
        # horizontally-fused form the planner routes as one hash_probe
        iter_objs: List[WeldObject] = []
        slots: Dict[str, int] = {}

        def slot(o: WeldObject) -> int:
            if o.obj_id not in slots:
                slots[o.obj_id] = len(iter_objs)
                iter_objs.append(o)
            return slots[o.obj_id]

        key_slots = [slot(lcols[c].obj) for c in on_l]
        col_slots = [slot(lcols[c].obj) for c in names_l]
        pred_slot = slot(pred_obj) if pred_obj is not None else None
        for o in iter_objs:
            dep(o)
        ids2 = [ir.Ident(o.obj_id, o.weld_type()) for o in iter_objs]
        elem = (
            wt.Struct(tuple(_ety(k, ids2) for k in range(len(ids2))))
            if len(ids2) > 1 else _ety(0, ids2)
        )
        out_tys = [lcols[c].weld_elem_ty for c in names_l] + \
            [rcols[c].weld_elem_ty for c in names_r]
        builders = tuple(wt.VecBuilder(t) for t in out_tys)
        b2 = ir.Ident(ir.fresh("b"), wt.StructBuilder(builders))
        i2 = ir.Ident(ir.fresh("i"), wt.I64)
        x2 = ir.Ident(ir.fresh("x"), elem)

        def field(k: int) -> ir.Expr:
            return ir.GetField(x2, k) if len(ids2) > 1 else x2

        key_expr: ir.Expr = (
            ir.MakeStruct(tuple(field(s) for s in key_slots))
            if nk > 1 else field(key_slots[0])
        )
        vals: List[ir.Expr] = [field(s) for s in col_slots]
        if m:
            fill_dflt: Optional[ir.Expr] = None
            if how == "left":
                fills = tuple(
                    ir.Literal(_fill_of(np.dtype(t.np_dtype)), t)
                    for t in enc_tys
                )
                fill_dflt = ir.MakeStruct(fills) if m > 1 else fills[0]
            look = ir.Lookup(d_id, key_expr, fill_dflt)
            for j in range(m):
                v: ir.Expr = ir.GetField(look, j) if m > 1 else look
                if rval_tys[j] == wt.Bool:
                    v = ir.Cast(v, wt.Bool)
                vals.append(v)
        merged = ir.MakeStruct(tuple(
            ir.Merge(ir.GetField(b2, k), v) for k, v in enumerate(vals)
        ))
        cond: Optional[ir.Expr] = None
        if how == "inner":
            cond = ir.KeyExists(d_id, key_expr)
        elif how == "anti":
            cond = ir.UnaryOp("not", ir.KeyExists(d_id, key_expr))
        if pred_slot is not None:
            pf = field(pred_slot)
            cond = pf if cond is None else ir.BinOp("&&", pf, cond)
        body: ir.Expr = merged if cond is None else ir.If(cond, merged, b2)
        loop = ir.For(
            tuple(ir.Iter(idn) for idn in ids2),
            ir.MakeStruct(tuple(ir.NewBuilder(bt2) for bt2 in builders)),
            ir.Lambda((b2, i2, x2), body),
        )

        obj = NewWeldObject(deps, ir.Result(loop))
        return self._finish(
            obj,
            lambda v: Table(
                dict(zip(out_names, [np.asarray(a) for a in v])),
                eager=False),
            op="join", tables={"table": self.table, "right": other},
            memory_limit=memory_limit, kernelize=kernelize,
            kernel_impl=kernel_impl, collect_stats=collect_stats)


class _Explain:
    """Proxy returned by :meth:`Query.explain`: runs the next operator
    with stats collection (and, under ``analyze``, tracing) and wraps
    the outcome in a :class:`PlanReport` instead of returning it."""

    def __init__(self, query: Query, analyze: bool):
        self._q = query
        self._analyze = analyze

    def agg(self, *args, **kwargs) -> "PlanReport":
        return self._capture("agg", args, kwargs)

    def group_agg(self, *args, **kwargs) -> "PlanReport":
        return self._capture("group_agg", args, kwargs)

    def join(self, *args, **kwargs) -> "PlanReport":
        return self._capture("join", args, kwargs)

    def _capture(self, op: str, args, kwargs) -> "PlanReport":
        from ..core import obs

        if self._q.table.eager:
            raise ValueError(
                "explain() requires a lazy table — eager tables never "
                "build a Weld program to report on"
            )
        stats = kwargs.pop("collect_stats", None)
        stats = {} if stats is None else stats
        kwargs["collect_stats"] = stats
        was_on = obs.enabled()
        if self._analyze:
            obs.enable()
        pos = obs.mark()
        try:
            result = getattr(Query, op)(self._q, *args, **kwargs)
        finally:
            if self._analyze and not was_on:
                obs.disable()
        spans = obs.spans_since(pos) if self._analyze else []
        return PlanReport(op=op, stats=stats, spans=spans,
                          analyze=self._analyze, result=result)


class PlanReport:
    """Formatted EXPLAIN [ANALYZE] output for one weldrel operator."""

    def __init__(self, op: str, stats: dict, spans: list, analyze: bool,
                 result: object):
        self.op = op
        self.stats = stats
        self.spans = spans
        self.analyze = analyze
        self.result = result

    # -- structured accessors ------------------------------------------------

    def kernels(self) -> List[dict]:
        """One row per planned KernelCall in the program that ran, with
        its tuned launch parameters (the port's grid cap ``max_blocks``)."""
        from ..core.pretty import TUNED_PARAMS

        plan = self.stats.get("plan.ir")
        if plan is None:
            return []
        rows = []
        for node in ir.walk(plan):
            if not isinstance(node, ir.KernelCall):
                continue
            params = dict(node.params)
            rows.append({
                "kernel": node.kernel,
                "n_rows": params.get("n_rows"),
                "tuned": {k: v for k, v in params.items()
                          if k in TUNED_PARAMS},
                "predicted_ns": params.get("predicted_ns"),
            })
        return rows

    def costs(self) -> List[dict]:
        """The cost gate's decisions (``"auto"`` compiles): each
        candidate's kernel and generic µs, whether it routed, why, and
        where the kernel figure came from (``source``: "roofline" or
        "measured")."""
        return list(self.stats.get("kernelplan", {}).get("costs") or [])

    def kernel_spans(self) -> List[dict]:
        """Measured per-launch rows (analyze=True only): predicted vs
        measured ns and their ratio."""
        rows = []
        for sp in self.spans:
            if not sp.name.startswith("kernel."):
                continue
            pred = sp.tags.get("predicted_ns")
            meas = sp.tags.get("measured_ns") or sp.dur_ns
            rows.append({
                "kernel": sp.name[len("kernel."):],
                "n_rows": sp.tags.get("n"),
                "predicted_ns": pred,
                "measured_ns": meas,
                "ratio": (meas / pred) if pred and meas else None,
            })
        return rows

    # -- rendering -----------------------------------------------------------

    def render(self) -> str:
        from ..core import obs
        from ..core.pretty import pretty

        st = self.stats
        kplan = st.get("kernelplan", {})
        lines = [
            f"== EXPLAIN{' ANALYZE' if self.analyze else ''} "
            f"weldrel.{self.op} ==",
            f"loops: {st.get('loops.before', '?')} -> "
            f"{st.get('loops.after', '?')} (after fusion)   "
            f"kernelize={kplan.get('mode', 'off')}   "
            f"matched={st.get('kernelize.matched', 0)}   "
            f"compile_ms={st.get('compile_ms', 0.0):.1f}",
        ]
        plan = st.get("plan.ir")
        if plan is not None:
            lines += ["", "-- fused IR (post-planning) --", pretty(plan)]
        krows = self.kernels()
        if krows:
            lines += ["", "-- routed kernels --"]
            for r in krows:
                tuned = ",".join(f"{k}={v}" for k, v in r["tuned"].items())
                pred = (f"{r['predicted_ns'] / 1e3:.1f}us"
                        if r["predicted_ns"] else "-")
                lines.append(
                    f"  {r['kernel']:<24} n={r['n_rows']!s:<10} "
                    f"tuned[{tuned}] predicted={pred}"
                )
        tuned = kplan.get("autotune") or []
        if tuned:
            lines += ["", "-- autotune --"]
            for t in tuned:
                times = ""
                if t.get("us") is not None:
                    times = (f" winner={t['us']}us default="
                             f"{t.get('default_us')}us")
                lines.append(
                    f"  {t['kernel']:<24} n={t['n']!s:<10} "
                    f"{t['params']}{' (cached)' if t.get('cached') else ''}"
                    f"{times}")
        costs = self.costs()
        if costs:
            lines += ["", "-- cost-gate decisions --"]
            for c in costs:
                lines.append(
                    f"  {c.get('kernel'):<24} "
                    f"kernel={c.get('kernel_us', 0):.1f}us "
                    f"generic={c.get('jnp_us', 0):.1f}us "
                    f"{'ROUTE' if c.get('routed') else 'reject'} "
                    f"source={c.get('source', '-')} "
                    f"({c.get('why', '')})"
                )
        if st.get("recovery.attempts"):
            lines += ["", "-- recovery --"]
            lines.append(
                f"  recovered after {st['recovery.attempts']} attempts "
                f"(capacity x{st.get('recovery.regrow_factor', 1)}"
                f"{', generic fallback' if st.get('recovery.fallback') else ''})"
            )
            for ev in st.get("recovery.events", []):
                lines.append(
                    f"  attempt {ev.get('attempt')}: {ev.get('action')} — "
                    f"{ev.get('detail')}"
                )
            for q in st.get("recovery.quarantined", []):
                lines.append(f"  quarantined: {q}")
        if st.get("verify.runs"):
            lines += ["", "-- verify --"]
            total = st.get("verify.ms", 0.0)
            lines.append(
                f"  weldcheck: {st['verify.runs']} checkpoints clean "
                f"(types, linearity, races, capacity) in {total:.1f}ms"
            )
            phases = st.get("verify.phases", [])
            by_phase: Dict[str, List[float]] = {}
            for name, ms in phases:
                by_phase.setdefault(name, []).append(ms)
            for name, times in by_phase.items():
                lines.append(
                    f"  {name:<24} x{len(times):<3} {sum(times):8.2f}ms"
                )
        if "bounds.certificate" in st:
            lines += ["", "-- bounds --"]
            lines.append(
                f"  peak-memory certificate: {st['bounds.certificate']}"
            )
            lines.append(
                f"  peak_bytes={st.get('bounds.peak_bytes')}   "
                f"admitted={st.get('bounds.admitted')}   "
                f"analysis_ms={st.get('bounds.ms', 0.0):.2f}"
            )
            out_rows = st.get("bounds.out_rows")
            if out_rows is not None:
                lo, hi = out_rows
                lines.append(
                    f"  out_rows in [{lo}, {'inf' if hi is None else hi}]"
                )
            for bl in st.get("bounds.builders") or []:
                lines.append(f"  {bl}")
        if self.analyze:
            mrows = self.kernel_spans()
            if mrows:
                lines += ["", "-- predicted vs measured (per launch) --"]
                for r in mrows:
                    pred = (f"{r['predicted_ns'] / 1e3:10.1f}"
                            if r["predicted_ns"] else f"{'-':>10}")
                    ratio = (f"{r['ratio']:.2f}x" if r["ratio"] else "-")
                    lines.append(
                        f"  {r['kernel']:<24} n={r['n_rows']!s:<10} "
                        f"pred_us={pred} meas_us="
                        f"{(r['measured_ns'] or 0) / 1e3:10.1f} "
                        f"ratio={ratio}"
                    )
            if self.spans:
                lines += ["", "-- span tree --",
                          obs.format_tree(self.spans)]
        return "\n".join(lines)

    __str__ = render

    def __repr__(self) -> str:
        return self.render()


class _Stage:
    """Proxy returned by :meth:`Query.stage`: the next operator call
    captures a :class:`StagedQuery` instead of evaluating."""

    def __init__(self, query: Query):
        self._q = query

    def agg(self, *args, **kwargs) -> "StagedQuery":
        return self._capture("agg", args, kwargs)

    def group_agg(self, *args, **kwargs) -> "StagedQuery":
        return self._capture("group_agg", args, kwargs)

    def join(self, *args, **kwargs) -> "StagedQuery":
        return self._capture("join", args, kwargs)

    def _capture(self, op: str, args, kwargs) -> "StagedQuery":
        if self._q.table.eager:
            raise ValueError(
                "stage()/compile() require a lazy table — eager tables "
                "evaluate immediately and never build a Weld program"
            )
        q = Query(self._q.table)
        q.pred = self._q.pred
        q._staged = True
        out = getattr(Query, op)(q, *args, **kwargs)
        if not isinstance(out, StagedQuery):  # pragma: no cover - guard
            raise ValueError(f"{op} did not reach the lazy tail; "
                             "cannot stage it")
        return out


class _Compile:
    """Proxy returned by :meth:`Query.compile`: the next operator call
    stages AND compiles, yielding a :class:`CompiledQuery`."""

    def __init__(self, query: Query, collect_stats: Optional[dict] = None):
        self._stage = _Stage(query)
        self._collect = collect_stats

    def agg(self, *args, **kwargs) -> "CompiledQuery":
        return self._stage._capture("agg", args, kwargs).compile(
            collect_stats=self._collect)

    def group_agg(self, *args, **kwargs) -> "CompiledQuery":
        return self._stage._capture("group_agg", args, kwargs).compile(
            collect_stats=self._collect)

    def join(self, *args, **kwargs) -> "CompiledQuery":
        return self._stage._capture("join", args, kwargs).compile(
            collect_stats=self._collect)


class StagedQuery:
    """One captured lazy operator: the stitched program, the bound
    tables, and the host-side result finalizer — nothing compiled yet.

    ``core.serve.QueryServer.submit`` accepts these directly (it reads
    ``program()``/``finalize`` by duck type); :meth:`compile` produces
    the reusable :class:`CompiledQuery`."""

    def __init__(self, op: str, obj: WeldObject, finalize: Callable,
                 tables: Dict[str, Table], memory_limit=None,
                 kernelize=None, kernel_impl=None):
        self.op = op
        self.obj = obj
        self.finalize = finalize
        self.tables = tables
        self.memory_limit = memory_limit
        self.kernelize = kernelize
        self.kernel_impl = kernel_impl
        self._prog = None

    def program(self):
        """The stitched :class:`~repro_torch.core.lazy.Program` (cached)."""
        if self._prog is None:
            self._prog = build_program(self.obj)
        return self._prog

    def binding(self) -> Dict[str, Dict[str, str]]:
        """alias -> {column name -> program input name} for every bound
        table column that is actually a program input (filter predicates
        reach their columns through the same input objects, so
        re-binding a column re-binds the predicate too)."""
        prog = self.program()
        out: Dict[str, Dict[str, str]] = {}
        for alias, tbl in self.tables.items():
            cols = {}
            for cname, col in tbl.cols.items():
                oid = col.obj.obj_id
                if oid in prog.inputs:
                    cols[cname] = oid
            out[alias] = cols
        return out

    def compile(self, collect_stats: Optional[dict] = None
                ) -> "CompiledQuery":
        from ..core import runtime

        handle = runtime.compile_program(
            self.program(), memory_limit=self.memory_limit,
            kernelize=self.kernelize, kernel_impl=self.kernel_impl)
        if collect_stats is not None:
            collect_stats.update(handle.stats)
        return CompiledQuery(self, handle)


class CompiledQuery:
    """AOT handle for one weldrel operator: ``.stats``, ``.explain()``,
    and ``.run(**tables)`` re-binding same-shape tables against the
    cached program with zero recompiles.

    ``run()`` with no arguments executes against the staged tables (the
    encoded inputs stay on the device); ``run(table=t2)`` (and
    ``right=r2`` for joins) re-binds the named tables' columns by name.
    Shapes and dtypes must match the compiled signature — anything else
    needs a fresh ``Query(...).compile()``."""

    def __init__(self, staged: StagedQuery, handle):
        self.staged = staged
        self.handle = handle
        self._binding = staged.binding()
        self._pos = {name: i for i, name in enumerate(handle.input_names)}

    @property
    def stats(self) -> dict:
        return self.handle.stats

    @property
    def from_cache(self) -> bool:
        return self.handle.from_cache

    def explain(self) -> PlanReport:
        """The same EXPLAIN report ``Query.explain()`` renders, off the
        compiled plan's stats (cost-gate decisions included)."""
        return PlanReport(op=self.staged.op, stats=self.stats, spans=[],
                          analyze=False, result=None)

    def run(self, **tables):
        prog = self.staged.program()
        arrays = None
        if tables:
            arrays = list(self.handle._low.arrays)
            for alias, tbl in tables.items():
                mapping = self._binding.get(alias)
                if mapping is None:
                    raise KeyError(
                        f"unknown table alias {alias!r}; this "
                        f"{self.staged.op} binds {sorted(self._binding)}")
                for cname, iname in mapping.items():
                    if cname not in tbl.cols:
                        raise KeyError(
                            f"re-bound table {alias!r} is missing column "
                            f"{cname!r} required by the compiled plan")
                    enc = prog.inputs[iname][1]
                    arrays[self._pos[iname]] = enc.encode(
                        np.asarray(_host(tbl.cols[cname])))
        value = self.handle.run(arrays)
        return self.staged.finalize(value)


def _host(col: weldnp.ndarray) -> np.ndarray:
    """The numpy buffer behind a table column (eager or lazy)."""
    return col._eager if col.is_eager else np.asarray(col.obj.data)


def _fill_of(dt) -> object:
    """Per-dtype miss fill for left joins: NaN for floats, 0 for ints,
    False for bools (a sentinel fill, NOT pandas' float upcast)."""
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating):
        return float("nan")
    if dt == np.dtype(np.bool_):
        return False
    return 0


def _check_join_keys(lcols: List[np.ndarray], rcols: List[np.ndarray],
                     multi: bool) -> None:
    """Pin the key semantics every path shares: mismatched key dtypes
    raise (the eager packed compare would silently conflate e.g. an int
    with a float's bitcast while the lazy dict raises a type error),
    NaN keys raise (eager NumPy would treat them as unmatchable while
    the packed-bits dict would equate identical payloads — neither
    silently), and multi-column int keys must fit the
    32-bit-per-column packed space."""
    for lc, rc in zip(lcols, rcols):
        if lc.dtype != rc.dtype:
            raise ValueError(
                f"join key dtype mismatch: {lc.dtype} vs {rc.dtype}; "
                "cast one side before joining"
            )
    for c in lcols + rcols:
        if np.issubdtype(c.dtype, np.floating) and np.isnan(c).any():
            raise ValueError(
                "join keys contain NaN; NaN join keys are unsupported "
                "(drop or fill them before joining)"
            )
        if multi and np.issubdtype(c.dtype, np.integer) and c.size:
            # strictly greater than INT32_MIN: -2^31 in a leading column
            # packs onto the hash table's EMPTY sentinel (INT64_MIN)
            if int(c.min()) <= -(2 ** 31) or int(c.max()) >= 2 ** 31:
                raise ValueError(
                    "multi-column join keys must fit in 32 bits per "
                    "column (the packed-key space is 64-bit; INT32_MIN "
                    "is reserved as the hash sentinel)"
                )


def _pack_host(cols: List[np.ndarray]) -> np.ndarray:
    """Host-side mirror of the backend's packed key space (torchgen
    ``_pack_keys``): 32 bits per column, floats bit-cast through f32 —
    byte-identical packing, so the eager path and the dict paths agree
    on exactly which keys are equal (applied to multi-column keys AND
    single float key columns, which the torch packing also bitcasts)."""
    packed = np.zeros(cols[0].shape[0], dtype=np.int64)
    for c in cols:
        if np.issubdtype(c.dtype, np.floating):
            c = np.where(c == 0, np.zeros_like(c), c)  # -0.0 == +0.0
            c = c.astype(np.float32).view(np.int32).astype(np.int64)
        else:
            c = c.astype(np.int64)
        packed = packed * np.int64(1 << 32) + (c & np.int64(0xFFFFFFFF))
    return packed


def _as_lazy(col: weldnp.ndarray) -> weldnp.ndarray:
    return col if col.obj is not None else weldnp.array(col._eager)


def _ety(k: int, ids: List[ir.Expr]) -> wt.Scalar:
    t = ids[k].ty
    assert isinstance(t, wt.Vec)
    return t.elem
