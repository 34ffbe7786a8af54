"""Declarative registry of the kernels reachable from the IR planner.

Each :class:`KernelSpec` describes one kernel route in
``repro_torch.kernels.ops``: the IR pattern family it accelerates (loop
shape + builder kind), the scalar kinds it accepts, its static-shape
constraints, and the backend adapter that invokes the entry point on
device tensors.  The planner (:mod:`.planner`) consults this table, so
registering/unregistering a spec is the ablation knob for a route.

Adapters receive backend values (``WVec``/tensors), the static params
baked into the ``KernelCall`` node, the staged per-element callables,
and the ``impl`` knob ("cuda"/"ref"/None), forwarded to the kernel
entries.  Each spec also carries its roofline ``cost`` hook (drives
``mode="auto"``) and its ``footprint`` (staged columns + scratch bytes
of one call, charged against ``memory_limit`` by the emitter).

The port registers the routes of the ported slices: the aggregate and
group-by routes ``filter_reduce_sum``, ``vecmerger_segment_sum`` and
``dict_group_sum``, the hash-join routes ``dict_hash_build`` +
``hash_probe`` (m:1) and ``group_build`` + ``group_probe`` (m:n), and
the array routes ``matmul`` / ``matvec`` (the tiling pass's linalg ops,
on ``tiled_matmul``) and ``map_elementwise`` (a fused elementwise chain,
on a kernel generated from its IR body).  A spec may carry a ``prepare``
hook, which the runtime calls for each of its calls when a program is
compiled for the card: the map chain builds its generated kernel there,
not at the first row.  Its ``refuse`` hook tells the planner at match
time which bodies the generator cannot emit, and its ``cost_meta`` hook
adds the generated kernel's own operation count to the cost meta.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ...kernels import ops as kops
from ...kernels import filter_reduce as _fr
from ...kernels import hash_table as _ht
from ...kernels import map_chain as _mc
from ...kernels import segment_reduce as _sr
from ..backend.torchgen import TORCH_OF_NP, _pack_keys, group_expand
from .. import ir
from ..backend.values import WDict, WGroup, WVec
from . import cost as _cost


class KernelPlanError(RuntimeError):
    """An annotated kernel call could not be executed (planner bug or a
    runtime-shape violation of a registry constraint)."""


# ---------------------------------------------------------------------------
# Spec + registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelSpec:
    #: registry key; also the ``KernelCall.kernel`` tag and stats suffix.
    name: str
    #: entry point, dotted (module:function) — documentation + dispatch.
    entry: str
    #: IR pattern family the planner matches (see planner.py).
    pattern: str
    #: builder kind of the matched loop.
    builder: str
    #: scalar kinds accepted for the merged element / operands.
    elem_kinds: Tuple[str, ...]
    description: str
    #: static bound on segment count / dict capacity (None = unbounded).
    max_segments: Optional[int] = None
    #: backend adapter: (args, params, fns, impl) -> backend value.
    execute: Callable = None
    #: roofline cost hook: (meta dict) -> cost.CostEstimate.
    cost: Optional[Callable] = None
    #: (arg_shapes, itemsize, params) -> bytes of staged columns +
    #: scratch this call adds beyond its natural inputs/outputs.
    footprint: Optional[Callable] = None
    #: (KernelCall) -> None, run when a program routing the call is
    #: compiled for the card (builds what the first launch needs).
    prepare: Optional[Callable] = None
    #: (ir.Lambda) -> None, or the reason the kernel cannot take this
    #: body; asked at match time (a refused loop stays generic).
    refuse: Optional[Callable] = None
    #: (KernelCall) -> dict of cost meta only the kernel knows.
    cost_meta: Optional[Callable] = None


_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def get(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KernelPlanError(f"no registered kernel {name!r}")
    return _REGISTRY[name]


def available(name: str) -> Optional[KernelSpec]:
    return _REGISTRY.get(name)


def all_specs() -> Tuple[KernelSpec, ...]:
    return tuple(_REGISTRY.values())


def fingerprint() -> str:
    """Stable key of the registered-kernel set — part of the compile-cache
    key, so register/unregister forces a recompile rather than serving a
    stale plan."""
    return ",".join(sorted(f"{s.name}:{s.entry}" for s in _REGISTRY.values()))


def prepare_kernels(expr: ir.Expr) -> None:
    """Run the ``prepare`` hook of every kernel call in a planned program."""
    for node in ir.walk(expr):
        if isinstance(node, ir.KernelCall):
            spec = _REGISTRY.get(node.kernel)
            if spec is not None and spec.prepare is not None:
                spec.prepare(node)


def describe() -> str:
    """Human-readable registry dump (docs / debugging)."""
    return "\n".join(
        f"{s.name:24s} {s.pattern:16s} {s.builder:14s} "
        f"[{','.join(s.elem_kinds)}] -> {s.entry}"
        for s in _REGISTRY.values()
    )


# ---------------------------------------------------------------------------
# Adapter helpers
# ---------------------------------------------------------------------------


def _poison_value(out):
    """Negate every dynamic count in a kernel result (the ``poison``
    fault action): downstream probes and decode then see exactly what a
    real capacity overflow produces."""
    if isinstance(out, WVec):
        if out.count is None:
            leaf = out.data[0] if isinstance(out.data, tuple) else out.data
            return WVec(out.data, torch.tensor(-1, dtype=torch.int64,
                                               device=leaf.device))
        return WVec(out.data, -torch.abs(out.count) - 1)
    if isinstance(out, WDict):
        return WDict(out.keys, out.vals, -torch.abs(out.count) - 1)
    if isinstance(out, WGroup):
        return WGroup(out.keys, out.values, out.offsets,
                      -torch.abs(out.count) - 1)
    if isinstance(out, tuple):
        return tuple(_poison_value(v) for v in out)
    return out


def execute_spec(spec: KernelSpec, args, params, fns, impl):
    """Every planned kernel launch funnels through here.

    A ``poison`` armed at the ``kernel.<name>`` failpoint negates the
    result's counts, as a capacity overflow would.  A kernel that fails
    raises as it is (the reference's ``KernelCompileError`` wrapping and
    its quarantine rung are not ported yet).
    """
    from .. import faults

    out = spec.execute(args, params, fns, impl)
    if faults.poisoned(f"kernel.{spec.name}"):
        out = _poison_value(out)
    return out


def _dense_data(v, what: str):
    if not isinstance(v, WVec):
        raise KernelPlanError(f"{what}: expected a vector value")
    if not v.is_dense:
        raise KernelPlanError(f"{what}: kernel path requires a dense vector")
    return v.data


def _elem_of(arrays):
    return arrays[0] if len(arrays) == 1 else tuple(arrays)


def _as_col(v, n):
    """Broadcast a staged per-element result to a full contiguous (n,)
    column (the kernels read contiguous memory)."""
    if v.ndim >= 1 and v.shape[0] == n:
        return v.contiguous()
    return torch.broadcast_to(v, (n,) + tuple(v.shape)).contiguous()


def _staging(arrays):
    n = arrays[0].shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=arrays[0].device)
    return n, idx, _elem_of(arrays)


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------


def _exec_filter_reduce(args, params, fns, impl):
    """(iters...) + staged val/pred bodies -> scalar (or struct of) sums.

    Multi-aggregate calls (weldrel's struct-of-mergers ``agg``) stack
    the staged value columns and take the multi-output kernel, so the
    predicate and the columns are read once for ALL aggregates.
    ``multi=False`` in params forces the per-aggregate path."""
    arrays = [_dense_data(a, "filter_reduce") for a in args]
    n, idx, elem = _staging(arrays)
    n_aggs = params["n_aggs"]
    if params["has_pred"]:
        pred = _as_col(fns[n_aggs](idx, elem), n).to(torch.bool)
    else:
        pred = torch.ones((n,), dtype=torch.bool, device=idx.device)
    vals = [_as_col(fns[k](idx, elem), n) for k in range(n_aggs)]
    fuse = (
        params.get("multi", True)
        and n_aggs > 1
        and len({v.dtype for v in vals}) == 1
    )
    if fuse:
        fused = kops.filter_reduce_sum_multi(torch.stack(vals), pred,
                                             impl=impl)
        outs = [fused[k] for k in range(n_aggs)]
    else:
        outs = [kops.filter_reduce_sum(v, pred, impl=impl) for v in vals]
    return tuple(outs) if params["struct"] else outs[0]


def _exec_vecmerger_segment_sum(args, params, fns, impl):
    """base + scatter-add of staged {index, value} pairs via segment_sum."""
    base = _dense_data(args[0], "vecmerger base")
    arrays = [_dense_data(a, "vecmerger") for a in args[1:]]
    n, idx, elem = _staging(arrays)
    seg = _as_col(fns[0](idx, elem), n).to(torch.int32)
    vals = _as_col(fns[1](idx, elem), n).to(base.dtype)
    k = base.shape[0]
    return WVec(base + kops.segment_sum(seg, vals, num_segments=k, impl=impl))


def _exec_dict_group_sum(args, params, fns, impl):
    """Dense-int-key group-by-sum: segment sums of [vals, ones] +
    compaction.

    The route assumes keys in [0, capacity).  Rows failing the (optional)
    loop predicate are masked out; rows that PASS the predicate but carry
    an out-of-range key cannot be aggregated here, so the result is
    flagged (negative count) and decoding raises instead of returning a
    silently-short dict.
    """
    arrays = [_dense_data(a, "dict group") for a in args]
    n, idx, elem = _staging(arrays)
    dev = idx.device
    cap = int(params["capacity"])
    keys = _as_col(fns[0](idx, elem), n).to(torch.int64)
    vals = _as_col(fns[1](idx, elem), n)
    if params.get("has_pred"):
        mask = _as_col(fns[2](idx, elem), n).to(torch.bool)
    else:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    inrange = (keys >= 0) & (keys < cap)
    overflow = torch.any(mask & ~inrange)
    valid = mask & inrange
    zero = torch.zeros((), dtype=vals.dtype, device=dev)
    # invalid rows contribute zero to segment 0 (sum identity)
    seg = torch.where(valid, keys, torch.zeros_like(keys)).to(torch.int32)
    vals_m = torch.where(valid, vals, zero)
    ones = valid.to(vals.dtype)
    # one launch for sums + presence counts (shared segment-id loads)
    both = kops.segment_sum_vectors(seg, torch.stack([vals_m, ones], dim=1),
                                    num_segments=cap, impl=impl)
    sums, counts = both[:, 0], both[:, 1]
    present = counts > 0
    order = torch.argsort((~present).to(torch.uint8), stable=True)
    key_dtype = TORCH_OF_NP[params.get("key_np", "int64")]
    keys_out = torch.arange(cap, dtype=key_dtype, device=dev)[order]
    vals_out = sums[order]
    count = present.sum()
    # Overflow guards, layered: the negative count makes host decode
    # raise; poisoned keys/values cover consumers that never decode —
    # KeyExists sees no keys, Lookup yields NaN.
    count = torch.where(overflow, -count - 1, count)
    keys_out = torch.where(overflow, torch.full_like(keys_out, -1), keys_out)
    if vals_out.is_floating_point():
        vals_out = torch.where(overflow, torch.full_like(vals_out, float("nan")),
                               vals_out)
    return WDict(keys_out, vals_out, count)


def _exec_dict_hash_build(args, params, fns, impl):
    """Dictmerger build with arbitrary (sparse) int keys: open-addressing
    hash-to-slot kernel, then per-column segment accumulation over the
    ascending-key compact slot ids, which is the backend's
    sorted-front-packed WDict layout.

    Key space is the same packed-int64 space the generic lowering
    compares in (torchgen ``_pack_keys``), so probing a hash-built dict
    and a generic dict is indistinguishable.  Overflow (more distinct
    keys than the builder capacity, or a key colliding with the reserved
    EMPTY sentinel) poisons the result with the same negative-count
    convention as the dense group-by route."""
    arrays = [_dense_data(a, "hash build") for a in args]
    n, idx, elem = _staging(arrays)
    cap = int(params["capacity"])
    nk = int(params.get("n_keys", 1))
    nv = int(params.get("n_vals", 1))
    key_cols = [_as_col(fns[j](idx, elem), n).to(torch.int64)
                for j in range(nk)]
    vals = [_as_col(fns[nk + j](idx, elem), n) for j in range(nv)]
    if params.get("has_pred"):
        mask = _as_col(fns[nk + nv](idx, elem), n).to(torch.bool)
    else:
        mask = torch.ones((n,), dtype=torch.bool, device=idx.device)
    packed = _pack_keys(tuple(key_cols) if nk > 1 else key_cols[0])
    sentinel_clash = torch.any(mask & (packed == _ht.EMPTY))
    pk = torch.where(mask, packed, torch.full_like(packed, _ht.EMPTY))
    slots, table, used = kops.hash_to_slot(pk, _ht.table_size(cap),
                                           impl=impl)
    overflow = (used > cap) | sentinel_clash
    # table slot -> compact position in ascending packed order (matches
    # the generic keyed finalize, so lookups/decodes are layout-identical)
    cslots = _ht.compact_slots(slots, table, cap)
    key_nps = params.get("key_nps") or (params.get("key_np", "int64"),)
    keys_fin = _recover_key_cols(key_cols, mask, cslots, cap, key_nps,
                                 overflow)
    outs = []
    for v in vals:
        vm = torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                              device=v.device))
        out = kops.segment_sum(cslots, vm, num_segments=cap, impl=impl)
        if out.is_floating_point():  # overflow: NaN, never a wrong sum
            out = torch.where(overflow, torch.full_like(out, float("nan")),
                              out)
        outs.append(out)
    count = torch.clamp(used.to(torch.int64), max=cap)
    count = torch.where(overflow, -count - 1, count)
    keys_out = tuple(keys_fin) if nk > 1 else keys_fin[0]
    vals_out = tuple(outs) if params.get("struct_val") else outs[0]
    return WDict(keys_out, vals_out, count)


def _recover_key_cols(key_cols, mask, slots, cap, key_nps, overflow):
    """Per-slot raw key recovery shared by the keyed build adapters:
    every row in a slot holds one key, so a masked max per field
    (``scatter_reduce("amax")`` from an INT64_MIN fill, exact for
    integers) reads it back (packing may have dropped high bits); parked
    rows carry slot ``cap`` and fall off the ``[:cap]`` slice, and
    overflow poisons the columns to -1."""
    outs = []
    lo = torch.iinfo(torch.int64).min
    for kc, knp in zip(key_cols, key_nps):
        src = torch.where(mask, kc, torch.full_like(kc, lo))
        ko = torch.full((cap + 1,), lo, dtype=torch.int64, device=kc.device)
        ko = ko.scatter_reduce(0, slots.to(torch.int64), src, reduce="amax",
                               include_self=True)[:cap]
        ko = ko.to(TORCH_OF_NP[knp])
        outs.append(torch.where(overflow, torch.full_like(ko, -1), ko))
    return outs


def _probe_membership(args, params, fns, impl, nk, n_iters=None):
    """Shared prologue of the probe adapters: stage the probe-side
    columns, pack the (possibly multi-column) query keys into the int64
    key space, neutralize the table's parked slots, and run ONE
    membership kernel — ``dict_probe`` for dict tables, the fused
    membership + match-count ``group_probe`` for group (m:n) tables.
    Returns ``(n, idx, elem, pos, found, sizes, cap)`` with ``sizes``
    None for dicts."""
    d = args[0]
    if not isinstance(d, (WDict, WGroup)):
        raise KernelPlanError("probe: expected a dict/group value")
    is_group = isinstance(d, WGroup)
    tail = args[1:] if n_iters is None else args[1:1 + n_iters]
    arrays = [_dense_data(a, "hash probe") for a in tail]
    n, idx, elem = _staging(arrays)
    dev = idx.device
    key_cols = [_as_col(fns[j](idx, elem), n).to(torch.int64)
                for j in range(nk)]
    keys_q = _pack_keys(tuple(key_cols) if nk > 1 else key_cols[0])
    packed_t = _pack_keys(d.keys)
    cap = packed_t.shape[0]
    cnt = torch.clamp(torch.as_tensor(d.count, device=dev).to(torch.int64),
                      min=0)
    sizes = torch.zeros((n,), dtype=torch.int64, device=dev) \
        if is_group else None
    if cap == 0:
        pos = torch.zeros((n,), dtype=torch.int32, device=dev)
        found = torch.zeros((n,), dtype=torch.bool, device=dev)
    else:
        big = torch.iinfo(torch.int64).max
        neut = torch.where(torch.arange(cap, device=dev) < cnt, packed_t,
                           torch.full_like(packed_t, big))
        if is_group:
            pos, found, sizes = kops.group_probe(neut, d.offsets, cnt, keys_q,
                                                 impl=impl)
            sizes = sizes.to(torch.int64)
        else:
            pos, found = kops.dict_probe(neut, cnt, keys_q, impl=impl)
    return n, idx, elem, pos, found, sizes, cap


def _front_pack(keep: torch.Tensor) -> torch.Tensor:
    """Stable order that moves the kept rows to the front (sorts a uint8
    key: the card does not sort bool tensors)."""
    return torch.argsort((~keep).to(torch.uint8), stable=True)


def _probe_count(d, kept: torch.Tensor) -> torch.Tensor:
    """Kept-row count, or -1 when the probed build was poisoned."""
    poisoned = torch.as_tensor(d.count, device=kept.device).to(torch.int64) < 0
    return torch.where(poisoned, torch.full_like(kept, -1), kept)


def _gather_col(vcol: torch.Tensor, pos: torch.Tensor, n: int, cap: int):
    if cap == 0 or vcol.shape[0] == 0:
        return torch.zeros((n,), dtype=vcol.dtype, device=pos.device)
    return vcol[torch.clamp(pos.to(torch.int64), 0, vcol.shape[0] - 1)]


def _exec_hash_probe(args, params, fns, impl):
    """Probe a dict with per-row keys; keep matching rows (front-packed)
    and emit either the looked-up value column (``gather``) or a staged
    elementwise expression over the probe row.  The positional probe
    kernel serves every value dtype — the gather itself is plain
    indexing outside the kernel.

    Fused calls (``cols`` in params — weldrel's horizontally fused join
    probe) dispatch to :func:`_exec_hash_probe_fused`: ONE membership
    kernel launch shared by every output column."""
    if "cols" in params:
        return _exec_hash_probe_fused(args, params, fns, impl)
    d = args[0]
    n, idx, elem, pos, found, _, cap = _probe_membership(
        args, params, fns, impl, nk=1)
    gather = bool(params.get("gather"))
    if params.get("has_pred"):
        mask = _as_col(fns[1 if gather else 2](idx, elem), n).to(torch.bool)
        found = found & mask
    if gather:
        field = int(params.get("field", -1))
        vcol = d.vals[field] if isinstance(d.vals, tuple) else d.vals
        out = _gather_col(vcol, pos, n, cap)
    else:
        out = _as_col(fns[1](idx, elem), n)
    order = _front_pack(found)
    return WVec(out[order], count=_probe_count(d, found.sum()))


def _exec_hash_probe_fused(args, params, fns, impl):
    """Horizontally fused join probe: ONE ``dict_probe`` launch computes
    the found-mask/positions for the (possibly multi-column, packed)
    keys, then EVERY output column reuses them — build-side columns as
    plain gathers, probe-side columns as staged expressions, and all
    columns sharing a single front-pack sort.

    ``how`` selects the row semantics: ``inner`` keeps found rows,
    ``anti`` keeps misses (left columns only), and ``left`` keeps every
    row — misses in gathered columns fill from the per-column ``fills``
    (the planner lifts them off the ``lookup(d, k, fill)`` defaults)
    instead of front-packing, so no second probe pass exists anywhere."""
    d = args[0]
    how = params["how"]
    nk = int(params.get("n_keys", 1))
    n, idx, elem, pos, found, _, cap = _probe_membership(
        args, params, fns, impl, nk=nk)
    mask = None
    if params.get("has_pred"):
        mask = _as_col(fns[-1](idx, elem), n).to(torch.bool)
    outs = []
    for (kind, j), fill in zip(params["cols"], params["fills"]):
        if kind == "expr":
            col = _as_col(fns[nk + j](idx, elem), n)
        else:
            vcol = d.vals[j] if isinstance(d.vals, tuple) else d.vals
            col = _gather_col(vcol, pos, n, cap)
            if how == "left":
                col = torch.where(found, col, torch.tensor(
                    fill, dtype=vcol.dtype, device=col.device))
        outs.append(col)
    keep = {"inner": found, "anti": ~found, "left": None}[how]
    if mask is not None:
        keep = mask if keep is None else keep & mask
    if keep is None:  # left join, no predicate: every row survives
        count = _probe_count(d, torch.tensor(n, device=idx.device))
        return tuple(WVec(c, count=count) for c in outs)
    order = _front_pack(keep)  # ONE shared front-pack
    count = _probe_count(d, keep.sum())
    return tuple(WVec(c[order], count=count) for c in outs)


def _exec_group_build(args, params, fns, impl):
    """Groupbuilder build (the m:n join build side): hash-to-slot over
    the packed keys, slot-histogram compaction into CSR offsets, and the
    payload column sorted by (ascending key, build-row order) — the
    layout the generic keyed finalize produces, so the probe side is
    indistinguishable.  Overflow (more distinct keys than the builder
    capacity, or a key hitting the reserved EMPTY sentinel) poisons via
    the shared negative-count convention."""
    arrays = [_dense_data(a, "group build") for a in args]
    n, idx, elem = _staging(arrays)
    cap = int(params["capacity"])
    nk = int(params.get("n_keys", 1))
    key_cols = [_as_col(fns[j](idx, elem), n).to(torch.int64)
                for j in range(nk)]
    val = _as_col(fns[nk](idx, elem), n)
    if params.get("has_pred"):
        mask = _as_col(fns[nk + 1](idx, elem), n).to(torch.bool)
    else:
        mask = torch.ones((n,), dtype=torch.bool, device=idx.device)
    packed = _pack_keys(tuple(key_cols) if nk > 1 else key_cols[0])
    sentinel_clash = torch.any(mask & (packed == _ht.EMPTY))
    pk = torch.where(mask, packed, torch.full_like(packed, _ht.EMPTY))
    cslots, offsets, used = kops.group_build(pk, cap, impl=impl)
    overflow = (used > cap) | sentinel_clash
    # CSR payload ordering: ascending compact slot, stable — within a
    # group, build-row order (identical to the generic keyed finalize)
    values = val[torch.argsort(cslots, stable=True)]
    key_nps = params.get("key_nps") or ("int64",)
    keys_fin = _recover_key_cols(key_cols, mask, cslots, cap, key_nps,
                                 overflow)
    keys_out = tuple(keys_fin) if nk > 1 else keys_fin[0]
    count = torch.clamp(used.to(torch.int64), max=cap)
    count = torch.where(overflow, -count - 1, count)
    return WGroup(keys_out, values, offsets, count)


def _exec_group_probe(args, params, fns, impl):
    """The m:n join fan-out probe: ONE fused membership + match-count
    launch (``kops.group_probe``) for the packed keys, then the shared
    two-phase expansion (exclusive scan over the per-row counts, binary
    search back to source rows, repeat/gather) materializes EVERY output
    column through one expansion index — probe columns repeat, build
    columns gather through the group's stored row ids, left-join misses
    emit one fill row.  Poison propagates as a negative output count."""
    d = args[0]
    if not isinstance(d, WGroup):
        raise KernelPlanError("group_probe: expected a groupbuilder value")
    if isinstance(d.values, tuple):
        raise KernelPlanError("group_probe: scalar payloads only")
    how = params["how"]
    nk = int(params.get("n_keys", 1))
    n_iters = int(params.get("n_iters", 1))
    n, idx, elem, pos, found, sizes, cap = _probe_membership(
        args, params, fns, impl, nk=nk, n_iters=n_iters)
    if params.get("has_pred"):
        mask = _as_col(fns[-1](idx, elem), n).to(torch.bool)
    else:
        mask = torch.ones((n,), dtype=torch.bool, device=idx.device)
    col_specs = []
    for (kind, j), fill in zip(params["cols"], params["fills"]):
        if kind == "expr":
            col_specs.append(("expr", _as_col(fns[nk + j](idx, elem), n)))
        else:
            rv = _dense_data(args[j], "group probe gather")
            col_specs.append(("gather", rv, fill))
    return group_expand(d, pos, found, sizes, mask, how,
                        int(params["out_cap"]), col_specs)


def _exec_matmul(args, params, fns, impl):
    """linalg.matmul: C = A @ B in the operands' common dtype."""
    a = _dense_data(args[0], "matmul lhs")
    b = _dense_data(args[1], "matmul rhs")
    ct = torch.promote_types(a.dtype, b.dtype)
    return WVec(kops.matmul(a.to(ct).contiguous(), b.to(ct).contiguous(),
                            impl=impl))


def _exec_matvec(args, params, fns, impl):
    """linalg.matvec: the matmul kernel with a (k, 1) right-hand side,
    which takes its warp-per-row launch shape."""
    a = _dense_data(args[0], "matvec lhs")
    b = _dense_data(args[1], "matvec rhs")
    ct = torch.promote_types(a.dtype, b.dtype)
    out = kops.matmul(a.to(ct).contiguous(), b.to(ct).reshape(-1, 1)
                      .contiguous(), impl=impl)
    return WVec(out[:, 0])


def _exec_map_elementwise(args, params, fns, impl):
    """One fused pass of the staged body over the loop's columns: the
    torch closure is the plain version, the IR body (``fns[0].lam``) the
    source of the CUDA kernel."""
    arrays = [_dense_data(a, "map chain") for a in args]
    n = min(a.shape[0] for a in arrays)
    arrays = [a[:n].contiguous() for a in arrays]
    staged = fns[0]
    # the staged lambda is (i, x); map-chain matching guarantees the
    # index is unused, so bind a dummy scalar
    dummy = torch.zeros((), dtype=torch.int64, device=arrays[0].device)

    def body(*cols):
        return staged(dummy, _elem_of(list(cols)))

    return WVec(kops.map_elementwise(body, arrays, impl=impl,
                                     lam=staged.lam, env=staged.env))


# ---------------------------------------------------------------------------
# Footprints: staged columns + scratch bytes one call adds to the budget.
# (arg_shapes are the dense arg shapes; itemsize is the result element
# width.)  Charged by the emitter against memory_limit.
# ---------------------------------------------------------------------------


def _fp_filter_reduce(arg_shapes, itemsize, params):
    n = arg_shapes[0][0] if arg_shapes and arg_shapes[0] else 0
    aggs = params.get("n_aggs", 1)
    # staged value columns (stacked when fused) + predicate + partials
    return aggs * n * itemsize + n + _fr.MAX_BLOCKS * aggs * itemsize


def _fp_vecmerger(arg_shapes, itemsize, params):
    n = arg_shapes[1][0] if len(arg_shapes) > 1 and arg_shapes[1] else 0
    k = arg_shapes[0][0] if arg_shapes and arg_shapes[0] else 0
    # staged seg-id (i32) and value columns + per-block partials
    return n * (4 + itemsize) + _sr.MAX_BLOCKS * k * itemsize


def _fp_dict_group(arg_shapes, itemsize, params):
    n = arg_shapes[0][0] if arg_shapes and arg_shapes[0] else 0
    cap = int(params.get("capacity", 0))
    # staged keys/mask + the stacked (n, 2) value matrix + per-block
    # partials + K-compaction
    return (n * (8 + 4 + 2 * itemsize + 1)
            + _sr.MAX_BLOCKS * cap * 2 * itemsize + cap * (3 * itemsize + 8))


def _fp_hash_build(arg_shapes, itemsize, params):
    n = arg_shapes[0][0] if arg_shapes and arg_shapes[0] else 0
    cap = int(params.get("capacity", 0))
    ctab = _ht.table_size(cap) if cap else 16
    nv = int(params.get("n_vals", 1))
    # staged packed keys + table slots + compact slots + per-column
    # staged values, the table + its sort + rank permutation, and the
    # compacted key/value columns with their segment partials
    return (n * (8 + 4 + 4 + nv * itemsize) + ctab * (8 + 8 + 4)
            + cap * (nv * itemsize + 8) + _sr.MAX_BLOCKS * cap * itemsize)


def _fp_hash_probe(arg_shapes, itemsize, params):
    n = arg_shapes[1][0] if len(arg_shapes) > 1 and arg_shapes[1] else 0
    cap = int(params.get("k", 0))
    cols = max(len(params.get("cols", ())), 1)
    # staged packed queries + pos/found columns + the (per output
    # column) gathered and front-packed outputs, plus the neutralized
    # key table — shared across columns (no one-hot tile: the kernel
    # searches)
    return n * (8 + 4 + 1 + 8 + 2 * cols * itemsize) + cap * 8


def _fp_group_build(arg_shapes, itemsize, params):
    n = arg_shapes[0][0] if arg_shapes and arg_shapes[0] else 0
    cap = int(params.get("capacity", 0))
    ctab = _ht.table_size(cap) if cap else 16
    # staged packed keys + table/compact slots + payload column + the
    # ordering sort, the table + rank, and the CSR offsets/key columns
    return (n * (8 + 4 + 4 + itemsize + 8) + ctab * (8 + 8 + 4)
            + (cap + 1) * 4 + cap * 8)


def _fp_group_probe(arg_shapes, itemsize, params):
    n = arg_shapes[1][0] if len(arg_shapes) > 1 and arg_shapes[1] else 0
    cap = int(params.get("k", 0))
    out = int(params.get("out_cap", 0))
    cols = max(len(params.get("cols", ())), 1)
    # staged packed queries + pos/found/size columns + the scan, and the
    # expanded output buffers every column shares (the expansion-factor
    # term of the memory budget)
    return n * (8 + 4 + 1 + 4 + 8) + out * (cols * itemsize + 8 + 8) \
        + cap * (8 + 4)


def _fp_matmul(arg_shapes, itemsize, params):
    # the kernel masks its edges: no padded copies, no scratch
    return 0


def _fp_map_chain(arg_shapes, itemsize, params):
    # the body runs in registers: no padding, no intermediates
    return 0


# ---------------------------------------------------------------------------
# The shipped registry (one entry per ported route)
# ---------------------------------------------------------------------------

register(KernelSpec(
    name="filter_reduce_sum",
    entry="repro_torch.kernels.ops:filter_reduce_sum",
    pattern="filter_reduce",
    builder="merger[+]",
    elem_kinds=("f32", "f64", "i32", "i64"),
    description="predicated sum over a (possibly multi-column) loop; the "
                "fused form of Listing 10 / TPC-H Q6; multi-aggregate "
                "struct matches fuse into one multi-output launch",
    execute=_exec_filter_reduce,
    cost=_cost.cost_filter_reduce,
    footprint=_fp_filter_reduce,
))

register(KernelSpec(
    name="vecmerger_segment_sum",
    entry="repro_torch.kernels.ops:segment_sum",
    pattern="vecmerger_scatter",
    builder="vecmerger[+]",
    elem_kinds=("f32", "f64"),
    description="scatter-add into a dense base vector as atomic-free "
                "segment sums (PageRank's edge scan)",
    max_segments=_sr.MAX_K,  # the reference's match rule (its tile bound)
    execute=_exec_vecmerger_segment_sum,
    cost=_cost.cost_vecmerger,
    footprint=_fp_vecmerger,
))

register(KernelSpec(
    name="dict_group_sum",
    entry="repro_torch.kernels.ops:segment_sum_vectors",
    pattern="dict_group",
    builder="dictmerger[+]",
    elem_kinds=("f32", "f64", "i32", "i64"),
    description="group-by-sum with dense int keys in [0, capacity) via "
                "segment sums + presence compaction",
    max_segments=_sr.MAX_K,
    execute=_exec_dict_group_sum,
    cost=_cost.cost_dict_group,
    footprint=_fp_dict_group,
))

register(KernelSpec(
    name="dict_hash_build",
    entry="repro_torch.kernels.ops:hash_to_slot",
    pattern="dict_hash_build",
    builder="dictmerger[+]",
    elem_kinds=("f32", "f64", "i32", "i64"),
    description="open-addressing hash build for sparse/non-dense int "
                "keys, scalar or multi-column struct (hash-join build "
                "side; also the group-by fallback beyond the dense "
                "segment route's capacity)",
    max_segments=_ht.MAX_CAP,
    execute=_exec_dict_hash_build,
    cost=_cost.cost_hash_build,
    footprint=_fp_hash_build,
))

register(KernelSpec(
    name="hash_probe",
    entry="repro_torch.kernels.ops:dict_probe",
    pattern="hash_probe",
    builder="vecbuilder",
    elem_kinds=("f32", "f64", "i32", "i64"),
    description="binary-search dict probe: one membership launch shared "
                "by every join output column (inner filter / left "
                "fill-on-miss / anti), gathers outside the kernel",
    max_segments=_ht.MAX_CAP,
    execute=_exec_hash_probe,
    cost=_cost.cost_hash_probe,
    footprint=_fp_hash_probe,
))

register(KernelSpec(
    name="group_build",
    entry="repro_torch.kernels.ops:group_build",
    pattern="group_build",
    builder="groupbuilder",
    elem_kinds=("i32", "i64"),
    description="CSR group build (key -> growing vector of build-row "
                "payloads) via hash-to-slot + slot-histogram compaction "
                "— the m:n hash-join build side",
    max_segments=_ht.MAX_CAP,
    execute=_exec_group_build,
    cost=_cost.cost_group_build,
    footprint=_fp_group_build,
))

register(KernelSpec(
    name="group_probe",
    entry="repro_torch.kernels.ops:group_probe",
    pattern="group_probe",
    builder="vecbuilder",
    elem_kinds=("bool", "i8", "i32", "i64", "f32", "f64"),
    description="m:n join fan-out probe: ONE fused membership + "
                "match-count launch shared by every output column, "
                "then the two-phase expansion (scan + repeat/gather) "
                "outside the kernel",
    max_segments=_ht.MAX_CAP,
    execute=_exec_group_probe,
    cost=_cost.cost_group_probe,
    footprint=_fp_group_probe,
))

register(KernelSpec(
    name="matmul",
    entry="repro_torch.kernels.ops:matmul",
    pattern="linalg.matmul",
    builder="-",
    elem_kinds=("f32", "f64"),
    description="tiled matmul (shared-memory k tiles, register "
                "micro-tiles) for raised 2-D dot loops",
    execute=_exec_matmul,
    cost=_cost.cost_matmul,
    footprint=_fp_matmul,
))

register(KernelSpec(
    name="matvec",
    entry="repro_torch.kernels.ops:matmul",
    pattern="linalg.matvec",
    builder="-",
    elem_kinds=("f32", "f64"),
    description="matrix-vector product through the tiled matmul kernel "
                "(its row launches)",
    execute=_exec_matvec,
    cost=_cost.cost_matmul,
    footprint=_fp_matmul,
))

register(KernelSpec(
    name="map_elementwise",
    entry="repro_torch.kernels.ops:map_elementwise",
    pattern="map_chain",
    builder="vecbuilder",
    elem_kinds=("f32", "f64", "i32", "i64"),
    description="fused elementwise map chain as one generated CUDA kernel "
                "(Black-Scholes-style operator chains)",
    execute=_exec_map_elementwise,
    cost=_cost.cost_map_chain,
    footprint=_fp_map_chain,
    prepare=lambda kc: _mc.prepare(kc.fns[0]),
    refuse=_mc.check_emittable,
    # the generated kernel emits each shared subtree once
    cost_meta=lambda kc: {"kernel_ops": _mc.source_for(kc.fns[0]).ops or 1},
))
