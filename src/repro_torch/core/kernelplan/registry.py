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

This slice registers the three routes of the main path:
``filter_reduce_sum``, ``vecmerger_segment_sum`` and ``dict_group_sum``.
The join, matmul and map-chain routes wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ...kernels import ops as kops
from ...kernels import filter_reduce as _fr
from ...kernels import segment_reduce as _sr
from ..backend.torchgen import TORCH_OF_NP
from ..backend.values import WDict, WVec
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
    max_segments=_sr.MAX_K,  # beyond this, kops serves the plain scatter:
                             # the cost gate prices that route as a loss
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
