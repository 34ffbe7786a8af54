"""Lower optimized Weld IR to PyTorch tensor operations.

The port of the JAX package's ``jaxgen``: the emitter *interprets the IR
over whole tensors*, so one evaluation runs each fused loop as a short
sequence of vector operations on the device.  There is no tracing step:
PyTorch runs eagerly, and "compiling" a program means optimizing,
planning and building the closure below.

Loop lowering follows the reference:

* A parallel ``for`` is evaluated in **vector form**: the element
  parameter is bound to the whole column, builders become accumulator
  objects collecting masked contributions, and conditional control flow
  becomes predication masks.
* Bodies that use their element as a *vector* (nested loops, e.g. a dot
  per row) fall back to ``torch.func.vmap`` over a scalar-world
  evaluation.
* There is no sequential fallback: anything else raises
  ``WeldCompileError``.

Dtypes follow the reference, which runs with 64-bit types enabled: every
IR literal becomes a tensor of its IR type, and binary operations promote
both operands explicitly (torch's own rules would let a dimensioned
float32 operand win over a 0-dim float64 one; the reference does not).

Keyed builders are finalized by sort + segmented reduction over runs of
equal keys in a fixed order, so float dictmerger sums — and float
vecmerger sums — are bitwise identical from run to run on the card.
Groupbuilders finalize CSR-style (values sorted by key + offsets), and
``grouplookup`` lowers only as the iteration source of the m:n join
probe (:func:`match_group_probe`): a binary-search membership pass and a
two-phase expansion (match counts -> exclusive scan -> repeat/gather).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults
from .. import ir
from .. import wtypes as wt
from ..cudf import has_cudf, lookup_cudf_torch
from ..errors import ResourceError, WeldError
from .values import WDict, WGroup, WVec


class WeldCompileError(WeldError):
    """The generic lowering refuses this program shape (not a kernel
    failure)."""


#: memory_limit breaches are typed ResourceError (the reference's alias).
WeldMemoryError = ResourceError

class _NeedsVmap(Exception):
    """Raised when a loop body needs its element as a vector."""


_TORCH_OF = {
    "bool": torch.bool, "i8": torch.int8, "i32": torch.int32,
    "i64": torch.int64, "f32": torch.float32, "f64": torch.float64,
}

#: numpy dtype name -> torch dtype (kernel params carry numpy names)
TORCH_OF_NP = {
    "bool": torch.bool, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "float32": torch.float32, "float64": torch.float64,
}


def tdtype(ty: wt.Scalar) -> torch.dtype:
    return _TORCH_OF[ty.kind]


def _tree_map(fn, v):
    if isinstance(v, tuple):
        return tuple(_tree_map(fn, x) for x in v)
    return fn(v)


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Cast both operands to their common dtype, treating 0-dim tensors
    like any other (the reference's non-weak array promotion)."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return a.to(ct), b.to(ct)


def _where(c, a, b):
    a, b = _promote(a, b)
    return torch.where(c, a, b)


# ---------------------------------------------------------------------------
# Builder accumulators
# ---------------------------------------------------------------------------


class _Acc:
    """Base accumulator.  Contributions are ('single', value, mask) or
    ('batch', value, mask_or_None); struct values are tuples of tensors."""

    def __init__(self, bt: wt.BuilderType, device: torch.device):
        self.bt = bt
        self.device = device
        self.contribs: List[tuple] = []

    def add_single(self, value, mask=None):
        self.contribs.append(("single", value, mask))

    def add_batch(self, value, mask):
        self.contribs.append(("batch", value, mask))


class _MergerAcc(_Acc):
    def __init__(self, bt: wt.Merger, device, init=None):
        super().__init__(bt, device)
        self.init = init

    def finalize(self):
        ident = _identity_value(self.bt.elem, self.bt.op, self.device)
        acc = ident
        if self.init is not None:
            acc = _combine(self.bt.op, acc, self.init)
        for kind, value, mask in self.contribs:
            if kind == "single":
                if mask is not None:
                    value = _select_struct(mask, value, ident)
                acc = _combine(self.bt.op, acc, value)
            else:
                red = _masked_reduce(self.bt, value, mask, self.device)
                acc = _combine(self.bt.op, acc, red)
        return acc


class _VecBuilderAcc(_Acc):
    def __init__(self, bt: wt.VecBuilder, device):
        super().__init__(bt, device)
        self.segments: List[tuple] = []  # sealed per enclosing loop

    def seal(self):
        """Called when an enclosing For finishes: fix the ordering of the
        contributions it produced (interleaved across merge sites)."""
        if not self.contribs:
            return
        batches = [(v, m) for k, v, m in self.contribs if k == "batch"]
        singles = [(v, m) for k, v, m in self.contribs if k == "single"]
        self.contribs = []
        if batches:
            vals = _interleave([b[0] for b in batches])
            masks = [
                b[1] if b[1] is not None
                else torch.ones(_lead(b[0]), dtype=torch.bool,
                                device=self.device)
                for b in batches
            ]
            mask = _interleave(masks) if any(
                b[1] is not None for b in batches
            ) else None
            self.segments.append(("batch", vals, mask))
        for v, m in singles:
            self.segments.append(("single", v, m))

    def finalize(self):
        self.seal()
        if not self.segments:
            if not isinstance(self.bt.elem, wt.Scalar):
                raise WeldCompileError("empty struct vecbuilder")
            return WVec(torch.zeros((0,), dtype=tdtype(self.bt.elem),
                                    device=self.device))
        if len(self.segments) == 1 and self.segments[0][0] == "batch":
            _, vals, mask = self.segments[0]
            if mask is None:
                return WVec(vals)
            return _compact(vals, mask)
        # general: concatenate segments (singles become length-1 batches)
        parts_v, parts_m = [], []
        for kind, v, m in self.segments:
            if kind == "single":
                v = _tree_map(lambda a: a.reshape((1,) + a.shape), v)
                m = (torch.ones((1,), dtype=torch.bool, device=self.device)
                     if m is None else m.reshape(1))
            else:
                m = (torch.ones(_lead(v), dtype=torch.bool,
                                device=self.device) if m is None else m)
            parts_v.append(v)
            parts_m.append(m)
        vals = _concat_struct(parts_v)
        mask = torch.cat(parts_m)
        return _compact(vals, mask)


_INDEX_REDUCE = {"*": "prod", "min": "amin", "max": "amax"}


class _VecMergerAcc(_Acc):
    def __init__(self, bt: wt.VecMerger, base, device):
        super().__init__(bt, device)
        if not isinstance(base, WVec):
            raise WeldCompileError("vecmerger needs a vector base")
        if not base.is_dense:
            raise WeldCompileError("vecmerger base must be dense")
        self.base = base

    def finalize(self):
        """base merged with every contribution.  A float ``+`` sorts the
        contributions by index and sums each run in row order before it
        adds the base (torch's scatter-add uses float atomics on the card,
        which are not bitwise repeatable); integer ``+`` and ``*``,
        ``min``, ``max`` are exact in any order and scatter directly."""
        out = self.base.data
        k = out.shape[0]
        ident = _identity_value(self.bt.elem, self.bt.op, self.device)
        for kind, value, mask in self.contribs:
            idx, v = value  # struct {i64, T}
            if kind == "single":
                idx = idx.reshape(1)
                v = v.reshape(1)
                mask = None if mask is None else mask.reshape(1)
            idx = idx.to(torch.int64)
            # the reference's scatter wraps negative indices and drops
            # out-of-range ones; fold both into the row mask
            keep = (idx >= -k) & (idx < k)
            if mask is not None:
                keep = keep & mask
            idx = torch.where(idx < 0, idx + k, idx)
            if self.bt.op == "+" and out.is_floating_point():
                out = out + _sorted_scatter_sum(idx, v.to(out.dtype), keep, k)
                continue
            idx = torch.where(keep, idx, torch.zeros_like(idx))
            v = _where(keep, v, ident).to(out.dtype)
            if self.bt.op == "+":
                out = out.index_add(0, idx, v)
            else:
                out = out.index_reduce(0, idx, v, _INDEX_REDUCE[self.bt.op],
                                       include_self=True)
        return WVec(out)


class _DictMergerAcc(_Acc):
    def __init__(self, bt, capacity: int, device):
        super().__init__(bt, device)
        self.capacity = int(capacity)


class _GroupAcc(_Acc):
    def __init__(self, bt, capacity: int, device):
        super().__init__(bt, device)
        self.capacity = int(capacity)


def _identity_of_dtype(op: str, dtype: torch.dtype):
    if op == "+":
        return 0
    if op == "*":
        return 1
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _segment_reduce_sorted(col: torch.Tensor, seg: torch.Tensor, nseg: int,
                           op: str) -> torch.Tensor:
    """Reduce ``col`` over segment ids ``seg`` (nondecreasing, in
    ``[0, nseg)``) into ``nseg`` slots; empty slots hold the identity.

    Floats reduce each run of equal ids in row order (deterministic, no
    atomics); integer reductions are exact in any order."""
    ident = _identity_of_dtype(op, col.dtype)
    if col.is_floating_point():
        lengths = torch.bincount(seg, minlength=nseg)
        red = {"+": "sum", "*": "prod", "min": "min", "max": "max"}[op]
        return torch.segment_reduce(col, red, lengths=lengths, initial=ident)
    out = torch.full((nseg,), ident, dtype=col.dtype, device=col.device)
    red = {"+": "sum", "*": "prod", "min": "amin", "max": "amax"}[op]
    return out.scatter_reduce(0, seg, col, reduce=red, include_self=True)


def _sorted_scatter_sum(idx: torch.Tensor, v: torch.Tensor,
                        keep: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) sums of ``v`` over equal ``idx`` in [0, k), rows where
    ``keep`` only; each run of one index sums in row order."""
    seg = torch.where(keep, idx, torch.full_like(idx, k))
    order = torch.argsort(seg, stable=True)
    return _segment_reduce_sorted(v[order], seg[order], k + 1, "+")[:k]


def _finalize_keyed(acc, is_group: bool = False):
    """Finalize a dictmerger or groupbuilder: sort by packed key, then
    segment-reduce the runs of equal keys (dicts) or keep the values
    sorted by key with CSR offsets (groups) — the atomic-free 'global
    builder' strategy."""
    parts_k, parts_v, parts_m = [], [], []
    for kind, value, mask in acc.contribs:
        k, v = value
        if kind == "single":
            k = _tree_map(lambda a: a.reshape(1), k)
            v = _tree_map(lambda a: a.reshape(1), v)
            mask = None if mask is None else mask.reshape(1)
        n = _lead(k)
        parts_k.append(k)
        parts_v.append(v)
        parts_m.append(torch.ones(n, dtype=torch.bool, device=acc.device)
                       if mask is None else mask)
    if not parts_k:
        raise WeldCompileError("empty dict builder")
    keys = _concat_struct(parts_k)
    vals = _concat_struct(parts_v)
    mask = torch.cat(parts_m)

    packed = _pack_keys(keys)
    big = torch.iinfo(torch.int64).max
    packed = torch.where(mask, packed, torch.full_like(packed, big))
    order = torch.argsort(packed, stable=True)
    sp = packed[order]
    sk = _gather_struct(keys, order)
    sv = _gather_struct(vals, order)
    n = sp.shape[0]
    dev = sp.device
    valid = sp != big
    is_new = torch.cat([valid[:1], (sp[1:] != sp[:-1]) & valid[1:]])
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1   # segment id per row
    cap = acc.capacity
    seg = torch.where(valid, seg, torch.full_like(seg, cap))  # park invalid
    count = is_new.sum()
    # more distinct keys than capacity POISONS (negative count), never
    # silently truncates: the segment arrays below are only `cap` wide.
    # The dict.build/group.build failpoints force the flag for tests.
    overflow = count > cap
    if faults.poisoned("group.build" if is_group else "dict.build"):
        overflow = torch.ones_like(overflow)
    count = torch.where(overflow, -count - 1, count)

    first_idx = torch.where(is_new, torch.arange(n, device=dev),
                            torch.full_like(seg, n))
    starts = torch.sort(first_idx).values[:cap]        # first row per segment
    out_keys = _gather_struct(sk, torch.clamp(starts, 0, max(n - 1, 0)))

    # rows past the capacity (overflow) fold into the parked slot, which
    # keeps `seg` nondecreasing for the ordered segmented reduction
    seg = torch.clamp(seg, max=cap)
    if is_group:
        # values stay sorted by key (build-row order within a key);
        # offsets from the rows per segment
        sizes = torch.bincount(seg, minlength=cap + 1)[:cap]
        offsets = torch.cat([torch.zeros((1,), dtype=sizes.dtype,
                                         device=dev), torch.cumsum(sizes, 0)])
        return WGroup(out_keys, sv, offsets, count)
    out_vals = _tree_map(
        lambda col: _segment_reduce_sorted(col, seg, cap + 1,
                                           acc.bt.op)[:cap], sv)
    return WDict(out_keys, out_vals, count)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def _lead(v) -> int:
    leaf = v[0] if isinstance(v, tuple) else v
    return leaf.shape[0]


def _interleave(vals: List):
    """[(n,...) x k] -> (n*k, ...) interleaved per-iteration."""
    if len(vals) == 1:
        return vals[0]
    if isinstance(vals[0], tuple):
        return tuple(
            _interleave([v[f] for v in vals]) for f in range(len(vals[0]))
        )
    stacked = torch.stack(list(_promote_all(vals)), dim=1)
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


def _promote_all(ts):
    ct = ts[0].dtype
    for t in ts[1:]:
        ct = torch.promote_types(ct, t.dtype)
    return [t.to(ct) for t in ts]


def _concat_struct(parts: List):
    if isinstance(parts[0], tuple):
        return tuple(
            torch.cat(_promote_all([p[f] for p in parts]))
            for f in range(len(parts[0]))
        )
    return torch.cat(_promote_all(parts))


def _gather_struct(v, idx):
    if isinstance(v, tuple):
        return tuple(f[idx] for f in v)
    return v[idx]


def _select_struct(mask, a, b):
    if isinstance(a, tuple):
        b = b if isinstance(b, tuple) else tuple(b for _ in a)
        return tuple(_select_struct(mask, x, y) for x, y in zip(a, b))
    return _where(mask, a, b)


def _identity_value(ty, op, device):
    if isinstance(ty, wt.Struct):
        return tuple(_identity_value(f, op, device) for f in ty.fields)
    return torch.tensor(wt.merge_identity(op, ty), dtype=tdtype(ty),
                        device=device)


_COMBINE = {
    "+": torch.add, "*": torch.mul,
    "min": torch.minimum, "max": torch.maximum,
}


def _combine(op, a, b):
    if isinstance(a, tuple):
        return tuple(_combine(op, x, y) for x, y in zip(a, b))
    return _COMBINE[op](*_promote(a, b))


def _masked_reduce(bt: wt.Merger, value, mask, device):
    ident = _identity_value(bt.elem, bt.op, device)
    if mask is not None:
        value = _select_struct(mask, value, ident)
    fn = {
        "+": torch.sum, "*": torch.prod,
        "min": torch.amin, "max": torch.amax,
    }[bt.op]

    def red(x, iv):
        if x.ndim >= 1:
            if x.shape[0] == 0:  # empty loop: min/max have no identity
                return iv
            return fn(x, dim=0)
        return x

    if isinstance(value, tuple):
        return tuple(red(x, iv) for x, iv in zip(value, ident))
    return red(value, ident)


def _compact(vals, mask) -> WVec:
    """Front-pack valid elements (stable) — compaction via sort."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    packed = _gather_struct(vals, order)
    return WVec(packed, count=mask.sum())


def _pack_keys(keys):
    """Pack a (possibly struct) key into one i64 for sorting.  A single
    int column keeps its full 64-bit value (injective); multi-field
    struct keys are bit-packed 32 bits per field and floats are bit-cast
    through f32 after normalizing -0.0 to +0.0 (byte-identical to the
    reference's packing)."""
    cols = list(keys) if isinstance(keys, tuple) else [keys]
    if len(cols) == 1 and not cols[0].is_floating_point():
        return cols[0].to(torch.int64)
    packed = torch.zeros(_lead(keys), dtype=torch.int64,
                         device=cols[0].device)
    for c in cols:
        if c.is_floating_point():
            c = torch.where(c == 0, torch.zeros_like(c), c)
            c = c.to(torch.float32).view(torch.int32).to(torch.int64)
        else:
            c = c.to(torch.int64)
        packed = packed * (1 << 32) + (c & 0xFFFFFFFF)
    return packed


def _dict_find(d: WDict, key):
    """Locate `key` (scalar, (n,) column, or tuple thereof for struct
    keys) in a dict's sorted-front-packed key columns.

    Returns ``(pos, found, scalar)``.  Parked slots (>= count) are
    neutralized to +inf before the binary search; a poisoned dict
    (negative count) matches nothing."""
    packed_keys = _pack_keys(d.keys)
    cap = packed_keys.shape[0]
    dev = packed_keys.device
    valid_n = torch.clamp(torch.as_tensor(d.count, device=dev)
                          .to(torch.int64), min=0)
    big = torch.iinfo(torch.int64).max
    kt = key
    lead = kt[0] if isinstance(kt, tuple) else kt
    scalar = lead.ndim == 0
    if scalar:
        kt = _tree_map(lambda a: a.reshape(1), kt)
    q = _pack_keys(kt)
    if cap == 0:  # empty build side (static): nothing can match
        zeros = torch.zeros(q.shape, dtype=torch.int64, device=dev)
        return zeros, zeros.to(torch.bool), scalar
    table = torch.where(torch.arange(cap, device=dev) < valid_n,
                        packed_keys, torch.full_like(packed_keys, big))
    pos = torch.clamp(torch.searchsorted(table, q), 0, cap - 1)
    found = (table[pos] == q) & (pos < valid_n)
    return pos, found, scalar


def _group_find(g: WGroup, key):
    """Locate batched probe keys in a groupbuilder result's sorted key
    columns (the :func:`_dict_find` search: parked slots neutralized, a
    poisoned group matches nothing).  Returns ``(pos, found, sizes)`` —
    clipped slot positions, a hit mask, and the per-query group size
    (0 on a miss)."""
    pos, found, _ = _dict_find(g, key)
    offs = torch.as_tensor(g.offsets, device=pos.device).to(torch.int64)
    if offs.shape[0] < 2:  # statically empty build side
        return pos, found, torch.zeros_like(pos)
    sizes = torch.where(found, (offs[1:] - offs[:-1])[pos],
                        torch.zeros_like(pos))
    return pos, found, sizes


def expand_rows(cnt: torch.Tensor, out_cap: int):
    """Two-phase variable-length expansion: per-row repeat counts ->
    ``(rows, ordinals, total)``.  ``rows[j]`` is the source row of output
    slot ``j`` (exclusive-scan offsets + binary search), ``ordinals[j]``
    its position within that row's run; ``total`` is the dynamic output
    length (a device tensor) materialized into the static ``out_cap``
    buffer."""
    n = cnt.shape[0]
    dev = cnt.device
    cnt = cnt.to(torch.int64)
    total = cnt.sum() if n else torch.zeros((), dtype=torch.int64, device=dev)
    if out_cap == 0 or n == 0:
        z = torch.zeros((out_cap,), dtype=torch.int64, device=dev)
        return z, z, total
    ends = torch.cumsum(cnt, 0)
    starts = ends - cnt
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    rows = torch.clamp(torch.searchsorted(ends, j, right=True), 0, n - 1)
    ordinals = j - starts[rows]
    return rows, ordinals, total


def group_expand(g: WGroup, pos, found, sizes, mask, how: str,
                 out_cap: int, col_specs):
    """Materialize an m:n probe's expanded output columns: match counts
    -> exclusive scan -> repeat/gather, all columns sharing ONE
    expansion index.  ``col_specs`` entries are ``("expr", col)`` (a
    whole probe-side column, repeated per match) or ``("gather", data,
    fill)`` (a build-side column gathered through the group's stored
    row payload; ``fill`` selects left-join miss rows).  Poison
    (negative group count, or a dynamic total exceeding the static
    capacity) propagates as a negative output count."""
    n = pos.shape[0]
    dev = found.device
    sizes = sizes.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if how == "inner":
        cnt = torch.where(found & mask, sizes, zero)
    elif how == "left":  # misses emit ONE fill row each
        cnt = torch.where(mask, torch.where(found, sizes, zero + 1), zero)
    else:
        raise WeldCompileError(f"group expansion how={how!r}")
    rows, ordinals, total = expand_rows(cnt, out_cap)
    total = torch.where(total > out_cap, -total - 1, total)
    total = torch.where(
        torch.as_tensor(g.count, device=dev).to(torch.int64) < 0,
        zero - 1, total)
    vals = g.values
    if isinstance(vals, tuple):
        raise WeldCompileError("group expansion needs a scalar payload")
    nv = vals.shape[0]
    offs = torch.as_tensor(g.offsets, device=dev).to(torch.int64)
    if n == 0 or out_cap == 0:
        frow = torch.zeros((out_cap,), dtype=torch.bool, device=dev)
        payload = torch.zeros((out_cap,), dtype=torch.int64, device=dev)
    else:
        frow = found[rows]
        grp = torch.clamp(pos[rows].to(torch.int64), 0, offs.shape[0] - 2)
        if nv == 0:
            payload = torch.zeros((out_cap,), dtype=torch.int64, device=dev)
        else:
            bpos = torch.clamp(offs[grp] + ordinals, 0, nv - 1)
            payload = vals[bpos].to(torch.int64)
    outs = []
    for spec in col_specs:
        if spec[0] == "expr":
            col = spec[1]
            out = col[rows] if (n and out_cap) else torch.zeros(
                (out_cap,), dtype=col.dtype, device=dev)
        else:
            rv, fill = spec[1], spec[2]
            if rv.shape[0] == 0 or out_cap == 0:
                out = torch.zeros((out_cap,), dtype=rv.dtype, device=dev)
                if fill is not None:
                    out = torch.full((out_cap,), fill, dtype=rv.dtype,
                                     device=dev)
            else:
                out = rv[torch.clamp(payload, 0, rv.shape[0] - 1)]
            if how == "left" and out_cap:
                out = torch.where(frow, out, torch.tensor(
                    fill, dtype=rv.dtype, device=dev))
        outs.append(out)
    return tuple(WVec(o, count=total) for o in outs)


@dataclass
class GroupProbeShape:
    """Destructured m:n probe loop (see :func:`match_group_probe`)."""

    d: "ir.Ident"                 # the groupbuilder dict
    key_parts: list               # per-probe-row key column exprs
    pred: Optional["ir.Expr"]     # optional elementwise row predicate
    how: str                      # "inner" | "left"
    cols: list                    # ("expr", e) | ("gather", rcol Ident)
    fills: list                   # per-column left-miss Literal (or None)
    builders: list                # the output NewBuilder(VecBuilder)s


def match_group_probe(loop: ir.For) -> Optional[GroupProbeShape]:
    """Structurally match weldrel's m:n join probe loop — the canonical
    variable-length-expansion form shared by the generic lowering and
    the kernel planner's ``group_probe`` route:

        for(V.., {vecbuilder..}, (b,i,x) =>
            [if(pred,]
              [if(keyexists(d, k),]                        # left only
                for(grouplookup(d, k), b, (b2,i2,r) =>
                    {merge(b2.$k, f(x) | lookup(RCOL, r))..})
              [, {merge(b.$k, f(x) | fill)..})]            # left misses
            [, b)])

    Returns ``None`` when the loop is anything else (the generic
    accumulator lowering then applies)."""
    nb = loop.builder
    if not (isinstance(nb, ir.MakeStruct) and nb.items and all(
            isinstance(p, ir.NewBuilder) and isinstance(p.ty, wt.VecBuilder)
            and isinstance(p.ty.elem, wt.Scalar) for p in nb.items)):
        return None
    if len(loop.func.params) != 3:
        return None
    b, i, x = loop.func.params
    body = loop.func.body
    pred: Optional[ir.Expr] = None
    if (isinstance(body, ir.If) and isinstance(body.on_false, ir.Ident)
            and body.on_false.name == b.name):
        pred, body = body.cond, body.on_true
    how, miss, ke = "inner", None, None
    if isinstance(body, ir.If) and isinstance(body.cond, ir.KeyExists):
        how, ke, miss, body = "left", body.cond, body.on_false, body.on_true
    if not (isinstance(body, ir.For) and len(body.iters) == 1
            and body.iters[0].is_plain
            and isinstance(body.iters[0].data, ir.GroupLookup)):
        return None
    gl = body.iters[0].data
    d = gl.expr
    if not (isinstance(d, ir.Ident) and isinstance(d.ty, wt.DictType)
            and isinstance(d.ty.val, wt.Vec)):
        return None
    if how == "left" and not (
            isinstance(ke.expr, ir.Ident) and ke.expr.name == d.name
            and ir.canon_key(ke.key) == ir.canon_key(gl.key)):
        return None
    if not (isinstance(body.builder, ir.Ident)
            and body.builder.name == b.name):
        return None
    if len(body.func.params) != 3:
        return None
    bi, ii, ri = body.func.params
    ibody = body.func.body
    if not (isinstance(ibody, ir.MakeStruct)
            and len(ibody.items) == len(nb.items)):
        return None

    def merge_into(item: ir.Expr, k: int, bname: str) -> Optional[ir.Expr]:
        if (isinstance(item, ir.Merge)
                and isinstance(item.builder, ir.GetField)
                and item.builder.index == k
                and isinstance(item.builder.expr, ir.Ident)
                and item.builder.expr.name == bname):
            return item.value
        return None

    cols: list = []
    fills: list = []
    for k, item in enumerate(ibody.items):
        v = merge_into(item, k, bi.name)
        if v is None:
            return None
        if (isinstance(v, ir.Lookup) and v.default is None
                and isinstance(v.expr, ir.Ident)
                and isinstance(v.expr.ty, wt.Vec)
                and isinstance(v.index, ir.Ident)
                and v.index.name == ri.name):
            cols.append(("gather", v.expr))
        else:
            if set(ir.free_vars(v)) & {ri.name, ii.name, bi.name, d.name}:
                return None
            cols.append(("expr", v))
        fills.append(None)
    if how == "left":
        if not (isinstance(miss, ir.MakeStruct)
                and len(miss.items) == len(nb.items)):
            return None
        for k, item in enumerate(miss.items):
            mv = merge_into(item, k, b.name)
            if mv is None:
                return None
            kind, payload = cols[k]
            if kind == "gather":
                if not isinstance(mv, ir.Literal):
                    return None
                fills[k] = mv
            elif ir.canon_key(mv) != ir.canon_key(payload):
                return None  # probe columns must fill with themselves
    key = gl.key
    key_parts = (
        list(key.items) if isinstance(key, ir.MakeStruct) else [key]
    )
    for e2 in key_parts + ([pred] if pred is not None else []):
        if d.name in ir.free_vars(e2):
            return None
    return GroupProbeShape(d=d, key_parts=key_parts, pred=pred, how=how,
                           cols=cols, fills=fills, builders=list(nb.items))


def _gather_clamped(data, idx):
    """``data[idx]`` with the reference's gather rules: negative indices
    wrap once, out-of-range ones clamp (an out-of-range CUDA gather
    would fault instead)."""
    n = _lead(data)
    idx = idx.to(torch.int64)
    idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, max(n - 1, 0))
    return _gather_struct(data, idx)


_UNARY = {
    "neg": torch.neg,
    "not": torch.logical_not,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "erf": torch.erf,
    "sin": torch.sin,
    "cos": torch.cos,
    "tanh": torch.tanh,
    "abs": torch.abs,
    "sigmoid": torch.sigmoid,
    "floor": torch.floor,
    "rsqrt": torch.rsqrt,
}

_CMP = {
    "==": torch.eq, "!=": torch.ne, "<": torch.lt,
    "<=": torch.le, ">": torch.gt, ">=": torch.ge,
}


def _binop(op, a, b):
    if op == "&&":
        return torch.logical_and(a, b)
    if op == "||":
        return torch.logical_or(a, b)
    a, b = _promote(a, b)
    if op in ("+", "-", "*"):
        return {"+": torch.add, "-": torch.sub, "*": torch.mul}[op](a, b)
    integer = not a.is_floating_point()
    if op == "/":
        # integer division truncates toward zero (C semantics)
        return torch.div(a, b, rounding_mode="trunc") if integer \
            else torch.div(a, b)
    if op == "%":
        return torch.fmod(a, b) if integer else torch.remainder(a, b)
    if op == "pow":
        return torch.pow(a, b)
    if op in ("min", "max"):
        return (torch.minimum if op == "min" else torch.maximum)(a, b)
    if op in ir.CMP_OPS:
        return _CMP[op](a, b)
    raise WeldCompileError(f"binop {op}")


# ---------------------------------------------------------------------------
# static const-eval for iter bounds / capacities
# ---------------------------------------------------------------------------


def _static_eval(e: ir.Expr, shapes: Dict[str, tuple]) -> Optional[int]:
    if isinstance(e, ir.Literal):
        return int(e.value)
    if isinstance(e, ir.Len) and isinstance(e.expr, ir.Ident):
        shp = shapes.get(e.expr.name)
        return None if shp is None else int(shp[0])
    if isinstance(e, ir.BinOp):
        a = _static_eval(e.left, shapes)
        b = _static_eval(e.right, shapes)
        if a is None or b is None:
            return None
        return int({
            "+": a + b, "-": a - b, "*": a * b,
            "/": int(a / b) if b else 0,
            "min": min(a, b), "max": max(a, b),
        }.get(e.op, None)) if e.op in ("+", "-", "*", "/", "min", "max") else None
    return None


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------


class _LoopCtx:
    def __init__(self, n: int, mask, per_elem: frozenset, parent=None):
        self.n = n
        self.mask = mask  # (n,) bool or None
        self.per_elem = per_elem
        self.parent = parent
        self.touched: List[_Acc] = []  # vecbuilders merged in this loop


def _ret_dtype(x: ir.KernelCall) -> str:
    """A kernel call's ledger/quarantine dtype: the planner's
    ``meta["dtype"]`` formula (``planner._np_dtype_of``), so the
    calibration can match ledger medians to the gate's meta."""
    from ..kernelplan.planner import _np_dtype_of

    return str(np.dtype(_np_dtype_of(x.ret_ty)))


class Emitter:
    def __init__(self, input_shapes: Dict[str, tuple], device: torch.device,
                 memory_limit: Optional[int] = None,
                 kernel_impl: Optional[str] = None,
                 measure: bool = False):
        self.input_shapes = input_shapes
        self.device = torch.device(device)
        self.memory_limit = memory_limit
        self.kernel_impl = kernel_impl
        self.measure = measure
        self.est_bytes = 0
        #: dynamic counts of every dict this program probed —
        #: emit_program ORs their signs into the output counts so a
        #: probe against a poisoned (overflowed) dict can never decode
        #: as a plausible empty/partial result
        self.taints: List[object] = []

    def _note_taint(self, coll) -> None:
        count = getattr(coll, "count", None)
        if count is not None:
            self.taints.append(count)

    def _charge(self, nbytes: int, what: str) -> None:
        if self.memory_limit is None:
            return
        self.est_bytes += int(nbytes)
        if self.est_bytes > self.memory_limit:
            raise WeldMemoryError(
                f"estimated temp bytes {self.est_bytes}{what} exceed "
                f"memory limit {self.memory_limit}"
            )

    # -- entry ---------------------------------------------------------------

    def run(self, expr: ir.Expr, env: Dict[str, object]):
        return self.ev(expr, dict(env), None)

    # -- main dispatch ---------------------------------------------------------

    def ev(self, x: ir.Expr, env, ctx: Optional[_LoopCtx]):
        m = getattr(self, "_ev_" + type(x).__name__, None)
        if m is None:
            raise WeldCompileError(f"cannot lower {type(x).__name__}")
        return m(x, env, ctx)

    # -- leaves ---------------------------------------------------------------

    def _ev_Literal(self, x: ir.Literal, env, ctx):
        return torch.tensor(x.value, dtype=tdtype(x.ty), device=self.device)

    def _ev_Ident(self, x: ir.Ident, env, ctx):
        if x.name not in env:
            raise WeldCompileError(f"unbound {x.name}")
        return env[x.name]

    def _ev_Let(self, x: ir.Let, env, ctx):
        v = self.ev(x.value, env, ctx)
        env2 = dict(env)
        env2[x.name] = v
        if ctx is not None and self._depends_per_elem(x.value, ctx):
            ctx2 = _LoopCtx(ctx.n, ctx.mask, ctx.per_elem | {x.name}, ctx.parent)
            ctx2.touched = ctx.touched  # share accumulator-seal tracking
            ctx = ctx2
        return self.ev(x.body, env2, ctx)

    def _ev_BinOp(self, x: ir.BinOp, env, ctx):
        return _binop(x.op, self.ev(x.left, env, ctx),
                      self.ev(x.right, env, ctx))

    def _ev_UnaryOp(self, x: ir.UnaryOp, env, ctx):
        v = self.ev(x.expr, env, ctx)
        if x.op in ("exp", "log", "sqrt", "erf", "sin", "cos", "tanh",
                    "sigmoid", "rsqrt"):
            v = _to_float(v)
        return _UNARY[x.op](v)

    def _ev_Cast(self, x: ir.Cast, env, ctx):
        return self.ev(x.expr, env, ctx).to(tdtype(x.ty))

    def _ev_Select(self, x: ir.Select, env, ctx):
        c = self.ev(x.cond, env, ctx)
        t = self.ev(x.on_true, env, ctx)
        f = self.ev(x.on_false, env, ctx)
        return _select_struct(c, t, f)

    def _ev_If(self, x: ir.If, env, ctx):
        bty = self._is_builder_expr(x.on_true, env)
        if not bty:
            return self._ev_Select(ir.Select(x.cond, x.on_true, x.on_false),
                                   env, ctx)
        # control flow over builders -> predication masks
        c = self.ev(x.cond, env, ctx)
        if ctx is None:
            raise WeldCompileError("builder If outside a loop")
        c = torch.broadcast_to(c, (ctx.n,))
        mask_t = c if ctx.mask is None else ctx.mask & c
        mask_f = ~c if ctx.mask is None else ctx.mask & ~c
        ctx_t = _LoopCtx(ctx.n, mask_t, ctx.per_elem, ctx.parent)
        ctx_t.touched = ctx.touched
        ctx_f = _LoopCtx(ctx.n, mask_f, ctx.per_elem, ctx.parent)
        ctx_f.touched = ctx.touched
        t = self.ev(x.on_true, env, ctx_t)
        self.ev(x.on_false, env, ctx_f)
        return t  # same accumulator objects on both paths

    def _ev_MakeStruct(self, x: ir.MakeStruct, env, ctx):
        return tuple(self.ev(i, env, ctx) for i in x.items)

    def _ev_GetField(self, x: ir.GetField, env, ctx):
        v = self.ev(x.expr, env, ctx)
        return v[x.index]

    def _ev_MakeVec(self, x: ir.MakeVec, env, ctx):
        items = [self.ev(i, env, ctx) for i in x.items]
        return WVec(torch.stack(_promote_all(items)))

    def _ev_Len(self, x: ir.Len, env, ctx):
        if ctx is not None and self._depends_per_elem(x.expr, ctx):
            raise _NeedsVmap()
        v = self.ev(x.expr, env, ctx)
        if isinstance(v, WVec):
            return torch.as_tensor(v.length(), device=self.device
                                   ).to(torch.int64)
        raise WeldCompileError("len of non-vec")

    def _ev_Lookup(self, x: ir.Lookup, env, ctx):
        if ctx is not None and self._depends_per_elem(x.expr, ctx):
            raise _NeedsVmap()
        coll = self.ev(x.expr, env, ctx)
        idx = self.ev(x.index, env, ctx)
        if isinstance(coll, WVec):
            return _gather_clamped(coll.data, idx)
        if isinstance(coll, WDict):
            # scalar OR whole-column probe; with a `default` the miss
            # mask from the SAME find selects the fill
            self._note_taint(coll)
            pos, found, scalar = _dict_find(coll, idx)

            def gather(a):
                if a.shape[0] == 0:  # empty dict: type-correct zeros
                    return torch.zeros(pos.shape, dtype=a.dtype,
                                       device=a.device)
                return a[pos]

            out = _tree_map(gather, coll.vals)
            if x.default is not None:
                dflt = self.ev(x.default, env, ctx)
                out = _select_struct(found, out, dflt)
            if scalar:
                out = _tree_map(lambda a: a[0], out)
            return out
        raise WeldCompileError("lookup on unsupported value")

    def _ev_KeyExists(self, x: ir.KeyExists, env, ctx):
        d = self.ev(x.expr, env, ctx)
        k = self.ev(x.key, env, ctx)
        self._note_taint(d)
        if isinstance(d, WGroup):
            pos, found, _ = _group_find(d, k)
            return found
        pos, found, scalar = _dict_find(d, k)
        return found[0] if scalar else found

    def _ev_GroupLookup(self, x: ir.GroupLookup, env, ctx):
        raise WeldCompileError(
            "grouplookup has data-dependent length and lowers only as "
            "the iteration source of an m:n probe loop (the shape "
            "match_group_probe recognizes); restructure the program "
            "around that canonical expansion form"
        )

    def _ev_CUDF(self, x: ir.CUDF, env, ctx):
        if ctx is not None and any(
            self._depends_per_elem(a, ctx) for a in x.args
        ):
            raise _NeedsVmap()
        if not has_cudf(x.name) and not x.name.startswith("linalg."):
            raise WeldCompileError(f"unknown cudf {x.name}")
        args = [self.ev(a, env, ctx) for a in x.args]
        uw = [a.data if isinstance(a, WVec) and a.is_dense else a for a in args]
        if any(isinstance(a, WVec) for a in uw):
            raise WeldCompileError(f"cudf {x.name} on padded vector")
        if x.name in ("linalg.dot", "linalg.matvec", "linalg.matmul"):
            # a plain product outside any kernel, as the reference left
            # it to XLA's dot
            out = torch.matmul(*_promote(uw[0], uw[1]))
        else:
            out = lookup_cudf_torch(x.name)(*uw)
        if isinstance(x.ret_ty, wt.Vec):
            return WVec(out)
        return out

    def _ev_KernelCall(self, x: ir.KernelCall, env, ctx):
        if ctx is not None and any(
            self._depends_per_elem(a, ctx) for a in x.args
        ):
            raise _NeedsVmap()
        from ..kernelplan import registry as kreg

        spec = kreg.get(x.kernel)
        args = [self.ev(a, env, ctx) for a in x.args]
        params = dict(x.params)
        if self.memory_limit is not None and spec.footprint is not None:
            # kernel calls pay their staged columns + scratch out of the
            # same budget the vecbuilder size hints feed
            self._charge(self._kernel_footprint(spec, args, x, params),
                         f" (incl. kernel {x.kernel} scratch)")
        fns = [self._stage_elem_fn(lam, env) for lam in x.fns]
        dtype = _ret_dtype(x)
        if self.measure:
            return self._measured_kernel_call(x, spec, args, params, fns,
                                              dtype)
        return kreg.execute_spec(spec, args, params, fns, self.kernel_impl,
                                 dtype=dtype)

    def _measured_kernel_call(self, x: ir.KernelCall, spec, args, params,
                              fns, dtype: str):
        """Replay path: time this call under a ``kernel.<name>`` span and
        append a cost-ledger record carrying the planner's
        ``predicted_ns`` beside the measured time.

        On the card ``measured_ns`` is the device time inside the call's
        kernel entries (``kernels/ops.py``, CUDA events around each:
        ``_count.device_clock``), the clock of the roofline's figures
        that the calibrated gate compares it with: the staged bodies,
        which the generic lowering evaluates too, and the entries' own
        host path (each entry's launches queue behind a cover) stay out.
        The span around the call is bracketed by
        ``torch.cuda.synchronize()`` on both sides and is kept as
        ``host_ns``; CUDA events just inside give ``event_ns``, the
        stream's time from the call's first work to its last (the covers
        included).  On the CPU ``measured_ns`` is the span's host time."""
        from .. import obs
        from ...kernels import _count
        from ..kernelplan import registry as kreg

        cuda = self.device.type == "cuda"
        marks: list = []
        if cuda:
            torch.cuda.synchronize(self.device)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
        with obs.span(f"kernel.{x.kernel}", n=params.get("n_rows"),
                      impl=self.kernel_impl) as sp:
            if cuda:
                ev0.record()
                with _count.device_clock() as marks:
                    out = kreg.execute_spec(spec, args, params, fns,
                                            self.kernel_impl, dtype=dtype)
                ev1.record()
                torch.cuda.synchronize(self.device)
            else:
                out = kreg.execute_spec(spec, args, params, fns,
                                        self.kernel_impl, dtype=dtype)
        predicted = params.get("predicted_ns")
        measured = _count.clock_ns(marks) if cuda else (sp.dur_ns or 0)
        sp.set("predicted_ns", predicted)
        sp.set("measured_ns", measured)
        sp.set("host_ns", sp.dur_ns)
        if cuda:
            sp.set("event_ns", int(ev0.elapsed_time(ev1) * 1e6))
        obs.ledger.record(
            kernel=x.kernel, dtype=dtype, n=params.get("n_rows") or 0,
            predicted_ns=predicted, measured_ns=measured,
            impl=self.kernel_impl,
            device=(torch.cuda.get_device_name(self.device) if cuda
                    else "cpu"),
            host_ns=sp.dur_ns,
        )
        return out

    @staticmethod
    def _kernel_footprint(spec, args, x: ir.KernelCall, params) -> int:
        def shape_of(v):
            if isinstance(v, WVec):
                leaf = v.data[0] if isinstance(v.data, tuple) else v.data
                return tuple(leaf.shape)
            return tuple(getattr(v, "shape", ()))

        return int(spec.footprint(
            [shape_of(a) for a in args], wt.elem_bytes(x.ret_ty), params
        ))

    def _stage_elem_fn(self, lam: ir.Lambda, env):
        """Per-element IR lambda -> whole-column callable (evaluation via
        this emitter, closing over the current env).  The callable also
        carries the lambda (``.lam``) and that env (``.env``): a kernel
        that generates its code from the IR body (the map chain) reads
        them."""
        base_env = dict(env)

        def fn(*vals):
            env2 = dict(base_env)
            for p, v in zip(lam.params, vals):
                env2[p.name] = v
            return self.ev(lam.body, env2, None)

        fn.lam = lam
        fn.env = base_env
        return fn

    # -- builders -------------------------------------------------------------

    def _ev_NewBuilder(self, x: ir.NewBuilder, env, ctx):
        bt = x.ty
        if isinstance(bt, wt.Merger):
            init = self.ev(x.arg, env, ctx) if x.arg is not None else None
            return _MergerAcc(bt, self.device, init)
        if isinstance(bt, wt.VecBuilder):
            if x.size_hint is not None and self.memory_limit is not None:
                n = _static_eval(x.size_hint, self.input_shapes)
                if n is not None and isinstance(bt.elem, wt.Scalar):
                    self._charge(n * np.dtype(bt.elem.np_dtype).itemsize, "")
            return _VecBuilderAcc(bt, self.device)
        if isinstance(bt, wt.VecMerger):
            base = self.ev(x.arg, env, ctx)
            return _VecMergerAcc(bt, base, self.device)
        if isinstance(bt, (wt.DictMerger, wt.GroupBuilder)):
            cap = 1024
            if x.arg is not None:
                c = _static_eval(x.arg, self.input_shapes)
                if c is not None:
                    cap = c
            cls = _DictMergerAcc if isinstance(bt, wt.DictMerger) else _GroupAcc
            return cls(bt, cap, self.device)
        raise WeldCompileError(f"cannot build {bt}")

    def _ev_Merge(self, x: ir.Merge, env, ctx):
        acc = self.ev(x.builder, env, ctx)
        if not isinstance(acc, _Acc):
            raise WeldCompileError("merge into non-builder value")
        val = self.ev(x.value, env, ctx)
        if ctx is None:
            acc.add_single(val)
        else:
            val = self._broadcast_elem(val, ctx)
            acc.add_batch(val, ctx.mask)
            if isinstance(acc, _VecBuilderAcc) and acc not in ctx.touched:
                ctx.touched.append(acc)
        return acc

    def _ev_Result(self, x: ir.Result, env, ctx):
        if ctx is None and isinstance(x.builder, ir.For):
            shape = match_group_probe(x.builder)
            if shape is not None:
                return self._lower_group_probe(x.builder, shape, env)
        acc = self.ev(x.builder, env, ctx)
        if isinstance(acc, tuple):
            return tuple(self._finalize(a) for a in acc)
        return self._finalize(acc)

    def _lower_group_probe(self, loop: ir.For, shape: GroupProbeShape, env):
        """Generic (kernel-free) lowering of the m:n join probe: one
        binary-search membership pass over the group's sorted keys, then
        the shared two-phase expansion (match counts -> exclusive scan ->
        repeat/gather) with every output column riding one expansion
        index.  Output length is data-dependent; the static buffer
        capacity comes from the vecbuilders' size hints."""
        g = self.ev(shape.d, env, None)
        if not isinstance(g, WGroup):
            raise WeldCompileError("group probe expects a groupbuilder dict")
        seqs = [self.ev(it, env, None) for it in loop.iters]
        n = min(s.capacity() for s in seqs)
        mask = None
        for s in seqs:
            if not s.is_dense:
                m = torch.arange(n, device=self.device) < s.count
                mask = m if mask is None else mask & m
        b_p, i_p, x_p = loop.func.params
        env2 = dict(env)
        env2[i_p.name] = torch.arange(n, dtype=torch.int64, device=self.device)
        env2[x_p.name] = (
            _first_n(seqs[0].data, n) if len(seqs) == 1
            else tuple(_first_n(s.data, n) for s in seqs)
        )

        def col(v):
            return v if v.ndim >= 1 and v.shape[0] == n \
                else torch.broadcast_to(v, (n,) + tuple(v.shape))

        key_cols = [col(self.ev(kp, env2, None)) for kp in shape.key_parts]
        key = tuple(key_cols) if len(key_cols) > 1 else key_cols[0]
        pos, found, sizes = _group_find(g, key)
        pm = mask
        if shape.pred is not None:
            pv = col(self.ev(shape.pred, env2, None)).to(torch.bool)
            pm = pv if pm is None else pm & pv
        if pm is None:
            pm = torch.ones((n,), dtype=torch.bool, device=self.device)
        hint = shape.builders[0].size_hint
        out_cap = (
            _static_eval(hint, self.input_shapes)
            if hint is not None else None
        )
        if out_cap is None:
            raise WeldCompileError(
                "m:n group probe needs a static output capacity "
                "(vecbuilder size hint)"
            )
        self._charge(sum(int(out_cap) * np.dtype(p.ty.elem.np_dtype).itemsize
                         for p in shape.builders),
                     " (incl. m:n join expansion)")
        col_specs = []
        for (kind, payload), fill in zip(shape.cols, shape.fills):
            if kind == "expr":
                col_specs.append(("expr", col(self.ev(payload, env2, None))))
            else:
                rv = self.ev(payload, env, None)
                if not isinstance(rv, WVec) or not rv.is_dense:
                    raise WeldCompileError(
                        "group probe gathers need dense build columns"
                    )
                col_specs.append(
                    ("gather", rv.data,
                     None if fill is None else fill.value)
                )
        return group_expand(g, pos, found, sizes, pm, shape.how,
                            int(out_cap), col_specs)

    def _finalize(self, acc):
        if isinstance(acc, (_MergerAcc, _VecBuilderAcc, _VecMergerAcc)):
            return acc.finalize()
        if isinstance(acc, _DictMergerAcc):
            return _finalize_keyed(acc, is_group=False)
        if isinstance(acc, _GroupAcc):
            return _finalize_keyed(acc, is_group=True)
        raise WeldCompileError("result of non-builder")

    # -- loops ----------------------------------------------------------------

    def _ev_Iter(self, x: ir.Iter, env, ctx):
        data = self.ev(x.data, env, ctx)
        if not isinstance(data, WVec):
            raise WeldCompileError("iter over non-vec")
        start = _static_eval(x.start, self.input_shapes) if x.start is not None else 0
        end = (
            _static_eval(x.end, self.input_shapes)
            if x.end is not None else None
        )
        stride = (
            _static_eval(x.stride, self.input_shapes)
            if x.stride is not None else 1
        )
        if (x.start is not None and start is None) or \
           (x.end is not None and end is None) or \
           (x.stride is not None and stride is None):
            raise WeldCompileError("iter bounds must be statically evaluable")
        if start == 0 and end is None and stride == 1:
            return data
        if not data.is_dense:
            raise WeldCompileError("cannot slice a padded (filtered) vector")
        if stride <= 0:
            raise WeldCompileError("iter stride must be positive")
        sl = slice(start, end, stride)
        return WVec(_tree_map(lambda a: a[sl], data.data))

    def _ev_For(self, x: ir.For, env, ctx):
        # nested loop whose data depends on the enclosing element -> vmap
        if ctx is not None and any(
            self._depends_per_elem(it, ctx) for it in x.iters
        ):
            raise _NeedsVmap()

        acc_tree = self.ev(x.builder, env, ctx)
        seqs = [self.ev(it, env, ctx) for it in x.iters]
        n = min(s.capacity() for s in seqs)
        mask = None
        for s in seqs:
            if not s.is_dense:
                m = torch.arange(n, device=self.device) < s.count
                mask = m if mask is None else (mask & m)

        b_p, i_p, x_p = x.func.params
        idx = torch.arange(n, dtype=torch.int64, device=self.device)
        if len(seqs) == 1:
            elem = _first_n(seqs[0].data, n)
        else:
            elem = tuple(_first_n(s.data, n) for s in seqs)

        env2 = dict(env)
        env2[b_p.name] = acc_tree
        env2[i_p.name] = idx
        env2[x_p.name] = elem
        loop = _LoopCtx(n, mask, frozenset({i_p.name, x_p.name}), ctx)
        # Decide the lowering BEFORE evaluating: evaluation mutates the
        # accumulators, so a mid-body fallback would double-merge.
        if self._body_needs_vmap(x.func.body, {i_p.name, x_p.name}):
            out = self._for_via_vmap(x, acc_tree, idx, elem, mask, env, loop)
        else:
            try:
                out = self.ev(x.func.body, env2, loop)
            except _NeedsVmap as exc:  # pre-scan missed a case: hard error
                raise WeldCompileError(
                    "loop body unexpectedly needed per-element vector "
                    "evaluation"
                ) from exc
        # seal vecbuilder ordering for this loop
        for a in loop.touched:
            if isinstance(a, _VecBuilderAcc):
                a.seal()
        return out

    def _body_needs_vmap(self, body: ir.Expr, per_elem: set) -> bool:
        """Pre-scan: does the body use its element/index as a *vector*
        (inner For / Len / Lookup / CUDF over per-element data)?"""

        def dep(e: ir.Expr, pe: set) -> bool:
            return bool(set(ir.free_vars(e)) & pe)

        def scan(e: ir.Expr, pe: set) -> bool:
            if isinstance(e, ir.For):
                if any(dep(it, pe) for it in e.iters):
                    return True
                return scan(e.builder, pe) or scan(e.func.body, pe)
            if isinstance(e, (ir.Len, ir.Lookup)):
                if dep(e.expr, pe):
                    return True
            if isinstance(e, ir.CUDF):
                if any(dep(a, pe) for a in e.args):
                    return True
            if isinstance(e, ir.Let):
                pe2 = pe | {e.name} if dep(e.value, pe) else pe
                return scan(e.value, pe) or scan(e.body, pe2)
            if isinstance(e, ir.Lambda):
                return scan(e.body, pe)
            return any(scan(c, pe) for c in e.children())

        return scan(body, set(per_elem))

    def _for_via_vmap(self, x: ir.For, acc_tree, idx, elem, mask, env, loop):
        """Un-nesting fallback: the body needs its element as a vector.
        Supports (lets*) [If(cond,] Merge(b, V) [, b)] bodies — V computed
        per element under torch.func.vmap."""
        b_p, i_p, x_p = x.func.params
        body = x.func.body
        lets: List[Tuple[str, ir.Expr]] = []
        while isinstance(body, ir.Let):
            lets.append((body.name, body.value))
            body = body.body
        cond_expr = None
        if isinstance(body, ir.If):
            merge_branch, other = body.on_true, body.on_false
            cond_expr = body.cond
            if not isinstance(merge_branch, ir.Merge):
                merge_branch, other = body.on_false, body.on_true
                cond_expr = ir.UnaryOp("not", body.cond)
            if not isinstance(merge_branch, ir.Merge):
                raise WeldCompileError(
                    "cannot lower nested loop body (no merge branch)"
                )
            body = merge_branch
        if not isinstance(body, ir.Merge):
            raise WeldCompileError(
                "unsupported nested-vector loop body; restructure with "
                "flat edge lists or weldnp 2-D ops"
            )
        target = self.ev(body.builder, dict(env, **{b_p.name: acc_tree}), None)

        def per_elem(i_s, x_s):
            env_s = dict(env)
            env_s[i_p.name] = i_s
            env_s[x_p.name] = _wrap_rows(x_s)
            for nm, val in lets:
                env_s[nm] = self.ev(val, env_s, None)
            v = self.ev(body.value, env_s, None)
            keep = (
                torch.ones((), dtype=torch.bool, device=self.device)
                if cond_expr is None
                else self.ev(cond_expr, env_s, None)
            )
            return v, keep

        vals, keeps = torch.func.vmap(per_elem)(idx, elem)
        m = keeps if cond_expr is not None else None
        if mask is not None:
            m = mask if m is None else (m & mask)
        if not isinstance(target, _Acc):
            raise WeldCompileError("nested loop must merge into a builder")
        target.add_batch(vals, m)
        if isinstance(target, _VecBuilderAcc) and target not in loop.touched:
            loop.touched.append(target)
        return acc_tree

    # -- helpers --------------------------------------------------------------

    def _depends_per_elem(self, e: ir.Expr, ctx: _LoopCtx) -> bool:
        names = set(ir.free_vars(e))
        c = ctx
        while c is not None:
            if names & c.per_elem:
                return True
            c = c.parent
        return False

    def _broadcast_elem(self, val, ctx: _LoopCtx):
        def bc(a):
            if a.ndim >= 1 and a.shape[0] == ctx.n:
                return a
            return torch.broadcast_to(a, (ctx.n,) + tuple(a.shape))

        return _tree_map(bc, val)

    def _is_builder_expr(self, e: ir.Expr, env) -> bool:
        try:
            t = ir.typeof(e, {})
            return isinstance(t, wt.BuilderType)
        except Exception:
            pass
        # structural fallback: Merge / NewBuilder / structs thereof /
        # idents bound to accumulators
        if isinstance(e, (ir.Merge, ir.NewBuilder)):
            return True
        if isinstance(e, ir.MakeStruct):
            return any(self._is_builder_expr(i, env) for i in e.items)
        if isinstance(e, ir.Let):
            return self._is_builder_expr(e.body, env)
        if isinstance(e, ir.GetField):
            return self._is_builder_expr(e.expr, env)
        if isinstance(e, ir.Ident):
            v = env.get(e.name)
            if isinstance(v, _Acc):
                return True
            if isinstance(v, tuple):
                return all(isinstance(i, _Acc) for i in v)
        return False


def _to_float(v):
    if not v.is_floating_point():
        return v.to(torch.float64)
    return v


def _first_n(data, n):
    return _tree_map(lambda a: a[:n], data)


def _wrap_rows(x_s):
    """Inside vmap, an element of vec[vec[T]] is a row — re-wrap as WVec so
    inner loops can iterate it."""

    def wrap(a):
        if a.ndim >= 1:
            return WVec(a)
        return a

    if isinstance(x_s, tuple):
        return tuple(wrap(a) for a in x_s)
    return wrap(x_s)


# ---------------------------------------------------------------------------
# Program entry
# ---------------------------------------------------------------------------


def emit_program(expr: ir.Expr, input_names: List[str],
                 input_types: Dict[str, wt.WeldType],
                 input_shapes: Dict[str, tuple],
                 device,
                 memory_limit: Optional[int] = None,
                 kernel_impl: Optional[str] = None,
                 measure: bool = False):
    """Returns fn(*tensors) evaluating the program on ``device``.

    With ``measure=True`` every ``KernelCall`` is timed on its own and
    recorded as a ``kernel.<name>`` span and a cost-ledger entry (the
    runtime's measured replay, run only under tracing)."""

    def fn(*arrays):
        env = {}
        for name, arr in zip(input_names, arrays):
            env[name] = _wrap_input(arr, input_types[name])
        em = Emitter(input_shapes, device, memory_limit,
                     kernel_impl=kernel_impl, measure=measure)
        out = em.run(expr, env)
        if em.taints:
            # the program probed dynamic-count dicts: a negative count on
            # ANY of them poisons every countable output
            bad = torch.zeros((), dtype=torch.bool, device=em.device)
            for t in em.taints:
                bad = bad | (torch.as_tensor(t, device=em.device) < 0)
            out = _apply_taint(out, bad)
        return out

    return fn


def _apply_taint(v, bad):
    """Poison the dynamic counts of ``v`` where ``bad`` (bool tensor)."""
    if isinstance(v, WVec):
        if v.count is None:
            n = torch.full((), v.capacity(), dtype=torch.int64,
                           device=bad.device)
            return WVec(v.data, torch.where(bad, torch.full_like(n, -1), n))
        c = torch.as_tensor(v.count, device=bad.device).to(torch.int64)
        return WVec(v.data, torch.where(bad, -c.abs() - 1, c))
    if isinstance(v, WDict):
        c = torch.as_tensor(v.count, device=bad.device).to(torch.int64)
        return WDict(v.keys, v.vals, torch.where(bad, -c.abs() - 1, c))
    if isinstance(v, WGroup):
        c = torch.as_tensor(v.count, device=bad.device).to(torch.int64)
        return WGroup(v.keys, v.values, v.offsets,
                      torch.where(bad, -c.abs() - 1, c))
    if isinstance(v, tuple):
        return tuple(_apply_taint(x, bad) for x in v)
    return v


def _wrap_input(arr, ty: wt.WeldType):
    if isinstance(ty, wt.Vec):
        return WVec(arr)
    return arr
