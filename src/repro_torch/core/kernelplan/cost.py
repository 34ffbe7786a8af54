"""Roofline cost model for adaptive kernel routing (planner ``mode="auto"``).

Every candidate ``KernelCall`` is priced twice — the kernel route and the
generic emitter's lowering — and routed only when the kernel is not
meaningfully worse (:data:`ROUTE_MARGIN`).  Both sides are priced on an
NVIDIA H100 from what the port runs there, not from the TPU kernels, and
by the same two terms:

* **Bytes**: what each pass moves, over the HBM rate.  On the kernel
  side, the CUDA kernel's own passes (``kernels/csrc/*.cu``) at the share
  of that rate the kernel reached on the card (``PERF.md``'s kernel
  table) and the eager operators its executor (``registry.py``) adds
  around it at the full rate; the segment kernels stream rows, keys and
  values once and multiply nothing.  On the generic side, what
  ``core/backend/torchgen.py`` emits, one eager PyTorch operator per IR
  node, and its sort-based keyed sum (``_finalize_keyed``) at the per-row
  rate the card measured for it.
* **Launches**: :data:`LAUNCH_S` for every kernel launch on the card,
  on either side: a kernel of ``csrc/*.cu`` or one of the kernels an
  eager operator runs (:func:`operator_launches`: most run one, a sort
  or a scan several).  Each hook counts its route's launches from the
  code (named beside each hook); ``tests/test_torch_cost.py`` counts the
  operators each route runs, weighs them by :func:`operator_launches`
  and holds the hooks' counts to them.

Operators that both routes evaluate alike (the staged loop bodies) are
left out of both.  Every constant below names its source; the ``PERF.md``
figures are its kernel table and section 5 as they stood when the
formulas were derived (H100 80GB HBM3, 700 W).

Once the cost ledger holds at least ``$WELD_CALIBRATE_MIN`` records of a
(kernel, dtype, size bucket) from the compile's impl on this device,
:func:`estimate` replaces the hook's kernel-side figure with their
median (:mod:`.calibrate`) and re-decides; ``CostEstimate.source`` says
which: ``"measured"`` or ``"roofline"``.  On a card the median is device
time inside the call's kernel entries, the clock of the generic side's
roofline figure; it leaves out the adapter's own operators between the
entries, which the roofline's kernel side counts, so a calibrated gate
leans, if anything, toward the kernel.

``estimate(spec, meta)`` returns a :class:`CostEstimate`; ``meta`` is
the planner-collected static description of the match.  Unknown sizes
reject conservatively: a route we cannot price is a route we do not
take (the generic lowering is always correct).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from math import ceil, log2

from ...kernels import filter_reduce as _fr
from ...kernels import hash_table as _ht
from ...kernels import segment_reduce as _sr

#: NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense rates): HBM3 at
#: 3.35 TB/s; 67 TFLOP/s FP32 and 34 TFLOP/s FP64 on the CUDA cores,
#: 67 TFLOP/s FP64 on the tensor cores.  Rates assume the card's full
#: 700 W power limit.
HW_H100 = {
    "hbm_bw": 3.35e12,          # B/s
    "peak_flops_f32": 67e12,    # FLOP/s
    "peak_flops_f64": 34e12,    # FLOP/s
    # the FP64 tensor cores (DMMA)
    "peak_flops_f64_tc": 67e12,  # FLOP/s
}

#: route when kernel_s <= jnp_s * (1 + ROUTE_MARGIN): prefer the kernel
#: on a near-tie (the reference's margin).
ROUTE_MARGIN = 0.10

#: one kernel launch's device time beyond its bytes, on either route: a
#: kernel of csrc/*.cu or one of the kernels an eager PyTorch operator
#: runs.  The floor of one launch: a trivial kernel (``zero_()`` of one
#: int32) back to back on the card, 1.78-2.00 us host-free
#: (``launch/join_build_times.py``; PERF.md kernel table, B6 and B8)
LAUNCH_S = 1.9e-6

#: kernels that one PyTorch operator runs on the card, where more than
#: one (the operator census of chip_smoke.py's gate phase; PERF.md
#: section 6): a cumsum 2 (cub's scan init and scan), a bincount 4 (two
#: reductions for its size, a fill, the histogram), a segment_reduce 8;
#: a sort 2 up to SMALL_SORT elements (a fill and one block sort), past
#: it a radix sort of 3 + its key's bytes (4 for uint8 keys, 11 for
#: int64)
CUMSUM_LAUNCHES = 2
BINCOUNT_LAUNCHES = 4
SEGMENT_REDUCE_LAUNCHES = 8
SMALL_SORT = 4096


def sort_launches(n: int, key_bytes: int = 8) -> int:
    """Kernels one sort (or argsort) of n keys runs on the card."""
    return 2 if n <= SMALL_SORT else 3 + key_bytes


def operator_launches(name: str, numel: int, itemsize: int) -> int:
    """Kernels the eager operator ``name`` (an aten overload packet's
    name) runs on the card for an input of ``numel`` elements of
    ``itemsize`` bytes."""
    if name == "sort":
        return sort_launches(numel, itemsize)
    return {"cumsum": CUMSUM_LAUNCHES, "bincount": BINCOUNT_LAUNCHES,
            "segment_reduce": SEGMENT_REDUCE_LAUNCHES}.get(name, 1)


#: a segment_reduce run: bincount for the run lengths, segment_reduce
_SEGMENTED = BINCOUNT_LAUNCHES + SEGMENT_REDUCE_LAUNCHES

#: filter_reduce.cu's share of the HBM rate: B1, bound 0.1612 ms over
#: 0.179 ms (PERF.md kernel table)
FILTER_REDUCE_SHARE = 0.1612 / 0.179

#: segment_reduce.cu's share of the HBM rate by row width D: B4 (D = 1),
#: bound 0.0601 ms over 0.320 ms; B5 (D = 2), 0.3581 ms over 1.257 ms
#: (PERF.md kernel table, host-free times).  Its owner warps spend about
#: the same warp-wide work on every 32-row tile whatever D
#: (segment_reduce.cu), so it streams well below the HBM rate.
SEGMENT_SHARE = {1: 0.0601 / 0.320, 2: 0.3581 / 1.257}

#: the generic keyed sum (torchgen ``_finalize_keyed``: two stable sorts
#: and a dozen passes) per row: 40.4 ms at 59,986,052 rows
#: (PERF.md section 5, groupby[off]')
KEYED_SUM_S_PER_ROW = 40.4e-3 / 59_986_052

#: bytes per row of ``_finalize_keyed``'s passes besides its two sorts:
#: pack 16, where 17, three gathers 72, compare and concatenate 26,
#: cumsum 17, where 17, first-row where 17, clamp 16, bincount 8,
#: segment_reduce 16 (torchgen.py, ``_finalize_keyed``)
KEYED_PASS_BYTES = 222.0

#: one stable argsort of int64 keys, per row: what is left of the keyed
#: sum's rate after its other passes, over its two sorts
ARGSORT_S_PER_ROW = (KEYED_SUM_S_PER_ROW
                     - KEYED_PASS_BYTES / HW_H100["hbm_bw"]) / 2

#: an argsort inside a kernel route, per row, priced as its passes: eight
#: 8-bit radix passes over (int64 key, int64 index) pairs, 32 bytes each
RADIX_SORT_BYTES = 8 * 32.0

#: bytes of one random read-modify-write: a 32-byte sector read and
#: written (hash_table.cu's atomicCAS probes, group_build.cu's atomics)
RANDOM_RMW_BYTES = 64.0

#: tiled_matmul.cu's and torch.matmul's shares of their peaks at 4096^3
#: (PERF.md kernel table, B10): f64 on DMMA, bound 2.0513 ms over 2.784
#: (kernel) and 2.452 ms (library); f32 on the CUDA cores (the SGEMM) over
#: 3.2128 and 2.6578 ms
MATMUL_SHARE = {
    ("kernel", 8): 2.0513 / 2.784, ("library", 8): 2.0513 / 2.452,
    ("kernel", 4): 2.0513 / 3.2128, ("library", 4): 2.0513 / 2.6578,
}
#: the same for the matvec at 4,194,304 x 64 (logreg's scoring), by
#: element size, as shares of the HBM rate: the byte bound, 0.6511 ms in
#: f64 and 0.3255 ms in f32, over the bulk row launch's 0.7365 and 0.3903
#: ms and torch.matmul's 0.7649 and 0.6114 ms (PERF.md kernel table, B10
#: matvec rows)
MATVEC_SHARE = {
    ("kernel", 8): 0.6511 / 0.7365, ("library", 8): 0.6511 / 0.7649,
    ("kernel", 4): 0.3255 / 0.3903, ("library", 4): 0.3255 / 0.6114,
}

#: group_probe's kernel (hash_probe.cu ``group_search``) per query: its
#: 8 B key read, 9 B of outputs written and, on a hit, its group's two
#: offsets (8 B); past GROUP_PROBE_STAGED keys a block stages every S-th
#: key and a query also reads a key between two splitters (a 32 B
#: sector).  Each block stages the key column (8 B a key) and the offsets
#: are read once (4 B a key).
GROUP_PROBE_QUERY_BYTES = 8 + 9 + 8
GROUP_PROBE_WINDOW_BYTES = 32
GROUP_PROBE_STAGED = 54_000

#: group_probe's host-free ms at 16,777,216 queries by key count (PERF.md
#: kernel table, B9): the column staged whole and staged every 2nd key
GROUP_PROBE_MS = {50_000: 0.1628, 65_536: 0.3520}


def _group_probe_bytes(n: int, k: int) -> float:
    window = GROUP_PROBE_WINDOW_BYTES if k > GROUP_PROBE_STAGED else 0
    return n * (GROUP_PROBE_QUERY_BYTES + window) + k * 12.0


#: group_probe's share of the HBM rate on those bytes, by whether a query
#: reads the table (k > GROUP_PROBE_STAGED)
GROUP_PROBE_SHARE = {
    k > GROUP_PROBE_STAGED:
        _group_probe_bytes(16_777_216, k) / HW_H100["hbm_bw"] / (ms * 1e-3)
    for k, ms in GROUP_PROBE_MS.items()
}

#: a vectorized binary search (the generic dict-probe lowering) issues
#: log2(K) dependent random loads per row; each achieves this many
#: streaming-pass equivalents (the reference's constant, kept with the
#: port's search kernels)
BSEARCH_PENALTY = 2.0


@dataclass(frozen=True)
class CostEstimate:
    """Priced routing decision for one matched pattern."""

    kernel_s: float
    jnp_s: float
    routed: bool
    why: str
    #: where the kernel-side figure came from: "roofline" (the hook's
    #: formula) or "measured" (the cost ledger's median, :func:`_calibrated`)
    source: str = "roofline"

    def as_stats(self) -> dict:
        return {
            "kernel_us": round(self.kernel_s * 1e6, 3),
            "jnp_us": round(self.jnp_s * 1e6, 3),
            "routed": self.routed,
            "why": self.why,
            "source": self.source,
        }


REJECT_UNKNOWN = CostEstimate(
    float("inf"), 0.0, False,
    "unknown size: cannot price the kernel route, falling back to generic",
)


def _hbm_s(nbytes: float, share: float = 1.0) -> float:
    return nbytes / (HW_H100["hbm_bw"] * share)


def _decide(kernel_s: float, jnp_s: float, why: str) -> CostEstimate:
    routed = kernel_s <= jnp_s * (1.0 + ROUTE_MARGIN)
    return CostEstimate(kernel_s, jnp_s, routed, why)


def _launches_s(count: int) -> float:
    return count * LAUNCH_S


def _segment_s(n: int, k: int, d: int, e: int) -> float:
    """One segment_sum(_vectors) call: for each window of MAX_K keys, the
    int32 ids and D values of every row streamed once at the kernel's
    share, and each block's window x D partial written and combined (the
    grid of the wrapper's ``launch_config``); two launches a window
    (seg_partial, seg_combine: segment_reduce.cu)."""
    w = _sr.windows(k)
    blocks = _sr.launch_config(n, min(k, _sr.MAX_K), d, e).blocks
    return (w * _hbm_s(n * (4 + d * e), SEGMENT_SHARE[min(d, 2)])
            + _hbm_s(2 * blocks * k * d * e) + _launches_s(2 * w))


# ---------------------------------------------------------------------------
# Per-pattern cost hooks (wired onto KernelSpec.cost in registry.py).
# Every hook takes the planner's `meta` dict and returns a CostEstimate.
# ---------------------------------------------------------------------------


def cost_filter_reduce(meta: dict) -> CostEstimate:
    """Predicated sums: filter_reduce.cu reads each value row and the
    predicate once (fr_partial, no block padding) and combines its
    per-block partials (fr_combine), two launches per four aggregates;
    the executor stacks several aggregates first, and makes an all-true
    predicate when there is none.  The generic merger selects each value
    with the predicate (``torch.where``: value and mask read, value
    written), sums it and adds the sum to the merger's identity: three
    launches an aggregate, two without a predicate."""
    n = meta.get("n")
    if not n:
        return REJECT_UNKNOWN
    aggs = max(meta.get("n_aggs", 1), 1)
    pred = bool(meta.get("has_pred", True))
    e = meta.get("elem_bytes", 8)
    k_bytes = n * (aggs * e + 1) + 2 * _fr.grid_blocks(n) * aggs * e
    k_launches = 2 * ceil(aggs / _fr.MAX_A) + (not pred)
    if aggs > 1:
        k_bytes_eager = 2 * n * aggs * e  # torch.stack of the values
        k_launches += 1
    else:
        k_bytes_eager = 0
    kernel_s = (_hbm_s(k_bytes, FILTER_REDUCE_SHARE) + _hbm_s(k_bytes_eager)
                + _launches_s(k_launches))
    if pred:
        jnp_s = _hbm_s(n * aggs * (3 * e + 1)) + _launches_s(3 * aggs)
    else:
        jnp_s = _hbm_s(n * aggs * e) + _launches_s(2 * aggs)
    return _decide(kernel_s, jnp_s, f"n={n} aggs={aggs}")


def cost_vecmerger(meta: dict) -> CostEstimate:
    """Scatter-add of (index, value) pairs into K slots: the segment
    kernel (ids cast to int32, one segment_sum, the base added: two
    eager launches) against the generic float scatter, which sorts the
    ids (torchgen ``_VecMergerAcc.finalize`` and ``_sorted_scatter_sum``:
    three masks, the index wrap, two gathers and the base added, 11
    operators, a stable argsort, bincount and segment_reduce).  Past
    MAX_K keys the kernel reads the rows once a window
    (:func:`_segment_s`)."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    jnp_s = (_hbm_s(n * (3 * 9 + 17 + 2 * 24 + 8 + (8 + e)))
             + n * ARGSORT_S_PER_ROW + _hbm_s(3 * k * e)
             + _launches_s(11 + sort_launches(n) + _SEGMENTED))
    kernel_s = (_hbm_s(n * 12 + 3 * k * e) + _launches_s(2)
                + _segment_s(n, k, 1, e))
    return _decide(kernel_s, jnp_s, f"n={n} K={k}")


def _keyed_sum_launches(n: int, nv: int = 1) -> int:
    """The generic keyed sum (torchgen ``_finalize_keyed``) over n rows and
    nv value columns: 28 one-kernel operators, two sorts of the packed
    int64 keys, a cumsum, and a segmented reduction of each value column
    with two more operators for each after the first."""
    return (28 + 2 * sort_launches(n) + CUMSUM_LAUNCHES
            + nv * _SEGMENTED + 2 * (nv - 1))


def cost_dict_group(meta: dict) -> CostEstimate:
    """Dense-int-key group-by: the executor's masks, casts and the
    stacked (value, presence) rows (about 110 bytes a row of eager
    passes, registry ``_exec_dict_group_sum``: 29 one-kernel operators
    and an argsort of K presence flags), one segment_sum_vectors call
    (D = 2) and a K-sized compaction, against the generic keyed sum at
    its measured rate."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    eager = n * (9 + 9 + 3 + 3 + 3 + 17 + 12 + (1 + 2 * e) + (1 + e)
                 + 4 * e)
    kernel_s = (_hbm_s(eager + 8 * k * e)
                + _launches_s(29 + sort_launches(k, 1))
                + _segment_s(n, k, 2, e))
    jnp_s = n * KEYED_SUM_S_PER_ROW + _launches_s(_keyed_sum_launches(n))
    return _decide(kernel_s, jnp_s, f"n={n} K={k}")


def cost_hash_build(meta: dict) -> CostEstimate:
    """Open-addressing dict build: hash_table.cu fills a power-of-two
    table of T >= 2K slots and inserts every key by ``atomicCAS`` probes
    (one random read-modify-write a key, the slot written), the executor
    renumbers the slots in ascending key order (an argsort of the table,
    priced as its radix passes, and a dozen passes over the table and
    the rows) and recovers each key column (a masked scatter-max); each
    value column is masked and summed by segment_sum.  That is 40
    one-kernel operators, the argsort of the table and the kernel's one
    launch (hash_table.cu) at one key and one value column, and four
    operators more for each further value column.  The generic lowering
    is the keyed sum at its measured rate."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    nv = max(meta.get("n_vals", 1), 1)
    nk = max(meta.get("n_keys", 1), 1)
    t = _ht.table_size(k)
    table = t * (8 + 17 + RADIX_SORT_BYTES + 12 + 8)
    rows = n * (8 + 4 + RANDOM_RMW_BYTES + 16 + 2 * 20 + 12)
    rows += n * nk * (8 + RANDOM_RMW_BYTES) + n * (nk - 1) * 16
    kernel_s = _hbm_s(table + rows) + _launches_s(
        40 + sort_launches(t) + 1 + 4 * (nv - 1))
    for _ in range(nv):
        kernel_s += _hbm_s(n * (1 + 2 * e))  # the masked value column
        kernel_s += _segment_s(n, k, 1, e)
    jnp_s = n * KEYED_SUM_S_PER_ROW + _launches_s(_keyed_sum_launches(n, nv))
    return _decide(kernel_s, jnp_s,
                   f"n={n} K={k} keys={nk} vals={nv} table={t}")


def _search_loads(k: int) -> int:
    """Dependent loads of one binary search over k sorted keys."""
    return max(int(ceil(log2(max(k, 2)))), 1)


def cost_hash_probe(meta: dict) -> CostEstimate:
    """Binary-search membership kernel vs. the generic vectorized binary
    search.  The port's kernel (hash_probe.cu) searches: ceil(log2 K)
    dependent loads per query, served from L2 (the table is at most
    512 KiB), charged here as 8 B each, ONCE for every output column of
    a fused probe.  The generic lowering pays the same search in
    separate passes (the BSEARCH_PENALTY) plus the staged table.

    Launches (registry ``_exec_hash_probe_fused`` against torchgen's
    ``_dict_find`` and the generic loop's columns), for p probe-side and
    g gathered (build-side) columns: the kernel route 13 + p + 4 g
    one-kernel operators, the kernel's one and one front-pack (an
    argsort of n flags); the generic route 15 + 9 p + 20 g + g^2
    operators and 1 + 2 g front-packs: each gathered column searches
    again and gathers every build column."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    cols = max(meta.get("cols", 1), 1)
    gathers = min(meta.get("gathers", 0), cols)
    probe_cols = cols - gathers
    e = meta.get("elem_bytes", 8)
    lgk = _search_loads(k)
    k_bytes = n * (8 + 4 + 1 + cols * e) + k * 8 + n * 8 * lgk
    pack = sort_launches(n, 1)
    kernel_s = _hbm_s(k_bytes) + _launches_s(
        13 + probe_cols + 4 * gathers + 1 + pack)
    jnp_s = (_hbm_s(n * 8 * lgk * BSEARCH_PENALTY + n * cols * e)
             + _launches_s(15 + 9 * probe_cols + 20 * gathers
                           + gathers * gathers + (1 + 2 * gathers) * pack))
    return _decide(kernel_s, jnp_s, f"n={n} K={k} cols={cols}")


def cost_group_build(meta: dict) -> CostEstimate:
    """CSR group build (hash_to_slot, slot_hist, the payload ordering
    sort) vs. the generic keyed finalize at its measured rate.  Both
    routes order the payload rows; the kernel replaces the keyed sort
    and segment machinery with the hash and histogram atomics and one
    ordering sort of the rows.  Launches: the kernel route 40 one-kernel
    operators (registry ``_exec_group_build``, group_build.py,
    compact_slots), the table's argsort, a cumsum, the payload's int32
    argsort and its two kernels (hash_table.cu, group_build.cu: one
    launch each);
    the generic route 30 operators, two sorts, two cumsums and a
    bincount (``_finalize_keyed`` for a group)."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    nk = max(meta.get("n_keys", 1), 1)
    # slot probes + histogram atomics + the CSR payload ordering sort +
    # table/offsets traffic; extra staged key columns cost one i64 pass
    k_bytes = (n * (8 + 4 + RANDOM_RMW_BYTES) + n * RANDOM_RMW_BYTES
               + 4 * k * 8 + n * (nk - 1) * 8 + n * e)
    kernel_s = (_hbm_s(k_bytes) + n * ARGSORT_S_PER_ROW
                + _launches_s(40 + sort_launches(_ht.table_size(k))
                              + CUMSUM_LAUNCHES + sort_launches(n, 4) + 2))
    jnp_s = n * KEYED_SUM_S_PER_ROW + _launches_s(
        30 + 2 * sort_launches(n) + 2 * CUMSUM_LAUNCHES + BINCOUNT_LAUNCHES)
    return _decide(kernel_s, jnp_s, f"n={n} K={k} keys={nk}")


def _group_probe_s(n: int, k: int) -> float:
    """One group_probe launch: its bytes (:func:`_group_probe_bytes`) at
    the share of the HBM rate the kernel reached on the card."""
    return _hbm_s(_group_probe_bytes(n, k),
                  GROUP_PROBE_SHARE[k > GROUP_PROBE_STAGED])


def cost_group_probe(meta: dict) -> CostEstimate:
    """m:n fan-out probe: the fused membership + match-count kernel
    (:func:`_group_probe_s`: its traffic at its measured share of the HBM
    rate) vs. the generic vectorized binary search.
    BOTH routes then pay the shared two-phase expansion (exclusive scan
    + repeat/gather into the static expansion buffer), priced by the
    expansion factor ``out``/``n`` the planner lifts off the vecbuilder
    size hints.  Launches: the membership takes ten on the kernel route
    (``_probe_membership``, the kernel's one among them) against 15 on
    the generic one (``_group_find``); the rest both routes share."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    out = meta.get("out") or n
    cols = max(meta.get("cols", 1), 1)
    e = meta.get("elem_bytes", 8)
    lgk = _search_loads(k)
    # scan + out-row binary search + per-column repeated/gathered output
    expand_bytes = n * 8.0 + out * (8 + cols * e)
    kernel_s = (_group_probe_s(n, k) + _hbm_s(expand_bytes)
                + _launches_s(10))
    jnp_s = (_hbm_s(n * 8 * lgk * BSEARCH_PENALTY + expand_bytes)
             + _launches_s(15))
    return _decide(kernel_s, jnp_s,
                   f"n={n} K={k} cols={cols} out={out}")


def cost_matmul(meta: dict) -> CostEstimate:
    """tiled_matmul.cu against one ``torch.matmul``, each at the share of
    its peak it reached on the card: f64 on the FP64 tensor cores (DMMA)
    on both routes, f32 on the CUDA cores; a matvec (n = 1) is bound by
    bytes on both, priced at the shares of the HBM rate its element size
    reached.  One launch on either route.  The f64 4096^3 product
    prices the library ahead, as the card measured it."""
    dims = meta.get("dims")
    if not dims or any(d is None for d in dims):
        return REJECT_UNKNOWN
    m, k, n = dims
    e = meta.get("elem_bytes", 8)
    nbytes = (m * k + k * n + m * n) * e
    kind = 8 if e >= 8 else 4
    if n == 1:
        kernel_s = _hbm_s(nbytes, MATVEC_SHARE["kernel", kind]) + LAUNCH_S
        jnp_s = _hbm_s(nbytes, MATVEC_SHARE["library", kind]) + LAUNCH_S
        return _decide(kernel_s, jnp_s, f"dims={m}x{k}x{n}")
    flops = 2.0 * m * k * n
    peak = HW_H100["peak_flops_f64_tc" if e >= 8 else "peak_flops_f32"]

    def at(route):
        return max(_hbm_s(nbytes), flops / (peak * MATMUL_SHARE[route, kind]))

    kernel_s = at("kernel") + LAUNCH_S
    return _decide(kernel_s, at("library") + LAUNCH_S, f"dims={m}x{k}x{n}")


def cost_map_chain(meta: dict) -> CostEstimate:
    """Fused elementwise chain: the generated kernel reads each column
    once and writes the result once, computing each shared subtree once
    (``kernel_ops``); the generic emitter runs one eager operator per IR
    node of the inlined tree (``ops``), each reading its (up to two)
    operands and writing a materialized intermediate: one launch against
    ``ops``."""
    n = meta.get("n")
    if not n:
        return REJECT_UNKNOWN
    cols = max(meta.get("cols", 1), 1)
    ops = max(meta.get("ops", 2), 1)
    e = meta.get("elem_bytes", 8)
    kernel_s = _hbm_s(n * (cols + 1) * e) + LAUNCH_S
    jnp_s = _hbm_s(n * (cols + 1) * e + ops * 3 * n * e) + _launches_s(ops)
    return _decide(kernel_s, jnp_s, f"n={n} cols={cols} ops={ops}")


def _calibrated(spec, meta: dict, est: CostEstimate) -> CostEstimate:
    """Overlay the cost ledger's measured median over the roofline
    kernel-side estimate (see :mod:`.calibrate`): the median of the
    records of ``meta["impl"]`` (the planner's) on the default device,
    or of the records that name neither where ``meta`` has no impl.  The gate re-decides
    routing from the measured figure; ``why`` gains ``source=measured``
    vs ``source=roofline`` so ``Query.explain()`` shows which world the
    decision came from.  Best-effort: any calibration failure leaves the
    roofline estimate untouched."""
    kernel = meta.get("kernel") or getattr(spec, "name", None)
    dtype = meta.get("dtype")
    n = meta.get("n")
    impl = meta.get("impl")
    hit = None
    try:
        if kernel and dtype is not None and n:
            from . import calibrate
            from .quarantine import device_name

            device = device_name() if impl is not None else None
            hit = calibrate.measured_ns(str(kernel), str(dtype), int(n),
                                        impl=impl, device=device)
    except Exception:
        hit = None
    if hit is None:
        if " source=" in est.why:
            return est
        return replace(est, why=f"{est.why} source=roofline")
    med_ns, calls = hit
    kernel_s = med_ns / 1e9
    routed = kernel_s <= est.jnp_s * (1.0 + ROUTE_MARGIN)
    return CostEstimate(
        kernel_s, est.jnp_s, routed,
        f"{est.why} source=measured calls={calls} "
        f"median={med_ns / 1e3:.1f}us",
        source="measured",
    )


def estimate(spec, meta: dict) -> CostEstimate:
    """Price one candidate through the spec's cost hook, then overlay
    any ledger-measured median of ``meta["impl"]`` on the default device
    (:func:`_calibrated`).  Specs without a hook route unconditionally
    (the pre-cost-model behavior)."""
    hook = getattr(spec, "cost", None)
    if hook is None:
        return CostEstimate(0.0, 0.0, True, "no cost hook: always route")
    return _calibrated(spec, meta, hook(meta))
