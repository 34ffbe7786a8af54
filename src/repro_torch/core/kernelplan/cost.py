"""Roofline cost model for adaptive kernel routing (planner ``mode="auto"``).

The copy of the JAX package's cost model, priced with an H100 table
instead of the TPU v5e one.  Every candidate ``KernelCall`` is priced
twice — kernel route vs. the generic emitter's lowering — and routed
only when the kernel is not meaningfully worse.

Each estimate is ``max(bytes/HBM_bw, flops/peak)`` plus route-specific
overheads (padding, launch, scratch, structure factors).  The overhead
constants and the per-pattern formulas are the reference's, calibrated
on the reference's own ablation; they stay as they are until they are
measured on the card.  The formulas still price the TPU kernels'
shapes (block padding, one-hot matmul FLOPs for the segment routes), so
an "auto" decision here is the reference's decision under H100 rates,
not a measured one.  The join probes are the exception: their kernels
search where the TPU's compared a one-hot tile, and are priced as
searches.  So are the array routes: ``matmul``/``matvec`` against one
``torch.matmul`` (cuBLAS, on the FP64 tensor cores; the kernel's f64
launch now runs there too but is still priced at the CUDA-core rate,
until ROADMAP A4 re-derives the formulas), and the map chain against
one eager PyTorch operator per IR node, each intermediate materialized.
The ledger calibration and the autotuner wait for their slices.

``estimate(spec, meta)`` returns a :class:`CostEstimate`; ``meta`` is
the planner-collected static description of the match.  Unknown sizes
reject conservatively: a route we cannot price is a route we do not
take (the generic lowering is always correct).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import ceil, log2

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
#: on a near-tie (it strictly reduces HBM traffic on the real target).
ROUTE_MARGIN = 0.10

#: fixed per-launch overhead of a Pallas dispatch (grid setup + the
#: kernel's own jit boundary) that the inlined jnp lowering never pays.
LAUNCH_OVERHEAD_S = 1e-6

#: generic-emitter accumulator machinery (mask broadcast, select chain,
#: finalize combine) as a multiplicative tax on the jnp reduce lowering.
REDUCE_STRUCTURE_TAX = 1.15

#: random-access scatter stores achieve a fraction of streaming HBM
#: bandwidth; .at[].add is modelled as this many streaming passes.
SCATTER_PENALTY = 4.0

#: sort-based keyed aggregation (the generic dictmerger lowering) moves
#: roughly key+val+packed rows per comparison level; this scales the
#: n*log2(n) byte volume.
SORT_BYTES_PER_ROW = 24.0

#: the segment kernels' accumulator bound (segment_reduce MAX_K): keyed
#: accumulation beyond it serves the plain scatter instead.
SEGMENT_TILE_K = 4096

#: a vectorized binary search (the generic dict-probe lowering) issues
#: log2(K) dependent random loads per row; each achieves this many
#: streaming-pass equivalents (gentler than full scatter: the upper tree
#: levels stay cache resident).
BSEARCH_PENALTY = 2.0


@dataclass(frozen=True)
class CostEstimate:
    """Priced routing decision for one matched pattern."""

    kernel_s: float
    jnp_s: float
    routed: bool
    why: str
    #: where the kernel-side figure came from (always "roofline" until
    #: the ledger calibration is ported).
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
    "unknown size: cannot price the kernel route, falling back to jnp",
)


def _roofline_s(bytes_moved: float, flops: float, elem_bytes: int) -> float:
    peak = HW_H100["peak_flops_f64" if elem_bytes >= 8 else "peak_flops_f32"]
    return max(bytes_moved / HW_H100["hbm_bw"], flops / peak)


def _pad(n: int, block: int) -> int:
    return int(ceil(max(n, 1) / block)) * block


def _decide(kernel_s: float, jnp_s: float, why: str) -> CostEstimate:
    routed = kernel_s <= jnp_s * (1.0 + ROUTE_MARGIN)
    return CostEstimate(kernel_s, jnp_s, routed, why)


# ---------------------------------------------------------------------------
# Per-pattern cost hooks (wired onto KernelSpec.cost in registry.py).
# Every hook takes the planner's `meta` dict and returns a CostEstimate.
# ---------------------------------------------------------------------------


def cost_filter_reduce(meta: dict) -> CostEstimate:
    """Predicated multi-aggregate sum: one shared pass vs. the generic
    merger accumulators.  Gate is padding + launch vs. structure tax."""
    n = meta.get("n")
    if not n:
        return REJECT_UNKNOWN
    cols = max(meta.get("cols", 1), 1)
    ops = meta.get("ops", 1)
    aggs = max(meta.get("n_aggs", 1), 1)
    e = meta.get("elem_bytes", 8)
    block = meta.get("block", 8 * 1024)
    np_ = _pad(n, block)
    # kernel: every column + the predicate mask stream once, padded;
    # the multi-agg variant shares the mask/column loads across outputs.
    k_bytes = np_ * (cols * e + 1) + aggs * e
    k_flops = np_ * (ops + aggs)
    kernel_s = _roofline_s(k_bytes, k_flops, e) + LAUNCH_OVERHEAD_S
    j_bytes = (n * (cols * e + 1)) * REDUCE_STRUCTURE_TAX
    j_flops = n * (ops + aggs)
    jnp_s = _roofline_s(j_bytes, j_flops, e)
    return _decide(kernel_s, jnp_s,
                   f"n={n} cols={cols} aggs={aggs} pad={np_ - n}")


def cost_vecmerger(meta: dict) -> CostEstimate:
    """Scatter-add vs. one-hot MXU segment sum.  The kernel's 2*n*K
    matmul FLOPs cross the scatter's memory bound as K grows; beyond the
    VMEM tile bound the 'kernel' route degenerates to the same scatter
    plus overhead, so it can never win there."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    block = meta.get("block", 512)
    max_k = meta.get("max_k")
    np_ = _pad(n, block)
    j_bytes = n * (8 + 2 * e) * SCATTER_PENALTY + k * e
    jnp_s = _roofline_s(j_bytes, n, e)
    if max_k is not None and k > max_k:
        # kops falls back to the ref segment-sum (itself a scatter):
        # strictly the jnp cost plus dispatch — never routable.
        return _decide(jnp_s * 1.2 + LAUNCH_OVERHEAD_S, jnp_s,
                       f"n={n} K={k} exceeds VMEM tile bound {max_k}")
    k_bytes = np_ * (4 + e) + k * e
    k_flops = 2.0 * np_ * k
    kernel_s = _roofline_s(k_bytes, k_flops, e) + LAUNCH_OVERHEAD_S
    return _decide(kernel_s, jnp_s, f"n={n} K={k} pad={np_ - n}")


def cost_dict_group(meta: dict) -> CostEstimate:
    """Dense-int-key group-by: one-hot segment sums + compaction vs. the
    generic sort-based dictmerger lowering."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    block = meta.get("block", 256)
    np_ = _pad(n, block)
    # kernel: stacked (vals, ones) scratch + one-hot matmul + K-compaction
    k_bytes = np_ * (4 + 2 * e) + 2 * n * e + 4 * k * e
    k_flops = 2.0 * np_ * k * 2 + k * max(log2(max(k, 2)), 1.0)
    kernel_s = _roofline_s(k_bytes, k_flops, e) + 2 * LAUNCH_OVERHEAD_S
    j_bytes = n * SORT_BYTES_PER_ROW * max(log2(max(n, 2)), 1.0)
    jnp_s = _roofline_s(j_bytes, n, e)
    return _decide(kernel_s, jnp_s, f"n={n} K={k} pad={np_ - n}")


def cost_hash_build(meta: dict) -> CostEstimate:
    """Open-addressing dict build (hash-to-slot + segment accumulation +
    compaction) vs. the generic sort-based dictmerger lowering.  The
    insert is random-access bound; the sort pays n*log2(n) passes — the
    kernel wins once n clears the launch overheads."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    nv = max(meta.get("n_vals", 1), 1)
    nk = max(meta.get("n_keys", 1), 1)
    block = meta.get("block", 256)
    np_ = _pad(n, block)
    # slot probes (key + slot traffic, random access) + table init/sort
    # + per-column staged values through the segment kernels;
    # multi-column keys stream one extra staged i64 column each beyond
    # the packed stream already charged
    k_bytes = (np_ * (8 + 4) * SCATTER_PENALTY + 4 * k * 8 + n * nv * e
               + n * (nk - 1) * 8)
    if k <= SEGMENT_TILE_K:
        k_flops = 2.0 * np_ * k * nv  # the reference's one-hot pricing
    else:
        k_flops = float(n)  # kops serves the plain scatter instead
        k_bytes += n * nv * e * SCATTER_PENALTY
    kernel_s = _roofline_s(k_bytes, k_flops, e) + 2 * LAUNCH_OVERHEAD_S
    j_bytes = n * SORT_BYTES_PER_ROW * max(log2(max(n, 2)), 1.0)
    jnp_s = _roofline_s(j_bytes, n, e)
    return _decide(kernel_s, jnp_s,
                   f"n={n} K={k} keys={nk} vals={nv} pad={np_ - n}")


def _search_loads(k: int) -> int:
    """Dependent loads of one binary search over k sorted keys."""
    return max(int(ceil(log2(max(k, 2)))), 1)


def cost_hash_probe(meta: dict) -> CostEstimate:
    """Binary-search membership kernel vs. the generic vectorized binary
    search.  The TPU kernel compared each query against the whole key
    tile (n*K compares); the port's kernel searches instead: ceil(log2
    K) dependent loads per query, served from L2 (the table is at most
    512 KiB), charged here as 8 B each, ONCE for every output column of
    a fused probe.  The generic lowering pays the same search in
    separate passes (the BSEARCH_PENALTY) plus the staged table."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    cols = max(meta.get("cols", 1), 1)
    e = meta.get("elem_bytes", 8)
    lgk = _search_loads(k)
    # one search per query + per-column gather/compaction traffic
    k_bytes = n * (8 + 4 + 1 + cols * e) + k * 8 + n * 8 * lgk
    kernel_s = _roofline_s(k_bytes, n * lgk, e) + LAUNCH_OVERHEAD_S
    j_bytes = n * 8 * lgk * BSEARCH_PENALTY + n * cols * e
    jnp_s = _roofline_s(j_bytes, n * lgk, e)
    return _decide(kernel_s, jnp_s, f"n={n} K={k} cols={cols}")


def cost_group_build(meta: dict) -> CostEstimate:
    """CSR group build (hash-to-slot + slot histogram + payload
    ordering sort) vs. the generic sort-based groupbuilder finalize.
    Both routes order the payload rows; the kernel replaces the full
    keyed sort + segment machinery with the hash/histogram atomics
    (random access) and a narrower ordering sort."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    e = meta.get("elem_bytes", 8)
    nk = max(meta.get("n_keys", 1), 1)
    block = meta.get("block", 256)
    np_ = _pad(n, block)
    lgn = max(log2(max(n, 2)), 1.0)
    # slot probes + histogram atomics + the CSR payload ordering sort +
    # table/offsets traffic; extra staged key columns beyond the packed
    # stream cost one i64 pass each
    k_bytes = (np_ * (8 + 4) * SCATTER_PENALTY + n * 4 * SCATTER_PENALTY
               + n * 8 * lgn + 4 * k * 8 + n * (nk - 1) * 8 + n * e)
    kernel_s = _roofline_s(k_bytes, float(n), e) + 2 * LAUNCH_OVERHEAD_S
    j_bytes = n * SORT_BYTES_PER_ROW * lgn
    jnp_s = _roofline_s(j_bytes, n, e)
    return _decide(kernel_s, jnp_s, f"n={n} K={k} keys={nk}")


def cost_group_probe(meta: dict) -> CostEstimate:
    """m:n fan-out probe: the fused binary-search membership +
    match-count kernel (priced as :func:`cost_hash_probe`'s search, plus
    the 4 B size per query) vs. the generic vectorized binary search.
    BOTH routes then pay the shared two-phase expansion (exclusive scan
    + repeat/gather into the static expansion buffer), priced by the
    expansion factor ``out``/``n`` the planner lifts off the vecbuilder
    size hints."""
    n, k = meta.get("n"), meta.get("k")
    if not n or not k:
        return REJECT_UNKNOWN
    out = meta.get("out") or n
    cols = max(meta.get("cols", 1), 1)
    e = meta.get("elem_bytes", 8)
    lgk = _search_loads(k)
    # scan + out-row binary search + per-column repeated/gathered output
    expand_bytes = n * 8.0 + out * (8 + cols * e)
    k_bytes = n * (8 + 4 + 1 + 4) + k * 8 + n * 8 * lgk + expand_bytes
    kernel_s = _roofline_s(k_bytes, n * lgk, e) + LAUNCH_OVERHEAD_S
    j_bytes = n * 8 * lgk * BSEARCH_PENALTY + expand_bytes
    jnp_s = _roofline_s(j_bytes, n * lgk, e)
    return _decide(kernel_s, jnp_s,
                   f"n={n} K={k} cols={cols} out={out}")


def cost_matmul(meta: dict) -> CostEstimate:
    """Tiled matmul kernel (operand-dtype accumulation, no padding),
    priced at the CUDA-core rate, vs. one ``torch.matmul``: the same
    bytes, but the library runs f64 on the FP64 tensor cores at twice
    that rate, so a large f64 product prices the generic route ahead
    (the kernel's f64 launch is on DMMA now, and still slower than the
    library's: ROADMAP F2, A4); a matvec is bound by bytes on both
    routes and the kernel pays its launch."""
    dims = meta.get("dims")
    if not dims or any(d is None for d in dims):
        return REJECT_UNKNOWN
    m, k, n = dims
    e = meta.get("elem_bytes", 8)
    nbytes = (m * k + k * n + m * n) * e
    flops = 2.0 * m * k * n
    kernel_s = _roofline_s(nbytes, flops, e) + LAUNCH_OVERHEAD_S
    lib_peak = HW_H100["peak_flops_f64_tc" if e >= 8 else "peak_flops_f32"]
    jnp_s = max(nbytes / HW_H100["hbm_bw"], flops / lib_peak)
    return _decide(kernel_s, jnp_s, f"dims={m}x{k}x{n}")


def cost_map_chain(meta: dict) -> CostEstimate:
    """Fused elementwise chain: the generated kernel reads each column
    once, writes the result once and computes each shared subtree once
    (``kernel_ops``); the generic emitter runs one eager operator per IR
    node of the inlined tree (``ops``), each reading its (up to two)
    operands and writing a materialized intermediate, and pays a launch
    per node."""
    n = meta.get("n")
    if not n:
        return REJECT_UNKNOWN
    cols = max(meta.get("cols", 1), 1)
    ops = max(meta.get("ops", 2), 1)
    k_ops = max(meta.get("kernel_ops", ops), 1)
    e = meta.get("elem_bytes", 8)
    kernel_s = (_roofline_s(n * (cols + 1) * e, n * k_ops, e)
                + LAUNCH_OVERHEAD_S)
    j_bytes = n * (cols + 1) * e + ops * 3 * n * e
    jnp_s = _roofline_s(j_bytes, n * ops, e) + ops * LAUNCH_OVERHEAD_S
    return _decide(kernel_s, jnp_s, f"n={n} cols={cols} ops={ops}")


def estimate(spec, meta: dict) -> CostEstimate:
    """Price one candidate through the spec's cost hook.  Specs without
    a hook route unconditionally (the pre-cost-model behavior)."""
    hook = getattr(spec, "cost", None)
    if hook is None:
        return CostEstimate(0.0, 0.0, True, "no cost hook: always route")
    return hook(meta)
