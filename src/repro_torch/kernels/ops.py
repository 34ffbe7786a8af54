"""Public entries of the port's kernel library (the counterparts of the
JAX package's ``kernels/ops.py`` for the ported kernels).

``impl`` is ``"cuda"`` (the hand-written kernel), ``"ref"`` (the plain
PyTorch version) or ``None``.  The tensors' device decides: a CUDA
tensor takes the kernel, a CPU tensor the plain version, and asking for
the other one raises — ``impl="ref"`` never runs on the card, and no
kernel failure is ever retried with the plain version.  Every entry is
``_count.clocked``: the measured replay reads the card's time inside
the entries (``_count.device_clock``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed import mesh_ops
from . import _count
from . import filter_reduce as _fr
from . import flash_attention as _fa
from . import fused_adamw as _aw
from . import group_build as _gb
from . import hash_probe as _hp
from . import hash_table as _ht
from . import map_chain as _mc
from . import segment_reduce as _sr
from . import tiled_matmul as _tm

IMPLS = ("cuda", "ref")

#: every counted wrapper, by name (chip_smoke and the tests read these)
WRAPPERS = {
    "filter_reduce_sum": _fr.filter_reduce_sum,
    "filter_reduce_sum_multi": _fr.filter_reduce_sum_multi,
    "segment_sum": _sr.segment_sum,
    "segment_sum_vectors": _sr.segment_sum_vectors,
    "hash_to_slot": _ht.hash_to_slot,
    "dict_probe": _hp.dict_probe,
    "group_probe": _hp.group_probe,
    "slot_hist": _gb.slot_hist,
    "map_elementwise": _mc.map_elementwise,
    "tiled_matmul": _tm.tiled_matmul,
    "filter_reduce_q6": _fr.filter_reduce_q6,
    "flash_attention": _fa.flash_attention,
    "fused_adamw": _aw.adamw_update,
}


def _check_impl(impl: Optional[str], t: torch.Tensor) -> None:
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"kernel impl must be one of {IMPLS} or None, "
                         f"got {impl!r}")
    want = "cuda" if t.device.type == "cuda" else "ref"
    if impl is not None and impl != want:
        raise ValueError(
            f"kernel_impl={impl!r} cannot serve a tensor on {t.device}: CUDA "
            f"tensors take the CUDA kernels, CPU tensors the plain versions")


def counts() -> dict:
    """{wrapper name: (launches, plain_calls)}."""
    with _count._lock:
        return {k: (f.launches, f.plain_calls) for k, f in WRAPPERS.items()}


def reset_counts() -> None:
    """Zero every wrapper's counters (flash_attention's
    ``backward_calls`` and ``launches_sm90`` too)."""
    _count.reset(WRAPPERS.values())
    _count.reset([_fa.flash_attention], ("backward_calls", "launches_sm90"))


@_count.clocked
def filter_reduce_sum(x, pred, impl: Optional[str] = None,
                      max_blocks: Optional[int] = None):
    """sum(x[pred]); ``max_blocks`` caps the kernel's grid (the
    autotuner's parameter; None = ``filter_reduce.MAX_BLOCKS``)."""
    _check_impl(impl, x)
    return _fr.filter_reduce_sum(x, pred, max_blocks=max_blocks)


@_count.clocked
def filter_reduce_sum_multi(vals, pred, impl: Optional[str] = None,
                            max_blocks: Optional[int] = None):
    """Predicated row sums: vals (A, n) + pred (n,) -> (A,) in ONE pass."""
    _check_impl(impl, vals)
    return _fr.filter_reduce_sum_multi(vals, pred, max_blocks=max_blocks)


@_count.clocked
def filter_reduce_q6(cols, lo, hi, val, impl: Optional[str] = None):
    """The hand-fused TPC-H Q6: sum(val where all(lo_k <= cols[k] < hi_k))
    in one pass; cols (K, n), lo/hi (K,), val (n,)."""
    _check_impl(impl, val)
    return _fr.filter_reduce_q6(cols, lo, hi, val)


@_count.clocked
def segment_sum(seg_ids, vals, num_segments: int,
                impl: Optional[str] = None, max_blocks: Optional[int] = None):
    """Keyed sums; ``max_blocks`` caps the kernel's grid (the
    autotuner's parameter; None = ``segment_reduce.MAX_BLOCKS``)."""
    _check_impl(impl, vals)
    return _sr.segment_sum(seg_ids, vals, num_segments,
                           max_blocks=max_blocks)


@_count.clocked
def segment_sum_vectors(seg_ids, vals, num_segments: int,
                        impl: Optional[str] = None,
                        max_blocks: Optional[int] = None):
    _check_impl(impl, vals)
    return _sr.segment_sum_vectors(seg_ids, vals, num_segments,
                                   max_blocks=max_blocks)


# -- dict build / probe (hash-join route) --------------------------------------


@_count.clocked
def hash_to_slot(keys, cap_table: int, impl: Optional[str] = None):
    """Open-addressing slot assignment for int64 (packed) keys; rows equal
    to ``hash_table.EMPTY`` park at slot ``cap_table``.  Returns
    ``(slots, table_keys, used)`` — see kernels/hash_table.py."""
    _check_impl(impl, keys)
    return _ht.hash_to_slot(keys, cap_table)


@_count.clocked
def dict_probe(table_keys, count, queries, impl: Optional[str] = None):
    """(pos, found) per query against a sorted-front-packed dict key
    column; ``pos`` is zeroed where not found."""
    _check_impl(impl, queries)
    return _hp.dict_probe(table_keys, count, queries)


# -- group build / probe (m:n hash-join route) ---------------------------------


@_count.clocked
def group_build(keys, capacity: int, impl: Optional[str] = None):
    """CSR group build over int64 (packed) keys: rows with equal keys share
    an ascending-key compact slot.  Returns ``(cslots, offsets, used)`` —
    see kernels/group_build.py for the contract."""
    _check_impl(impl, keys)
    return _gb.group_build(keys, capacity)


@_count.clocked
def group_probe(table_keys, offsets, count, queries,
                impl: Optional[str] = None):
    """(pos, found, sizes) per query against a groupbuilder's sorted key
    column + CSR offsets — membership and the m:n expansion's
    match-count pass in one launch; ``sizes`` is 0 where not found."""
    _check_impl(impl, queries)
    return _hp.group_probe(table_keys, offsets, count, queries)


# -- tiled matmul (linalg.matmul / linalg.matvec) --------------------------------


@_count.clocked
def matmul(a, b, impl: Optional[str] = None):
    """C = A @ B for 2-D f32/f64 operands of one dtype, accumulated in that
    dtype; a (k, 1) right-hand side is the matvec launch shape."""
    _check_impl(impl, a)
    return _tm.tiled_matmul(a, b)


# -- fused elementwise map chain -------------------------------------------------


@_count.clocked
def map_elementwise(fn, arrays, impl: Optional[str] = None, lam=None,
                    env=None, max_blocks: Optional[int] = None):
    """Apply a staged elementwise body to 1-D columns in one fused pass.
    ``fn`` is the body as a whole-column torch closure (the plain
    version), ``lam`` the same body as IR (the CUDA route generates its
    kernel from it) and ``env`` binds the body's free scalars;
    ``max_blocks`` caps the kernel's grid (None = ``map_chain.MAX_BLOCKS``)."""
    _check_impl(impl, arrays[0])
    return _mc.map_elementwise(fn, arrays, lam=lam, env=env,
                               max_blocks=max_blocks)


# -- attention (the LM stack's prefill) ------------------------------------------


@_count.clocked
def attention(q, k, v, causal: bool = True, group: int = 1, scale=None,
              chunk: int = 1024, impl: Optional[str] = None):
    """Online-softmax attention: q (H, Sq, D), k/v (H // group, Skv, D),
    or the same with a leading batch dimension; the causal mask is
    aligned to the last Sq kv positions.  ``chunk`` is the plain
    version's kv chunk.  DTensors (on a mesh) are attended on each rank's
    local tensors (``distributed.mesh_ops.attention``): no DTensor reaches
    the kernel."""
    def local(q, k, v):
        _check_impl(impl, q)
        return _fa.flash_attention(q, k, v, causal=causal, group=group,
                                   scale=scale, chunk=chunk)

    if mesh_ops.is_dtensor(q):
        return mesh_ops.attention(local, q, k, v)
    return local(q, k, v)


# -- fused AdamW (the LM stack's optimizer step) ---------------------------------


@_count.clocked
def adamw_update(p, g, m, v, lr, step, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, wd: float = 0.01,
                 impl: Optional[str] = None):
    """One fused AdamW step over one parameter tensor: p (bf16 or f32), g
    (bf16 or f32), m and v (f32) are updated in place and returned."""
    _check_impl(impl, p)
    return _aw.adamw_update(p, g, m, v, lr, step, b1=b1, b2=b2, eps=eps,
                            wd=wd)
