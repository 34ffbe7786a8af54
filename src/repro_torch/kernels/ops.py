"""Public entries of the port's kernel library (the counterparts of the
JAX package's ``kernels/ops.py`` for the ported kernels).

``impl`` is ``"cuda"`` (the hand-written kernel), ``"ref"`` (the plain
PyTorch version) or ``None``.  The tensors' device decides: a CUDA
tensor takes the kernel, a CPU tensor the plain version, and asking for
the other one raises — ``impl="ref"`` never runs on the card, and no
kernel failure is ever retried with the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import filter_reduce as _fr
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
    return {k: (f.launches, f.plain_calls) for k, f in WRAPPERS.items()}


def reset_counts() -> None:
    for f in WRAPPERS.values():
        f.launches = 0
        f.plain_calls = 0


def filter_reduce_sum(x, pred, impl: Optional[str] = None):
    _check_impl(impl, x)
    return _fr.filter_reduce_sum(x, pred)


def filter_reduce_sum_multi(vals, pred, impl: Optional[str] = None):
    """Predicated row sums: vals (A, n) + pred (n,) -> (A,) in ONE pass."""
    _check_impl(impl, vals)
    return _fr.filter_reduce_sum_multi(vals, pred)


def filter_reduce_q6(cols, lo, hi, val, impl: Optional[str] = None):
    """The hand-fused TPC-H Q6: sum(val where all(lo_k <= cols[k] < hi_k))
    in one pass; cols (K, n), lo/hi (K,), val (n,)."""
    _check_impl(impl, val)
    return _fr.filter_reduce_q6(cols, lo, hi, val)


def segment_sum(seg_ids, vals, num_segments: int,
                impl: Optional[str] = None):
    _check_impl(impl, vals)
    return _sr.segment_sum(seg_ids, vals, num_segments)


def segment_sum_vectors(seg_ids, vals, num_segments: int,
                        impl: Optional[str] = None):
    _check_impl(impl, vals)
    return _sr.segment_sum_vectors(seg_ids, vals, num_segments)


# -- dict build / probe (hash-join route) --------------------------------------


def hash_to_slot(keys, cap_table: int, impl: Optional[str] = None):
    """Open-addressing slot assignment for int64 (packed) keys; rows equal
    to ``hash_table.EMPTY`` park at slot ``cap_table``.  Returns
    ``(slots, table_keys, used)`` — see kernels/hash_table.py."""
    _check_impl(impl, keys)
    return _ht.hash_to_slot(keys, cap_table)


def dict_probe(table_keys, count, queries, impl: Optional[str] = None):
    """(pos, found) per query against a sorted-front-packed dict key
    column; ``pos`` is zeroed where not found."""
    _check_impl(impl, queries)
    return _hp.dict_probe(table_keys, count, queries)


# -- group build / probe (m:n hash-join route) ---------------------------------


def group_build(keys, capacity: int, impl: Optional[str] = None):
    """CSR group build over int64 (packed) keys: rows with equal keys share
    an ascending-key compact slot.  Returns ``(cslots, offsets, used)`` —
    see kernels/group_build.py for the contract."""
    _check_impl(impl, keys)
    return _gb.group_build(keys, capacity)


def group_probe(table_keys, offsets, count, queries,
                impl: Optional[str] = None):
    """(pos, found, sizes) per query against a groupbuilder's sorted key
    column + CSR offsets — membership and the m:n expansion's
    match-count pass in one launch; ``sizes`` is 0 where not found."""
    _check_impl(impl, queries)
    return _hp.group_probe(table_keys, offsets, count, queries)


# -- tiled matmul (linalg.matmul / linalg.matvec) --------------------------------


def matmul(a, b, impl: Optional[str] = None):
    """C = A @ B for 2-D f32/f64 operands of one dtype, accumulated in that
    dtype; a (k, 1) right-hand side is the matvec launch shape."""
    _check_impl(impl, a)
    return _tm.tiled_matmul(a, b)


# -- fused elementwise map chain -------------------------------------------------


def map_elementwise(fn, arrays, impl: Optional[str] = None, lam=None,
                    env=None):
    """Apply a staged elementwise body to 1-D columns in one fused pass.
    ``fn`` is the body as a whole-column torch closure (the plain
    version), ``lam`` the same body as IR (the CUDA route generates its
    kernel from it) and ``env`` binds the body's free scalars."""
    _check_impl(impl, arrays[0])
    return _mc.map_elementwise(fn, arrays, lam=lam, env=env)
