"""Public entries of the port's kernel library (the counterparts of the
JAX package's ``kernels/ops.py`` for this slice).

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
from . import segment_reduce as _sr

IMPLS = ("cuda", "ref")

#: every counted wrapper, by name (chip_smoke and the tests read these)
WRAPPERS = {
    "filter_reduce_sum": _fr.filter_reduce_sum,
    "filter_reduce_sum_multi": _fr.filter_reduce_sum_multi,
    "segment_sum": _sr.segment_sum,
    "segment_sum_vectors": _sr.segment_sum_vectors,
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


def segment_sum(seg_ids, vals, num_segments: int,
                impl: Optional[str] = None):
    _check_impl(impl, vals)
    return _sr.segment_sum(seg_ids, vals, num_segments)


def segment_sum_vectors(seg_ids, vals, num_segments: int,
                        impl: Optional[str] = None):
    _check_impl(impl, vals)
    return _sr.segment_sum_vectors(seg_ids, vals, num_segments)
