"""Predicated filter+reduce — the fused form of the paper's Listing 10.

    result(for(v, merger[+,0], (b,i,x) => if(p(x)) merge(b,x) else b))

Wrappers over the CUDA kernel in ``csrc/filter_reduce.cu`` (the port of
the TPU kernels ``filter_reduce_sum``, ``filter_reduce_sum_multi`` and
the hand-fused Q6 ``filter_reduce_q6``).
A CUDA tensor launches the kernel — or raises; a CPU tensor takes the
plain version in ``ref``.  Each wrapper counts its kernel launches in
``.launches`` and its plain-version calls in ``.plain_calls``.

Results keep the input dtype, as the TPU kernels do, and are bitwise
the same from run to run (fixed grid, fixed summation order).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, _count
from .ref import filter_reduce_sum as filter_reduce_sum_plain
from .ref import filter_reduce_q6 as filter_reduce_q6_plain
from .ref import filter_reduce_sum_multi as filter_reduce_sum_multi_plain

#: threads per block and the default grid cap of the partial-sum launch
#: (the grid depends only on n and the cap, so a given n sums in the
#: same order at a given cap)
THREADS = 256
MAX_BLOCKS = 1024
#: the caps the autotuner times (kernelplan/registry.py): one, two and
#: four blocks an SM of the H100's 132, and the default
GRID_CAPS = (132, 264, 528, MAX_BLOCKS)
#: aggregates per launch (csrc kMaxA); wider calls take several launches
MAX_A = 4
#: range columns of one Q6 launch (csrc kMaxQ6)
MAX_Q6_COLS = 8

DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
               torch.int64: 3}


def grid_blocks(n: int, max_blocks: Optional[int] = None) -> int:
    """Blocks of the partial-sum launch: four rows per thread, capped at
    ``max_blocks`` (default :data:`MAX_BLOCKS`).  Any cap of at least one
    block is valid: the launch strides over the rows by its grid."""
    cap = MAX_BLOCKS if max_blocks is None else int(max_blocks)
    if cap < 1:
        raise ValueError(f"filter_reduce grid cap must be >= 1, got {cap}")
    return max(1, min(cap, math.ceil(n / (THREADS * 4))))


def _check_args(vals: torch.Tensor, pred: torch.Tensor) -> None:
    if vals.device.type != "cuda" or pred.device != vals.device:
        raise ValueError(
            f"filter_reduce kernel takes CUDA tensors on one device, got "
            f"{vals.device} and {pred.device}")
    if vals.dtype not in DTYPE_CODES:
        raise TypeError(f"filter_reduce kernel takes f32/f64/i32/i64 values, "
                        f"got {vals.dtype}")
    if pred.dtype != torch.bool or pred.ndim != 1 \
            or pred.shape[0] != vals.shape[-1]:
        raise ValueError("filter_reduce kernel needs a bool predicate of the "
                         "values' length")
    if not (vals.is_contiguous() and pred.is_contiguous()):
        raise ValueError("filter_reduce kernel takes contiguous tensors")


def _launch(vals: torch.Tensor, pred: torch.Tensor,
            max_blocks: Optional[int] = None) -> torch.Tensor:
    """(A, n) values -> (A,) predicated sums on the card."""
    a, n = vals.shape
    out = torch.empty((a,), dtype=vals.dtype, device=vals.device)
    nblocks = grid_blocks(n, max_blocks)
    partials = torch.empty((nblocks, min(a, MAX_A)), dtype=vals.dtype,
                           device=vals.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        for a0 in range(0, a, MAX_A):
            rows = vals[a0:a0 + MAX_A]
            rc = lib.weld_filter_reduce_sum(
                DTYPE_CODES[vals.dtype], rows.data_ptr(), pred.data_ptr(), n,
                rows.shape[0], partials.data_ptr(), nblocks,
                out[a0:].data_ptr(), stream)
            _build.check(rc, "filter_reduce kernel launch")
    return out


def filter_reduce_sum(x: torch.Tensor, pred: torch.Tensor,
                      max_blocks: Optional[int] = None) -> torch.Tensor:
    """sum(x[pred]) in one pass: x (n,), pred (n,) bool -> 0-dim tensor.
    ``max_blocks`` caps the grid (:func:`grid_blocks`)."""
    if x.device.type == "cpu":
        _count.bump(filter_reduce_sum, "plain_calls")
        return filter_reduce_sum_plain(x, pred)
    if x.ndim != 1:
        raise ValueError(f"filter_reduce_sum takes a 1-D column, got {x.shape}")
    _check_args(x, pred)
    if x.shape[0] == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    out = _launch(x[None, :], pred, max_blocks)[0]
    _count.bump(filter_reduce_sum, "launches")
    return out


filter_reduce_sum.launches = 0
filter_reduce_sum.plain_calls = 0


def filter_reduce_sum_multi(vals: torch.Tensor, pred: torch.Tensor,
                            max_blocks: Optional[int] = None
                            ) -> torch.Tensor:
    """Row-wise predicated sums: vals (A, n), pred (n,) -> (A,), with the
    predicate and the value rows read once for all A aggregates."""
    if vals.device.type == "cpu":
        _count.bump(filter_reduce_sum_multi, "plain_calls")
        return filter_reduce_sum_multi_plain(vals, pred)
    if vals.ndim != 2:
        raise ValueError(f"filter_reduce_sum_multi takes (A, n) values, got "
                         f"{vals.shape}")
    _check_args(vals, pred)
    if vals.shape[1] == 0 or vals.shape[0] == 0:
        return torch.zeros((vals.shape[0],), dtype=vals.dtype,
                           device=vals.device)
    out = _launch(vals, pred, max_blocks)
    _count.bump(filter_reduce_sum_multi, "launches")
    return out


filter_reduce_sum_multi.launches = 0
filter_reduce_sum_multi.plain_calls = 0


def filter_reduce_q6(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     val: torch.Tensor) -> torch.Tensor:
    """sum(val where all(lo[k] <= cols[k] < hi[k])) in one pass: cols
    (K, n), lo/hi (K,), val (n,), all of one float dtype -> 0-dim."""
    if val.device.type == "cpu":
        _count.bump(filter_reduce_q6, "plain_calls")
        return filter_reduce_q6_plain(cols, lo, hi, val)
    tensors = (cols, lo, hi, val)
    if any(t.device != val.device for t in tensors) \
            or val.device.type != "cuda":
        raise ValueError("filter_reduce_q6 kernel takes CUDA tensors on one "
                         "device")
    if val.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != val.dtype for t in tensors):
        raise TypeError(f"filter_reduce_q6 kernel takes f32 or f64 tensors of "
                        f"one dtype, got {[t.dtype for t in tensors]}")
    if cols.ndim != 2 or val.ndim != 1 or cols.shape[1] != val.shape[0] \
            or lo.shape != (cols.shape[0],) or hi.shape != (cols.shape[0],):
        raise ValueError(f"filter_reduce_q6 kernel needs cols (K, n), lo/hi "
                         f"(K,), val (n,); got {cols.shape}, {lo.shape}, "
                         f"{hi.shape}, {val.shape}")
    if not 1 <= cols.shape[0] <= MAX_Q6_COLS:
        raise ValueError(f"filter_reduce_q6 kernel takes 1..{MAX_Q6_COLS} "
                         f"range columns, got {cols.shape[0]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("filter_reduce_q6 kernel takes contiguous tensors")
    n = val.shape[0]
    if n == 0:
        return torch.zeros((), dtype=val.dtype, device=val.device)
    out = torch.empty((), dtype=val.dtype, device=val.device)
    nblocks = grid_blocks(n)
    partials = torch.empty((nblocks,), dtype=val.dtype, device=val.device)
    lib = _build.library()
    with torch.cuda.device(val.device):
        rc = lib.weld_filter_reduce_q6(
            DTYPE_CODES[val.dtype], cols.data_ptr(), cols.shape[0],
            lo.data_ptr(), hi.data_ptr(), val.data_ptr(), n,
            partials.data_ptr(), nblocks, out.data_ptr(),
            torch.cuda.current_stream(val.device).cuda_stream)
    _build.check(rc, "filter_reduce_q6 kernel launch")
    _count.bump(filter_reduce_q6, "launches")
    return out


filter_reduce_q6.launches = 0
filter_reduce_q6.plain_calls = 0
