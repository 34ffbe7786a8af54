"""vecmerger / dictmerger accumulation: keyed sums without atomics.

Wrappers over the CUDA kernel in ``csrc/segment_reduce.cu`` (the port of
the TPU kernels ``segment_sum`` and ``segment_sum_vectors``).  A CUDA
tensor launches the kernel — or raises; a CPU tensor takes the plain
version in ``ref``, and so does K > ``MAX_K``, the reference's own size
rule (its kernel's accumulator tile bound), kept so both packages route
the same calls.  Each wrapper counts its kernel launches in
``.launches`` and its plain-version calls in ``.plain_calls``.

Results keep the value dtype and are bitwise the same from run to run.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from .filter_reduce import DTYPE_CODES
from .ref import segment_sum as segment_sum_plain
from .ref import segment_sum_vectors as segment_sum_vectors_plain

MAX_K = 4096
#: widest row the kernel takes (csrc kMaxD); the main path uses D <= 2
MAX_D = 4
#: dynamic shared memory a block may use (csrc kSmemLimit)
SMEM_LIMIT = 232448
MAX_WARPS = 8
#: grid cap: two waves of the H100's 132 SMs at one block per SM
MAX_BLOCKS = 264
#: 32-row tiles each warp takes at least before the grid grows
MIN_TILES_PER_WARP = 16


def launch_config(n: int, k: int, d: int, itemsize: int) -> Tuple[int, int]:
    """(warps per block, blocks) of the partial launch; raises for a
    shape the kernel does not take.  Every warp holds a private K x D
    accumulator in shared memory, so K * D * itemsize bounds the warps
    per block.  The shape depends only on the call's sizes, which fixes
    the summation order."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"segment_sum kernel takes rows of 1 to {MAX_D} "
                         f"values, got D={d}")
    per_warp = k * d * itemsize
    if per_warp > SMEM_LIMIT:
        raise ValueError(
            f"segment_sum kernel keeps a K x D accumulator per warp in shared "
            f"memory: K={k} D={d} x {itemsize} B exceeds {SMEM_LIMIT} B")
    warps = min(MAX_WARPS, SMEM_LIMIT // per_warp)
    tiles = math.ceil(n / 32)
    blocks = max(1, min(MAX_BLOCKS,
                        math.ceil(tiles / (warps * MIN_TILES_PER_WARP))))
    return warps, blocks


def _launch(seg: torch.Tensor, vals: torch.Tensor, k: int) -> torch.Tensor:
    n, d = vals.shape
    if seg.device != vals.device or vals.device.type != "cuda":
        raise ValueError(
            f"segment_sum kernel takes CUDA tensors on one device, got "
            f"{seg.device} and {vals.device}")
    if vals.dtype not in DTYPE_CODES:
        raise TypeError(f"segment_sum kernel takes f32/f64/i32/i64 values, "
                        f"got {vals.dtype}")
    if seg.dtype != torch.int32 or seg.shape != (n,):
        raise ValueError("segment_sum kernel takes (n,) int32 segment ids")
    if not (seg.is_contiguous() and vals.is_contiguous()):
        raise ValueError("segment_sum kernel takes contiguous tensors")
    out = torch.empty((k, d), dtype=vals.dtype, device=vals.device)
    if n == 0:
        return out.zero_()
    warps, blocks = launch_config(n, k, d, vals.element_size())
    partials = torch.empty((blocks, k, d), dtype=vals.dtype,
                           device=vals.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        rc = lib.weld_segment_sum(
            DTYPE_CODES[vals.dtype], seg.data_ptr(), vals.data_ptr(), n, k, d,
            warps, blocks, partials.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "segment_sum kernel launch")
    return out


def segment_sum(seg_ids: torch.Tensor, vals: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum(vals[seg_ids == s]): seg_ids (n,) int32, vals (n,)."""
    if seg_ids.device.type == "cpu" or num_segments > MAX_K:
        segment_sum.plain_calls += 1
        return segment_sum_plain(seg_ids, vals, num_segments)
    if vals.ndim != 1:
        raise ValueError(f"segment_sum takes a 1-D column, got {vals.shape}")
    out = _launch(seg_ids, vals[:, None], num_segments)[:, 0]
    segment_sum.launches += bool(vals.shape[0])
    return out


segment_sum.launches = 0
segment_sum.plain_calls = 0


def segment_sum_vectors(seg_ids: torch.Tensor, vals: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """vals (n, D) rows summed into (K, D) by segment id."""
    if seg_ids.device.type == "cpu" or num_segments > MAX_K:
        segment_sum_vectors.plain_calls += 1
        return segment_sum_vectors_plain(seg_ids, vals, num_segments)
    if vals.ndim != 2:
        raise ValueError(f"segment_sum_vectors takes (n, D) values, got "
                         f"{vals.shape}")
    out = _launch(seg_ids, vals, num_segments)
    segment_sum_vectors.launches += bool(vals.shape[0])
    return out


segment_sum_vectors.launches = 0
segment_sum_vectors.plain_calls = 0
