"""vecmerger / dictmerger accumulation: keyed sums without atomics.

Wrappers over the CUDA kernel in ``csrc/segment_reduce.cu`` (the port of
the TPU kernels ``segment_sum`` and ``segment_sum_vectors``).  A CUDA
tensor launches the kernel — or raises; a CPU tensor takes the plain
version in ``ref``.  Any K runs on the kernel: it sums the keys
``MAX_K`` at a time (:func:`windows` passes over the rows), where the
reference's kernel stops at its accumulator tile.  The planner keeps the
reference's match rule (``max_segments``) for the routes that it has.
Each wrapper counts its kernel launches in ``.launches`` and its
plain-version calls in ``.plain_calls``.

Results keep the value dtype and are bitwise the same from run to run.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import _build, _count
from .filter_reduce import DTYPE_CODES
from .ref import segment_sum as segment_sum_plain
from .ref import segment_sum_vectors as segment_sum_vectors_plain

#: keys one pass of the kernel accumulates (the reference's tile bound)
MAX_K = 4096
#: widest row the kernel takes (csrc kMaxD); the main path uses D <= 2
MAX_D = 4
#: warps of a block (csrc kWarps): every one owns keys of a replica
WARPS = 16
#: 32-row tiles a staged chunk holds, at most (csrc kMaxTiles) and at
#: least
MAX_TILES = 32
MIN_TILES = 16
#: dynamic shared memory a block may use (csrc kSmemLimit), an SM's shared
#: memory and what the runtime reserves of it for each block (H100)
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
BLOCK_RESERVED = 1024
SMS = 132
#: grid cap: one wave of the H100's 132 SMs at two blocks an SM
MAX_BLOCKS = 2 * SMS
#: the caps the autotuner times (kernelplan/registry.py): a quarter, half
#: and one block an SM, and the default
GRID_CAPS = (SMS // 4, SMS // 2, SMS, MAX_BLOCKS)
#: chunks each block takes at least before the grid grows
MIN_CHUNKS_PER_BLOCK = 4


class Launch(NamedTuple):
    """The partial launch: blocks of WARPS warps holding ``replicas``
    accumulators (WARPS // replicas owners each) and staging ``tiles``
    32-row tiles a chunk; ``per_sm`` blocks resident on an SM,
    ``blocks`` in the grid."""
    replicas: int
    tiles: int
    per_sm: int
    blocks: int

    @property
    def warps_per_sm(self) -> int:
        return WARPS * self.per_sm


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def smem_bytes(k: int, d: int, itemsize: int, replicas: int,
               tiles: int) -> int:
    """Shared memory of one block (csrc ``smem_bytes``): the replicas'
    K x D accumulators (each owner's keys padded to a whole share) and
    their election tags (4 bytes a slot), two chunk buffers of ids and
    values, and the owner masks."""
    owners = WARPS // replicas
    slots = replicas * owners * -(-k // owners)
    return (_align16(slots * d * itemsize) + _align16(slots * 4)
            + 2 * tiles * 32 * (4 + d * itemsize) + tiles * owners * 4)


def launch_config(n: int, k: int, d: int, itemsize: int,
                  max_blocks: Optional[int] = None) -> Launch:
    """The partial launch for one window of K keys; raises for a shape the
    kernel does not take.  Two blocks an SM where they fit, else one.  A
    block keeps as many replicas of the K x D accumulator as fit beside
    chunks of MAX_TILES tiles (16 at small K: every warp its own replica,
    owning every key); where not even one does, one replica and the
    largest chunk that fits, of at least MIN_TILES tiles.  The grid is
    capped at ``max_blocks`` (default :data:`MAX_BLOCKS`; any cap of at
    least one block is valid, the blocks stride over the chunks).  The
    shape depends only on the call's sizes and the cap, which fixes the
    summation order."""
    cap = MAX_BLOCKS if max_blocks is None else int(max_blocks)
    if cap < 1:
        raise ValueError(f"segment_sum grid cap must be >= 1, got {cap}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"segment_sum kernel takes rows of 1 to {MAX_D} "
                         f"values, got D={d}")
    for per_sm in (2, 1):
        budget = min(SMEM_LIMIT, SMEM_PER_SM // per_sm - BLOCK_RESERVED)
        shape = next(((r, MAX_TILES) for r in (16, 8, 4, 2, 1)
                      if smem_bytes(k, d, itemsize, r, MAX_TILES) <= budget),
                     None)
        if shape is None:
            fits = [t for t in range(MIN_TILES, MAX_TILES)
                    if smem_bytes(k, d, itemsize, 1, t) <= budget]
            shape = (1, max(fits)) if fits else None
        if shape is not None:
            replicas, tiles = shape
            chunks = math.ceil(n / (32 * tiles))
            blocks = max(1, min(SMS * per_sm, cap,
                                math.ceil(chunks / MIN_CHUNKS_PER_BLOCK)))
            return Launch(replicas, tiles, per_sm, blocks)
    raise ValueError(
        f"segment_sum kernel keeps a K x D accumulator in shared memory: "
        f"K={k} D={d} x {itemsize} B and its chunk buffers exceed "
        f"{SMEM_LIMIT} B")


def windows(k: int) -> int:
    """Passes of the kernel over the rows for K keys: one a MAX_K keys."""
    return max(1, math.ceil(k / MAX_K))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes
    (a view at an offset): the kernel stages rows with 16-byte copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(seg: torch.Tensor, vals: torch.Tensor, k: int,
            max_blocks: Optional[int] = None) -> torch.Tensor:
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
    seg, vals = _aligned(seg), _aligned(vals)
    window = min(k, MAX_K)
    cfg = launch_config(n, window, d, vals.element_size(), max_blocks)
    partials = torch.empty((cfg.blocks, window, d), dtype=vals.dtype,
                           device=vals.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        rc = lib.weld_segment_sum(
            DTYPE_CODES[vals.dtype], seg.data_ptr(), vals.data_ptr(), n, k,
            window, d, cfg.replicas, cfg.tiles, cfg.blocks,
            partials.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "segment_sum kernel launch")
    return out


def segment_sum(seg_ids: torch.Tensor, vals: torch.Tensor,
                num_segments: int,
                max_blocks: Optional[int] = None) -> torch.Tensor:
    """out[s] = sum(vals[seg_ids == s]): seg_ids (n,) int32, vals (n,);
    ``max_blocks`` caps the grid (:func:`launch_config`)."""
    if seg_ids.device.type == "cpu":
        _count.bump(segment_sum, "plain_calls")
        return segment_sum_plain(seg_ids, vals, num_segments)
    if vals.ndim != 1:
        raise ValueError(f"segment_sum takes a 1-D column, got {vals.shape}")
    out = _launch(seg_ids, vals[:, None], num_segments, max_blocks)[:, 0]
    _count.bump(segment_sum, "launches", bool(vals.shape[0]))
    return out


segment_sum.launches = 0
segment_sum.plain_calls = 0


def segment_sum_vectors(seg_ids: torch.Tensor, vals: torch.Tensor,
                        num_segments: int,
                        max_blocks: Optional[int] = None) -> torch.Tensor:
    """vals (n, D) rows summed into (K, D) by segment id."""
    if seg_ids.device.type == "cpu":
        _count.bump(segment_sum_vectors, "plain_calls")
        return segment_sum_vectors_plain(seg_ids, vals, num_segments)
    if vals.ndim != 2:
        raise ValueError(f"segment_sum_vectors takes (n, D) values, got "
                         f"{vals.shape}")
    out = _launch(seg_ids, vals, num_segments, max_blocks)
    _count.bump(segment_sum_vectors, "launches", bool(vals.shape[0]))
    return out


segment_sum_vectors.launches = 0
segment_sum_vectors.plain_calls = 0
