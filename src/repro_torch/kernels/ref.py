"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same
result dtype (the input's, as the TPU kernels keep it).  The wrappers in
``filter_reduce``/``segment_reduce`` run these for tensors that lie on
the CPU; on the card they are what a kernel is held against."""
from __future__ import annotations

import torch


def filter_reduce_sum(x: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """sum(x[pred]) as a 0-dim tensor of x's dtype."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(pred, x, zero).sum(dtype=x.dtype)


def filter_reduce_sum_multi(vals: torch.Tensor,
                            pred: torch.Tensor) -> torch.Tensor:
    """vals (A, n), pred (n,) -> (A,) predicated row sums."""
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    return torch.where(pred[None, :], vals, zero).sum(dim=1, dtype=vals.dtype)


def segment_sum_vectors(seg_ids: torch.Tensor, vals: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """(n, D) rows summed into (K, D) by segment id; ids outside
    [0, K) are dropped."""
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = torch.where(keep, seg_ids, torch.zeros_like(seg_ids)).to(torch.int64)
    src = torch.where(keep[:, None], vals, torch.zeros_like(vals))
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, src)


def segment_sum(seg_ids: torch.Tensor, vals: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum(vals[seg_ids == s]); ids outside [0, K) are dropped."""
    return segment_sum_vectors(seg_ids, vals[:, None], num_segments)[:, 0]
