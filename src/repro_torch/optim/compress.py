"""Int8 error-feedback gradient compression for the cross-pod hop (the
port of the JAX package's ``optim/compress.py``).

At 512+ ranks the pod interconnect's all-reduce is the scarcest
bandwidth; 4× compression with error feedback keeps convergence while
quartering the cross-pod bytes.  The within-pod reduction stays full
precision.

    g_sync, err = compressed_psum(g_local, err, (mesh, "pod"))

`err` is carried in the optimizer state; the quantization residual is
re-added next step, so the compression bias telescopes instead of
accumulating.  As in the reference, the training step does not call it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-dim): scale = max|x| / 127 + 1e-12, q =
    clip(round(x / scale), ±127), rounding half to even."""
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group(group):
    """A ``ProcessGroup`` as it is, or a (mesh, axis name) pair's."""
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(axis)
    return group


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group):
    """Error-feedback int8 all-reduce over ``group`` (a ``ProcessGroup``
    or a (mesh, axis name) pair).  Returns (mean-reduced gradient f32,
    new error buffer)."""
    pg = _group(group)
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    sent = dequantize_int8(q, scale)
    new_err = corrected - sent
    # int8 payload on the wire (4x fewer bytes); each shard is
    # dequantized with ITS OWN scale, so the reduction is exact up to
    # per-shard quantization error
    n = dist.get_world_size(pg)
    qs = [torch.empty_like(q) for _ in range(n)]
    scales = [torch.empty((1,), dtype=scale.dtype, device=scale.device)
              for _ in range(n)]
    dist.all_gather(qs, q.contiguous(), group=pg)
    dist.all_gather(scales, scale.reshape(1), group=pg)
    scales = [s[0] for s in scales]
    total = dequantize_int8(qs[0], scales[0])
    for qi, si in zip(qs[1:], scales[1:]):
        total = total + dequantize_int8(qi, si)
    return total / n, new_err


def tree_compressed_psum(grads: Mapping[str, torch.Tensor],
                         errs: Mapping[str, torch.Tensor], group):
    """:func:`compressed_psum` of every gradient; each mean in its
    gradient's dtype.  Returns (means, new errors), dicts keyed as
    ``grads``."""
    out_g, out_e = {}, {}
    for k, g in grads.items():
        m, ne = compressed_psum(g, errs[k], group)
        out_g[k] = m.to(g.dtype)
        out_e[k] = ne
    return out_g, out_e


def init_error_buffers(grads: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}
