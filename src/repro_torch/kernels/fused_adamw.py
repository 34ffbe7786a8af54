"""One fused AdamW step over a flat parameter, on the CUDA kernel in
``csrc/fused_adamw.cu`` (the port of the TPU kernel ``adamw_update``,
repro/kernels/fused_adamw.py:50).

A CUDA tensor launches the kernel — or raises; a CPU tensor takes the
plain version, ``ref.adamw_update``.  The wrapper counts its kernel
launches in ``.launches`` and its plain-version calls in
``.plain_calls``.

p and g are bf16 or f32 (the train step hands over bf16 parameters and
bf16 or, under gradient accumulation, f32 gradients), m and v f32, all
four contiguous and of one element count; the arithmetic is f32 and p is
rounded to its own dtype at the end — the reference's
``_leaf_update_pallas`` (cast to f32, run the kernel, cast back) without
the f32 copies.  p, m and v are updated **in place** and returned (the
reference returns new arrays): a step over a 3.2 B-parameter model needs
no second copy of its 38 GB of state.
"""
from __future__ import annotations

import torch

from . import _build, _count
from .ref import adamw_scalars
from .ref import adamw_update as adamw_update_plain

DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, lr, step, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, wd: float = 0.01):
    """Update p, m and v in place by one AdamW step with bias correction
    at step ``step`` (t, counted from 1) and learning rate ``lr`` (Python
    numbers or CPU scalars); returns (p, m, v)."""
    if p.device.type == "cpu":
        _count.bump(adamw_update, "plain_calls")
        pn, mn, vn = adamw_update_plain(p, g, m, v, lr, step, b1=b1, b2=b2,
                                        eps=eps, wd=wd)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        return p, m, v
    if p.device.type != "cuda" or any(t.device != p.device
                                      for t in (g, m, v)):
        raise ValueError(f"fused_adamw kernel takes CUDA tensors on one "
                         f"device, got {p.device}, {g.device}, {m.device}, "
                         f"{v.device}")
    if p.dtype not in DTYPE_CODES or g.dtype not in DTYPE_CODES \
            or m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"fused_adamw kernel takes p, g bf16 or f32 and m, v "
                        f"f32, got {p.dtype}, {g.dtype}, {m.dtype}, "
                        f"{v.dtype}")
    n = p.numel()
    if any(t.numel() != n for t in (g, m, v)):
        raise ValueError(f"fused_adamw kernel takes p, g, m, v of one size, "
                         f"got {p.numel()}, {g.numel()}, {m.numel()}, "
                         f"{v.numel()}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("fused_adamw kernel takes contiguous p, g, m, v")
    lr, omb1, omb2, c1, c2 = adamw_scalars(lr, step, b1, b2)
    lib = _build.library()
    with torch.cuda.device(p.device):
        rc = lib.weld_fused_adamw(
            DTYPE_CODES[p.dtype], DTYPE_CODES[g.dtype], p.data_ptr(),
            g.data_ptr(), m.data_ptr(), v.data_ptr(), n, lr, b1, omb1, b2,
            omb2, eps, wd, c1, c2,
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "fused_adamw kernel launch")
    _count.bump(adamw_update, "launches")
    return p, m, v


adamw_update.launches = 0
adamw_update.plain_calls = 0
