"""C = A @ B — the linalg ops the tiling pass raises (``matmul``,
``matvec``), on the CUDA kernel in ``csrc/tiled_matmul.cu`` (the port of
the TPU kernel ``tiled_matmul``).

A CUDA tensor launches the kernel — or raises; a CPU tensor takes the
plain version in ``ref``.  The wrapper counts its kernel launches in
``.launches`` and its plain-version calls in ``.plain_calls``.  The
product is accumulated in the operands' dtype (f32 or f64, no TF32), in
one fixed order: bitwise the same from run to run.  f64 runs on the
FP64 tensor cores (DMMA), f32 on the CUDA cores; a (k, 1) right-hand
side takes the kernel's row launch shape (a warp per row of A).  The
tile launches index their tiles on a 1-D grid, so n has no limit of its
own.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import tiled_matmul as tiled_matmul_plain

DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n) -> (m, n) in the operands' (common) dtype."""
    if a.device.type == "cpu":
        tiled_matmul.plain_calls += 1
        return tiled_matmul_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"tiled_matmul kernel takes CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"tiled_matmul kernel takes two f32 or two f64 "
                        f"operands, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul kernel takes (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tiled_matmul kernel takes contiguous operands")
    (m, k), n = a.shape, b.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=a.dtype, device=a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.weld_tiled_matmul(
            DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, n, k, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "tiled_matmul kernel launch")
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
tiled_matmul.plain_calls = 0
