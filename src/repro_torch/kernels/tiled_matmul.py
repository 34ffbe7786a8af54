"""C = A @ B — the linalg ops the tiling pass raises (``matmul``,
``matvec``), on the CUDA kernel in ``csrc/tiled_matmul.cu`` (the port of
the TPU kernel ``tiled_matmul``).

A CUDA tensor launches the kernel — or raises; a CPU tensor takes the
plain version in ``ref``.  The wrapper counts its kernel launches in
``.launches`` and its plain-version calls in ``.plain_calls``.  The
product is accumulated in the operands' dtype (f32 or f64, no TF32), in
one fixed order: bitwise the same from run to run.  f64 runs on the
FP64 tensor cores (DMMA), f32 on the FP32 CUDA cores (a register-blocked
SGEMM: 128 x 128 tiles, an 8 x 8 micro-tile a thread).  A (k, 1)
right-hand side takes one of two row launches, which :func:`plan` picks
from shape and alignment alone, before the launch: ``"rows_bulk"``
streams tiles of 64 rows of A through a ring of shared-memory stages by
Hopper's 1-D bulk copy (one persistent block an SM, 4 threads a row),
and takes an A that starts on 16 bytes with rows of at most
:data:`MAX_BULK_ROW_BYTES`; ``"rows_warp"`` (a warp a row, read
straight from global memory) takes every other A.  The tile launches
index their tiles on a 1-D grid, so n has no limit of its own.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import tiled_matmul as tiled_matmul_plain

DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
#: the kernel's launches (csrc/tiled_matmul.cu, ``which``)
LAUNCH_CODES = {"tiles": 0, "rows_bulk": 1, "rows_warp": 2}
#: the longest row the bulk launch takes: a 64-row tile fills at most one
#: stage of a 3-stage, 192 KB ring (csrc ``kMaxBulkRowBytes``)
MAX_BULK_ROW_BYTES = 1024


def plan(a: torch.Tensor, b: torch.Tensor) -> str:
    """The launch an (m, k) @ (k, n) product takes, from shape and
    alignment alone (runs on CPU tensors): ``"tiles"`` for n > 1; for
    n = 1 ``"rows_bulk"`` where A starts on 16 bytes and a row holds at
    most :data:`MAX_BULK_ROW_BYTES`, else ``"rows_warp"``.  An m that is
    not a multiple of the 64-row tile keeps ``"rows_bulk"``: the kernel
    reads the partial last tile from global memory itself."""
    if b.shape[1] != 1:
        return "tiles"
    if a.data_ptr() % 16 == 0 \
            and a.shape[1] * a.element_size() <= MAX_BULK_ROW_BYTES:
        return "rows_bulk"
    return "rows_warp"


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
    which = plan(a, b)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.weld_tiled_matmul(
            DTYPE_CODES[a.dtype], LAUNCH_CODES[which], a.data_ptr(),
            b.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, f"tiled_matmul kernel launch ({which})")
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
tiled_matmul.plain_calls = 0
