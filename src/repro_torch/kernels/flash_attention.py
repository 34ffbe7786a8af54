"""Online-softmax attention with grouped-query heads, on two CUDA kernels,
both ports of the TPU kernel ``flash_attention``
(repro/kernels/flash_attention.py:74).

Which kernel is an explicit choice by dtype and head dimension
(:func:`route`), never a reaction to a failure:

* ``"sm90"``, ``csrc/flash_attention_sm90.cu``: bf16 with D in {64, 128}.
  Hopper's wgmma and TMA in a warp-specialised pipeline, 128 q rows x 128
  kv rows a tile.
* ``"v1"``, ``csrc/flash_attention.cu``: f32, and bf16 with any other
  head dimension (``mma.sync``).  Its f32 kernel runs on the FP32 CUDA
  cores in full f32: 64 q rows x 64 kv rows a tile, 8 warps, each thread
  a 4 x 4 micro-tile of the scores and a 4 x (DP / 16) one of the output
  in registers (DP: D rounded up to 64, 128 or 256), fed by 128-bit
  shared loads, with K and V brought by ``cp.async`` while the previous
  product computes.

A CUDA tensor launches its route's kernel — or raises: a build or launch
error is not caught.  A CPU tensor takes the plain version,
``ref.chunked_attention`` (what the reference's ``ops`` runs off the TPU).
The wrapper counts every kernel launch in ``.launches``, the launches of
the ``"sm90"`` route among them also in ``.launches_sm90``, and its
plain-version calls in ``.plain_calls``.

Gradients: on a CPU tensor autograd runs through the plain version.  On
a CUDA tensor that needs a gradient the launch goes through
``FlashAttention``, a ``torch.autograd.Function`` whose backward
recomputes the attention with ``ref.chunked_attention`` under autograd
and differentiates that — as the reference does, whose kernel has no
backward of its own (its gradient is XLA's through
``chunked_attention``).  Each backward is counted in
``.backward_calls``, not in ``.plain_calls``: the forward still ran the
kernel.  A backward kernel written by hand is later work.

The kernels take bf16 (tensor cores, p rounded to bf16 before the PV
product as the TPU kernel does) or f32 (CUDA cores, full f32), a head
dimension that is a multiple of 8 up to 256, and ``Sq <= Skv``; anything
else raises (:func:`plan`).  They read q, k and v through their strides
(the ``"sm90"`` route through TMA tensor maps built from them), so the
(B, T, H, D) activations of a layer go in as (B, H, T, D) views without a
copy, and they write the output in (B, Sq, H, D) storage, returned as a
(B, H, Sq, D) view.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _count
from . import ref
from .ref import chunked_attention as attention_plain

DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
MAX_D = 256
#: the head dimensions of the ``"sm90"`` route (bf16 only)
SM90_DIMS = (64, 128)
#: flash_attention_sm90.cu's code for a failed cuTensorMapEncodeTiled
#: (plus its CUresult; alone: the driver has no such entry point)
TMA_ERROR = 1 << 20

#: f32: |kernel - ref.attention| <= F32_ATOL + F32_RTOL |plain| (the JAX
#: package's own kernel test)
F32_ATOL, F32_RTOL = 2e-5, 2e-4
#: bf16: |kernel - ref.attention| <= BF16_VALUE_TOL |plain| +
#: BF16_WEIGHT_TOL R, see :func:`tolerance`
BF16_VALUE_TOL = 2.0 ** -7
BF16_WEIGHT_TOL = 2.0 ** -6


def _aligned(t: torch.Tensor) -> bool:
    """16-byte loads: a unit-stride last dimension, the other strides and
    the base address on 16 bytes (a dimension of size 1 is never
    stepped, so its stride does not count)."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per == 0 for n, s in zip(t.shape[:-1],
                                                 t.stride()[:-1]) if n > 1))


def _strides(t: torch.Tensor) -> list:
    """The (batch, head, seq) element strides of a 4-D operand, a
    dimension of size 1 given the 16-byte stride a tensor map takes."""
    per = 16 // t.element_size()
    return [s if n > 1 else per for n, s in zip(t.shape[:3], t.stride()[:3])]


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dimension launches:
    ``"sm90"`` for bf16 with D in :data:`SM90_DIMS`, else ``"v1"``."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_DIMS else "v1"


#: the ``__global__`` function each (route, dtype) runs, and its source
KERNELS = {("sm90", torch.bfloat16): ("flash_sm90", "flash_attention_sm90.cu"),
           ("v1", torch.bfloat16): ("flash_bf16", "flash_attention.cu"),
           ("v1", torch.float32): ("flash_f32", "flash_attention.cu")}


def kernel(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel a call of this dtype and head dimension launches
    (its :func:`route`'s kernel for that dtype)."""
    return KERNELS[route(dtype, d), dtype][0]


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         group: int = 1) -> str:
    """Check the operands of a kernel launch (dtype, shapes, group, head
    dimension, ``Sq <= Skv``; not the device) and return their
    :func:`route`.  Raises ``TypeError`` or ``ValueError`` on what no
    kernel takes."""
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16 or f32 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel takes q (B, H, Sq, D) and "
                         f"k, v (B, H // group, Skv, D) (or no B), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.ndim == 3:
        q, k = q[None], k[None]
    bsz, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if k.shape[0] != bsz or k.shape[3] != d or group < 1 \
            or h != hk * group:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match group={group}")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"flash_attention kernel takes a head dimension "
                         f"that is a multiple of 8 up to {MAX_D}, got {d}")
    if not 1 <= sq <= skv:
        raise ValueError(f"flash_attention kernel takes 1 <= Sq <= Skv, "
                         f"got Sq={sq}, Skv={skv}")
    return route(q.dtype, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, group: int = 1, scale=None,
                    chunk: int = 1024) -> torch.Tensor:
    """q (B, H, Sq, D) or (H, Sq, D); k, v (B, H // group, Skv, D) or
    (H // group, Skv, D).  Returns q's shape and dtype.  ``chunk`` is the
    plain version's kv chunk (the kernel tiles by itself; the backward
    recomputes with the plain version at this chunk)."""
    if q.device.type == "cpu":
        _count.bump(flash_attention, "plain_calls")
        return attention_plain(q, k, v, causal=causal, group=group,
                               scale=scale, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, group, scale, chunk)
    return _launch(q, k, v, causal, group, scale)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, group, scale, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, group=group, scale=scale, chunk=chunk)
        return _launch(q, k, v, causal, group, scale)

    @staticmethod
    def backward(ctx, dout):
        _count.bump(flash_attention, "backward_calls")
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((q, k, v),
                                                               need)]
            out = attention_plain(*ins, **ctx.opts)
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, dout))
        return (*(next(got) if n else None for n in need), None, None, None,
                None)


def _launch(q, k, v, causal, group, scale) -> torch.Tensor:
    """Check the operands and launch their route's kernel (counted)."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention kernel takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    which = plan(q, k, v, group)
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    bsz, h, sq, d = q.shape
    skv = k.shape[2]
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty((bsz, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    scale = float(scale if scale is not None else d ** -0.5)
    strides = (ctypes.c_longlong * 12)(
        *_strides(q), *_strides(k), *_strides(v), *out.stride()[:3])
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if which == "sm90":
            rc = lib.weld_flash_attention_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, bsz, h, group, sq, skv, d, int(causal), scale,
                stream)
        else:
            rc = lib.weld_flash_attention(
                DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), strides, bsz, h, group, sq,
                skv, d, int(causal), scale, stream)
    if rc >= TMA_ERROR:
        raise RuntimeError(
            "flash_attention kernel launch: cuTensorMapEncodeTiled "
            + (f"returned CUresult {rc - TMA_ERROR}" if rc > TMA_ERROR
               else "is not in the driver"))
    _build.check(rc, f"flash_attention kernel launch ({which})")
    _count.bump(flash_attention, "launches")
    if which == "sm90":
        _count.bump(flash_attention, "launches_sm90")
    return out[0] if squeeze else out


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.plain_calls = 0
flash_attention.backward_calls = 0


def tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              plain: torch.Tensor, *, causal: bool = True, group: int = 1,
              scale=None) -> torch.Tensor:
    """The f32 per-element limit of |kernel - plain|, where ``plain`` is
    ``ref.attention(q, k, v, ...)``.

    In bf16 the kernel differs from the plain version in two roundings.
    Both round their f32 result to bf16: once the f32 values agree, the
    two differ by at most one bf16 step, 2**-7 of the value.  And the
    kernel rounds each softmax weight p_j to bf16 before the PV product
    (the TPU kernel's cast), each by at most 2**-8 of itself: a sum of
    independent roundings whose standard deviation is at most
    2**-8 / sqrt(3) R, with R = sqrt(sum_j (p_j / l)**2 v_j**2) the root of
    the squared weighted values.  The limit allows 2**-6 R, 6.9 standard
    deviations, which is also the whole worst case 2**-8 sum_j p_j |v_j| / l
    whenever 16 or fewer weights carry the row.  The f32 arithmetic's
    own differences (order of sums, exp2 for exp) lie far below both.
    R shrinks with the row's
    spread as its value does (a near-uniform row over n keys has both
    about n**-0.5), so the limit follows the size of what it compares."""
    want = plain.float()
    if plain.dtype == torch.float32:
        return F32_ATOL + F32_RTOL * want.abs()
    p = ref.attention_weights(q, k, causal=causal, group=group, scale=scale)
    v2 = ref._repeat_kv(v, group).float().square()
    r = torch.einsum("...hqk,...hkd->...hqd", p.square_(), v2).sqrt_()
    return BF16_VALUE_TOL * want.abs() + BF16_WEIGHT_TOL * r
