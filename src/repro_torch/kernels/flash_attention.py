"""Online-softmax attention with grouped-query heads, on two CUDA kernels,
both ports of the TPU kernel ``flash_attention``
(repro/kernels/flash_attention.py:74).

Which kernel is an explicit choice by dtype (:func:`route`), never a
reaction to a failure:

* ``"sm90"``, ``csrc/flash_attention_sm90.cu``: bf16, any head dimension
  from 1 to 256.  Hopper's wgmma and TMA in a warp-specialised pipeline,
  128 q rows a tile, the head dimension padded with zeros to whole panels
  of 64 columns in shared memory (:func:`sm90_plan`).  An operand that TMA
  cannot map (a row stride or base off 16 bytes: a D of 14, a view of an
  odd H * D) is first copied into zero-padded rows by the kernel's packing
  pass, one launch for every such operand of a call.
* ``"v1"``, ``csrc/flash_attention.cu``: f32, on the FP32 CUDA cores in
  full f32: 64 q rows x 64 kv rows a tile, 8 warps, each thread a 4 x 4
  micro-tile of the scores and a 4 x (DP / 16) one of the output in
  registers (DP: D rounded up to 64, 128 or 256), fed by 128-bit shared
  loads, with K and V brought by ``cp.async`` while the previous product
  computes.

A CUDA tensor launches its route's kernel — or raises: a build or launch
error is not caught.  A CPU tensor takes the plain version,
``ref.chunked_attention`` (what the reference's ``ops`` runs off the TPU).
The wrapper counts every attention launch in ``.launches``, the launches
of the ``"sm90"`` route among them also in ``.launches_sm90``, the
packing pass's launches in ``.launches_pack``, and its plain-version calls
in ``.plain_calls``.  The launch goes through the operator
``torch.ops.weld.flash_attention`` (a ``torch.library.custom_op``):
under a fake mode (the dry run) its fake form gives the output and
nothing is launched or counted, and ``torch.utils.flop_counter`` counts
it by the pairs its mask leaves (:func:`attention_pairs`), at D (the
padding is not the function's work).

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
product as the TPU kernel does) or f32 (CUDA cores, full f32), any head
dimension from 1 to 256 (the reference's blocks take the whole D), and,
under the causal mask,
``Sq <= Skv`` (the mask aligns the q rows to the last Sq kv positions;
without the mask any Sq and Skv, as the reference's kernel takes: a
cross-attention's text may be longer than what it attends to); anything
else raises (:func:`plan`).  They read q, k and v through their strides
(the ``"sm90"`` route through TMA tensor maps built from them), so the
(B, T, H, D) activations of a layer go in as (B, H, T, D) views without a
copy where their rows lie on 16 bytes, and they write the output in
(B, Sq, H, D) storage, returned as a (B, H, Sq, D) view.  The ``"v1"``
kernel moves rows in 16-byte copies where every row starts on 16 bytes
and D fills whole 16-byte chunks, and element by element otherwise: the
C entry decides from the operands at each launch.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build, _count
from . import ref
from .ref import chunked_attention as attention_plain

DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 256
#: head-dimension columns of one 128-byte panel of the ``"sm90"`` route's
#: shared-memory tiles (and the width of a tensor map's box)
PANEL = 64
#: q rows a block of the ``"sm90"`` route takes
SM90_Q_ROWS = 128
#: the dynamic shared memory one block may take on an H100
SMEM_LIMIT = 232_448
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
    dimension of size 1 (never stepped) given the 16-byte stride a tensor
    map takes and the v1 kernels' 16-byte copies allow."""
    per = 16 // t.element_size()
    return [s if n > 1 else per for n, s in zip(t.shape[:3], t.stride()[:3])]


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dimension launches:
    ``"sm90"`` for bf16 (any D), ``"v1"`` for f32."""
    return "sm90" if dtype == torch.bfloat16 else "v1"


#: the ``__global__`` function each (route, dtype) runs, and its source
KERNELS = {("sm90", torch.bfloat16): ("flash_sm90", "flash_attention_sm90.cu"),
           ("v1", torch.float32): ("flash_f32", "flash_attention.cu")}


@dataclass(frozen=True)
class Sm90Plan:
    """How the ``"sm90"`` route lays out one call (:func:`sm90_plan`).

    ``dp``: D padded to whole panels of 64 columns, the width of the
    shared-memory tiles and of O's accumulators; ``kv_rows``: kv rows a
    tile (two stages of K and V beside Q must fit ``SMEM_LIMIT``), the
    rows of the K and V maps' boxes; ``smem_bytes``: the dynamic shared
    memory a block takes (the kernel's ``block_smem<DP>()``); ``pack``:
    for q, k, v, whether the operand goes through the packing pass (TMA
    maps only rows whose strides and base lie on 16 bytes); ``dims0``:
    each tensor map's row width, ``globalDim[0]`` (D, or the packed rows'
    8 ceil(D / 8) columns, zero past D); ``box``: each map's box (columns,
    rows).  TMA fills the columns past ``dims0`` up to ``dp`` and the rows
    past the sequence with zeros.  The C entry launches the instantiation
    of ``dp`` and ``kv_rows`` with these maps and refuses a plan whose
    ``dp``, ``kv_rows`` or ``smem_bytes`` are not its own layout's."""
    dp: int
    kv_rows: int
    smem_bytes: int
    pack: Tuple[bool, bool, bool]
    dims0: Tuple[int, int, int]
    box: Tuple[Tuple[int, int], ...]


def packed_width(d: int) -> int:
    """Columns of a row the packing pass writes: D rounded up to whole
    16-byte chunks, the columns past D zero."""
    return 8 * -(-d // 8)


def sm90_plan(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> Sm90Plan:
    """The ``"sm90"`` route's layout of a call on (B, H, S, D) q, k, v
    (checked by :func:`plan`); reads shapes, strides and addresses only,
    so it runs on CPU tensors."""
    d = q.shape[-1]
    dp = PANEL * -(-d // PANEL)
    rows = 128 if dp <= 128 else 64
    # Q, two stages of K and V, 10 mbarriers, the 1,024-byte alignment
    smem = SM90_Q_ROWS * dp * 2 + 2 * 2 * rows * dp * 2 + 8 * 10 + 1024
    pack = tuple(not _aligned(t) for t in (q, k, v))
    return Sm90Plan(dp=dp, kv_rows=rows, smem_bytes=smem, pack=pack,
                    dims0=tuple(packed_width(d) if p else d for p in pack),
                    box=((PANEL, SM90_Q_ROWS), (PANEL, rows), (PANEL, rows)))


def kernel(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel a call of this dtype and head dimension launches
    (its :func:`route`'s kernel for that dtype)."""
    return KERNELS[route(dtype, d), dtype][0]


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         group: int = 1, causal: bool = True) -> str:
    """Check the operands of a kernel launch (dtype, shapes, group, head
    dimension, ``Sq <= Skv`` under ``causal``; not the device) and return
    their :func:`route`.  Raises ``TypeError`` or ``ValueError`` on what no
    kernel takes."""
    if q.dtype not in DTYPES or k.dtype != q.dtype \
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
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention kernel takes a head dimension "
                         f"from 1 to {MAX_D}, got {d}")
    if sq < 1 or skv < 1:
        raise ValueError(f"flash_attention kernel takes Sq, Skv >= 1, got "
                         f"Sq={sq}, Skv={skv}")
    if causal and sq > skv:
        raise ValueError(f"flash_attention kernel takes Sq <= Skv under the "
                         f"causal mask, got Sq={sq}, Skv={skv}")
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
    """Check the operands and launch their route's kernel (counted),
    through the ``weld::flash_attention`` op."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention kernel takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    plan(q, k, v, group, causal)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    return _kernel_op(q, k, v, causal, group, scale)


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, group: int, scale: float) -> torch.Tensor:
    """The launch: the body of the operator ``weld::flash_attention``
    (:data:`_kernel_op`), whose fake form gives the output's shape and
    strides and launches and counts nothing (the dry run,
    ``launch/dryrun.py``)."""
    which = route(q.dtype, q.shape[-1])
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    bsz, h, sq, d = q.shape
    skv = k.shape[2]
    out = _output(q)
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if which == "sm90":
            layout = sm90_plan(q, k, v)
            q, k, v = _pack(lib, layout, (q, k, v), stream)
            rc = lib.weld_flash_attention_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _stride_array(q, k, v, out), _plan_array(layout), bsz, h,
                group, sq, skv, d, int(causal), scale, stream)
        else:
            # v1 takes any strides of a unit-stride D
            q, k, v = (t if t.stride(-1) == 1 or d == 1 else t.contiguous()
                       for t in (q, k, v))
            rc = lib.weld_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _stride_array(q, k, v, out), bsz, h, group, sq, skv, d,
                int(causal), scale, stream)
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


def _stride_array(*ts: torch.Tensor):
    """The (batch, head, seq) element strides of each operand, as the C
    entries take them."""
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(s for t in ts for s in _strides(t)))


def _plan_array(layout: Sm90Plan):
    """``layout`` as the C entry takes it: the three maps' widths, DP, the
    kv rows of a tile and the block's shared memory (the entry refuses a
    plan its own layout disagrees with)."""
    return (ctypes.c_int * 6)(*layout.dims0, layout.dp, layout.kv_rows,
                              layout.smem_bytes)


def _pack(lib, layout: Sm90Plan, ops, stream) -> tuple:
    """q, k, v with each operand that ``layout`` packs replaced by its
    zero-padded (B, H, S, :func:`packed_width`) copy, written by one
    launch of the packing pass (counted in ``.launches_pack``)."""
    if not any(layout.pack):
        return tuple(ops)
    bsz, d = ops[0].shape[0], ops[0].shape[-1]
    width = packed_width(d)
    got, desc = [], []
    for t, pack in zip(ops, layout.pack):
        if not pack:
            got.append(t)
            continue
        dst = torch.empty((*t.shape[:3], width), dtype=t.dtype,
                          device=t.device)
        desc += [t.data_ptr(), dst.data_ptr(), t.shape[1], t.shape[2],
                 *t.stride()]
        got.append(dst)
    rc = lib.weld_flash_attention_pack(
        len(desc) // 8, (ctypes.c_longlong * len(desc))(*desc), bsz, d,
        width, stream)
    _build.check(rc, "flash_attention packing launch")
    _count.bump(flash_attention, "launches_pack")
    return tuple(got)


def _output(q: torch.Tensor) -> torch.Tensor:
    """The (B, H, Sq, D) output of a (B, H, Sq, D) q: a view of
    (B, Sq, H, D) storage (the layout the kernels write)."""
    bsz, h, sq, d = q.shape
    return torch.empty((bsz, sq, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


_kernel_op = torch.library.custom_op("weld::flash_attention", _kernel,
                                     mutates_args=())


@_kernel_op.register_fake
def _(q, k, v, causal, group, scale):
    out = _output(q if q.ndim == 4 else q[None])
    return out if q.ndim == 4 else out[0]


def attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """(q, kv) pairs the mask leaves, per (batch, head): the causal mask
    aligns the Sq rows to the last Sq of the Skv positions
    (``Sq <= Skv``)."""
    if not causal:
        return sq * skv
    return sq * (skv - sq) + sq * (sq + 1) // 2


@register_flop_formula(torch.ops.weld.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, group, scale, *args,
           out_shape=None, **kwargs) -> int:
    """4 D FLOPs a (q, kv) pair the mask leaves (2 D for q . k, 2 D for
    p . v), for every (batch, head)."""
    *lead, h, sq, d = q_shape
    bsz = lead[0] if lead else 1
    return 4 * bsz * h * d * attention_pairs(sq, k_shape[-2], causal)


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.launches_pack = 0
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
