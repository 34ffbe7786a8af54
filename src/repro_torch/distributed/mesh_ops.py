"""What the models need of a mesh.  On a mesh the parameters are DTensors
placed by ``sharding``'s rules and the batch is ``Shard(0)`` over the
batch axes; DTensor's sharding propagation partitions the plain tensor
code, as GSPMD partitions the reference's.  The helpers here take over
where it cannot: a hand-written kernel takes local tensors
(:func:`attention`), routing by expert id has no sharding strategy
(:func:`expert_parallel`), and a masked partial sum may be reduced only
once (:func:`like`).  Off a mesh every helper is the identity or a plain
call, so the single-device path runs as it did.

Where the installed torch's DTensor cannot propagate an operation, the
helper here does it another way that runs on torch 2.11 and 2.13 alike
(:func:`batched`, :func:`pad`, :func:`cumsum`), never in the models.  Only :func:`mergeable`'s all-gather depends on the torch,
by a probe of DTensor's own rule decided once
(:func:`flattens_inner_shards`: true on 2.13, false on 2.11).
"""
from __future__ import annotations

import functools
import sys
from typing import Callable

import torch
import torch.nn.functional as F

from .sharding import BATCH_AXES


def is_dtensor(x) -> bool:
    # no DTensor exists before torch.distributed.tensor is imported (which
    # takes a second: the single-device path never imports it)
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local(x):
    """A DTensor's local tensor, or ``x`` itself off a mesh."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """A DTensor's whole value as a plain tensor (a collective), or ``x``
    itself off a mesh."""
    return x.full_tensor() if is_dtensor(x) else x


def like(x, ref):
    """``x`` redistributed to ``ref``'s placements (both DTensors on one
    mesh), or ``x`` as it is off a mesh."""
    if not is_dtensor(x):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def splittable(x, dim: int, outer: int):
    """``x`` ready for a reshape of its dimension ``dim`` into (outer, -1):
    as it is off a mesh or where every mesh dimension that shards ``dim``
    divides ``outer``; else with ``dim`` replicated over those mesh
    dimensions (an all-gather; DTensor cannot unflatten a shard that
    straddles the new outer dimension)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    sizes = x.device_mesh.mesh.shape
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and outer % sizes[i] else p for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                              pl)


def mergeable(x, first: int, last: int):
    """``x`` ready for a reshape that merges its dimensions first..last
    into one: as it is off a mesh, or where DTensor makes a strided shard
    of the result (:func:`flattens_inner_shards`); else each of those
    dimensions but the first that a mesh dimension shards is replicated
    there (an all-gather)."""
    if not is_dtensor(x) or flattens_inner_shards():
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard)
          and first < p.dim % x.ndim <= last % x.ndim else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                              pl)


@functools.cache
def flattens_inner_shards() -> bool:
    """Whether the installed torch's DTensor views a shard of an inner
    dimension of a merge as a strided shard of the result.  Torch 2.13
    does; 2.11 refuses the view ("Attempted to flatten multiple
    dimensions ... without redistribution"), and :func:`mergeable` then
    all-gathers first.  Decided once, by asking DTensor's view rule of a
    (2, 4) tensor sharded on its dimension 1 over 2 ranks."""
    try:
        from torch.distributed.tensor import Shard
        from torch.distributed.tensor._ops._view_ops import (
            propagate_shape_and_sharding, view_groups)

        _, out = propagate_shape_and_sharding(
            [Shard(1)], (2, 4), view_groups((2, 4), (8,)), (2,),
            strict_view=True)
    except RuntimeError:
        return False
    return type(out[0]).__name__ == "_StridedShard"


def batched(fn: Callable, args, dims, out_dims):
    """``fn(*args)``, where ``fn`` computes independently along the
    dimensions ``dims[i]`` of ``args[i]`` (the same logical batch
    dimensions, in one order, for every argument; ``None`` where an
    argument has none, as a tensor shared by every head) and returns
    them as its output's ``out_dims`` (one tuple an output where ``fn``
    returns a tuple).  Decode attention's einsums and the chunked scan
    of Mamba2 and mLSTM have (batch, head).

    On a mesh whose every sharded dimension of the arguments is one of
    their batch dimensions, ``fn`` runs under ``local_map`` on the local
    tensors, forward and backward, so that no DTensor rule of its
    operations is needed (torch 2.11 cannot flatten (batch, head) with
    the heads sharded, as einsums do, nor flip, as a cumulative sum's
    gradient does): each batch dimension stays sharded where it was, an
    argument without it (``None``) is replicated there, and nothing is
    gathered.  Where a mesh dimension shards another dimension (the
    head dimension, where the heads do not divide "model"), DTensor runs
    ``fn`` itself, which gathers nothing either.  A plain tensor among
    the arguments is taken as replicated."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def batch_dim(p, a, d):
        """Which of ``d`` (dimensions of ``a``) the placement ``p``
        shards, or None."""
        d = [None if x is None else x % a.ndim for x in d]
        if isinstance(p, Shard) and p.dim % a.ndim in d:
            return d.index(p.dim % a.ndim)
        return None

    if any(isinstance(p, Shard) and batch_dim(p, a, d) is None
           for a, d in zip(args, dims) if is_dtensor(a)
           for p in a.placements):
        return fn(*args)
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    args = [a if is_dtensor(a) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    several = not isinstance(out_dims[0], int)
    outs = out_dims if several else (out_dims,)
    in_pl = [[] for _ in args]
    out_pl = [[] for _ in outs]
    for i in range(mesh.ndim):
        js = {batch_dim(a.placements[i], a, d) for a, d in zip(args, dims)
              if isinstance(a.placements[i], Shard)}
        j = js.pop() if len(js) == 1 else None
        for a, d, pl in zip(args, dims, in_pl):
            pl.append(Replicate() if j is None or d[j] is None
                      else Shard(d[j] % a.ndim))
        for o, pl in zip(outs, out_pl):
            pl.append(Replicate() if j is None else Shard(o[j]))
    # a list is one output's placements (a tuple would be one per output)
    return local_map(fn, out_placements=tuple(out_pl) if several
                     else out_pl[0], in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def pad(x, pads):
    """``F.pad(x, pads)`` with zeros.  On a mesh the zeros are
    concatenated along each padded dimension (the same values; DTensor's
    ``cat`` keeps the other dimensions' shards, where torch 2.11's
    ``constant_pad_nd`` rule gives one placement and planning its
    redistribution on a 2-D mesh raises ``IndexError``)."""
    if not is_dtensor(x):
        return F.pad(x, pads)
    for k in range(len(pads) // 2):
        if not (pads[2 * k] or pads[2 * k + 1]):
            continue
        dim = x.ndim - 1 - k
        zero = torch.zeros_like(x.narrow(dim, 0, 1))

        def zeros(n):
            return [zero.expand(*x.shape[:dim], n, *x.shape[dim + 1:])] \
                if n else []
        x = torch.cat(zeros(pads[2 * k]) + [x] + zeros(pads[2 * k + 1]),
                      dim=dim)
    return x


def cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``.  Its gradient is the reversed cumulative
    sum, which autograd takes as ``flip``, ``cumsum``, ``flip``; torch
    2.11's DTensor has no rule for ``flip``, so on a mesh the gradient
    takes the same three operations on the local tensor, ``dim``
    replicated first where a mesh dimension shards it (the same
    values)."""
    if not is_dtensor(x):
        return torch.cumsum(x, dim)
    return _CumSum.apply(x, dim)


class _CumSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim % x.ndim
        return torch.cumsum(x, dim)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        dim = ctx.dim
        if grad.shape[dim] == 1:   # autograd's own trivial case
            return grad, None
        pl = [Replicate() if isinstance(p, Shard) and p.dim % grad.ndim
              == dim else p for p in grad.placements]
        if pl != list(grad.placements):
            grad = grad.redistribute(grad.device_mesh, pl)
        out = grad.to_local().flip(dim).cumsum(dim).flip(dim)
        return DTensor.from_local(out, grad.device_mesh, grad.placements,
                                  run_check=False, shape=grad.shape,
                                  stride=grad.stride()), None


def grad_splittable(x, dim: int, outer: int):
    """``x``, whose gradient comes back :func:`splittable` (identity off a
    mesh): put it after a reshape that merged ``dim`` from (outer, -1),
    whose backward splits the gradient's ``dim`` again."""
    return _GradSplittable.apply(x, dim, outer) if is_dtensor(x) else x


class _GradSplittable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, outer):
        ctx.dim, ctx.outer = dim, outer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return splittable(grad, ctx.dim, ctx.outer), None, None


def attention(fn: Callable, q, k, v):
    """``fn(q, k, v)`` (an attention over (B, H, S, D) tensors) on each
    rank's local tensors: the batch ``Shard(0)`` over the batch axes, the
    heads ``Shard(1)`` over "model" when both q's and k's head counts
    divide it (the GQA group is then the same on every rank), else
    replicated over "model" (the reference's ``head_dim`` fallback: an
    all-gather, the same result).  The backward runs on the same local
    tensors.  No DTensor reaches ``fn``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    heads = [q.shape[1], k.shape[1]]
    pl = []
    for name, size in zip(mesh.mesh_dim_names, mesh.mesh.shape):
        if name in BATCH_AXES:
            pl.append(Shard(0))
        elif name == "model" and all(h % size == 0 for h in heads):
            pl.append(Shard(1))
        else:
            pl.append(Replicate())

    def local(q, k, v):
        return fn(*(_LaidOutGrad.apply(t) for t in (q, k, v)))

    # a list is one output's placements (a tuple would be one per output)
    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


class _LaidOutGrad(torch.autograd.Function):
    """The identity, whose gradient comes back in its input's memory
    layout.  Attention takes (B, H, S, D) views of (B, S, H, D) tensors and
    gives (B, H, S, D) gradients; DTensor then views them as the global
    strides say, which a local tensor of another layout cannot follow."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.stride = x.shape, x.stride()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if grad.stride() == ctx.stride:
            return grad
        out = torch.empty_strided(ctx.shape, ctx.stride, dtype=grad.dtype,
                                  device=grad.device)
        return out.copy_(grad)


def _full_grad(placements) -> tuple:
    """The gradient placements of a local partial sum: each ``Partial``
    replaced by ``Replicate``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in placements)


class _Reduced(torch.autograd.Function):
    """Local partial sums -> a DTensor at ``out`` placements; the local
    gradient is the whole gradient of the sum (it does not depend on the
    DTensor version's handling of a ``Partial`` gradient)."""

    @staticmethod
    def forward(ctx, local, mesh, partial, out):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.partial = mesh, partial
        d = DTensor.from_local(local, mesh, partial, run_check=False)
        return d.redistribute(mesh, out)

    @staticmethod
    def backward(ctx, grad):
        # contiguous: the local code's views (``.view``) take it back
        return (grad.redistribute(ctx.mesh, _full_grad(ctx.partial))
                .to_local().contiguous(), None, None, None)


def reduced(local: torch.Tensor, mesh, partial, out):
    """The DTensor of ``local``, a partial sum placed ``partial`` (some
    mesh dimensions ``Partial()``), reduced to ``out`` placements."""
    return _Reduced.apply(local, mesh, tuple(partial), tuple(out))


def embedding(tokens, table):
    """``F.embedding(tokens, table)``.  On a mesh whose "model" axis holds
    the vocab (``table`` ``Shard(0)`` there), each rank looks up the ids
    of its own rows, zeros elsewhere, and the partial sums are reduced to
    the tokens' placements (DTensor's masked partial sum would be, but may
    be reduced only once and not from a partial gradient)."""
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard

    if Shard(0) not in table.placements:
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    vdim = table.placements.index(Shard(0))
    tok_pl = list(tokens.placements)
    tok_pl[vdim] = Replicate()
    tl = tokens.redistribute(mesh, tok_pl).to_local()
    # the table's gradient from this rank's tokens: partial over the mesh
    # dimensions that split the batch
    grad_pl = [Partial() if isinstance(t, Shard) and p.is_replicate()
               else p for t, p in zip(tok_pl, table.placements)]
    wl = table.to_local(grad_placements=grad_pl)
    n = wl.shape[0]
    lo = mesh.get_local_rank(vdim) * n
    inside = (tl >= lo) & (tl < lo + n)
    e = F.embedding(torch.where(inside, tl - lo, 0), wl) \
        * inside[..., None].to(wl.dtype)
    part = list(tok_pl)
    part[vdim] = Partial()
    return reduced(e, mesh, part, tokens.placements)


def expert_parallel(fn: Callable, x, router, weights):
    """A mixture of experts with its experts on "model" (expert
    parallelism).  ``fn(x, router, weights, e0, first)`` is the layer on
    local tensors: x (B, T, d) every token, the router whole, ``weights``
    each rank's own shards of the expert weights (their first local
    expert ``e0``), returning (out, aux) where out sums only the local
    experts' slots and aux counts on the ``first`` rank of "model" only.

    The tokens are gathered over the batch axes (the routing and each
    expert's capacity are the global batch's, as the reference's) and
    replicated over "model"; each rank computes its own experts' slots,
    so out and aux are ``Partial(sum)`` over "model" and are reduced to
    x's placements (aux replicated).  The gradients of x and the router
    are partial over "model" too."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    nd = len(names)
    mdim = names.index("model") if "model" in names else None
    rep = (Replicate(),) * nd
    part = tuple(Partial() if i == mdim else Replicate() for i in range(nd))
    xl = x.redistribute(mesh, rep).to_local(grad_placements=part)
    rl = router.redistribute(mesh, rep).to_local(grad_placements=part)
    local = {k: w.to_local() for k, w in weights.items()}
    e0, first = 0, True
    if mdim is not None:
        rank = mesh.get_local_rank(mdim)
        first = rank == 0
        wi = weights["experts.wi"]
        if wi.placements[mdim] == Shard(0):
            e0 = rank * local["experts.wi"].shape[0]
    out, aux = fn(xl, rl, local, e0, first)
    return reduced(out, mesh, part, x.placements), reduced(aux, mesh, part,
                                                           rep)
