"""What the models need of a mesh.  On a mesh the parameters are DTensors
placed by ``sharding``'s rules and the batch is ``Shard(0)`` over the
batch axes; DTensor's sharding propagation partitions the plain tensor
code, as GSPMD partitions the reference's.  The helpers here take over
where it cannot: a hand-written kernel takes local tensors
(:func:`attention`), routing by expert id has no sharding strategy
(:func:`expert_parallel`), and a masked partial sum may be reduced only
once (:func:`like`).  Off a mesh every helper is the identity or a plain
call, so the single-device path runs as it did.
"""
from __future__ import annotations

from typing import Callable

import sys

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
