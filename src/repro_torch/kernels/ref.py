"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same
result dtype (the input's, as the TPU kernels keep it).  The wrappers in
the kernel modules run these for tensors that lie on the CPU; on the
card they are what a kernel is held against.  The join's versions (``hash_to_slot``,
``dict_probe``, ``group_probe``, ``group_build``) are sort and
searchsorted based, as the reference's are."""
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


_INT64_MAX = torch.iinfo(torch.int64).max


def _sorted_runs(keys: torch.Tensor, empty: int):
    """Sort the valid keys (``!= empty``) stably; return the order, the
    sorted keys (invalid ones as INT64_MAX), the sorted validity, each
    row's run id in sorted order and the run-start mask."""
    valid = keys != empty
    pk = torch.where(valid, keys, torch.full_like(keys, _INT64_MAX))
    order = torch.argsort(pk, stable=True)
    sk = pk[order]
    sval = valid[order]
    is_new = torch.cat([sval[:1], (sk[1:] != sk[:-1]) & sval[1:]])
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
    return order, sk, sval, seg, is_new


def hash_to_slot(keys: torch.Tensor, cap_table: int):
    """Sort-based slot assignment: equal keys share a slot, distinct keys
    get distinct slots, numbered as ascending-key compact ids (the CUDA
    kernel numbers by hash position; only the contract in
    ``hash_table`` is shared).  Returns (slots int32, table int64,
    used int32), ``used`` uncapped."""
    from .hash_table import EMPTY

    dev = keys.device
    n = keys.shape[0]
    table = torch.full((cap_table + 1,), EMPTY, dtype=torch.int64, device=dev)
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                table[:cap_table], torch.zeros((), dtype=torch.int32,
                                               device=dev))
    keys = keys.to(torch.int64)
    order, sk, sval, seg, is_new = _sorted_runs(keys, EMPTY)
    seg = torch.where(sval & (seg < cap_table), seg,
                      torch.full_like(seg, cap_table))
    slots = torch.empty((n,), dtype=torch.int32, device=dev).scatter_(
        0, order, seg.to(torch.int32))
    used = is_new.sum().to(torch.int32)
    # rows that start no run, and runs past the table, land in the extra
    # slot, which is cut off
    at = torch.where(is_new, seg, torch.full_like(seg, cap_table))
    table.scatter_(0, at, torch.where(is_new, sk, torch.full_like(sk, EMPTY)))
    return slots, table[:cap_table], used


def _search(table_keys: torch.Tensor, count, queries: torch.Tensor):
    """Binary search of each query among the first ``count`` keys (the
    tail neutralized to INT64_MAX): clipped positions and the hit mask."""
    cap = table_keys.shape[0]
    dev = table_keys.device
    cnt = torch.as_tensor(count, device=dev).to(torch.int64)
    neut = torch.where(torch.arange(cap, device=dev) < cnt,
                       table_keys.to(torch.int64),
                       torch.full((cap,), _INT64_MAX, dtype=torch.int64,
                                  device=dev))
    q = queries.to(torch.int64)
    pos = torch.clamp(torch.searchsorted(neut, q), 0, cap - 1)
    found = (neut[pos] == q) & (pos < cnt)
    return pos, found


def dict_probe(table_keys: torch.Tensor, count, queries: torch.Tensor):
    """(pos int32, found bool) of each query in the sorted, front-packed
    first ``count`` table keys; pos is 0 on a miss."""
    n = queries.shape[0]
    dev = queries.device
    if n == 0 or table_keys.shape[0] == 0:
        return (torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.bool, device=dev))
    pos, found = _search(table_keys, count, queries)
    return torch.where(found, pos, 0).to(torch.int32), found


def group_probe(table_keys: torch.Tensor, offsets: torch.Tensor, count,
                queries: torch.Tensor):
    """dict_probe plus each matching group's size off the CSR offsets
    (0 on a miss): (pos int32, found bool, sizes int32)."""
    n = queries.shape[0]
    dev = queries.device
    if n == 0 or table_keys.shape[0] == 0:
        z = torch.zeros((n,), dtype=torch.int32, device=dev)
        return z, torch.zeros((n,), dtype=torch.bool, device=dev), z
    pos, found = _search(table_keys, count, queries)
    offs = offsets.to(torch.int64)
    sizes = (offs[1:] - offs[:-1])[pos]
    return (torch.where(found, pos, 0).to(torch.int32), found,
            torch.where(found, sizes, 0).to(torch.int32))


def slot_hist(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """out[s] = #{i: slots[i] == s} as int32; ids outside
    [0, num_slots) are not counted."""
    keep = (slots >= 0) & (slots < num_slots)
    idx = torch.where(keep, slots, torch.zeros_like(slots)).to(torch.int64)
    out = torch.zeros((num_slots,), dtype=torch.int32, device=slots.device)
    return out.scatter_add_(0, idx, keep.to(torch.int32))


def group_build(keys: torch.Tensor, capacity: int):
    """Sort-based CSR group build: (cslots int32, offsets int32 (cap+1,),
    used int32).  Equal keys share an ascending-key compact slot; rows
    equal to EMPTY, and keys past the capacity, park at ``capacity``;
    ``used`` counts the distinct valid keys (``used > capacity`` is
    overflow)."""
    from .hash_table import EMPTY

    cap = int(capacity)
    dev = keys.device
    n = keys.shape[0]
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((cap + 1,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    keys = keys.to(torch.int64)
    order, sk, sval, seg, is_new = _sorted_runs(keys, EMPTY)
    seg = torch.where(sval & (seg < cap), seg, torch.full_like(seg, cap))
    cslots = torch.empty((n,), dtype=torch.int32, device=dev).scatter_(
        0, order, seg.to(torch.int32))
    counts = torch.bincount(seg, minlength=cap + 1)[:cap]
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    return cslots, offsets, is_new.sum().to(torch.int32)


def filter_reduce_q6(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     val: torch.Tensor) -> torch.Tensor:
    """sum(val where all(lo[k] <= cols[k] < hi[k])) as a 0-dim tensor of
    val's dtype; cols (K, n), lo/hi (K,), val (n,)."""
    keep = torch.all((cols >= lo[:, None]) & (cols < hi[:, None]), dim=0)
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    return torch.where(keep, val, zero).sum(dtype=val.dtype)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B in the operands' own dtype (no TF32: the reference
    keeps full f32)."""
    return torch.matmul(a, b)


def map_elementwise(fn, arrays):
    """``fn`` (a whole-column torch closure staged from the IR body)
    over the columns, broadcast to the first column's length."""
    n = arrays[0].shape[0]
    out = fn(*arrays)
    if out.ndim >= 1 and out.shape[0] == n:
        return out
    return torch.broadcast_to(out, (n,) + tuple(out.shape)).contiguous()


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """kv head j serves q heads j * group .. j * group + group - 1."""
    return x.repeat_interleave(group, dim=-3) if group > 1 else x


def attention_weights(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, group: int = 1,
                      scale=None) -> torch.Tensor:
    """The f32 softmax weights (..., H, Sq, Skv) of ``attention``."""
    sq, d = q.shape[-2:]
    scale = float(scale if scale is not None else d ** -0.5)
    k = _repeat_kv(k, group)
    s = torch.einsum("...hqd,...hkd->...hqk", q.float(), k.float()) * scale
    skv = k.shape[-2]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kj = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(kj <= qi, s, torch.tensor(-1e30, device=q.device))
    return torch.softmax(s, dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, group: int = 1, scale=None) -> torch.Tensor:
    """Dense attention: q (..., H, Sq, D), k/v (..., H // group, Skv, D),
    scores and softmax in f32, the causal mask aligned to the last Sq kv
    positions; the result in q's dtype."""
    p = attention_weights(q, k, causal=causal, group=group, scale=scale)
    return torch.einsum("...hqk,...hkd->...hqd", p,
                        _repeat_kv(v, group).float()).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, group: int = 1, scale=None,
                      chunk: int = 1024) -> torch.Tensor:
    """``attention`` with O(Sq * chunk) live scores: an online softmax over
    kv chunks (running max, normaliser and f32 accumulator), kv padding
    masked.  Shapes as ``attention``."""
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    scale = float(scale if scale is not None else d ** -0.5)
    lead = q.shape[:-1]
    dev = q.device
    neg = torch.tensor(-1e30, device=dev)
    qf = q.float()
    qi = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    m = torch.full(lead, -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros(lead, dtype=torch.float32, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    for j0 in range(0, skv, chunk):
        kb = _repeat_kv(k[..., j0:j0 + chunk, :], group).float()
        vb = _repeat_kv(v[..., j0:j0 + chunk, :], group).float()
        pad = chunk - kb.shape[-2]
        if pad:  # the reference pads the last chunk with zeros
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
        s = torch.einsum("...hqd,...hkd->...hqk", qf, kb) * scale
        kj = j0 + torch.arange(chunk, device=dev)[None, :]
        s = torch.where(kj < skv, s, neg)
        if causal:
            s = torch.where(kj <= qi, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("...hqk,...hkd->...hqd",
                                                   p, vb)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def adamw_scalars(lr, step, b1: float, b2: float):
    """The f32 scalars of an AdamW step, as Python floats: lr, 1 - b1,
    1 - b2 (rounded from their double values, as a Python scalar in an
    f32 expression is) and the bias corrections c1 = 1 - b1**t and
    c2 = 1 - b2**t, computed in f32 as the reference's kernel does."""
    f32 = torch.float32
    t = torch.as_tensor(step, dtype=f32).cpu()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32), t)
    as_f32 = lambda x: float(torch.tensor(x, dtype=f32))  # noqa: E731
    return (float(torch.as_tensor(lr, dtype=f32).cpu()), as_f32(1.0 - b1),
            as_f32(1.0 - b2), float(c1), float(c2))


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, lr, step, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, wd: float = 0.01):
    """One AdamW step with bias correction, ``wd * p`` folded into the
    lr-scaled update: returns new (p in p's dtype, m, v in f32).  p and g
    may be bf16 or f32; the arithmetic is f32, one IEEE operation at a
    time (the divisions by c1 and c2 divide by a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal)."""
    lr, _, _, c1, c2 = adamw_scalars(lr, step, b1, b2)
    c1 = torch.tensor(c1, dtype=torch.float32, device=p.device)
    c2 = torch.tensor(c2, dtype=torch.float32, device=p.device)
    gf, pf = g.float(), p.float()
    m_new = b1 * m + (1.0 - b1) * gf
    v_new = b2 * v + (1.0 - b2) * gf * gf
    upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + wd * pf
    return (pf - lr * upd).to(p.dtype), m_new, v_new
