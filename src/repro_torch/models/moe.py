"""Mixture-of-Experts layer (deepseek-moe / dbrx) with capacity-bounded
sort-based dispatch — the port of the JAX package's ``models/moe.py``.

The dispatch and combine are Weld's groupbuilder and vecmerger: token
slots grouped by expert id into buckets of ``cap`` rows, the experts'
outputs weighted by their gates and summed back into the tokens.
``tests/test_torch_moe_routing.py`` writes the same routing as a Weld
program and evaluates it on the port's runtime.  Here it runs as the
reference's static-shape lowering (a stable sort by expert, ranks from
``searchsorted``) with two changes that give the same values:

* dispatch: the reference scatter-adds every slot into its bucket, the
  dropped ones as zeros onto their expert's rank-0 row.  Each kept slot
  is alone in its bucket, so the port writes the rows (the dropped ones
  into a spare row that is never read).
* combine: the reference scatter-adds each slot's weighted output into
  its token (float atomics on a card, whose order changes from run to
  run).  Every token has exactly ``top_k`` slots, so the port gathers
  them by token and sums them in a fixed order — the order the
  reference's scatter takes them on the CPU, by expert id — with no
  atomics: two runs are bitwise equal.

The expert SwiGLU is a batched product (``torch.matmul`` over the expert
axis), as the reference's is an einsum outside any Pallas kernel.
Parameter names and shapes are the reference's: ``router`` (d, E) in
f32, ``experts.{wi,wg}`` (E, d, f), ``experts.wo`` (E, f, d), and the
same for ``shared`` when the config has shared experts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers as L


class ExpertFfn(L.Initialised):
    """``n`` SwiGLU experts of width ``d_ff`` side by side."""

    SPECS = {"wi": (L.EXPERTS, L.EMBED, L.MLP),
             "wg": (L.EXPERTS, L.EMBED, L.MLP),
             "wo": (L.EXPERTS, L.MLP, L.EMBED)}

    def __init__(self, cfg, n: int, d_ff: int):
        super().__init__()
        dt = cfg.p_dtype
        self.wi = L._param((n, cfg.d_model, d_ff), dt)
        self.wg = L._param((n, cfg.d_model, d_ff), dt)
        self.wo = L._param((n, d_ff, cfg.d_model), dt)
        self.INIT = {"wi": cfg.d_model, "wg": cfg.d_model, "wo": d_ff}

    def forward(self, x):
        """x: (E, C, d) bucketed tokens -> (E, C, d)."""
        h = torch.matmul(x, self.wi.to(x.dtype))
        g = torch.matmul(x, self.wg.to(x.dtype))
        return torch.matmul(F.silu(g) * h, self.wo.to(x.dtype))


class Routing(NamedTuple):
    """Where a layer's N·k token slots go.  Slot s of ``order`` is token
    ``tok_idx[s]``'s choice of expert ``ids.view(-1)[order[s]]``, kept when
    ``keep[s]``, in bucket row ``bucket_idx[s]``."""
    gates: torch.Tensor       # (N, k) f32, renormalised top-k probabilities
    ids: torch.Tensor         # (N, k) int64, expert ids, descending gate
    order: torch.Tensor       # (N·k,) slots stably sorted by expert id
    keep: torch.Tensor        # (N·k,) bool, rank within the expert < cap
    bucket_idx: torch.Tensor  # (N·k,) expert · cap + rank (0 if dropped)
    tok_idx: torch.Tensor     # (N·k,) the slot's token
    cap: int
    aux: torch.Tensor         # () f32 switch-style load-balance loss


def capacity(cfg, n_tok: int) -> int:
    """Bucket rows an expert takes: capacity_factor · N · k / E, rounded
    half up, at least 4 (the reference's Python arithmetic)."""
    cap = int(cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts + 0.5)
    return max(cap, 4)


class Moe(L.Initialised):
    SPECS = {"router": (L.EMBED, L.EXPERTS)}

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.router = L._param((cfg.d_model, cfg.n_experts), torch.float32)
        self.experts = ExpertFfn(cfg, cfg.n_experts, cfg.expert_d_ff)
        if cfg.n_shared_experts:
            self.shared = ExpertFfn(cfg, cfg.n_shared_experts,
                                    cfg.expert_d_ff)

    def route(self, xt, ids=None) -> Routing:
        """The router in f32, top-k, and each slot's bucket.  xt: (N, d).
        ``ids`` (N, k), if given, are the experts chosen instead of the
        top-k (their gates the router's probabilities there): a caller
        that holds two paths to one routing."""
        cfg = self.cfg
        n_tok = xt.shape[0]
        e, k = cfg.n_experts, cfg.top_k
        cap = capacity(cfg, n_tok)
        logits = torch.matmul(xt.float(), self.router.float())
        probs = torch.softmax(logits, dim=-1)
        if ids is None:
            gates, ids = torch.topk(probs, k, dim=-1, sorted=True)
        else:
            gates = torch.gather(probs, 1, ids)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        # load-balance aux (switch-style)
        me = probs.mean(dim=0)
        ce = F.one_hot(ids[:, 0], e).float().mean(dim=0)
        aux = e * torch.sum(me * ce)
        # dispatch: token slots sorted by expert, bounded by capacity
        flat_ids = ids.reshape(-1)
        order = torch.argsort(flat_ids, stable=True)
        sorted_ids = flat_ids[order]
        seg_starts = torch.searchsorted(
            sorted_ids, torch.arange(e, device=xt.device), side="left")
        rank = torch.arange(n_tok * k, device=xt.device) \
            - seg_starts[sorted_ids]
        keep = rank < cap
        bucket_idx = sorted_ids * cap + torch.where(keep, rank, 0)
        return Routing(gates, ids, order, keep, bucket_idx, order // k, cap,
                       aux)

    def forward(self, x):
        """x: (B, T, d).  Returns (out, aux)."""
        cfg = self.cfg
        b, t, d = x.shape
        n_tok, k = b * t, cfg.top_k
        xt = x.reshape(n_tok, d)
        r = self.route(xt)
        # dropped slots go to one spare row past the buckets (any of them
        # may land there; it is never read): no host sync on a count
        rows = cfg.n_experts * r.cap
        buckets = x.new_zeros((rows + 1, d))
        buckets[torch.where(r.keep, r.bucket_idx, rows)] = xt[r.tok_idx]
        outs = self.experts(buckets[:rows].view(cfg.n_experts, r.cap, d)) \
            .reshape(rows, d)
        # combine: slot s's weighted output, summed by token in a fixed order
        slot_gate = r.gates.reshape(-1)[r.order]
        contrib = outs[r.bucket_idx] * torch.where(
            r.keep, slot_gate, 0.0)[:, None].to(x.dtype)
        inv = torch.empty_like(r.order)
        inv[r.order] = torch.arange(n_tok * k, device=x.device)
        per_tok = contrib[inv].view(n_tok, k, d)   # token i's slots, top-k
        by_expert = torch.argsort(r.ids, dim=1, stable=True)
        per_tok = per_tok.gather(1, by_expert[..., None].expand(-1, -1, d))
        combined = per_tok[:, 0]
        for j in range(1, k):
            combined = combined + per_tok[:, j]
        out = combined.view(b, t, d)
        if cfg.n_shared_experts:
            sh = self.shared(xt.expand(cfg.n_shared_experts, n_tok, d))
            out = out + sh.sum(0).view(b, t, d)
        return out, r.aux
