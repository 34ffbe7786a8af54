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

from ..distributed import mesh_ops
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
        return swiglu(x, self.wi, self.wg, self.wo)


def swiglu(x, wi, wg, wo):
    """Experts side by side: x (E, C, d), wi and wg (E, d, f), wo (E, f, d)."""
    h = torch.matmul(x, wi.to(x.dtype))
    g = torch.matmul(x, wg.to(x.dtype))
    return torch.matmul(F.silu(g) * h, wo.to(x.dtype))


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
        """:meth:`route_on` the layer's own router."""
        return self.route_on(xt, self.router, ids)

    def route_on(self, xt, router, ids=None) -> Routing:
        """The router in f32, top-k, and each slot's bucket.  xt: (N, d).
        ``ids`` (N, k), if given, are the experts chosen instead of the
        top-k (their gates the router's probabilities there): a caller
        that holds two paths to one routing.  ``router`` (d, E) is the
        layer's own, or a rank's whole copy of it on a mesh."""
        cfg = self.cfg
        n_tok = xt.shape[0]
        e, k = cfg.n_experts, cfg.top_k
        cap = capacity(cfg, n_tok)
        logits = torch.matmul(xt.float(), router.float())
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
        """x: (B, T, d).  Returns (out, aux).  On a mesh the experts run
        expert-parallel (``mesh_ops.expert_parallel``)."""
        weights = {f"{m}.{w}": getattr(getattr(self, m), w)
                   for m in ("experts", "shared") if hasattr(self, m)
                   for w in ("wi", "wg", "wo")}
        if mesh_ops.is_dtensor(x):
            return mesh_ops.expert_parallel(self._apply, x, self.router,
                                            weights)
        return self._apply(x, None, weights, 0, True)

    def _apply(self, x, router, weights, e0: int, first: bool):
        """The layer on plain tensors: every token of x (B, T, d), the
        router (d, E) whole (None: the layer's own, through
        :meth:`route`), and ``weights`` ("experts.wi", ...; the
        shared experts' too) of the experts from ``e0`` on — all of them
        on one device, one rank's shards on a mesh, where only the slots
        of its own experts are summed (the others are another rank's) and
        aux counts on the ``first`` rank only.  Returns (out, aux)."""
        cfg = self.cfg
        b, t, d = x.shape
        n_tok, k = b * t, cfg.top_k
        xt = x.reshape(n_tok, d)
        r = self.route(xt) if router is None else self.route_on(xt, router)
        n_local = weights["experts.wi"].shape[0]
        lo = e0 * r.cap
        # this rank's kept slots: bucket rows [lo, lo + n_local * cap)
        mine = r.keep & (r.bucket_idx >= lo) \
            & (r.bucket_idx < lo + n_local * r.cap)
        row = torch.where(mine, r.bucket_idx - lo, 0)
        # every other slot goes to one spare row past the buckets (never
        # read): no host sync on a count
        rows = n_local * r.cap
        buckets = x.new_zeros((rows + 1, d))
        buckets[torch.where(mine, row, rows)] = xt[r.tok_idx]
        outs = swiglu(buckets[:rows].view(n_local, r.cap, d),
                      weights["experts.wi"], weights["experts.wg"],
                      weights["experts.wo"]).reshape(rows, d)
        # combine: slot s's weighted output, summed by token in a fixed order
        slot_gate = r.gates.reshape(-1)[r.order]
        contrib = outs[row] * torch.where(
            mine, slot_gate, 0.0)[:, None].to(x.dtype)
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
            n_sh = weights["shared.wi"].shape[0]
            sh = swiglu(xt.expand(n_sh, n_tok, d), weights["shared.wi"],
                        weights["shared.wg"], weights["shared.wo"])
            out = out + sh.sum(0).view(b, t, d)
        return out, (r.aux if first else r.aux * 0.0)
