"""MoE token routing as a Weld program on the port's runtime.

The MoE layer (``models/moe.py``) lowers its dispatch and combine to a
stable sort by expert, ranks from ``searchsorted`` and a fixed-order sum
by token.  The same routing in Weld's builder vocabulary, evaluated by
``repro_torch.core`` on the default device:

* dispatch — a ``groupbuilder`` of the token slots by expert id (each
  group in slot order); an expert keeps the first ``cap`` of its group;
* combine — a ``vecmerger`` that merges each kept slot's gate-weighted
  expert output into its token's row.

``examples/moe_weld_routing_torch.py`` runs it against the layer, and
``tests/test_torch_moe_routing.py`` holds it to the layer's buckets,
kept-slot mask and output.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core import ir, macros as M
from ..core.lazy import Evaluate, NewWeldObject


def _ident(obj):
    return ir.Ident(obj.obj_id, obj.weld_type())


def weld_dispatch(flat_ids: np.ndarray, n_experts: int) -> Dict[int,
                                                                List[int]]:
    """groupbuilder: {expert: [slot, ...]} in slot order."""
    ids_o = NewWeldObject(flat_ids.astype(np.int64), None)
    slot_o = NewWeldObject(np.arange(flat_ids.size, dtype=np.int64), None)
    groups = M.group_vals(_ident(ids_o), _ident(slot_o), capacity=n_experts)
    return Evaluate(NewWeldObject([ids_o, slot_o], groups)).value


def weld_combine(n_rows: int, rows: np.ndarray,
                 vals: np.ndarray) -> np.ndarray:
    """vecmerger: zeros(n_rows) with vals[i] merged into rows[i]."""
    base_o = NewWeldObject(np.zeros(n_rows), None)
    idx_o = NewWeldObject(rows.astype(np.int64), None)
    val_o = NewWeldObject(vals.astype(np.float64), None)
    merged = M.scatter_add(_ident(base_o), _ident(idx_o), _ident(val_o))
    return np.asarray(Evaluate(NewWeldObject([base_o, idx_o, val_o],
                                             merged)).value)


def weld_moe(moe, x: torch.Tensor):
    """The layer ``moe`` (a ``models.moe.Moe`` of a config without shared
    experts, f64) applied to ``x`` (B, T, d) with its dispatch and
    combine run as the Weld programs above: the layer's own routing
    (``moe.route``) and experts, the Weld groups and combine.  Returns
    ``(routing, groups, out)``, ``out`` (B, T, d) as numpy."""
    b, t, d = x.shape
    xt = x.reshape(-1, d)
    with torch.inference_mode():
        r = moe.route(xt)
    k = r.ids.shape[-1]
    e = moe.experts.wi.shape[0]
    groups = weld_dispatch(r.ids.reshape(-1).cpu().numpy(), e)
    # the buckets the groups give, through the layer's experts
    buckets = torch.zeros((e, r.cap, d), dtype=x.dtype, device=x.device)
    for ex, slots in groups.items():
        for rank, slot in enumerate(slots[:r.cap]):
            buckets[ex, rank] = xt[slot // k]
    with torch.inference_mode():
        outs = moe.experts(buckets).cpu().numpy()
    # combine: each kept slot's gated output merged into its token's row
    gates = r.gates.reshape(-1).cpu().numpy()
    rows, vals = [], []
    for ex, slots in groups.items():
        for rank, slot in enumerate(slots[:r.cap]):
            rows.append((slot // k) * d + np.arange(d))
            vals.append(outs[ex, rank] * gates[slot])
    out = weld_combine(b * t * d, np.concatenate(rows), np.concatenate(vals))
    return r, groups, out.reshape(b, t, d)
