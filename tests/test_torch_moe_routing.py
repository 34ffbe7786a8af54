"""MoE token routing as a Weld program on the port's runtime — the port's
counterpart of ``examples/moe_weld_routing.py``.

The MoE layer (``repro_torch.models.moe``) lowers its dispatch and
combine to a stable sort by expert, ranks from ``searchsorted`` and a
fixed-order sum by token.  The same routing written in Weld's builder
vocabulary and evaluated on ``repro_torch.core``:

* dispatch — a ``groupbuilder`` of the token slots by expert id (each
  group in slot order); an expert keeps the first ``cap`` of its group;
* combine — a ``vecmerger`` that merges each kept slot's gate-weighted
  expert output into its token's row;

must give the layer's buckets, kept-slot mask and output on the same ids
and gates: the groups equal the sorted slots exactly, the output to
1e-12 of its largest |value| (f64; the two sum each token's slots in
other orders).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core import ir, macros as M
from repro_torch.core.lazy import Evaluate, NewWeldObject
from repro_torch.models import build_model


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


def _ident(obj):
    return ir.Ident(obj.obj_id, obj.weld_type())


def _layer(capacity_factor, seed):
    """dbrx's smoke MoE layer in f64 (no shared experts: the layer's
    output is the routed combine alone), parameters from a seed."""
    cfg = dataclasses.replace(get_config("dbrx-132b", smoke=True),
                              dtype="float64", param_dtype="float64",
                              capacity_factor=capacity_factor)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed))
    return cfg, model._bind(params).moe_layers[0].mlp


def weld_dispatch(flat_ids: np.ndarray, n_experts: int) -> dict:
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


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_weld_routing_equals_the_layer(capacity_factor, seed):
    cfg, moe = _layer(capacity_factor, seed)
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    x = torch.from_numpy(np.random.RandomState(seed + 10).randn(
        2, 24, d))
    xt = x.reshape(-1, d)
    n_tok = xt.shape[0]
    with torch.inference_mode():
        r = moe.route(xt)
        want, _ = moe(x)
    flat_ids = r.ids.reshape(-1).numpy()

    # dispatch: each expert's group, in slot order; the first cap kept
    groups = weld_dispatch(flat_ids, e)
    order, keep = r.order.numpy(), r.keep.numpy()
    starts = np.searchsorted(flat_ids[order], np.arange(e + 1))
    dropped = 0
    for ex in range(e):
        got = groups.get(ex, [])
        np.testing.assert_array_equal(got, order[starts[ex]:starts[ex + 1]])
        kept = keep[starts[ex]:starts[ex + 1]]
        assert kept.sum() == min(len(got), r.cap)
        assert kept[:r.cap].all() and not kept[r.cap:].any()
        dropped += len(got) - kept.sum()
    if capacity_factor < 1:
        assert dropped > 0, "no slot dropped: the case tests nothing"

    # the buckets the groups give, through the layer's experts
    buckets = torch.zeros((e, r.cap, d), dtype=x.dtype)
    for ex, slots in groups.items():
        for rank, slot in enumerate(slots[:r.cap]):
            buckets[ex, rank] = xt[slot // k]
    with torch.inference_mode():
        outs = moe.experts(buckets).numpy()

    # combine: each kept slot's gated output merged into its token's row
    gates = r.gates.reshape(-1).numpy()
    rows, vals = [], []
    for ex, slots in groups.items():
        for rank, slot in enumerate(slots[:r.cap]):
            rows.append((slot // k) * d + np.arange(d))
            vals.append(outs[ex, rank] * gates[slot])
    got = weld_combine(n_tok * d, np.concatenate(rows),
                       np.concatenate(vals)).reshape(x.shape)
    scale = float(want.abs().max())
    assert float(np.abs(got - want.numpy()).max()) <= 1e-12 * scale
