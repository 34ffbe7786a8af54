"""MoE token routing as a Weld program on the port's runtime — the port's
counterpart of ``examples/moe_weld_routing.py``.

The MoE layer (``repro_torch.models.moe``) lowers its dispatch and
combine to a stable sort by expert, ranks from ``searchsorted`` and a
fixed-order sum by token.  The same routing written in Weld's builder
vocabulary and evaluated on ``repro_torch.core``
(``repro_torch.models.weld_routing``, which
``examples/moe_weld_routing_torch.py`` runs too):

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
from repro_torch.models import build_model
from repro_torch.models.weld_routing import weld_moe


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


def _layer(capacity_factor, seed):
    """dbrx's smoke MoE layer in f64 (no shared experts: the layer's
    output is the routed combine alone), parameters from a seed."""
    cfg = dataclasses.replace(get_config("dbrx-132b", smoke=True),
                              dtype="float64", param_dtype="float64",
                              capacity_factor=capacity_factor)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed))
    return cfg, model._bind(params).moe_layers[0].mlp


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_weld_routing_equals_the_layer(capacity_factor, seed):
    cfg, moe = _layer(capacity_factor, seed)
    e, d = cfg.n_experts, cfg.d_model
    x = torch.from_numpy(np.random.RandomState(seed + 10).randn(
        2, 24, d))
    with torch.inference_mode():
        want, _ = moe(x)
    r, groups, got = weld_moe(moe, x)
    flat_ids = r.ids.reshape(-1).numpy()

    # dispatch: each expert's group, in slot order; the first cap kept
    order, keep = r.order.numpy(), r.keep.numpy()
    starts = np.searchsorted(flat_ids[order], np.arange(e + 1))
    dropped = 0
    for ex in range(e):
        grp = groups.get(ex, [])
        np.testing.assert_array_equal(grp, order[starts[ex]:starts[ex + 1]])
        kept = keep[starts[ex]:starts[ex + 1]]
        assert kept.sum() == min(len(grp), r.cap)
        assert kept[:r.cap].all() and not kept[r.cap:].any()
        dropped += len(grp) - kept.sum()
    if capacity_factor < 1:
        assert dropped > 0, "no slot dropped: the case tests nothing"

    # combine: the layer's output
    scale = float(want.abs().max())
    assert float(np.abs(got - want.numpy()).max()) <= 1e-12 * scale
