"""MoE token→expert routing expressed as a Weld program, on the PyTorch
port (the counterpart of ``examples/moe_weld_routing.py``).

The dispatch/combine pattern of a Mixture-of-Experts layer is exactly
Weld's builder vocabulary (DESIGN.md §3):

  * dispatch — group token ids by expert id: a `groupbuilder`;
  * combine  — scatter-add weighted expert outputs back into token
    slots: a `vecmerger`.

This example routes a batch of tokens through the Weld IR version and
checks it against the production MoE layer's sort-based dispatch
(``repro_torch/models/moe.py``), which is the static-shape lowering of
the same program: dbrx's smoke MoE layer in f64, the Weld programs of
``repro_torch.models.weld_routing`` evaluated on the CUDA card
(``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/moe_weld_routing_torch.py
"""
import argparse
import dataclasses

import numpy as np
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.device import default_device
from repro_torch.models import build_model
from repro_torch.models.weld_routing import weld_moe


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    repro_torch.set_default_device(args.device)
    dev = default_device()

    # no shared experts: the layer's output is the routed combine alone
    cfg = dataclasses.replace(get_config("dbrx-132b", smoke=True),
                              dtype="float64", param_dtype="float64")
    model = build_model(cfg)
    params = {k: v.to(dev) for k, v in
              model.init(torch.Generator().manual_seed(0)).items()}
    moe = model._bind(params).moe_layers[0].mlp
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 32, cfg.d_model)).to(dev)

    r, groups, got = weld_moe(moe, x)
    print("dispatch (groupbuilder) — tokens per expert:")
    for e in sorted(groups):
        kept = min(len(groups[e]), r.cap)
        print(f"  expert {e}: {len(groups[e])} tokens ({kept} kept, "
              f"capacity {r.cap})")
    order = r.order.cpu().numpy()
    flat = r.ids.reshape(-1).cpu().numpy()
    starts = np.searchsorted(flat[order], np.arange(cfg.n_experts + 1))
    for e in range(cfg.n_experts):
        np.testing.assert_array_equal(groups.get(e, []),
                                      order[starts[e]:starts[e + 1]])
    print("dispatch matches the layer's sort-based buckets ✓")

    with torch.inference_mode():
        want, aux = moe(x)
    want = want.cpu().numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-12 * scale
    print("combine (vecmerger) matches the layer's output ✓")
    print(f"production MoE layer: out {tuple(want.shape)}, aux load-balance "
          f"loss {float(aux):.4f}")
    print("same groupbuilder/vecmerger algorithm, lowered with static "
          f"capacities (sort + segment ops) on {dev}")


if __name__ == "__main__":
    main()
