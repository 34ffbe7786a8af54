"""How far a model's decode drifts from its prefill, and how far two
prefills of the same tokens drift apart, as a share of the largest
|logit|, by depth and dtype:

* decode: teacher-forced decode of a prompt's last ``--decode`` tokens
  after a prefill of the rest, against the prefill of the whole prompt
  (the last position);
* prefill: the prefill of the prefix alone against the same position
  inside the prefill of the whole prompt (no decode involved: only the
  products' shapes differ).

    python -m repro_torch.launch.decode_drift --arch xlstm-350m \\
        --layers 8 24 --dtype bfloat16 float32 --device cpu

Full width, weights drawn from ``--seed``, the depth cut to each of
``--layers``; batch 2.  Prints one line a (layers, dtype).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_config
from ..device import default_device, set_default_device
from ..models import build_model
from .serve import _pad_cache_to, prompt_batch


def drift(cfg, prompt: int, n_dec: int, seed: int, dev) -> tuple:
    """(decode drift, prefill drift), each a share of the largest |logit|
    of the whole prompt's prefill."""
    model = build_model(cfg)
    batch = prompt_batch(cfg, np.random.RandomState(seed), 2, prompt, dev)
    toks = batch["tokens"]
    lo = prompt - n_dec
    with torch.inference_mode():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen)
        impl = model._bind(params)
        norm = getattr(impl, "final_norm", None) or impl.dec_norm
        seen = []
        hook = norm.register_forward_hook(lambda m, i, o: seen.append(o))
        try:
            full, _ = model.prefill(params, batch)
        finally:
            hook.remove()
        inside = impl.embed.unembed(seen[-1][:, lo - 1:lo])
        alone, cache = model.prefill(params, dict(batch,
                                                  tokens=toks[:, :lo]))
        cache = _pad_cache_to(cache, model.cache_spec(2, prompt))
        for t in range(lo, prompt):
            step, cache = model.decode_step(params, cache,
                                            toks[:, t:t + 1], t)
    dec = float((step - full).abs().max()) / float(full.abs().max())
    pre = float((alone - inside).abs().max()) / float(inside.abs().max())
    return dec, pre


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--layers", type=int, nargs="+", default=[8])
    ap.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--decode", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    set_default_device(args.device)
    dev = default_device()
    for layers in args.layers:
        for dtype in args.dtype:
            cfg = dataclasses.replace(get_config(args.arch),
                                      n_layers=layers, dtype=dtype,
                                      param_dtype=dtype)
            dec, pre = drift(cfg, args.prompt, args.decode, args.seed, dev)
            print(f"{cfg.name} layers={layers} {dtype} prompt={args.prompt}"
                  f" decode={args.decode} on {dev}: decode vs prefill "
                  f"{dec:.4f}, prefix prefill vs inside the whole "
                  f"{pre:.4f} of the largest |logit|", flush=True)


if __name__ == "__main__":
    main()
