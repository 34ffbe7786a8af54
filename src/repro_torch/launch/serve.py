"""Serving driver: batched prefill + greedy decode with a static KV/state
cache — the port of the JAX package's ``launch/serve.py``.

    python -m repro_torch.launch.serve --arch llama3.2-3b --full \\
        --batch 4 --prompt-len 2048 --gen-len 32

runs on the CUDA card (``--device cpu`` asks for the CPU), every prefill
attention through the hand-written flash-attention kernel.  Every family
serves: the encoder-decoder's batch also carries ``frames`` (B, n_frames,
d_model), the vision model's ``images`` (B, n_image_tokens, d_vision).
Prompts (and frames and images) come from ``np.random.RandomState(seed)``
in the reference's order, so both draw the same inputs; the weights are
drawn from a ``torch.Generator`` seeded with ``seed`` (the reference's
distributions, not its bits) unless ``params`` are given.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..configs import ModelConfig, get_config
from ..device import default_device, set_default_device
from ..models import build_model


def _pad_cache_to(cache, full_spec):
    """Place the prefill's cache into a max_seq-sized decode cache: a
    tree of any depth, each leaf padded with zeros along the one
    (sequence) axis on which it differs from its spec; a leaf shaped as
    its spec (a recurrent state, a cross-attention's k and v) passes
    through."""
    if isinstance(cache, dict):
        return {k: _pad_cache_to(v, full_spec[k]) for k, v in cache.items()}
    if tuple(cache.shape) == tuple(full_spec.shape):
        return cache
    idx = [i for i, (a, b) in enumerate(zip(cache.shape, full_spec.shape))
           if a != b]
    if len(idx) != 1 or cache.dim() != len(full_spec.shape):
        raise ValueError(f"cache leaf {tuple(cache.shape)} differs from "
                         f"{tuple(full_spec.shape)} on more than one axis")
    big = cache.new_zeros(full_spec.shape)
    big.narrow(idx[0], 0, cache.shape[idx[0]]).copy_(cache)
    return big


def prompt_batch(cfg, rng: np.random.RandomState, batch: int,
                 prompt_len: int, dev) -> Dict[str, torch.Tensor]:
    """A prefill's batch drawn from ``rng`` in the reference's order: the
    tokens, then the frames (encdec) or the images (vlm)."""
    out = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.randn(
            batch, cfg.n_frames, cfg.d_model)).to(cfg.act_dtype).to(dev)
    if cfg.family == "vlm":
        out["images"] = torch.from_numpy(rng.randn(
            batch, cfg.n_image_tokens, cfg.d_vision)).to(
                cfg.act_dtype).to(dev)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: Union[str, ModelConfig], *, smoke: bool = True,
          batch: int = 2, prompt_len: int = 16, gen_len: int = 16,
          seed: int = 0, verbose: bool = True,
          params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Prefill ``batch`` random prompts and greedy-decode ``gen_len``
    tokens on ``default_device()``.  ``arch`` is a registered name (its
    full or, with ``smoke``, its reduced config) or a config itself.
    Returns the tokens (B, gen_len) as numpy, the logits each token was
    chosen from (B, gen_len, V) f32 on the device, and the times."""
    dev = default_device()
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch,
                                                                smoke=smoke)
    model = build_model(cfg)
    rng = np.random.RandomState(seed)
    with torch.inference_mode():
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = model.init(gen)
        else:
            params = {k: v.to(dev) for k, v in params.items()}

        max_seq = prompt_len + gen_len
        batch_in = prompt_batch(cfg, rng, batch, prompt_len, dev)

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch_in)
        cache = _pad_cache_to(cache, model.cache_spec(batch, max_seq))
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out_tokens = [tok]
        t0 = time.perf_counter()
        for step in range(gen_len - 1):
            logits, cache = model.decode_step(params, cache, tok,
                                              prompt_len + step)
            steps.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            out_tokens.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    gen_tokens = torch.cat(out_tokens, dim=1).cpu().numpy()
    tput = batch * (gen_len - 1) / max(t_decode, 1e-9)
    if verbose:
        print(f"[serve] {cfg.name} on {dev}: prefill "
              f"{t_prefill * 1e3:.1f} ms, decode {tput:.1f} tok/s, sample "
              f"row: {gen_tokens[0][:8]}")
    return {"tokens": gen_tokens, "logits": torch.stack(steps, dim=1),
            "prefill_s": t_prefill, "decode_s": t_decode, "tok_per_s": tput}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_default_device(args.device)
    serve(args.arch, smoke=not args.full, batch=args.batch,
          prompt_len=args.prompt_len, gen_len=args.gen_len, seed=args.seed)


if __name__ == "__main__":
    main()
