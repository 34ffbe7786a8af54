"""Batched serving on the PyTorch port: prefill a batch of prompts, then
greedy-decode with the static KV cache — the same ``decode_step`` the
decode_32k/long_500k dry-run cells trace (the counterpart of
``examples/serve_lm.py``).  It runs on the CUDA card, every prefill
attention through the hand-written flash-attention kernel
(``--device cpu``: the CPU and its plain version).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-1.2b
"""
import argparse

import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    repro_torch.set_default_device(args.device)
    ops.reset_counts()
    out = serve(args.arch, smoke=True, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len)
    print(f"generated shape: {out['tokens'].shape}; "
          f"{out['tok_per_s']:.1f} tok/s decode")
    cfg = get_config(args.arch, smoke=True)
    c = fa.flash_attention
    print(f"flash_attention (D {cfg.head_dim}, {cfg.act_dtype}): "
          f"v1={c.launches - c.launches_sm90} sm90={c.launches_sm90} "
          f"plain={c.plain_calls} pack={c.launches_pack}")


if __name__ == "__main__":
    main()
