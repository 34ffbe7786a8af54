"""End-to-end training driver on the PyTorch port: train a ~10M-parameter
llama-family model for a few hundred steps with the full production
stack — sharding rules, AdamW + cosine schedule, grad clipping,
deterministic data pipeline, async checkpointing, straggler monitor (the
counterpart of ``examples/train_lm.py``).  It runs on the CUDA card,
attention through the hand-written flash-attention kernel and AdamW
through the fused one (``--device cpu``: the CPU and their plain
versions).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
"""
import argparse

import repro_torch
from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="/tmp/weld_lm_ckpt_torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    repro_torch.set_default_device(args.device)

    out = train(
        "llama3.2-3b",          # smoke variant: 2L x 64d (~10M with vocab)
        smoke=True,
        steps=args.steps,
        global_batch=16,
        seq_len=128,
        accum=1,
        peak_lr=3e-3,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=100,
        log_every=20,
    )
    losses = out["losses"]
    print(f"\nfirst-10 mean loss: {sum(losses[:10]) / 10:.4f}")
    print(f"last-10  mean loss: {sum(losses[-10:]) / 10:.4f}")
    print(f"straggler monitor : {out['straggler']}")
    assert sum(losses[-10:]) < sum(losses[:10]), "loss did not decrease"
    print("loss decreased ✓  (resume with the same --ckpt-dir to continue)")


if __name__ == "__main__":
    main()
