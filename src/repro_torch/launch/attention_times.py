"""Device times of the f32 flash-attention kernel at the shapes the port runs
it at, for one checkout of the repo, so that two checkouts can be compared
on one card in one call:

    python src/repro_torch/launch/attention_times.py --tree OTHER_CHECKOUT
    python src/repro_torch/launch/attention_times.py --tree .

It is run by path, not with ``-m``: it imports ``repro_torch`` from
``TREE/src``, builds that checkout's kernel library there and times its
``flash_attention`` wrapper (causal, grouped heads, q/k/v as the (B, H,
T, D) views of (B, T, H, D) activations a layer passes) at

* ``prefill``: the serving prefill, B 4, H 24/8, S 2,048, D 128;
* ``serve_copy``: the 2-layer copy of ``lm_serve``, B 2, S 256;
* ``train_copy``: the 2-layer copy of ``lm_train``, B 2, S 128.

Times are host-free: the calls queue behind a ``torch.cuda._sleep`` that
outlasts their enqueueing, CUDA events bracket them; the least of three
windows is kept.  Each shape's output is held against ``ref.attention``
within the f32 limit ``F32_ATOL + F32_RTOL |plain|``.  Prints the card's
name and power limit, then one JSON object a shape; exits 1 if an
output is past its limit or differs between two runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

#: name -> (B, H, H_kv, S, D)
SHAPES = {"prefill": (4, 24, 8, 2048, 128),
          "serve_copy": (2, 24, 8, 256, 128),
          "train_copy": (2, 24, 8, 128, 128)}


def _sleep_cycles_per_ms(torch) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(stop)


def window_ms(torch, fn, reps: int, cycles_per_ms: float) -> float:
    """ms a call of ``reps`` calls queued behind a sleep that holds the
    stream while the host enqueues them."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (5.0 + 0.1 * reps)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose src/repro_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("attention_times: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dt, ok = torch.float32, True
    cycles = _sleep_cycles_per_ms(torch)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, (b, h, hk, s, d) in SHAPES.items():
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda",
                               dtype=dt).transpose(1, 2)
                   for n in (h, hk, hk))

        def kern(q=q, k=k, v=v, group=h // hk):
            return fa.flash_attention(q, k, v, causal=True, group=group)

        first, second = kern(), kern()
        want = ref.attention(q, k, v, group=h // hk)
        torch.cuda.synchronize()
        limit = fa.F32_ATOL + fa.F32_RTOL * want.abs()
        share = float(((first - want).abs() / limit).max())
        bitwise = bool(torch.equal(first, second))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        kern()
        stop.record()
        torch.cuda.synchronize()
        reps = max(10, min(2000, int(100.0 / start.elapsed_time(stop))))
        times = [window_ms(torch, kern, reps, cycles) for _ in range(3)]
        print(json.dumps({
            "shape": name, "tree": args.tree,
            # a checkout older than flash_attention.kernel names none
            "kernel": getattr(fa, "kernel", lambda *_: None)(dt, d),
            "B": b, "H": h, "H_kv": hk, "S": s, "D": d, "reps": reps,
            "ms": min(times), "ms_runs": times, "limit_share": share,
            "bitwise_repeat": bitwise}), flush=True)
        ok = ok and bitwise and share <= 1.0
        del q, k, v, first, second, want, limit
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
