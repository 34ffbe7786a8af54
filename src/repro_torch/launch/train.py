"""Training driver on one device — the port of the JAX package's
``launch/train.py``: gradient accumulation, clipping, the cosine-warmup
schedule, AdamW, asynchronous checkpoints with preempt and resume, and
the straggler monitor.

    python -m repro_torch.launch.train --arch llama3.2-3b --full \\
        --batch 4 --seq 2048 --accum 2 --steps 3

runs on the CUDA card (``--device cpu`` asks for the CPU): every
attention forward through the hand-written flash-attention kernel, and
every optimizer step through the hand-written fused-AdamW kernel, one
launch per parameter tensor.  Batches come from ``TokenPipeline``, which
yields the reference's tokens for the same seed; the weights are drawn
from a ``torch.Generator`` seeded with ``seed`` (the reference's
distributions, not its bits) unless ``params`` are given.  The
reference's mesh (data and tensor parallelism, ZeRO-1 moments) is the
distributed slice's: ``dp`` or ``tp`` above 1 raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Union

import torch

from ..checkpoint import Checkpointer
from ..configs import ModelConfig, get_config
from ..data import TokenPipeline
from ..device import default_device, set_default_device
from ..distributed.straggler import StepMonitor
from ..models import build_model
from ..models.api import check_trained
from ..optim import adamw_init, adamw_update_tree, clip_by_global_norm
from ..optim.schedule import cosine_warmup
from .serve import _sync


def build_train_step(model, *, accum: int = 1, peak_lr: float = 3e-4,
                     warmup: int = 50, total_steps: int = 1000,
                     max_grad_norm: float = 1.0):
    """The step function ``step(params, opt, batch) -> (params, opt,
    metrics)`` (the reference's jitted step, without its shardings).

    With ``accum > 1`` the batch is cut into ``accum`` micro-batches along
    its first axis and their gradients summed in f32, then divided by
    ``accum``; the loss is the micro-batches' mean.  The gradients are
    clipped to ``max_grad_norm``, and AdamW runs at the cosine-warmup lr
    of ``opt["step"]``.  params and opt are updated in place; metrics are
    0-dim f32 tensors (loss and gnorm on the device, lr on the CPU)."""

    def lr_fn(step):
        return cosine_warmup(step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)

    def train_step(params, opt, batch):
        if accum > 1:
            mb = batch["tokens"].shape[0] // accum
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
            lsum = None
            for i in range(accum):
                part = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                loss, g = model.loss_and_grad(params, part)
                for k, x in g.items():
                    gsum[k].add_(x)
                del g
                lsum = loss if lsum is None else lsum + loss
            # a tensor divisor: a true division, as the reference's (a
            # Python one is a product with its reciprocal on CUDA)
            den = torch.tensor(float(accum), dtype=torch.float32,
                               device=lsum.device)
            for x in gsum.values():
                x.div_(den)
            grads, loss = gsum, lsum / den
        else:
            loss, grads = model.loss_and_grad(params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(opt["step"])
        params, opt = adamw_update_tree(params, grads, opt, lr)
        metrics = {"loss": loss.float(), "gnorm": gnorm, "lr": lr}
        return params, opt, metrics

    return train_step


def train(arch: Union[str, ModelConfig], *, smoke: bool = True,
          steps: int = 50, global_batch: int = 8, seq_len: int = 64,
          accum: int = 1, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, resume: bool = False,
          dp: Optional[int] = None, tp: int = 1, peak_lr: float = 1e-3,
          log_every: int = 10, seed: int = 0, verbose: bool = True,
          params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Run a training loop on ``default_device()``; returns the loss
    history, the final params and optimizer state and the straggler
    summary (and, beyond the reference's keys, each step's gnorm, lr and
    wall seconds).  ``arch`` is a registered name (its full or, with
    ``smoke``, its reduced config) or a config itself.  ``params`` (if
    given) are copied onto the device; the caller's tensors are not
    changed."""
    if (dp or 1) > 1 or tp > 1:
        raise NotImplementedError(
            f"dp={dp}, tp={tp}: training on a mesh is not ported yet "
            f"(ROADMAP, queue A item 9: the distributed slice)")
    dev = default_device()
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch,
                                                                smoke=smoke)
    check_trained(cfg)
    model = build_model(cfg)
    step_fn = build_train_step(model, accum=accum, peak_lr=peak_lr,
                               total_steps=steps)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq_len,
                         global_batch=global_batch, seed=seed)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None

    start = 0
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        shapes = {n: p for n, p in model.impl.named_parameters()}
        moments = {n: torch.empty(p.shape, dtype=torch.float32,
                                  device="meta") for n, p in shapes.items()}
        template = {"params": shapes,
                    "opt": {"m": moments, "v": moments,
                            "step": torch.zeros((), dtype=torch.int32)}}
        state, extra = ckpt.restore(ckpt.latest_step(), template)
        params = {k: t.to(dev) for k, t in state["params"].items()}
        opt = state["opt"]
        opt["m"] = {k: t.to(dev) for k, t in opt["m"].items()}
        opt["v"] = {k: t.to(dev) for k, t in opt["v"].items()}
        pipe.restore(extra["pipeline"])
        start = extra["step"]
        if verbose:
            print(f"[train] resumed from step {start}")
    else:
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            with torch.no_grad():
                params = model.init(gen)
        else:
            params = {k: v.to(dev, copy=True) for k, v in params.items()}
        opt = adamw_init(params)

    monitor = StepMonitor()
    losses, gnorms, lrs, step_s = [], [], [], []
    for s in range(start, steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.next_batch().items()}
        monitor.start()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        monitor.stop()
        losses.append(metrics["loss"])
        gnorms.append(metrics["gnorm"])
        lrs.append(metrics["lr"])
        if verbose and (s % log_every == 0 or s == steps - 1):
            print(f"[train] step {s:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['gnorm']:.3f} lr {metrics['lr']:.2e}")
        if ckpt is not None and (s + 1) % ckpt_every == 0:
            ckpt.save(s + 1, {"params": params, "opt": opt},
                      extra={"pipeline": pipe.state(), "step": s + 1})
    if ckpt is not None:
        ckpt.save(steps, {"params": params, "opt": opt},
                  extra={"pipeline": pipe.state(), "step": steps},
                  blocking=True)
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else None,
        "params": params,
        "opt": opt,
        "straggler": monitor.summary(),
        "gnorms": gnorms,
        "lrs": lrs,
        "step_s": step_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="full (published) config instead of smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_default_device(args.device)
    train(args.arch, smoke=not args.full, steps=args.steps,
          global_batch=args.batch, seq_len=args.seq, accum=args.accum,
          ckpt_dir=args.ckpt_dir, resume=args.resume, dp=args.dp,
          tp=args.tp, peak_lr=args.lr, seed=args.seed)


if __name__ == "__main__":
    main()
