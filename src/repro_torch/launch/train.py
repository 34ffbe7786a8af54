"""The training loop — the port of the JAX package's ``launch/train.py``:
gradient accumulation, clipping, the cosine-warmup schedule, AdamW,
asynchronous checkpoints with preempt and resume, the straggler monitor,
and the data × model mesh (data and tensor parallelism, ZeRO-1 moments).

    python -m repro_torch.launch.train --arch llama3.2-3b --full \\
        --batch 4 --seq 2048 --accum 2 --steps 3
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --dp 4 --tp 2

runs on the CUDA card (``--device cpu`` asks for the CPU): every
attention forward through the hand-written flash-attention kernel, and
every optimizer step through the hand-written fused-AdamW kernel, one
launch per parameter tensor.  Every family trains (``--arch zamba2-1.2b``
and the other registered configs).  ``train`` draws its batches from
``TokenPipeline``, which yields the reference's tokens for the same seed
and nothing else, so it refuses the encoder-decoder and vision families,
whose loss also needs ``frames`` or ``images``, with a ``ValueError``
before the first step (the reference fails on the missing key inside its
loss); ``build_train_step`` trains them on batches that carry the key.
The weights are drawn from a ``torch.Generator`` seeded with ``seed``
(the reference's distributions, not its bits) unless ``params`` are
given.

The mesh.  Whenever a process group is initialised (``train`` starts
one from torchrun's ``RANK``/``WORLD_SIZE`` when none is: NCCL on the
card, gloo on the CPU), training runs on the ``(dp, tp)`` mesh over
("data", "model"), at any world size, one card included.  Every
parameter is a DTensor placed by ``distributed.sharding``'s rules (heads,
mlp, vocab and experts on "model"), every moment one more sharded over
"data" (ZeRO-1), and each micro-batch ``Shard(0)`` over "data";
DTensor's propagation partitions the model's plain tensor code, the
flash-attention kernel runs on each rank's local heads
(``distributed.mesh_ops.attention``), the MoE's experts on their own
ranks (``mesh_ops.expert_parallel``), and fused AdamW on each rank's
ZeRO-1 shards.  The result is the single-device run's up to the order
of the sums.  Without a process group, ``dp · tp > 1`` raises.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..configs import ModelConfig, get_config
from ..data import TokenPipeline
from ..device import default_device, set_default_device
from ..distributed import mesh_ops, sharding
from ..distributed.straggler import StepMonitor
from ..models import build_model
from ..optim import adamw_init, adamw_update_tree, clip_by_global_norm
from ..optim.schedule import cosine_warmup
from .mesh import make_local_mesh
from .serve import _sync

#: the batch keys a family's loss needs beyond tokens and labels
BATCH_KEYS = {"encdec": "frames", "vlm": "images"}


def state_specs(model, mesh, rules=None):
    """(parameter specs, moment specs) of ``model`` on ``mesh``: the rules'
    spec of every parameter and its ZeRO-1 moment spec."""
    shapes = {n: p.shape for n, p in model.impl.named_parameters()}
    axes = model.param_specs()
    return (sharding.tree_shardings(axes, shapes, mesh, rules),
            sharding.zero1_moment_shardings(axes, shapes, mesh, rules))


def _batch_placements(mesh, x: torch.Tensor):
    """A batch leaf's placements: its first dimension on the batch axes."""
    spec = sharding.spec_for_leaf(x.shape, ("batch",) + (None,) *
                                  (x.ndim - 1), mesh)
    return sharding.placements(spec, mesh)


def _cut(batch, lo: int, hi: int, mesh):
    """Rows [lo, hi) of every batch leaf; on a mesh each distributed over
    the batch axes (a plain leaf is the whole batch, the same on every
    rank; a DTensor one is gathered first)."""
    if mesh is None:
        return {k: x[lo:hi] for k, x in batch.items()}
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, x in batch.items():
        full = x.full_tensor() if mesh_ops.is_dtensor(x) else x
        part = full[lo:hi]
        out[k] = distribute_tensor(part, mesh, _batch_placements(mesh, part),
                                   src_data_rank=None)
    return out


def build_train_step(model, *, mesh=None, accum: int = 1,
                     peak_lr: float = 3e-4, warmup: int = 50,
                     total_steps: int = 1000, max_grad_norm: float = 1.0):
    """The step function ``step(params, opt, batch) -> (params, opt,
    metrics)`` (the reference's jitted step).

    With ``accum > 1`` the batch is cut into ``accum`` micro-batches along
    its first axis and their gradients summed in f32, then divided by
    ``accum``; the loss is the micro-batches' mean.  The gradients are
    clipped to ``max_grad_norm``, and AdamW runs at the cosine-warmup lr
    of ``opt["step"]``.  Every key of the batch is cut (``frames`` and
    ``images`` too).  params and opt are updated in place; metrics are
    0-dim f32 tensors (loss and gnorm on the device, lr on the CPU).

    On a ``mesh`` params and opt are DTensors (placed by ``state_specs``,
    where the rules are chosen), and the
    batch is the whole global batch on every rank (or DTensors): each
    micro-batch is distributed ``Shard(0)`` over the batch axes, each
    gradient brought to its parameter's placement (the data-parallel
    reduction) before the clip, and the metrics are plain tensors."""

    def lr_fn(step):
        return cosine_warmup(step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)

    def grads_of(params, part):
        loss, g = model.loss_and_grad(params, part)
        if mesh is not None:
            g = {k: mesh_ops.like(x, params[k]) for k, x in g.items()}
        return loss, g

    def train_step(params, opt, batch):
        if accum > 1:
            mb = batch["tokens"].shape[0] // accum
            gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
            lsum = None
            for i in range(accum):
                part = _cut(batch, i * mb, (i + 1) * mb, mesh)
                loss, g = grads_of(params, part)
                for k, x in g.items():
                    mesh_ops.local(gsum[k]).add_(mesh_ops.local(x))
                del g
                loss = mesh_ops.full(loss)
                lsum = loss if lsum is None else lsum + loss
            # a tensor divisor: a true division, as the reference's (a
            # Python one is a product with its reciprocal on CUDA)
            den = torch.tensor(float(accum), dtype=torch.float32,
                               device=lsum.device)
            for x in gsum.values():
                mesh_ops.local(x).div_(den)
            grads, loss = gsum, lsum / den
        else:
            whole = batch if mesh is None else _cut(
                batch, 0, batch["tokens"].shape[0], mesh)
            loss, grads = grads_of(params, whole)
            loss = mesh_ops.full(loss)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(opt["step"])
        params, opt = adamw_update_tree(params, grads, opt, lr)
        metrics = {"loss": loss.float(), "gnorm": gnorm, "lr": lr}
        return params, opt, metrics

    if mesh is None:
        return train_step

    def mesh_step(params, opt, batch):
        from torch.distributed.tensor.experimental import implicit_replication

        # plain tensors made inside the model (positions, masks) count as
        # replicated on the mesh
        with implicit_replication():
            return train_step(params, opt, batch)

    return mesh_step


def _start_process_group() -> bool:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) when none
    is initialised and the environment names one: NCCL for a CUDA default
    device (on ``LOCAL_RANK``'s card), gloo for the CPU.  Returns whether
    a group is initialised."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = default_device()
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


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
    changed.

    With a process group (or torchrun's environment) the loop runs on the
    (dp, tp) mesh (dp defaults to world // tp) and params and opt come
    back as DTensors; without one, dp · tp above 1 raises ``ValueError``."""
    if not _start_process_group() and (dp or 1) * tp > 1:
        raise ValueError(
            f"dp={dp}, tp={tp}: training on a mesh needs a process group of "
            f"dp * tp ranks; start one rank per device, e.g. "
            f"torchrun --nproc-per-node {(dp or 1) * tp} -m "
            f"repro_torch.launch.train --dp {dp or 1} --tp {tp}")
    dev = default_device()
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch,
                                                                smoke=smoke)
    need = BATCH_KEYS.get(cfg.family)
    if need is not None:
        raise ValueError(
            f"train() draws its batches from TokenPipeline, which yields "
            f"tokens and labels only; the {cfg.family!r} family's loss also "
            f"needs {need!r} (the reference fails on the missing key inside "
            f"its loss): drive build_train_step with batches that carry it")
    mesh = make_local_mesh(dp, tp) if dist.is_initialized() else None
    model = build_model(cfg)
    step_fn = build_train_step(model, mesh=mesh, accum=accum,
                               peak_lr=peak_lr, total_steps=steps)
    pspecs, mspecs = state_specs(model, mesh) if mesh is not None \
        else (None, None)
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
        specs = None
        if mesh is not None:
            specs = {f"params/{k}": v for k, v in pspecs.items()}
            for mk in ("m", "v"):
                specs.update({f"opt/{mk}/{k}": v for k, v in mspecs.items()})
        state, extra = ckpt.restore(ckpt.latest_step(), template,
                                    mesh=mesh, specs=specs)
        params, opt = state["params"], state["opt"]
        if mesh is None:
            params = {k: t.to(dev) for k, t in params.items()}
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
        if mesh is not None:
            params = sharding.distribute(params, pspecs, mesh)
        opt = adamw_init(params, mspecs)

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
