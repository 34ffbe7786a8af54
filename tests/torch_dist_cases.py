"""What each rank runs in the distributed tests (``torch_dist.launch``).

Every case returns plain Python and numpy values (pickled back to the
test).  ``several`` runs a list of cases in one launch, so that one set
of processes serves several tests.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adamw as _aw
from repro_torch.kernels import ops


def several(cases):
    """{name: result} of each (name, case, kwargs) in turn."""
    return {name: globals()[case](**kw) for name, case, kw in cases}


def _no_dtensor(fn):
    """``fn`` that fails if any argument is a DTensor."""
    from torch.distributed.tensor import DTensor

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, DTensor):
                raise AssertionError(f"a DTensor reached {fn.__name__}")
        return fn(*args, **kwargs)
    return wrapped


def _guard_kernels():
    """Fail on a DTensor in the plain versions the CPU wrappers call with
    the tensors they were given (a kernel wrapper must get local tensors
    only)."""
    if not hasattr(_fa.attention_plain, "__wrapped__"):
        _fa.attention_plain = _no_dtensor(_fa.attention_plain)
    if not hasattr(_aw.adamw_update_plain, "__wrapped__"):
        _aw.adamw_update_plain = _no_dtensor(_aw.adamw_update_plain)


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


def _pl(t):
    """A DTensor's placements as short names ("S0", "R", "P"), the same in
    every torch version."""
    return [f"S{p.dim}" if p.is_shard() else "P" if p.is_partial() else "R"
            for p in t.placements]


def _local_shapes(tree):
    return {k: tuple(t.to_local().shape) for k, t in tree.items()}


def train_mesh(arch="llama3.2-3b", dp=None, tp=1, steps=3, global_batch=4,
               seq_len=16, accum=1, remat=None, ckpt_dir=None,
               ckpt_every=20, resume=False, full=True):
    """``train`` on the (dp, tp) mesh: losses, gnorms, each rank's local
    shapes of params and moments, the fused-AdamW calls a step, and (with
    ``full``) the final parameters whole (rank 0 only)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as t_train

    _guard_kernels()
    cfg = get_config(arch, smoke=True)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    ops.reset_counts()
    out = t_train.train(cfg, steps=steps, global_batch=global_batch,
                        seq_len=seq_len, accum=accum, dp=dp, tp=tp,
                        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                        resume=resume, verbose=False)
    n_steps = len(out["losses"])
    params, opt = out["params"], out["opt"]
    fused = ops.counts()["fused_adamw"]
    res = {
        "losses": out["losses"], "gnorms": out["gnorms"],
        "local": _local_shapes(params), "local_m": _local_shapes(opt["m"]),
        "local_v": _local_shapes(opt["v"]),
        "placements": {k: _pl(t) for k, t in params.items()},
        "placements_m": {k: _pl(t) for k, t in opt["m"].items()},
        "adamw_per_step": sum(fused) / max(n_steps, 1),
        "n_params": len(params),
        "attention_calls": ops.counts()["flash_attention"],
    }
    full_params = {k: _np(t) for k, t in params.items()} if full else None
    if dist.get_rank() == 0:
        res["params"] = full_params
    return res


def step_mesh(arch="llama3.2-3b", dp=2, tp=2, steps=3, global_batch=4,
              seq_len=16, accum=1, remat=True, seed=0):
    """``build_train_step`` on the mesh with the config's remat set: the
    batches of ``TokenPipeline``, the weights of ``train``'s draw."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as t_train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    _guard_kernels()
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    model = build_model(cfg)
    mesh = make_local_mesh(dp, tp)
    pspecs, mspecs = t_train.state_specs(model, mesh)
    gen = torch.Generator()
    gen.manual_seed(seed)
    with torch.no_grad():
        params = sharding.distribute(model.init(gen), pspecs, mesh)
    opt = adamw_init(params, mspecs)
    step = t_train.build_train_step(model, mesh=mesh, accum=accum,
                                    peak_lr=1e-3, total_steps=steps)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq_len,
                         global_batch=global_batch, seed=seed)
    losses, gnorms = [], []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    return {"losses": losses, "gnorms": gnorms}


def remesh_case():
    """A (4, 2) tree re-placed on (2, 4): values, placements and each
    rank's local shapes."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.elastic import remesh
    from repro_torch.launch.mesh import make_local_mesh

    m1 = make_local_mesh(4, 2)
    m2 = make_local_mesh(2, 4)
    spec = {"w": ("batch", "mlp"), "b": ("mlp",)}
    x = {"w": torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8),
         "b": torch.arange(8, dtype=torch.float32)}
    xs = sharding.distribute(x, sharding.tree_shardings(spec, x, m1), m1)
    xr = remesh(xs, spec, m2)
    return {"same": {k: bool(torch.equal(xr[k].full_tensor(), x[k]))
                     for k in x},
            "mesh": tuple(xr["w"].device_mesh.mesh.shape),
            "placements": {k: _pl(t) for k, t in xr.items()},
            "local": _local_shapes(xr)}


def psum_case(steps=5, n=256, seed=0):
    """``compressed_psum`` over every rank, the error carried: each step's
    corrected input, q, scale, new error and mean on this rank."""
    from repro_torch.optim.compress import compressed_psum, quantize_int8

    rank, world = dist.get_rank(), dist.get_world_size()
    g = torch.from_numpy(
        np.random.RandomState(seed).randn(world, n).astype(np.float32))
    gl = g[rank].clone()
    err = torch.zeros(n, dtype=torch.float32)
    group = dist.group.WORLD
    out = []
    for _ in range(steps):
        corrected = gl + err
        q, scale = quantize_int8(corrected)
        mean, new_err = compressed_psum(gl, err, group)
        out.append({"corrected": corrected.numpy(), "q": q.numpy(),
                    "scale": scale.numpy(), "mean": mean.numpy(),
                    "err": new_err.numpy()})
        err = new_err
    return out


def mesh_case():
    """``make_local_mesh`` on this world: its default shape, tp=2, and the
    refusal of a shape the world cannot hold."""
    from repro_torch.launch.mesh import make_local_mesh

    out = {"default": list(make_local_mesh().mesh.shape),
           "tp2": list(make_local_mesh(tp=2).mesh.shape)}
    try:
        make_local_mesh(2, 2)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out

