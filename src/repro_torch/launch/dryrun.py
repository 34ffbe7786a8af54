"""The dry run (the port of the JAX package's ``launch/dryrun.py``).

For every (architecture × input shape) cell, trace the real step — the
train step (``launch/train.build_train_step``: loss, gradient, clip,
AdamW, ZeRO-1 moments) for train_4k, ``prefill`` for prefill_32k,
``decode_step`` for decode_32k and long_500k — on the production mesh
(16×16, and 2×16×16 multi-pod) with fake tensors (``FakeTensorMode``:
shapes, dtypes and devices, no storage, nothing allocated or launched),
and record from rank 0's local tensors its parameter, optimizer-state and
cache bytes, the FLOPs, bytes and collectives it issues
and its peak memory (``roofline.analysis.StepCounter``), and its roofline
against the H100's published peaks (``roofline.analysis.HW_H100``).  Every
figure is a prediction from those peaks and these counts, not a
measurement.

The mesh is a ``DeviceMesh`` over a process group on the ``"fake"``
backend (256 or 512 ranks in one process; its collectives move nothing),
made by :func:`main`, never at import.  The trace is eager: every layer
runs, so the record's cost is the whole depth's (the reference lowers
reduced-depth unrolled variants and extrapolates, since XLA counts a
``while`` body once), and remat's recompute is counted as it runs (the
reference multiplies by 4/3).  The fake tensors lie on the target device
(``"cuda"`` by default: the card the table describes), where the two
kernels a step launches are operators with a fake form
(``weld::flash_attention``, ``weld::fused_adamw``); on the CPU their
plain versions are traced instead.

    python -m repro_torch.launch.dryrun --arch all --shapes all \\
        --mesh single --out dryrun_results.json          # on the card
    python -m repro_torch.launch.dryrun --device cpu ...  # anywhere

``--device cuda`` (the default) raises where ``default_device()`` does:
on a machine without CUDA.  The results JSON is resumable: a cell that
is ``ok`` there is not traced again.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import SHAPES, get_config, list_configs
from ..configs.base import ShapeConfig
from ..distributed import sharding
from ..models import build_model
from ..roofline.analysis import (StepCounter, model_flops, roofline_terms,
                                 tensor_bytes)


def _local_bytes(tree) -> int:
    """Bytes of rank 0's local shards of a (nested) dict of DTensors (or
    of plain tensors)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    local = tree.to_local() if hasattr(tree, "to_local") else tree
    return tensor_bytes(local)


def _fake(meta: torch.Tensor, dev) -> torch.Tensor:
    return torch.empty(meta.shape, dtype=meta.dtype, device=dev)


def _placed(metas, axes, mesh, dev, rules):
    """Fake tensors of a (nested) dict of ``meta`` tensors on ``dev``,
    each a DTensor placed by its logical ``axes``."""
    if isinstance(metas, dict):
        return {k: _placed(metas[k], axes[k], mesh, dev, rules)
                for k in metas}
    spec = sharding.spec_for_leaf(metas.shape, axes, mesh, rules)
    return sharding.distribute({"x": _fake(metas, dev)}, {"x": spec},
                               mesh)["x"]


def dryrun_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None,
                sharding_overrides: Optional[dict] = None,
                cfg_overrides: Optional[dict] = None,
                seq_shard_inputs: bool = False,
                with_cost: bool = True, device="cuda",
                accum: int = 1) -> Dict:
    """Trace one cell on ``mesh`` (a ``DeviceMesh`` over the process
    group, of ``device``'s type) with fake tensors on ``device``; returns a
    JSON-safe record.  A failure is reported in the record (``error``,
    ``traceback``), not raised.

    Hillclimb knobs (the reference's): ``sharding_overrides`` replaces
    logical-axis rules; ``cfg_overrides`` patches ``ModelConfig`` fields;
    ``seq_shard_inputs`` shards the token sequence axis over "model" at the
    data boundary (the train step gathers it back).  ``accum`` cuts a
    train batch into that many micro-batches (``build_train_step``'s).
    ``with_cost=False`` records no ``cost``, ``collectives`` or
    ``roofline`` (the multi-pod pass: the trace and its memory)."""
    t_start = time.perf_counter()
    cfg = get_config(arch, smoke=smoke)
    if not smoke and cfg.family in ("hybrid", "ssm"):
        # the reference's chunking for its full-size dry run (fewer,
        # larger SSD/mLSTM chunks)
        cfg = dataclasses.replace(cfg, ssm_chunk=max(cfg.ssm_chunk, 512))
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    if batch_override or seq_override:
        shape = ShapeConfig(shape.name, seq_override or shape.seq_len,
                            batch_override or shape.global_batch, shape.kind)
    rec: Dict = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "mesh": sharding.mesh_shape(mesh), "ok": False,
        "device": torch.device(device).type,
    }
    supported, why = cfg.shape_supported(shape)
    if not supported:
        rec.update(ok=True, skipped=why)
        return rec

    try:
        _trace(rec, cfg, shape, mesh, torch.device(device),
               sharding_overrides, seq_shard_inputs, with_cost, accum,
               t_start)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def _trace(rec, cfg, shape, mesh, dev, rules, seq_shard_inputs, with_cost,
           accum, t_start) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from ..optim import adamw_init
    from .train import build_train_step

    model = build_model(cfg)
    shapes = dict(model.impl.named_parameters())
    axes = model.param_specs()
    psh = sharding.tree_shardings(axes, shapes, mesh, rules)
    n_params = sum(p.numel() for p in shapes.values())
    rec["n_params"] = n_params
    in_specs = model.input_specs(shape, shape.kind)
    in_axes = model.input_axes(shape.kind)
    if seq_shard_inputs and shape.kind in ("train", "prefill"):
        in_axes = dict(in_axes)
        for k in ("tokens", "labels"):
            if k in in_axes:
                in_axes[k] = ("batch", "seq")
    n_chips = mesh.size()
    rec["n_chips"] = n_chips

    with FakeTensorMode(allow_non_fake_inputs=True):
        params = sharding.distribute(
            {k: _fake(p, dev) for k, p in shapes.items()}, psh, mesh)
        rec["param_bytes_per_dev"] = _local_bytes(params)
        state = {"params": params}
        if shape.kind == "train":
            opt = adamw_init(params, sharding.zero1_moment_shardings(
                axes, shapes, mesh, rules))
            # the step count a constant, as a real one: AdamW's scalars
            # are read from it on the host
            opt["step"] = torch.tensor(0, dtype=torch.int32)
            rec["opt_bytes_per_dev"] = _local_bytes(opt["m"]) \
                + _local_bytes(opt["v"])
            # train() hands the step the whole batch on every rank; a
            # seq-sharded batch comes as DTensors
            batch = ({k: _placed(in_specs[k], in_axes[k], mesh, dev, rules)
                      for k in in_specs} if seq_shard_inputs
                     else {k: _fake(v, dev) for k, v in in_specs.items()})
            step = build_train_step(model, mesh=mesh, accum=accum)
            state.update(opt=opt, batch=batch)

            def run():
                return step(params, opt, batch)
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            batch = {k: _placed(in_specs[k], in_axes[k], mesh, dev, rules)
                     for k in in_specs}
            state["batch"] = batch

            def run():
                with torch.no_grad(), implicit_replication():
                    return model.prefill(params, batch)
            tokens = shape.global_batch * shape.seq_len
        else:  # decode: one new token a sequence over a seq_len cache
            cache = _placed(in_specs["cache"], in_axes["cache"], mesh, dev,
                            rules)
            tok = _placed(in_specs["tokens"], in_axes["tokens"], mesh, dev,
                          rules)
            rec["cache_bytes_per_dev"] = _local_bytes(cache)
            state.update(cache=cache, tokens=tok)
            pos = shape.seq_len - 1

            def run():
                with torch.no_grad(), implicit_replication():
                    return model.decode_step(params, cache, tok, pos)
            tokens = shape.global_batch

        args = _local_bytes(state)
        counter = StepCounter()
        counter.track(*_leaves(state))
        t_trace = time.perf_counter()
        with counter, _dtensor_under_fake(counter):
            run()
        t_done = time.perf_counter()
        peak = counter.peak_bytes

    rec["lower_s"] = t_trace - t_start
    rec["compile_s"] = t_done - t_trace
    rec["memory_analysis"] = {
        "argument_size_in_bytes": args,
        "temp_size_in_bytes": max(peak - args, 0),
        "peak_size_in_bytes": peak,
    }
    if shape.kind in ("train", "decode"):
        # updated in place, as the reference's donated buffers
        rec["memory_analysis"]["alias_size_in_bytes"] = args \
            - _local_bytes(state.get("batch", state.get("tokens")))
    # MODEL_FLOPS: the useful-math floor (6·N_active·D train, 2·N·D
    # forward)
    rec["model_flops_global"] = model_flops(
        cfg, model.active_param_count(), tokens, shape.kind)
    if with_cost:
        rec["cost"] = counter.cost()
        rec["flops_by_dtype"] = dict(counter.flops_by_dtype)
        rec["collectives"] = dict(counter.collectives)
        rl = roofline_terms(rec["cost"], rec["collectives"]["total"],
                            dtype=cfg.dtype, chips=n_chips)
        rec["roofline"] = rl
        flops_global = rl["hlo_flops_per_dev"] * n_chips
        rec["useful_flops_ratio"] = (rec["model_flops_global"] / flops_global
                                     if flops_global else None)


@contextlib.contextmanager
def _dtensor_under_fake(counter: StepCounter):
    """Two parts of DTensor's dispatch, patched for the trace:

    * DTensor derives an op's output shape by running it on fake tensors
      of the global shapes (``ShardingPropagator``'s tensor-meta
      propagation), in the active fake mode when there is one: that is
      not the step's work, so ``counter`` is paused inside it;
    * the size of a strided shard (a sharded dimension merged behind
      another by a reshape, as ``layers._project`` does to a weight
      sharded on ``head_dim``) lists the shard's indices from a tensor
      (``_StridedShard.local_shard_size_and_offset``), which fails under a
      fake mode: it runs with every dispatch mode unset (the redistribution
      planner asks for it many times on a 3-D mesh).

    Both are DTensor internals (torch 2.11 and 2.13 have them): where one
    is missing the trace raises, as its counts would be wrong."""
    from torch.distributed.tensor import _sharding_prop, placement_types
    from torch.utils._python_dispatch import _disable_current_modes

    def paused(orig):
        @functools.wraps(orig)
        def run(*args, **kwargs):
            was, counter.paused = counter.paused, True
            try:
                return orig(*args, **kwargs)
            finally:
                counter.paused = was
        return run

    def unfaked(orig):
        @functools.wraps(orig)
        def run(*args, **kwargs):
            with _disable_current_modes():
                return orig(*args, **kwargs)
        return run

    patches = []
    for cls, name, wrap in (
            (_sharding_prop.ShardingPropagator,
             "_propagate_tensor_meta_non_cached", paused),
            (getattr(placement_types, "_StridedShard", None),
             "local_shard_size_and_offset", unfaked)):
        orig = cls.__dict__.get(name) if cls is not None else None
        if not callable(orig):
            raise RuntimeError(
                f"the dry run patches DTensor's {name} for its trace, and "
                f"torch {torch.__version__} has no such function: without "
                f"it the counts would be wrong")
        patches.append((cls, name, orig, wrap(orig)))
    for cls, name, _, patched in patches:
        setattr(cls, name, patched)
    try:
        yield
    finally:
        for cls, name, orig, _ in patches:
            setattr(cls, name, orig)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu: the fake tensors' device")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..device import default_device, set_default_device
    from .mesh import make_production_mesh

    set_default_device(args.device)
    dev = default_device()
    archs = ([a for a in list_configs() if a != "weld-bench"]
             if args.arch == "all" else args.arch.split(","))
    shapes = list(SHAPES) if args.shapes == "all" else args.shapes.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    # resumable sweep: merge into existing results
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for multi in meshes:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi)
            mesh_name = "2x16x16" if multi else "16x16"
            for arch in archs:
                for shape in shapes:
                    key = f"{arch}|{shape}|{mesh_name}"
                    if results.get(key, {}).get("ok"):
                        print(f"[dryrun] skip cached {key}")
                        continue
                    print(f"[dryrun] {key} ...", flush=True)
                    # the roofline table is single-pod; the multi-pod pass
                    # proves the 'pod' axis shards (trace and memory)
                    rec = dryrun_cell(arch, shape, mesh, smoke=args.smoke,
                                      with_cost=not multi, device=dev)
                    rec["mesh_name"] = mesh_name
                    results[key] = rec
                    print(f"[dryrun] {key} -> {status_line(rec)}",
                          flush=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
                    if rec.get("memory_analysis"):
                        print("   memory:", rec["memory_analysis"],
                              flush=True)
        finally:
            dist.destroy_process_group()

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} cells ok -> {args.out}")


def status_line(rec: Dict) -> str:
    """The reference's one-line verdict of a record: SKIP, FAIL or OK with
    the roofline's terms (predictions against HW_H100's peaks)."""
    status = ("SKIP: " + rec["skipped"] if "skipped" in rec
              else "OK" if rec["ok"] else "FAIL: " + rec.get("error", "?"))
    if rec.get("ok") and "roofline" in rec:
        rl = rec["roofline"]
        status += (
            f"  [{rl['bottleneck']}-bound; "
            f"c={rl['t_compute_s']*1e3:.2f}ms "
            f"m={rl['t_memory_s']*1e3:.2f}ms "
            f"x={rl['t_collective_s']*1e3:.2f}ms; "
            f"compile {rec['compile_s']:.1f}s]"
        )
    return status


if __name__ == "__main__":
    main()
