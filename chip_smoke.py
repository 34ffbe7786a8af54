#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout on a machine with a CUDA card (and
``nvcc``): it points the kernel health file, the cost ledger and the
autotuner's cache at a fresh temporary directory, turns on
``WELD_VERIFY=1`` (every compile verifies its IR after each pass, after
planning and after tuning; each phase's line prints ``verify.runs``,
``verify.ms`` and ``bounds.ms``, and a ``tuned:`` line for each routed
call with a grid cap the tuner chose, and each "auto" decision its
``source``), builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` and then

1. runs nineteen phases through the entry points a user calls — TPC-H Q6
   (Weld's and the hand-fused ``ops.filter_reduce_q6``) and a Q1-style
   four-aggregate query on an SF10-sized lineitem (59,986,052 rows), a
   4096-key group-by over the same row count, PageRank iterations (4,096
   vertices x 16,777,216 edges under ``kernelize="always"``, 1,000,000 x
   10,000,000 under ``"auto"``, run twice), the quickstart workflow
   (2,000,000 rows), the reference's cost-gate workloads (filtered sums
   of 256 and 500,000 rows, m:1 joins of 100 x 8 and 300,000 x 20,000
   rows) and the 4096-key group-by at 100,000, 1 M and 16 M rows, under
   "off", "always" and "auto" (every "auto" run logs the gate's
   predicted times beside its measured ``run_ms``; each mode's warm
   ``run_ms`` follows, and after the holds below its device kernel time
   and launches from a profiler trace, with an operator census), the
   Star Schema Benchmark's Q1.1 join (the SF10
   lineitem as lineorder, 59,986,052 rows, against the 365 date rows of
   1993: inner with a filter, left, anti), the evaluate pipeline's
   checks and records (``pipeline``: that inner join traced from a cold
   compile cache, with its ``jit_compile``, ``measure.replay`` and
   ``kernel.<name>`` spans and one cost-ledger record per routed call,
   and PageRank's first call traced; the join admitted at
   ``memory_limit`` = its certified peak, bitwise equal, and rejected a
   byte below with no launch and no cache entry; the SF10 group-by with
   ``kernel.dict_group_sum:raise`` raising, quarantined under the
   card's name, raising at the gate on the next compile and launched
   again after ``quarantine.clear()``; every phase fails on a
   quarantine), compile once and serve many (``serve``: a
   ``QueryServer`` of 8 workers over 32 requests of five SF10-sized
   plans — the Q1.1 join, weldrel's group-by, the dense group-by and Q6
   as WeldObjects, the m:n join — bitwise equal to one serial run a
   plan, one compile a plan, a rebound ``CompiledQuery`` with no
   compile, a request shed a byte below its certified peak, the gate
   calibrated from one traced run a plan on the card's clock, and the
   tuner's caps), an
   m:n join on TPC-H
   partsupp's fan-out (16,777,216 probe rows against 50,000 parts x 4
   suppliers: inner, left), the recovery ladder (that inner join with
   its build capacity under-estimated by the ``join.capacity`` failpoint,
   regrown to the healthy run's rows; the group-by with keys outside its
   capacity, regrown until they fit; every other phase must not have
   climbed the ladder), Black-Scholes over 33,554,432 options as a
   price vector and as a sum, logistic-regression scoring through
   ``weldflow`` (4,194,304 x 64, sessions native, xla and weld) and
   ``weldnp`` 4096 x 4096 matmuls in f64 and in f32 (the f32 product also
   under "auto"; each f32 element within its rounding bound) — each
   checked against numpy computed here — and LM serving
   (``repro_torch.launch.serve``: Llama 3.2 3B at full width and depth
   in bf16 on random weights, 4 prompts of 2,048
   tokens and 32 generated; each layer's prefill attention against
   ``ref.attention``, teacher-forced decode against prefill, runs bitwise
   equal, and a 2-layer f32 copy on the card against the CPU; every bf16
   attention launch on the Hopper route), with
   every kernel launch counter zeroed just before a phase and read just
   after; and LM training (``repro_torch.launch.train``: the same model
   at full width and depth, bf16 parameters, remat on, 3 steps of
   ``TokenPipeline`` batches of 4 x 2,048 tokens in 2 micro-batches;
   fused_adamw once per parameter tensor a step, flash_attention in every
   layer's forward and its recompute, losses and gnorms finite, the
   parameters moved; and a 2-layer f32 copy through ``build_train_step``
   on the card against the CPU, bitwise repeatable on the card and
   bitwise equal across a ``Checkpointer`` save and restore); the same
   training again on the data x model mesh (``lm_train_mesh``: an NCCL
   process group of one rank, ``train(..., dp=1, tp=1)``: DTensor
   parameters placed by the sharding rules, ZeRO-1 moments,
   flash_attention on each rank's local heads and fused_adamw on its
   local shards; losses and gnorms against ``lm_train``'s to rtol 2e-4,
   atol 2e-5, the same launch counts, and ``compressed_psum`` through
   the group against the quantizer's formula); and the
   LM stack's other families (``lm_families``: DeepSeek-MoE 16B,
   DBRX 132B cut to 2 of its 40 layers, Zamba2 1.2B, xLSTM 350M,
   Whisper large-v3 over 1,500 frames, Llama 3.2 Vision 90B cut to one
   super-block of 5 layers; full width, bf16, batch 2, each through
   ``serve``: flash_attention launched once for each attention call of
   the structure, all on the Hopper route, each call — causal and the
   encoder's and cross-attentions' non-causal ones, Sq > Skv included —
   against ``ref.attention``, decode against prefill, two runs bitwise
   equal, and an f32 depth-cut copy on the card against the CPU); and
   those families in training (``lm_families_train``: full width, bf16,
   remat, 3 steps of 2 x 512 tokens — Whisper 2 x 448 over 1,500 frames
   — DeepSeek-MoE cut to 6 layers, DBRX to 1, the vision model to one
   super-block of 5, the token families through ``train``, Whisper and
   the vision model through ``build_train_step`` with frames or images;
   fused_adamw once a tensor a step, flash_attention the remat
   structure's count, all on the Hopper route, its backward once a call,
   the first step run twice bitwise equal, step ms, tokens/s, MFU, peak
   memory and the device's idle share; and an f32 depth-cut copy on the
   card against the CPU: two steps, or one ``loss_and_grad`` for DBRX and
   the vision model);
2. holds each of the thirteen kernels against its plain PyTorch version
   on the card at the phases' shapes, for every dtype its planner spec
   takes (segment_sum also past 4,096 keys, at the gate's 20,000-key
   join build, which its kernel sums in windows; the map chain on the Black-Scholes and logreg bodies the
   phases routed and on an f32 body; group_probe also against 4,096 and
   65,536 keys; flash_attention at the prefill's
   and the train micro-batch's shapes and two non-causal shapes of
   ``lm_families`` (Whisper's encoder, the vision cross-attention with
   Sq > Skv; timed beside v1 on the same operands and SDPA, and in f32
   on v1), a ragged S, Sq < Skv and in f32, each element
   within a limit tied to its own size, which two planted faults built
   from copies of the Hopper kernel's source must break; fused_adamw at the embedding table's size for
   every p/g dtype pair and t in {1, 5}, and at an odd size), runs it
   twice
   (the two results must be bitwise equal; ``hash_to_slot``, whose slot
   numbers may differ between runs, is held to its contract and its
   compacted slots to the plain version's, at the m:n build and at the
   m:1 build's 365 date keys) and times kernel, plain
   version and a one-call PyTorch yardstick host-free (``window_ms``: the
   calls queued behind a ``torch.cuda._sleep`` and bracketed by CUDA
   events, beside the plain CUDA-event time of the kernel and the
   yardstick, ``event_ms``); segment_sum_vectors also on skewed keys
   (half of the rows on one key; Zipf s = 1.1); the join's builds
   (``hash_to_slot``, ``slot_hist``) also beside the floor of one launch
   (``zero_()`` of one int32, host-free) and with each kernel's device
   time a launch from a profiler trace;
3. prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

It exits non-zero, with no result line, when there is no CUDA device or
any check fails.  Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and the non-tensor-core
#: peaks (FP64, FP32; integer adds are priced at the FP32 rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float64": 34e12, "float32": 67e12, "int32": 67e12,
            "int64": 67e12}

#: flash_attention's launches on its Hopper route (bf16, D in {64, 128},
#: csrc/flash_attention_sm90.cu), kept beside the wrappers' counts
SM90 = "flash_attention.sm90"

SF10_ROWS = 59_986_052
#: days of SSB's date dimension, 1992-01-01 .. 1998-12-31
SSB_DAYS = 2557


@dataclass
class Sizes:
    lineitem: int = SF10_ROWS
    groupby_rows: int = SF10_ROWS
    groupby_keys: int = 4096
    pr_always: tuple = (4096, 16_777_216)
    pr_auto: tuple = (1_000_000, 10_000_000)
    quickstart: int = 2_000_000
    join_m1_rows: int = SF10_ROWS
    #: partsupp at SF 0.25: parts x suppliers per part
    join_mn_parts: int = 50_000
    join_mn_fanout: int = 4
    join_mn_rows: int = 16_777_216
    #: Black-Scholes options (Fig. 5a), logistic regression rows x
    #: features (Fig. 5d), and the square matmul's side
    bs_options: int = 33_554_432
    logreg: tuple = (4_194_304, 64)
    matmul: int = 4096
    #: LM serving: the architecture (full width and depth unless
    #: lm_smoke), batch x prompt + generated tokens, the prompt tokens
    #: decoded teacher-forced against prefill, and the f32 copy run on the
    #: card and the CPU (layers, batch, prompt, generated)
    lm_arch: str = "llama3.2-3b"
    lm_smoke: bool = False
    lm_batch: int = 4
    lm_prompt: int = 2048
    lm_gen: int = 32
    lm_decode_check: int = 8
    lm_cross: tuple = (2, 2, 256, 4)
    #: LM training (full width and depth, ``lm_arch``): global batch x
    #: sequence, micro-batches, steps; and the f32 copy run on the card and
    #: the CPU (layers, batch, sequence, steps — two: the first at lr 0)
    train_batch: int = 4
    train_seq: int = 2048
    train_accum: int = 2
    train_steps: int = 3
    train_cross: tuple = (2, 2, 128, 2)
    #: lm_families: the families served, each with its cuts (FAMILIES)
    families: tuple = None
    #: lm_families_train: the families trained, each with its cuts
    #: (FAMILIES_TRAIN)
    families_train: tuple = None
    #: fused_adamw's hold: an odd size beside the largest parameter
    adamw_odd: int = 16_384 * 3 + 7
    #: flash_attention's hold: the prefill's (B, H, Hkv, S, D), a ragged S
    #: and the Sq of the Sq < Skv case; and two non-causal shapes of
    #: lm_families (B, H, Hkv, Sq, Skv, D): Whisper's encoder (1,500
    #: frames: 11 kv tiles of 128 and one of 92) and the vision model's
    #: cross-attention (a 2,048-token prompt over 1,600 image tokens)
    attn_shape: tuple = (4, 24, 8, 2048, 128)
    attn_ragged: int = 1999
    attn_sq: int = 256
    attn_whisper: tuple = (2, 20, 20, 1500, 1500, 64)
    attn_vlm: tuple = (2, 64, 8, 2048, 1600, 128)
    timing_reps: int = 10


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# the main path, phase by phase
# ---------------------------------------------------------------------------


def health_file() -> dict:
    """The kernel health file's table (empty when there is none)."""
    from repro_torch.core.kernelplan import quarantine

    try:
        return json.loads(Path(quarantine.path()).read_text())
    except FileNotFoundError:
        return {}


def check_no_quarantine(stats: dict, what: str) -> None:
    """No kernel was quarantined and none was refused for it: the stats
    hold no ``recovery.quarantined``, no gate cost says "quarantined",
    and the quarantine and its health file are empty."""
    from repro_torch.core.kernelplan import quarantine

    costs = stats.get("kernelplan", {}).get("costs", [])
    check("recovery.quarantined" not in stats
          and not any(c.get("why") == "quarantined" for c in costs),
          f"{what}: a kernel was quarantined: "
          f"{stats.get('recovery.quarantined')} {costs}")
    check(not health_file() and not quarantine.entries(),
          f"{what}: the kernel health file holds {health_file()}, the "
          f"quarantine {quarantine.entries()}")


class MainPath:
    """Runs the phases through the port's frames and keeps the launch
    counts each phase's run produced."""

    def __init__(self, torch, sizes: Sizes, seed: int):
        from repro_torch.kernels import ops

        self.torch = torch
        self.ops = ops
        self.sizes = sizes
        self.seed = seed
        self.launches = {name: 0 for name in ops.WRAPPERS}
        self.launches[SM90] = 0
        #: the launches of each phase, by wrapper (a kernel row that
        #: times one shape of a wrapper reports its phase's count)
        self.by_phase = {}
        self.phase_ms = {}
        #: map-chain bodies (IR lambdas) the phases routed, by phase
        self.bodies = {}
        #: the grid caps the autotuner gave the phases' routed calls:
        #: (spec, size bucket) -> max_blocks
        self.tuned = {}
        #: tables and numpy results several phases share, made once
        self.memo = {}

    def run(self, phase: str, mode: str, fn, expect=(), recovers=False):
        """Zero the counters, drive ``fn(mode, stats)`` and read them.
        Under "always" every wrapper in ``expect`` must have launched and
        no wrapper may have served its plain version.  Unless the phase
        ``recovers`` on purpose, the recovery ladder must not have run: a
        kernel that raised a false overflow would otherwise climb it to
        the generic lowering unseen.  No kernel may have been
        quarantined (the stats' and the gate's record of it, the
        quarantine and its health file must be empty): a quarantined
        route is one the card does not run."""
        torch = self.torch
        torch.cuda.synchronize()
        self.ops.reset_counts()
        stats: dict = {}
        t0 = time.perf_counter()
        value = fn(mode, stats)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = self.ops.counts()
        self.last_counts = counts
        mine = self.by_phase.setdefault(phase, {})
        for name, (launches, _) in counts.items():
            self.launches[name] += launches
            mine[name] = mine.get(name, 0) + launches
        routed = {k[len("kernelize."):]: v for k, v in stats.items()
                  if k.startswith("kernelize.") and k != "kernelize.matched"}
        key = f"{phase}[{mode}]"
        while key in self.phase_ms:
            key += "'"
        entry = {"wall_ms": wall}
        parts = []
        if "encode_ms" in stats:  # an Evaluate ran (not a bare session)
            entry.update(encode_ms=stats["encode_ms"], run_ms=stats["run_ms"])
            compile_ms = 0.0 if stats.get("cache.hit") else stats["compile_ms"]
            entry["compile_ms"] = compile_ms
            parts = [f"encode_ms={stats['encode_ms']:.3f}",
                     f"compile_ms={compile_ms:.3f}",
                     f"run_ms={stats['run_ms']:.3f}"]
            if stats.get("kernels.prepare_ms") and not stats.get("cache.hit"):
                parts.append(f"prepare_ms={stats['kernels.prepare_ms']:.3f}")
        if "verify.runs" in stats:
            entry.update({k: stats[k] for k in ("verify.runs", "verify.ms")})
            parts += [f"verify.runs={stats['verify.runs']}",
                      f"verify.ms={stats['verify.ms']:.3f}"]
        if "bounds.ms" in stats:
            entry["bounds.ms"] = stats["bounds.ms"]
            parts.append(f"bounds.ms={stats['bounds.ms']:.3f}")
        self.phase_ms[key] = entry
        check_no_quarantine(stats, key)
        if recovers:
            entry["recovery"] = {k[len("recovery."):]: v
                                 for k, v in stats.items()
                                 if k.startswith("recovery.")}
        else:
            check("recovery.attempts" not in stats,
                  f"{phase}[{mode}]: the recovery ladder ran: "
                  f"{stats.get('recovery.events')}")
        log(f"phase {phase} kernelize={mode}: wall_ms={wall:.3f} "
            f"({' '.join(parts)}) routed={routed} launches="
            f"{ {k: v[0] for k, v in counts.items() if v[0]} } "
            f"plain_calls={ {k: v[1] for k, v in counts.items() if v[1]} }")
        refused = stats.get("kernelplan", {}).get("refused")
        if refused:
            log(f"  refused routes: {refused}")
        for t in stats.get("kernelplan", {}).get("autotune", []):
            if t["n"] and "max_blocks" in t["params"]:
                self.tuned[t["kernel"], bucket_of(t["n"])] = \
                    t["params"]["max_blocks"]
            log(f"  tuned: {t['kernel']} n={t['n']} {t['params']} "
                f"{'cached' if t['cached'] else 'timed'} winner_us="
                f"{t['us']} default_us={t['default_us']}")
        if mode == "auto":
            plan = stats.get("kernelplan", {})
            if plan.get("midpoint_priced"):
                log(f"  auto: {plan['midpoint_priced']} candidate(s) priced "
                    f"at the midpoint of their weldbound row interval")
            for c in plan.get("costs", []):
                log(f"  auto decision: {c['kernel']} routed={c['routed']} "
                    f"source={c.get('source')} predicted kernel_us="
                    f"{c['kernel_us']} generic_us="
                    f"{c['jnp_us']} ({c['why']}); measured run_ms="
                    f"{entry.get('run_ms', float('nan')):.3f}")
        if mode == "always":
            for spec, wrapper in expect:
                check(stats.get(f"kernelize.{spec}", 0) > 0,
                      f"{phase}: spec {spec} not routed under always")
                check(counts[wrapper][0] > 0,
                      f"{phase}: kernel {wrapper} never launched")
            check(all(p == 0 for _, p in counts.values()),
                  f"{phase}: plain versions served kernel calls: {counts}")
        return value, stats


def bucket_of(n: int) -> int:
    """The autotuner's size bucket of ``n`` rows."""
    from repro_torch.core.kernelplan import autotune

    return autotune.size_bucket(int(n))


#: the planner route whose tuned grid cap each held wrapper launches with
TUNED_SPEC = {"filter_reduce_sum": "filter_reduce_sum",
              "filter_reduce_sum_multi": "filter_reduce_sum",
              "segment_sum": "vecmerger_segment_sum",
              "segment_sum_vectors": "dict_group_sum",
              "map_elementwise": "map_elementwise"}


def main_path_cap(tuned: dict, wrapper: str, n: int):
    """The grid cap the main path's compile gave ``wrapper``'s route at
    ``n`` rows, or None (the kernel module's default) where no phase
    tuned that route at that size."""
    return tuned.get((TUNED_SPEC.get(wrapper), bucket_of(n)))


def lineitem(n: int, seed: int) -> dict:
    """The first four columns of the TPC-H lineitem generator the JAX
    package's benchmark uses (bench_tpch.make_lineitem)."""
    rng = np.random.RandomState(seed)
    return {
        "ship": rng.randint(0, 2557, n).astype(np.int64),
        "disc": rng.uniform(0, 0.1, n),
        "qty": rng.uniform(1, 50, n),
        "price": rng.uniform(100, 10_000, n),
    }


def close(got, want, rtol: float, what: str) -> None:
    got, want = float(got), float(want)
    check(np.isfinite(got), f"{what}: not finite ({got})")
    check(abs(got - want) <= rtol * max(abs(want), 1.0),
          f"{what}: {got!r} vs numpy {want!r}")


def phase_tpch(mp: MainPath, cols: dict) -> None:
    from repro_torch.frames import weldrel

    def q6(mode, stats):
        t = weldrel.Table(cols)
        q = weldrel.Query(t).filter(
            (t.col("ship") >= 365) & (t.col("ship") < 730)
            & (t.col("disc") >= 0.05) & (t.col("disc") <= 0.07)
            & (t.col("qty") < 24.0))
        return q.agg({"rev": (t.col("price") * t.col("disc"), "+")},
                     kernelize=mode, collect_stats=stats)["rev"]

    m = ((cols["ship"] >= 365) & (cols["ship"] < 730)
         & (cols["disc"] >= 0.05) & (cols["disc"] <= 0.07)
         & (cols["qty"] < 24.0))
    want = float((cols["price"][m] * cols["disc"][m]).sum())
    weld_q6 = None
    for mode in ("always", "auto"):
        got, _ = mp.run("q6", mode, q6,
                        expect=[("filter_reduce_sum", "filter_reduce_sum")])
        close(got, want, 1e-9, f"q6[{mode}]")
        weld_q6 = got

    # the hand-fused Q6 the JAX package's bench_tpch sets beside Weld's:
    # one range test per column, lo <= c < hi (disc <= 0.07 as the next
    # double above 0.07), the revenue column as the value
    import torch
    from repro_torch import default_device
    from repro_torch.kernels import ops

    def q6_hand(mode, stats):
        dev = default_device()
        c = torch.stack([torch.from_numpy(cols["ship"]).to(dev).double(),
                         torch.from_numpy(cols["disc"]).to(dev),
                         torch.from_numpy(cols["qty"]).to(dev)])
        lo = torch.tensor([365.0, 0.05, -np.inf], dtype=torch.float64,
                          device=dev)
        hi = torch.tensor([730.0, np.nextafter(0.07, np.inf), 24.0],
                          dtype=torch.float64, device=dev)
        val = (torch.from_numpy(cols["price"]).to(dev)
               * torch.from_numpy(cols["disc"]).to(dev))
        return float(ops.filter_reduce_q6(c, lo, hi, val))

    got, _ = mp.run("q6_hand", "kernel", q6_hand)
    check(mp.last_counts["filter_reduce_q6"] == (1, 0),
          "q6_hand: filter_reduce_q6 did not launch its kernel once")
    close(got, weld_q6, 1e-12, "q6_hand vs Weld's Q6")
    close(got, want, 1e-9, "q6_hand")

    def q1(mode, stats):
        t = weldrel.Table(cols)
        q = weldrel.Query(t).filter(t.col("ship") <= 2000)
        return q.agg({
            "sum_qty": (t.col("qty"), "+"),
            "sum_price": (t.col("price"), "+"),
            "sum_disc_price": (t.col("price") * (1.0 - t.col("disc")), "+"),
            "sum_disc": (t.col("disc"), "+"),
        }, kernelize=mode, collect_stats=stats)

    m = cols["ship"] <= 2000
    want = {
        "sum_qty": cols["qty"][m].sum(),
        "sum_price": cols["price"][m].sum(),
        "sum_disc_price": (cols["price"][m] * (1.0 - cols["disc"][m])).sum(),
        "sum_disc": cols["disc"][m].sum(),
    }
    for mode in ("always", "auto"):
        got, _ = mp.run("q1_agg", mode, q1, expect=[
            ("filter_reduce_sum", "filter_reduce_sum_multi")])
        for k, w in want.items():
            close(got[k], w, 1e-9, f"q1_agg[{mode}].{k}")


def phase_groupby(mp: MainPath) -> None:
    from repro_torch.frames import welddf

    s = mp.sizes
    rng = np.random.RandomState(mp.seed + 1)
    keys = rng.randint(0, s.groupby_keys, s.groupby_rows).astype(np.int64)
    vals = rng.rand(s.groupby_rows)
    want = np.bincount(keys, weights=vals, minlength=s.groupby_keys)
    want_keys = np.flatnonzero(np.bincount(keys, minlength=s.groupby_keys))

    def groupby(mode, stats):
        df = welddf.DataFrame({"k": keys, "v": vals})
        return df.groupby_sum("k", "v", capacity=s.groupby_keys,
                              kernelize=mode, collect_stats=stats)

    results = {}
    for mode in ("always", "auto", "off", "off"):
        got, stats = mp.run("groupby", mode, groupby, expect=[
            ("dict_group_sum", "segment_sum_vectors")])
        if mode == "auto":
            check(stats.get("kernelize.dict_group_sum", 0) == 1
                  and mp.last_counts["segment_sum_vectors"][0] > 0,
                  f"groupby[auto]: the cost gate did not route "
                  f"segment_sum_vectors: {stats.get('kernelplan')}")
        check(sorted(got) == want_keys.tolist(),
              f"groupby[{mode}]: wrong key set")
        err = max(abs(got[k] - want[k]) for k in got)
        check(err <= 1e-9 * float(np.abs(want).max()),
              f"groupby[{mode}]: max error {err}")
        if mode in results:
            check(got == results[mode],
                  f"groupby[{mode}]: repeated run differs bitwise")
            log(f"  groupby[{mode}] repeated run: bitwise identical")
        results[mode] = got


def _pagerank_iter(rank, src, dst, invdeg, nv, mode, stats):
    from repro_torch.core import ir, macros as M, wtypes as wt
    from repro_torch.core.lazy import Evaluate, NewWeldObject

    damp = 0.85
    r, s_o, d_o = (NewWeldObject(a, None) for a in (rank, src, dst))
    inv_o, base = NewWeldObject(invdeg, None), NewWeldObject(np.zeros(nv), None)

    def ident(o):
        return ir.Ident(o.obj_id, o.weld_type())

    bt = wt.VecMerger(wt.F64, "+")
    b = ir.Ident(ir.fresh("b"), bt)
    i = ir.Ident(ir.fresh("i"), wt.I64)
    x = ir.Ident(ir.fresh("x"), wt.Struct((wt.I64, wt.I64)))
    contrib = ir.BinOp("*", ir.Lookup(ident(r), ir.GetField(x, 0)),
                       ir.Lookup(ident(inv_o), ir.GetField(x, 0)))
    loop = ir.Result(ir.For(
        (ir.Iter(ident(s_o)), ir.Iter(ident(d_o))),
        ir.NewBuilder(bt, arg=ident(base)),
        ir.Lambda((b, i, x), ir.Merge(
            b, ir.MakeStruct((ir.GetField(x, 1), contrib)))),
    ))
    out = M.map_(loop, lambda v: ir.BinOp(
        "+", ir.Literal((1 - damp) / nv, wt.F64),
        ir.BinOp("*", ir.Literal(damp, wt.F64), v)))
    obj = NewWeldObject([r, s_o, d_o, inv_o, base], out)
    return np.asarray(Evaluate(obj, kernelize=mode,
                               collect_stats=stats).value)


def pagerank_case(mp: MainPath, nv: int, ne: int):
    """A random graph of nv vertices and ne edges, a rank vector, and
    numpy's next iterate: (rank, src, dst, invdeg, want)."""
    rng = np.random.RandomState(mp.seed + 2)
    src = rng.randint(0, nv, ne).astype(np.int64)
    dst = rng.randint(0, nv, ne).astype(np.int64)
    deg = np.maximum(np.bincount(src, minlength=nv), 1).astype(np.float64)
    rank = rng.rand(nv)
    rank /= rank.sum()
    invdeg = 1.0 / deg
    want = 0.15 / nv + 0.85 * np.bincount(
        dst, weights=rank[src] * invdeg[src], minlength=nv)
    return rank, src, dst, invdeg, want


def phase_pagerank(mp: MainPath) -> None:
    """PageRank's scatter under "always" (the segment kernel) and under
    "auto" (K > MAX_K, which the gate prices as one pass over the edges a
    window of MAX_K keys: the generic vecmerger, whose float sum is
    sorted and reduced in row order), the latter twice: bitwise the
    same."""
    previous = None
    for (nv, ne), mode in ((mp.sizes.pr_always, "always"),
                           (mp.sizes.pr_auto, "auto"),
                           (mp.sizes.pr_auto, "auto")):
        rank, src, dst, invdeg, want = pagerank_case(mp, nv, ne)
        got, stats = mp.run(
            f"pagerank[{nv}x{ne}]", mode,
            lambda m, st: _pagerank_iter(rank, src, dst, invdeg, nv, m, st),
            expect=[("vecmerger_segment_sum", "segment_sum")])
        check(got.shape == (nv,) and np.isfinite(got).all(),
              f"pagerank[{mode}]: bad output")
        err = float(np.abs(got - want).max())
        check(err <= 1e-9 * float(np.abs(want).max()),
              f"pagerank[{mode}]: max error {err}")
        if mode == "auto":
            rejected = stats["kernelplan"]["rejected"]
            check(rejected.get("vecmerger_segment_sum", 0) > 0,
                  f"pagerank[auto] at K={nv} should stay on the generic "
                  f"path (past MAX_K keys the kernel reads the rows once a "
                  f"window: the gate rejects it), got {stats['kernelplan']}")
            if previous is not None:
                check(np.array_equal(got.view(np.int64),
                                     previous.view(np.int64)),
                      "pagerank[auto]: repeated run differs bitwise")
                log("  pagerank[auto] repeated run: bitwise identical")
            previous = got


def phase_quickstart(mp: MainPath) -> None:
    from repro_torch.core.lazy import Evaluate
    from repro_torch.frames import welddf

    rng = np.random.RandomState(0)
    n = mp.sizes.quickstart
    data = {"population": rng.randint(0, 1_000_000, n).astype(np.float64),
            "crime": rng.rand(n)}
    m = data["population"] > 500_000
    want = (data["population"][m] * 0.1 + data["crime"][m] * 2.0).sum()

    def quickstart(mode, stats):
        df = welddf.DataFrame(data)
        big = df[df["population"] > 500_000]
        total = (big["population"] * 0.1 + big["crime"] * 2.0).sum()
        return Evaluate(total.obj, kernelize=mode, collect_stats=stats).value

    for mode in ("always", "auto"):
        got, _ = mp.run("quickstart", mode, quickstart,
                        expect=[("filter_reduce_sum", "filter_reduce_sum")])
        close(got, want, 1e-9, f"quickstart[{mode}]")


def _device_kernels(torch, fn):
    """(kernel ms, kernel launches, copy ms) of one call of ``fn`` on the
    card, from a profiler trace: what the cost gate prices (its kernel
    and generic ``us``), the host's time left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = copy_ms = 0.0
    launches = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)
        if not us:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copy_ms += us / 1e3
        else:
            ms += us / 1e3
            launches += e.count
    return ms, launches, copy_ms


#: gate workloads' group-by sizes (4,096 keys), beside phase_groupby's SF10
GATE_GROUPBY_ROWS = (100_000, 1_000_000, 16_000_000)


def operator_census(torch) -> list:
    """Kernels that each PyTorch operator the cost gate counts as more
    than one runs on the card (one call after a warm one, from a profiler
    trace), at 100 and 1,000,000 elements, beside what
    ``cost.operator_launches`` counts for it."""
    from repro_torch.core.kernelplan import cost

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for n in (100, 1_000_000):
        keys = torch.randint(0, 4096, (n,), generator=gen, device=dev)
        seg = torch.sort(keys).values
        lengths = torch.bincount(seg, minlength=4096)
        vals = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        keys32 = keys.to(torch.int32)
        flags = (keys < 2048).to(torch.uint8)
        cases += [
            ("sort", keys, lambda keys=keys: torch.argsort(keys, stable=True)),
            ("sort", keys32,
             lambda keys32=keys32: torch.argsort(keys32, stable=True)),
            ("sort", flags,
             lambda flags=flags: torch.argsort(flags, stable=True)),
            ("cumsum", keys, lambda keys=keys: torch.cumsum(keys, 0)),
            ("bincount", keys,
             lambda keys=keys: torch.bincount(keys, minlength=4096)),
            ("segment_reduce", vals,
             lambda vals=vals, lengths=lengths: torch.segment_reduce(
                 vals, "sum", lengths=lengths, initial=0)),
        ]
    rows = []
    for name, x, fn in cases:
        fn()
        rows.append({"op": name, "dtype": str(x.dtype).split(".")[-1],
                     "n": x.numel(),
                     "kernels": _device_kernels(torch, fn)[1],
                     "counted": cost.operator_launches(name, x.numel(),
                                                       x.element_size())})
    log("  operator census (kernels on the card / counted by cost.py): "
        + ", ".join(f"{r['op']}[{r['dtype']}, {r['n']}] {r['kernels']}/"
                    f"{r['counted']}" for r in rows))
    return rows


def gate_workloads(sizes: Sizes) -> list:
    """The reference's cost-gate workloads (its ``test_kernelplan.py`` and
    ``test_join.py`` gate tests): a filtered sum of 256 and 500,000 rows,
    a scatter of 100,000 rows into 50,000 slots, an m:1 join of 100 x 8
    and 300,000 x 20,000 rows, and the 4,096-key group-by at 100,000, 1 M
    and 16 M rows, as [(name, fn(mode, stats), held(got, what))], ``held``
    checking a result against numpy."""
    from repro_torch.core import ir, macros as M, wtypes as wt
    from repro_torch.core.lazy import Evaluate, NewWeldObject
    from repro_torch.frames import welddf, weldrel

    def filtered_sum(n):
        rng = np.random.RandomState(n % 1000)
        price, disc = rng.rand(n), rng.rand(n)
        want = float((price * disc)[price < 0.5].sum())

        def fn(mode, stats):
            po, do = NewWeldObject(price, None), NewWeldObject(disc, None)
            expr = M.filter_reduce(
                M.zip_map([ir.Ident(po.obj_id, po.weld_type()),
                           ir.Ident(do.obj_id, do.weld_type())],
                          lambda a, b: ir.MakeStruct((a, b))),
                lambda x: ir.BinOp("<", ir.GetField(x, 0),
                                   ir.Literal(0.5, wt.F64)),
                "+", lambda x: ir.BinOp("*", ir.GetField(x, 0),
                                        ir.GetField(x, 1)))
            return Evaluate(NewWeldObject([po, do], expr), kernelize=mode,
                            collect_stats=stats).value

        def held(got, what):
            close(float(got), want, 1e-9, what)
        return fn, held

    def join(n, k):
        rng = np.random.RandomState(n + k)
        lcols = {"key": rng.randint(0, 2 * k, n).astype(np.int64),
                 "lv": rng.rand(n)}
        rcols = {"key": np.arange(k, dtype=np.int64), "rv": rng.rand(k)}
        hit = lcols["key"] < k
        want = {"key": lcols["key"][hit], "lv": lcols["lv"][hit],
                "rv": rcols["rv"][lcols["key"][hit]]}

        def fn(mode, stats):
            return weldrel.Query(weldrel.Table(lcols, eager=False)).join(
                weldrel.Table(rcols, eager=False), on="key", kernelize=mode,
                collect_stats=stats)

        def held(got, what):
            cols = {c: np.asarray(weldrel._host(got.cols[c]))
                    for c in got.cols}
            same_row_set(cols, want, what)
        return fn, held

    def scatter(n, k):
        rng = np.random.RandomState(7)
        idxs = rng.randint(0, k, n).astype(np.int64)
        vals = rng.rand(n)
        want = np.zeros(k)
        np.add.at(want, idxs, vals)

        def fn(mode, stats):
            io, vo, bo = (NewWeldObject(a, None)
                          for a in (idxs, vals, np.zeros(k)))
            expr = M.scatter_add(*(ir.Ident(o.obj_id, o.weld_type())
                                   for o in (bo, io, vo)))
            return Evaluate(NewWeldObject([bo, io, vo], expr),
                            kernelize=mode, collect_stats=stats).value

        def held(got, what):
            close_vec(got, want, 1e-9, what)
        return fn, held

    def groupby(n):
        keys_n = sizes.groupby_keys
        rng = np.random.RandomState(n % 1000 + 3)
        keys = rng.randint(0, keys_n, n).astype(np.int64)
        vals = rng.rand(n)
        want = np.bincount(keys, weights=vals, minlength=keys_n)
        want_keys = np.flatnonzero(np.bincount(keys, minlength=keys_n))

        def fn(mode, stats):
            df = welddf.DataFrame({"k": keys, "v": vals})
            return df.groupby_sum("k", "v", capacity=keys_n, kernelize=mode,
                                  collect_stats=stats)

        def held(got, what):
            check(sorted(got) == want_keys.tolist(), f"{what}: wrong key set")
            err = max(abs(got[k] - want[k]) for k in got)
            check(err <= 1e-9 * float(np.abs(want).max()),
                  f"{what}: max error {err}")
        return fn, held

    cases = [("filter256", filtered_sum(256)),
             ("filter500k", filtered_sum(500_000)),
             ("scatter100kx50k", scatter(100_000, 50_000)),
             ("join100x8", join(100, 8)),
             ("join300kx20k", join(300_000, 20_000))]
    cases += [(f"groupby{n}", groupby(n)) for n in GATE_GROUPBY_ROWS]
    return [(name, fn, held) for name, (fn, held) in cases]


def phase_gate(mp: MainPath) -> None:
    """:func:`gate_workloads` on the card, each under "off", "always" and
    "auto", checked against numpy.  Each mode runs four times (the first
    builds and warms the cache), so that each "auto" decision stands
    beside the best ``run_ms`` of the three warm runs."""
    for name, fn, held in gate_workloads(mp.sizes):
        best = {}
        for mode in ("off", "always", "auto"):
            runs = []
            for _ in range(4):
                got, stats = mp.run(f"gate.{name}", mode, fn)
                held(got, f"gate.{name}[{mode}]")
                runs.append(stats["run_ms"])
            best[mode] = min(runs[1:])
            if name.startswith("groupby") and mode == "auto":
                check(stats.get("kernelize.dict_group_sum", 0) == 1,
                      f"gate.{name}[auto]: the cost gate did not route "
                      f"segment_sum_vectors: {stats.get('kernelplan')}")
        log(f"  gate.{name}: best warm run_ms off {best['off']:.3f} always "
            f"{best['always']:.3f} auto {best['auto']:.3f}")


def profile_gate(torch, sizes: Sizes) -> dict:
    """The operator census, then each gate workload once a mode (after a
    warm call) under the profiler: the device's kernel ms and launches,
    which the gate's ``us`` predict."""
    census = operator_census(torch)
    device = {}
    for name, fn, _ in gate_workloads(sizes):
        device[name] = {}
        for mode in ("off", "always", "auto"):
            fn(mode, {})
            device[name][mode] = _device_kernels(
                torch, lambda: fn(mode, {}))
        log(f"  gate.{name}: device kernel ms (launches; copies ms) "
            + ", ".join(f"{m} {ms:.4f} ({n}; {copy_ms:.4f})"
                        for m, (ms, n, copy_ms) in device[name].items()))
    return {"census": census, "device": device}


#: the last line of the gate trace's process, before its JSON
GATE_TRACE = "gate trace: "


def trace_gate() -> None:
    """:func:`profile_gate` in a process of its own (its last line, after
    ``GATE_TRACE``, the result as JSON).  Traces taken late in a process
    that has traced much, as the main run has, lose kernels, and these
    many short ones upset the main run's later traces."""
    import torch

    import repro_torch

    repro_torch.set_default_device("cuda")
    print(GATE_TRACE + json.dumps(profile_gate(torch, Sizes())), flush=True)


def run_gate_trace() -> dict:
    """Run :func:`trace_gate` in a child process, relay its lines, and
    return its result."""
    import subprocess

    root = Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(root)!r}, "
            f"{str(root / 'src')!r}]; import chip_smoke; "
            f"chip_smoke.trace_gate()")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    check(proc.returncode == 0 and lines and lines[-1].startswith(GATE_TRACE),
          f"the gate trace failed ({proc.returncode}):\n"
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1][len(GATE_TRACE):])


def ssb_dates() -> np.ndarray:
    """yyyymmdd of every day of SSB's date dimension, in order."""
    days = np.datetime64("1992-01-01") + np.arange(SSB_DAYS)
    y = days.astype("datetime64[Y]").astype(np.int64) + 1970
    m = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    d = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    return (y * 10000 + m * 100 + d).astype(np.int64)


def date_1993(seed: int) -> dict:
    """The 365 date-dimension rows of 1993 (SSB Q1.1's ``d_year = 1993``):
    key, week of the year and one float column."""
    lut = ssb_dates()
    first = int(np.searchsorted(lut, 19930101))
    keys = lut[first:first + 365]
    rng = np.random.RandomState(seed + 3)
    return {"datekey": keys, "weeknum": np.arange(365, dtype=np.int64) // 7 + 1,
            "rate": rng.uniform(0.0, 0.1, 365)}


def partsupp(parts: int, fanout: int, seed: int) -> dict:
    """TPC-H partsupp at `parts` parts: each part's `fanout` suppliers by
    the generator's formula (S = parts / 20 suppliers), rows in part
    order, a supply cost in cents."""
    s = parts // 20
    pk = np.repeat(np.arange(1, parts + 1, dtype=np.int64), fanout)
    i = np.tile(np.arange(fanout, dtype=np.int64), parts)
    sk = (pk + i * (s // 4 + (pk - 1) // s)) % s + 1
    rng = np.random.RandomState(seed + 4)
    return {"partkey": pk, "suppkey": sk,
            "supplycost": rng.randint(100, 100_001, pk.shape[0]) / 100.0}


def same_column(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Equal exactly: integers equal, floats bitwise (NaN as NaN)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype}{got.shape} vs numpy {want.dtype}{want.shape}")
    if want.dtype.kind == "f":
        bits = np.dtype(f"i{want.dtype.itemsize}")
        gb, wb = got.view(bits), want.view(bits)
        if np.array_equal(gb, wb):  # the same bits, NaN payloads included
            return
        nan = np.isnan(want)
        check(np.array_equal(np.isnan(got), nan), f"{what}: NaN rows differ")
        check(bool(np.all((gb == wb) | nan)),
              f"{what}: values differ from numpy's")
    else:
        check(np.array_equal(got, want), f"{what}: values differ from numpy's")


def same_table(got: dict, want: dict, what: str) -> None:
    check(list(got) == list(want), f"{what}: columns {list(got)} vs "
                                   f"{list(want)}")
    for c in want:
        same_column(got[c], want[c], f"{what}.{c}")


def _join_runs(mp: MainPath, phase: str, how: str, fn, want: dict,
               expect) -> None:
    """Drive one join under "always" twice and "auto" once; each equal to
    numpy, the two "always" results bitwise equal."""
    from repro_torch.frames import weldrel

    first = None
    for mode in ("always", "always", "auto"):
        res, _ = mp.run(f"{phase}.{how}", mode, fn, expect=expect)
        got = {c: np.asarray(weldrel._host(res.cols[c])) for c in res.cols}
        same_table(got, want, f"{phase}.{how}[{mode}]")
        if mode == "always" and first is not None:
            same_table(got, first, f"{phase}.{how}[always] repeat")
            log(f"  {phase}.{how}[always] repeated run: bitwise identical")
        if first is None:
            first = got
        del res, got


JOIN_M1_EXPECT = [("dict_hash_build", "hash_to_slot"),
                  ("dict_hash_build", "segment_sum"),
                  ("hash_probe", "dict_probe")]


def join_m1_tables(mp: MainPath, cols: dict):
    """lineorder (the lineitem columns + orderdate) and the 1993 date
    rows, with each order date's position in them and whether it is
    there."""
    if "join_m1" in mp.memo:
        return mp.memo["join_m1"]
    n = cols["qty"].shape[0]
    rng = np.random.RandomState(mp.seed + 5)
    probe = dict(cols, orderdate=ssb_dates()[rng.randint(0, SSB_DAYS, n)])
    date = date_1993(mp.seed)
    pos = np.clip(np.searchsorted(date["datekey"], probe["orderdate"]),
                  0, 364)
    found = date["datekey"][pos] == probe["orderdate"]
    mp.memo["join_m1"] = (probe, date, pos, found)
    return probe, date, pos, found


def join_m1_inner(probe: dict, date: dict):
    """SSB Q1.1's join, inner with the quantity filter, as a function of
    (mode, stats, **join options)."""
    from repro_torch.frames import weldrel

    def join(mode, stats, **kw):
        t = weldrel.Table(probe)
        return weldrel.Query(t).filter(t.col("qty") < 24.0).join(
            weldrel.Table(date), on="orderdate", right_on="datekey",
            how="inner", kernelize=mode, collect_stats=stats, **kw)

    return join


def phase_join_m1(mp: MainPath, cols: dict) -> None:
    """SSB Q1.1's join: lineorder (the lineitem columns + orderdate) with
    the 1993 rows of the date dimension, m:1 on the date key."""
    from repro_torch.frames import weldrel

    probe, date, pos, found = join_m1_tables(mp, cols)
    expect = JOIN_M1_EXPECT
    for how in ("inner", "left", "anti"):
        keep = {"inner": found & (probe["qty"] < 24.0), "left": None,
                "anti": ~found}[how]
        want = {c: (v if keep is None else v[keep]) for c, v in probe.items()}
        if how != "anti":
            p = pos if keep is None else pos[keep]
            f = found if keep is None else found[keep]
            want["weeknum"] = np.where(f, date["weeknum"][p], 0)
            want["rate"] = np.where(f, date["rate"][p], np.nan)

        def join(mode, stats, how=how):
            t = weldrel.Table(probe)
            q = weldrel.Query(t)
            if how == "inner":
                q = q.filter(t.col("qty") < 24.0)
            return q.join(weldrel.Table(date), on="orderdate",
                          right_on="datekey", how=how, kernelize=mode,
                          collect_stats=stats)

        _join_runs(mp, "join_m1", how, join, want, expect)
        del want


def phase_pipeline(mp: MainPath, cols: dict) -> dict:
    """The evaluate pipeline's checks and records at full size:

    (a) trace — SSB Q1.1's inner join under "always", traced from a cold
        compile cache: the ``jit_compile``, ``measure.replay`` and
        ``kernel.<name>`` spans, and one cost-ledger record per routed
        call (printed after the holds beside each kernel's
        ``window_ms``); and PageRank's first "always" call traced, its
        ``jit_compile`` span beside ``kernels.prepare_ms`` (the generated
        map-chain body's ``nvcc``);
    (b) admission — the join with ``memory_limit`` equal to its
        certified ``bounds.peak_bytes`` admits, bitwise equal to the run
        without one; one byte less raises ``ResourceError`` with no
        launch and no cache entry; the peak beside the growth of
        ``torch.cuda.max_memory_allocated()`` over the admitted run;
    (c) kernel failure — the SF10 group-by under "always" with
        ``kernel.dict_group_sum:raise`` (the route of
        ``segment_sum_vectors``) raises ``KernelCompileError``: on a
        card the generic lowering does not stand in for a kernel; the
        health file holds one key, naming the card; the next compile
        raises ``KernelQuarantinedError`` at the gate with no launch;
        after ``quarantine.clear()`` the next run launches the kernel
        again with numpy's sums, with no compile-cache clear between.

    Every other phase fails on a quarantine (``MainPath.run``)."""
    import torch

    from repro_torch import obs
    from repro_torch.core import faults, runtime
    from repro_torch.core.errors import (KernelCompileError,
                                         KernelQuarantinedError, ResourceError)
    from repro_torch.core.kernelplan import quarantine
    from repro_torch.frames import weldrel, welddf

    out: dict = {}
    # -- (a) trace ------------------------------------------------------
    probe, date, pos, found = join_m1_tables(mp, cols)
    join = join_m1_inner(probe, date)
    ledger_path = obs.ledger.ledger_path()
    before = len(obs.ledger.read(ledger_path))
    runtime.clear_cache()
    obs.clear()
    obs.enable()
    try:
        res, stats = mp.run("pipeline.trace", "always", join,
                            expect=JOIN_M1_EXPECT)
        names = [sp.name for sp in obs.spans()]
        kspans = [sp for sp in obs.spans() if sp.name.startswith("kernel.")]
        span_ms = {sp.name: sp.dur_ns / 1e6 for sp in obs.spans()
                   if sp.name in ("jit_compile", "execute", "measure.replay",
                                  "decode")}
    finally:
        obs.disable()
        obs.clear()
    routed = stats["kernelplan"]["routed"]
    for want in ["jit_compile", "measure.replay"] + [
            f"kernel.{k}" for k in routed]:
        check(want in names, f"pipeline.trace: no {want} span in {names}")
    recs = obs.ledger.read(ledger_path)[before:]
    check(sorted(r["kernel"] for r in recs)
          == sorted(k for k, n in routed.items() for _ in range(n)),
          f"pipeline.trace: ledger records {recs} for routes {routed}")
    check(all(r["measured_ns"] > 0 for r in recs),
          f"pipeline.trace: a record without a measured time: {recs}")
    out["ledger"] = [dict(r, event_ns=sp.tags.get("event_ns"))
                     for r, sp in zip(recs, kspans)]
    out["span_ms"] = span_ms
    log(f"  pipeline.trace spans (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in span_ms.items()))
    for r in out["ledger"]:
        log(f"  pipeline.trace ledger: {r['kernel']} n={r['n']} "
            f"dtype={r['dtype']} predicted_ns={r['predicted_ns']} "
            f"measured_ns={r['measured_ns']} event_ns={r['event_ns']}")
    free = {c: np.asarray(weldrel._host(res.cols[c])) for c in res.cols}
    del res
    keep = found & (probe["qty"] < 24.0)
    want = {c: v[keep] for c, v in probe.items()}
    want["weeknum"] = date["weeknum"][pos[keep]]
    want["rate"] = date["rate"][pos[keep]]
    same_table(free, want, "pipeline.trace")
    del want
    peak = stats["bounds.peak_bytes"]
    log(f"  pipeline.trace: bounds.certificate {stats['bounds.certificate']}"
        f" = {peak} bytes, bounds.out_rows {stats['bounds.out_rows']}, "
        f"bounds.ms {stats['bounds.ms']}")

    nv, ne = mp.sizes.pr_always
    rank, src, dst, invdeg, want_pr = pagerank_case(mp, nv, ne)
    obs.enable()
    try:
        got, st = mp.run(
            f"pipeline.pagerank[{nv}x{ne}]", "always",
            lambda m, s: _pagerank_iter(rank, src, dst, invdeg, nv, m, s),
            expect=[("vecmerger_segment_sum", "segment_sum"),
                    ("map_elementwise", "map_elementwise")])
        jit = [sp for sp in obs.spans() if sp.name == "jit_compile"]
    finally:
        obs.disable()
        obs.clear()
    check(float(np.abs(got - want_pr).max())
          <= 1e-9 * float(np.abs(want_pr).max()),
          "pipeline.pagerank: wrong result")
    check(len(jit) == 1, f"pipeline.pagerank: {len(jit)} jit_compile spans")
    out["pagerank_jit_compile_ms"] = jit[0].dur_ns / 1e6
    out["pagerank_prepare_ms"] = st.get("kernels.prepare_ms", float("nan"))
    log(f"  pipeline.pagerank first call: jit_compile "
        f"{out['pagerank_jit_compile_ms']:.3f} ms, kernels.prepare_ms "
        f"{out['pagerank_prepare_ms']:.3f}, compile_ms "
        f"{st['compile_ms']:.3f}")
    del rank, src, dst, invdeg, want_pr, got

    # -- (b) admission --------------------------------------------------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, st = mp.run("pipeline.admit", "always",
                     lambda m, s: join(m, s, memory_limit=peak),
                     expect=JOIN_M1_EXPECT)
    grew = torch.cuda.max_memory_allocated() - base
    check(st["bounds.admitted"] is True and st["bounds.peak_bytes"] == peak,
          f"pipeline.admit: {st.get('bounds.admitted')} at {peak}")
    got = {c: np.asarray(weldrel._host(res.cols[c])) for c in res.cols}
    del res
    same_table(got, free, "pipeline.admit (against the unlimited run)")
    del got, free
    out["peak_bytes"] = peak
    out["max_memory_allocated_growth"] = grew
    log(f"  pipeline.admit: memory_limit = bounds.peak_bytes {peak} "
        f"admitted, rows bitwise equal; max_memory_allocated grew {grew} "
        f"bytes over the run ({grew / max(peak, 1):.3f} x the peak)")
    cached = runtime.cache_size()
    mp.ops.reset_counts()
    try:
        join("always", {}, memory_limit=peak - 1)
    except ResourceError as e:
        log(f"  pipeline.admit: memory_limit {peak - 1} rejected: "
            f"{str(e)[:120]}")
    else:
        check(False, "pipeline.admit: peak - 1 was admitted")
    check(all(n == (0, 0) for n in mp.ops.counts().values()),
          f"pipeline.admit: a rejected plan launched {mp.ops.counts()}")
    check(runtime.cache_size() == cached,
          "pipeline.admit: a rejected plan was cached")
    del probe, date, pos, found

    # -- (c) kernel failure ---------------------------------------------
    s = mp.sizes
    rng = np.random.RandomState(mp.seed + 1)
    keys = rng.randint(0, s.groupby_keys, s.groupby_rows).astype(np.int64)
    vals = rng.rand(s.groupby_rows)
    wsum = np.bincount(keys, weights=vals, minlength=s.groupby_keys)
    wkeys = np.flatnonzero(np.bincount(keys, minlength=s.groupby_keys))

    def groupby(mode, stats):
        df = welddf.DataFrame({"k": keys, "v": vals})
        return df.groupby_sum("k", "v", capacity=s.groupby_keys,
                              kernelize=mode, collect_stats=stats)

    def held(got, what):
        check(sorted(got) == wkeys.tolist(), f"{what}: wrong key set")
        err = max(abs(got[k] - wsum[k]) for k in got)
        check(err <= 1e-9 * float(np.abs(wsum).max()),
              f"{what}: max error {err}")
        return err

    faults.clear()
    faults.inject("kernel.dict_group_sum", "raise", times=1)
    mp.ops.reset_counts()
    raised = None
    t0 = time.perf_counter()
    try:
        groupby("always", {})
    except KernelQuarantinedError as e:
        check(False, f"pipeline.fault: refused at the gate: {e}")
    except KernelCompileError as e:
        raised = e
    finally:
        out["fault_ms"] = (time.perf_counter() - t0) * 1e3
        fired = [f["site"] for f in faults.fired()]
        faults.clear()
    check(raised is not None, "pipeline.fault: the kernel fault did not raise")
    check(fired == ["kernel.dict_group_sum"], f"pipeline.fault: fired {fired}")
    check(mp.ops.counts()["segment_sum_vectors"] == (0, 0),
          f"pipeline.fault: {mp.ops.counts()['segment_sum_vectors']}")
    table = health_file()
    card = torch.cuda.get_device_name(0)
    check(len(table) == 1 and list(table)[0].endswith("|" + card)
          and list(table)[0].startswith("dict_group_sum|")
          and list(table)[0] in str(raised)
          and list(quarantine.entries()) == list(table),
          f"pipeline.fault: health file {table}")
    log(f"  pipeline.fault: raised KernelCompileError in "
        f"{out['fault_ms']:.3f} ms, quarantined {list(table)[0]}")
    mp.ops.reset_counts()
    t0 = time.perf_counter()
    try:
        groupby("always", {})
    except KernelQuarantinedError as e:
        out["gated_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"  pipeline.gated: the gate raised in {out['gated_ms']:.3f} "
            f"ms: {str(e)[:120]}")
    else:
        check(False, "pipeline.gated: the quarantined route ran")
    check(all(n == (0, 0) for n in mp.ops.counts().values()),
          f"pipeline.gated: a refused plan launched {mp.ops.counts()}")
    quarantine.clear()
    got, st = mp.run("pipeline.cleared", "always", groupby,
                     expect=[("dict_group_sum", "segment_sum_vectors")])
    held(got, "pipeline.cleared")
    check(st.get("cache.hit") is False,
          "pipeline.cleared: a stale compiled program served the run")
    log("  pipeline.cleared: after quarantine.clear() the kernel launched "
        "again (no compile-cache clear)")
    del keys, vals, got
    runtime.clear_cache()
    return out


JOIN_MN_EXPECT = [("group_build", "hash_to_slot"),
                  ("group_build", "slot_hist"),
                  ("group_probe", "group_probe")]


def join_mn_tables(mp: MainPath):
    """partsupp (the build side) and the lineitem-shaped probe rows of the
    m:n join, each part key uniform over twice the part range."""
    if "join_mn" in mp.memo:
        return mp.memo["join_mn"]
    s = mp.sizes
    build = partsupp(s.join_mn_parts, s.join_mn_fanout, mp.seed)
    probe = lineitem(s.join_mn_rows, mp.seed + 6)
    rng = np.random.RandomState(mp.seed + 7)
    probe["partkey"] = rng.randint(0, 2 * s.join_mn_parts,
                                   s.join_mn_rows).astype(np.int64)
    mp.memo["join_mn"] = (build, probe)
    return build, probe


def join_mn_want(mp: MainPath, how: str) -> dict:
    """numpy's m:n join of ``join_mn_tables``: probe-row order, build-row
    order within a key (made once a run for each ``how``)."""
    if ("join_mn", how) in mp.memo:
        return mp.memo["join_mn", how]
    build, probe = join_mn_tables(mp)
    bk = build["partkey"]  # sorted: within a key, build-row order
    lo = np.searchsorted(bk, probe["partkey"], side="left")
    cnt = np.searchsorted(bk, probe["partkey"], side="right") - lo
    rep = cnt if how == "inner" else np.maximum(cnt, 1)
    rows = np.repeat(np.arange(cnt.shape[0]), rep)
    ordinal = np.arange(rows.shape[0]) - np.repeat(np.cumsum(rep) - rep, rep)
    hit = cnt[rows] > 0
    gidx = np.where(hit, lo[rows] + ordinal, 0)
    want = {c: v[rows] for c, v in probe.items()}
    want["suppkey"] = np.where(hit, build["suppkey"][gidx], 0)
    want["supplycost"] = np.where(hit, build["supplycost"][gidx], np.nan)
    mp.memo["join_mn", how] = want
    return want


def phase_join_mn(mp: MainPath) -> None:
    """An m:n join on partsupp's fan-out: lineitem-shaped rows with a part
    key uniform over twice the part range, against every supplier of
    each part."""
    from repro_torch.frames import weldrel

    build, probe = join_mn_tables(mp)
    expect = JOIN_MN_EXPECT
    for how in ("inner", "left"):
        want = join_mn_want(mp, how)
        log(f"join_mn.{how}: {want['suppkey'].shape[0]} output rows")

        def join(mode, stats, how=how):
            return weldrel.Query(weldrel.Table(probe)).join(
                weldrel.Table(build), on="partkey", how=how, kernelize=mode,
                collect_stats=stats)

        _join_runs(mp, "join_mn", how, join, want, expect)
        del want


def same_row_set(got: dict, want: dict, what: str) -> None:
    """The same rows in any order: equal as they stand, or equal once
    both are sorted on every column (floats by their bits)."""
    check(list(got) == list(want), f"{what}: columns {list(got)} vs "
                                   f"{list(want)}")
    if all(np.array_equal(got[c].view(np.int64) if got[c].dtype.kind == "f"
                          else got[c],
                          want[c].view(np.int64) if want[c].dtype.kind == "f"
                          else want[c]) for c in want):
        return

    def keys(t):
        return [t[c].view(np.int64) if t[c].dtype.kind == "f" else t[c]
                for c in reversed(list(t))]

    go, wo = np.lexsort(keys(got)), np.lexsort(keys(want))
    for c in want:
        same_column(got[c][go], want[c][wo], f"{what}.{c} (sorted)")


def phase_recovery(mp: MainPath) -> None:
    """The recovery ladder on the card, at full size: the m:n join with
    its build capacity under-estimated by the ``join.capacity`` failpoint
    (regrown, never degraded), and the SF10 group-by with keys outside
    the dense-key route's [0, capacity) (regrown until they fit)."""
    from repro_torch.core import faults
    from repro_torch.frames import weldrel, welddf

    s = mp.sizes
    build, probe = join_mn_tables(mp)
    want = join_mn_want(mp, "inner")

    def join(mode, stats):
        res = weldrel.Query(weldrel.Table(probe)).join(
            weldrel.Table(build), on="partkey", how="inner", kernelize=mode,
            collect_stats=stats)
        return {c: np.asarray(weldrel._host(res.cols[c])) for c in res.cols}

    healthy, _ = mp.run("recovery.join_mn.inner", "always", join,
                        expect=JOIN_MN_EXPECT)
    same_table(healthy, want, "recovery.join_mn.inner[healthy]")
    del want
    # a power of two between a quarter and a half of the distinct build
    # keys: x2 still overflows, x4 covers them (16,384 -> 65,536 for
    # 50,000 parts) without passing the hash kernels' MAX_CAP (65,536),
    # above which the planner stops routing; a capacity of 1 would need
    # x65,536, past the ladder's x8, in the reference too
    cap = 1 << (s.join_mn_parts.bit_length() - 2)
    faults.clear()
    faults.inject("join.capacity", "cap", times=1, value=cap)
    try:
        got, stats = mp.run("recovery.join_mn.inner", "always", join,
                            expect=JOIN_MN_EXPECT, recovers=True)
        check([f["site"] for f in faults.fired()] == ["join.capacity"],
              f"recovery.join_mn: fired {faults.fired()}")
    finally:
        faults.clear()
    events = stats.get("recovery.events", [])
    check(stats.get("recovery.attempts", 0) >= 2 and events
          and all(e["action"] == "regrow" for e in events)
          and stats["recovery.fallback"] is False,
          f"recovery.join_mn: expected regrows and no fallback, got "
          f"{ {k: v for k, v in stats.items() if k.startswith('recovery.')} }")
    check(mp.last_counts["hash_to_slot"][0] == stats["recovery.attempts"],
          f"recovery.join_mn: {mp.last_counts['hash_to_slot'][0]} builds on "
          f"the card for {stats['recovery.attempts']} attempts")
    same_row_set(got, healthy, "recovery.join_mn.inner")
    log(f"  recovery.join_mn.inner: capacity {cap} -> attempts "
        f"{stats['recovery.attempts']}, regrow x"
        f"{stats['recovery.regrow_factor']}, rows equal the healthy run's "
        f"({got['suppkey'].shape[0]})")
    del got, healthy, build, probe

    n = s.groupby_rows
    rng = np.random.RandomState(mp.seed + 1)
    keys = rng.randint(0, s.groupby_keys, n).astype(np.int64)
    vals = rng.rand(n)
    wsum = np.bincount(keys, weights=vals, minlength=s.groupby_keys)
    wkeys = np.flatnonzero(np.bincount(keys, minlength=s.groupby_keys))
    # half the key range: keys >= capacity poison the dense-key route
    capacity = s.groupby_keys // 2

    def groupby(mode, stats):
        df = welddf.DataFrame({"k": keys, "v": vals})
        return df.groupby_sum("k", "v", capacity=capacity, kernelize=mode,
                              collect_stats=stats)

    got, stats = mp.run("recovery.groupby", "always", groupby,
                        expect=[("dict_group_sum", "segment_sum_vectors")],
                        recovers=True)
    check(stats.get("recovery.attempts", 0) >= 2,
          f"recovery.groupby: attempts {stats.get('recovery.attempts')}")
    check(mp.last_counts["segment_sum_vectors"][0] >= 2,
          f"recovery.groupby: {mp.last_counts['segment_sum_vectors'][0]} "
          f"segment_sum_vectors launches, expected one an attempt")
    check(sorted(got) == wkeys.tolist(), "recovery.groupby: wrong key set")
    err = max(abs(got[k] - wsum[k]) for k in got)
    check(err <= 1e-9 * float(np.abs(wsum).max()),
          f"recovery.groupby: max error {err}")
    log(f"  recovery.groupby: capacity {capacity} -> attempts "
        f"{stats['recovery.attempts']}, regrow x"
        f"{stats['recovery.regrow_factor']}, fallback "
        f"{stats['recovery.fallback']}, max error {err:.3e}")


SERVE_EXPECT = [("dict_hash_build", "hash_to_slot"),
                ("dict_hash_build", "segment_sum"),
                ("hash_probe", "dict_probe"),
                ("dict_group_sum", "segment_sum_vectors"),
                ("filter_reduce_sum", "filter_reduce_sum"),
                ("group_build", "slot_hist"),
                ("group_probe", "group_probe")]


def _served(got) -> dict:
    """A served result as numpy: a weldrel Table's columns, or the dict
    or scalar it is."""
    from repro_torch.frames import weldrel

    if isinstance(got, weldrel.Table):
        return {c: np.asarray(weldrel._host(v)) for c, v in got.cols.items()}
    if isinstance(got, tuple) and len(got) == 1:  # a one-merger struct
        return got[0]
    return got


def _bitwise_same(got, want, what: str) -> None:
    """Equal bit for bit: tables column by column, dicts key by key,
    scalars by their bits."""
    if isinstance(want, dict) and want and isinstance(
            next(iter(want.values())), np.ndarray):
        same_table(got, want, what)
        return
    def bits(v):
        return np.atleast_1d(np.asarray(v, dtype=np.float64)).view(np.int64)

    if isinstance(want, dict):
        check(list(got) == list(want), f"{what}: keys differ")
        check(all(np.array_equal(bits(got[k]), bits(want[k])) for k in want),
              f"{what}: values differ bitwise")
        return
    check(np.array_equal(bits(got), bits(want)),
          f"{what}: {got!r} vs {want!r} bitwise")


#: how much faster than its "auto" run a plan's "always" run may be
#: before a calibrated flip to the generic lowering counts as wrong (the
#: spread of a plan's runs on the card)
FLIP_SPREAD = 0.05


def _flip_times(torch, compiled, name: str, make) -> tuple:
    """(ms of the plan under "always", ms under "auto"): the minimum of
    3 runs of each compiled handle, alternating, on the inputs it bound
    at compile time (already on the card)."""
    handles = [compiled(name, make, "always"), compiled(name, make, "auto")]
    best = [float("inf"), float("inf")]
    for _ in range(3):
        for i, h in enumerate(handles):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h.run()
            torch.cuda.synchronize()
            best[i] = min(best[i], (time.perf_counter() - t0) * 1e3)
    return tuple(best)


def phase_serve(mp: MainPath, cols: dict) -> dict:
    """Compile once, serve many: ``QueryServer(workers=8)`` takes 32
    requests over five plans at the phases' sizes, every kernel route
    under "always":

    - 10 x SSB Q1.1's m:1 inner join (59,986,052 x 365), a StagedQuery
      (hash_to_slot, segment_sum, dict_probe);
    - 5 x weldrel's SF10 4,096-key ``group_agg``, a StagedQuery (the
      port's planner takes dict_hash_build for it: hash_to_slot,
      segment_sum);
    - 5 x the dense SF10 4,096-key group-by ``welddf.groupby_sum``
      builds, as a WeldObject (segment_sum_vectors, grid cap tuned);
    - 8 x TPC-H Q6's filtered sum on SF10 lineitem, as a WeldObject
      (filter_reduce_sum, grid cap tuned);
    - 4 x the partsupp m:n inner join (16,777,216 x 200,000), a
      StagedQuery (hash_to_slot, slot_hist, group_probe).

    (a) every result bitwise equal to the serial run of its plan (two a
    plan, the first compiling, through a server of one worker) and to
    numpy (join columns exact, f64 rtol 1e-9); the serial wall of the 32
    is the sum of their second runs' walls; (b) ``cache.misses`` = 5,
    nothing compiled twice; (c)
    ``CompiledQuery.run(table=, right=)`` on a lineorder and date table
    from another seed: zero compiles, equal to numpy; (d) one request
    with ``memory_limit`` a byte below its certified peak sheds with
    ``ResourceError`` (``serve.shed``), launches nothing, is not cached;
    (e) calibration: one traced run of each plan writes a ledger of the
    phase's own (later phases' gates stay on theirs), then
    ``clear_cache`` and an "auto" compile of each with
    ``WELD_CALIBRATE_MIN=1``: ``explain()`` shows ``source=measured`` for
    every group of the card's records, each decision's roofline and
    measured µs (the card's time inside the kernel entries), the routes
    that flipped, and the "auto" runs still equal numpy; a plan whose
    route flipped to the generic lowering fails if its "always" run is
    faster than its "auto" run by more than ``FLIP_SPREAD`` (min of 3
    runs each, inputs on the card); (f) the tuner's cap for each tuned
    call, with the default's and the winner's time by its clock."""
    import torch

    from repro_torch import obs
    from repro_torch.core import ir, macros as M, runtime
    from repro_torch.core.errors import ResourceError
    from repro_torch.core.kernelplan import calibrate
    from repro_torch.core.lazy import NewWeldObject
    from repro_torch.core.serve import QueryServer
    from repro_torch.frames import weldrel

    s = mp.sizes
    out: dict = {}
    t_serve = time.perf_counter()

    def clock(what):
        log(f"  serve.clock: {what} at {time.perf_counter() - t_serve:.1f} s")

    probe, date, pos, found = join_m1_tables(mp, cols)
    keep = found & (probe["qty"] < 24.0)
    want_m1 = {c: v[keep] for c, v in probe.items()}
    want_m1["weeknum"] = date["weeknum"][pos[keep]]
    want_m1["rate"] = date["rate"][pos[keep]]
    clock("the Q1.1 tables and numpy's join")
    rng = np.random.RandomState(mp.seed + 1)
    gkeys = rng.randint(0, s.groupby_keys, s.groupby_rows).astype(np.int64)
    gvals = rng.rand(s.groupby_rows)
    gsum = np.bincount(gkeys, weights=gvals, minlength=s.groupby_keys)
    gcnt = np.bincount(gkeys, minlength=s.groupby_keys)
    q6m = ((cols["ship"] >= 365) & (cols["ship"] < 730)
           & (cols["disc"] >= 0.05) & (cols["disc"] <= 0.07)
           & (cols["qty"] < 24.0))
    want_q6 = float((cols["price"][q6m] * cols["disc"][q6m]).sum())
    del q6m
    clock("the group-by table and Q6's sum")
    build, mn_probe = join_mn_tables(mp)
    want_mn = join_mn_want(mp, "inner")
    clock("the m:n tables and numpy's join")

    def m1(mode="always"):
        t = weldrel.Table(probe)
        return weldrel.Query(t).filter(t.col("qty") < 24.0).stage().join(
            weldrel.Table(date), on="orderdate", right_on="datekey",
            how="inner", kernelize=mode)

    def group_agg(mode="always"):
        t = weldrel.Table({"k": gkeys, "v": gvals})
        return weldrel.Query(t).stage().group_agg(
            [t.col("k")], {"v": (t.col("v"), "+")},
            capacity=s.groupby_keys, kernelize=mode)

    def groupby_dense():
        k, v = NewWeldObject(gkeys, None), NewWeldObject(gvals, None)
        return NewWeldObject([k, v], M.groupby_agg(
            ir.Ident(k.obj_id, k.weld_type()),
            ir.Ident(v.obj_id, v.weld_type()), "+",
            capacity=s.groupby_keys))

    def q6():
        t = weldrel.Table(cols)
        return weldrel.Query(t).filter(
            (t.col("ship") >= 365) & (t.col("ship") < 730)
            & (t.col("disc") >= 0.05) & (t.col("disc") <= 0.07)
            & (t.col("qty") < 24.0)).stage().agg(
            {"rev": (t.col("price") * t.col("disc"), "+")}).obj

    def mn(mode="always"):
        return weldrel.Query(weldrel.Table(mn_probe)).stage().join(
            weldrel.Table(build), on="partkey", how="inner", kernelize=mode)

    plans = [("join_m1", m1, 10), ("group_agg", group_agg, 5),
             ("groupby_dense", groupby_dense, 5), ("q6", q6, 8),
             ("join_mn", mn, 4)]
    make_of = {name: make for name, make, _ in plans}

    def held(name, got):
        """Each plan's result against numpy."""
        if name == "join_m1":
            same_table(got, want_m1, f"serve.{name}")
        elif name == "join_mn":
            same_table(got, want_mn, f"serve.{name}")
        elif name == "q6":
            close(got, want_q6, 1e-9, f"serve.{name}")
        else:
            wkeys = np.flatnonzero(gcnt).tolist()
            check(sorted(got) == wkeys, f"serve.{name}: wrong key set")
            scale = float(np.abs(gsum).max())
            for k in wkeys:
                v = got[k]
                total = v[0] if isinstance(v, tuple) else v
                check(abs(total - gsum[k]) <= 1e-9 * scale,
                      f"serve.{name}[{k}]: {total!r} vs {gsum[k]!r}")
                if isinstance(v, tuple):
                    check(v[1] == gcnt[k], f"serve.{name}[{k}]: count")

    # -- serial: two runs a plan through a server of one worker ----------
    runtime.clear_cache()
    serial, serial_ms, steady_ms = {}, {}, {}
    with QueryServer(workers=1, kernelize="always") as one:
        for name, make, _ in plans:
            for ms in (serial_ms, steady_ms):
                req = make()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = _served(one.run(req))
                ms[name] = (time.perf_counter() - t0) * 1e3
                if name in serial:
                    _bitwise_same(got, serial[name],
                                  f"serve.serial.{name}: second run")
                serial[name] = got
            held(name, serial[name])
    serial_wall = sum(steady_ms[name] * count for name, _, count in plans)
    log("  serve.serial (ms, first run of each plan, compile included): "
        + ", ".join(f"{k} {v:.3f}" for k, v in serial_ms.items())
        + "; second run: "
        + ", ".join(f"{k} {v:.3f}" for k, v in steady_ms.items()))
    reqs = [(name, make()) for name, make, count in plans
            for _ in range(count)]
    clock("the tables, numpy's results and the serial runs")

    # -- (a), (b): 32 requests on 8 workers from a cold compile cache ----
    runtime.clear_cache()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def compiled(name, make, mode="always"):
        """The cached handle of one plan (a hit once it has been served)."""
        from repro_torch.core.lazy import build_program

        req = make()
        prog = req.program() if hasattr(req, "program") \
            else build_program(req)
        return runtime.compile_program(prog, kernelize=mode)

    handles = {}

    def serve_all(mode, stats):
        with QueryServer(workers=8, kernelize=mode) as srv:
            futs = [srv.submit(q) for _, q in reqs]
            got = [f.result() for f in futs]
            stats["serve"] = srv.stats()
        # the routes the served plans took, from their cached compiles
        for name, make, _ in plans:
            handles[name] = compiled(name, make)
            routed = handles[name].stats["kernelplan"]["routed"]
            for spec, n in routed.items():
                key = f"kernelize.{spec}"
                stats[key] = stats.get(key, 0) + n
        return got

    results, st = mp.run("serve", "always", serve_all, expect=SERVE_EXPECT)
    wall = mp.phase_ms["serve[always]"]["wall_ms"]
    peak = torch.cuda.max_memory_allocated()
    sv = st["serve"]
    for (name, _), got in zip(reqs, results):
        _bitwise_same(_served(got), serial[name], f"serve.{name} vs serial")
    del results
    check(sv["cache.misses"] == len(plans)
          and sv["cache.hits"] + sv["cache.waits"] == len(reqs) - len(plans)
          and runtime.cache_size() == len(plans),
          f"serve: {len(plans)} plans but {sv}")
    check(sv["serve.completed"] == len(reqs) and sv["serve.shed"] == 0
          and sv["serve.errors"] == 0, f"serve: {sv}")
    out.update(wall_ms=wall, serial_ms=serial_ms, requests=len(reqs),
               serial_steady_ms=steady_ms, serial_wall_ms=serial_wall,
               requests_per_s=len(reqs) / (wall / 1e3),
               serial_requests_per_s=len(reqs) / (serial_wall / 1e3),
               max_memory_allocated=peak, memory_at_start=base,
               counters={k: v for k, v in sv.items()
                         if k.startswith(("serve.", "cache."))})
    log(f"  serve: {len(reqs)} requests on 8 workers in {wall:.3f} ms "
        f"({out['requests_per_s']:.3f} requests/s) from a cold compile "
        f"cache; serially (each plan's second run times its count) "
        f"{serial_wall:.3f} ms ({out['serial_requests_per_s']:.3f} "
        f"requests/s); serial first runs {sum(serial_ms.values()):.3f} "
        f"ms; every result bitwise equal to its serial run; "
        f"{out['counters']}; max_memory_allocated {peak} bytes ({base} "
        f"at the start)")
    log(f"  serve card: {card_line()}")
    clock("32 requests on 8 workers, held")

    # -- (f) the tuned calls --------------------------------------------
    tuned = []
    for name, handle in handles.items():
        for ev in handle.stats.get("kernelplan", {}).get("autotune", []):
            tuned.append(dict(ev, plan=name))
            log(f"  serve.tuned: {name} {ev['kernel']} n={ev['n']} cap "
                f"{ev['params']} winner_us={ev['us']} default_us="
                f"{ev['default_us']} (tuner's clock: CUDA events, min of "
                f"3)")
    check(any(t["kernel"] in ("filter_reduce_sum", "dict_group_sum",
                              "vecmerger_segment_sum")
              and t["us"] is not None for t in tuned),
          f"serve: no B1/B4/B5 call tuned on the card: {tuned}")
    out["tuned"] = tuned
    handles.clear()

    # -- (c) a rebound CompiledQuery: zero compiles ----------------------
    cq = m1().compile()
    misses = runtime.cache_stats()["cache.misses"]
    cols2 = lineitem(s.lineitem, mp.seed + 100)
    r2 = np.random.RandomState(mp.seed + 105)
    probe2 = dict(cols2, orderdate=ssb_dates()[r2.randint(0, SSB_DAYS,
                                                          s.lineitem)])
    del cols2
    date2 = dict(date, rate=np.random.RandomState(mp.seed + 103)
                 .uniform(0.0, 0.1, 365))
    pos2 = np.clip(np.searchsorted(date2["datekey"], probe2["orderdate"]),
                   0, 364)
    keep2 = (date2["datekey"][pos2] == probe2["orderdate"]) \
        & (probe2["qty"] < 24.0)
    want2 = {c: v[keep2] for c, v in probe2.items()}
    want2["weeknum"] = date2["weeknum"][pos2[keep2]]
    want2["rate"] = date2["rate"][pos2[keep2]]
    t0 = time.perf_counter()
    got2 = _served(cq.run(table=weldrel.Table(probe2),
                          right=weldrel.Table(date2)))
    rebind_ms = (time.perf_counter() - t0) * 1e3
    check(runtime.cache_stats()["cache.misses"] == misses,
          "serve.rebind: a same-shape rebind compiled")
    same_table(got2, want2, "serve.rebind")
    del probe2, want2, got2, pos2, keep2
    out["rebind_ms"] = rebind_ms
    log(f"  serve.rebind: CompiledQuery.run(table=, right=) on tables from "
        f"another seed in {rebind_ms:.3f} ms, 0 compiles, equal to numpy")
    clock("(c), a rebound CompiledQuery")

    # -- (d) a request a byte below its certified peak sheds -------------
    peak_bytes = cq.stats["bounds.peak_bytes"]
    shed = m1()
    shed.memory_limit = peak_bytes - 1
    cached = runtime.cache_size()
    mp.ops.reset_counts()
    with QueryServer(workers=8, kernelize="always") as srv:
        try:
            srv.run(shed)
        except ResourceError as e:
            log(f"  serve.shed: memory_limit {peak_bytes - 1} shed: "
                f"{str(e)[:100]}")
        else:
            check(False, "serve.shed: admitted a byte below its peak")
        ss = srv.stats()
    check(ss["serve.shed"] == 1 and ss["serve.errors"] == 0,
          f"serve.shed: {ss}")
    check(all(n == (0, 0) for n in mp.ops.counts().values()),
          f"serve.shed: a shed request launched {mp.ops.counts()}")
    check(runtime.cache_size() == cached, "serve.shed: a shed plan was cached")

    # -- (e) calibration from traced runs --------------------------------
    def auto_reports():
        """Each plan compiled under "auto": (its EXPLAIN report, a
        function running it)."""
        reps = {}
        for name, make, _ in plans:
            req = make("auto") if name in ("join_m1", "group_agg",
                                           "join_mn") else make()
            if hasattr(req, "program"):
                cq_ = req.compile()
                reps[name] = (cq_.explain(), cq_.run)
            else:
                from repro_torch.core.lazy import build_program

                h = runtime.compile_program(build_program(req),
                                            kernelize="auto")
                reps[name] = (weldrel.PlanReport(op=name, stats=h.stats,
                                                 spans=[], analyze=False,
                                                 result=None), h.run)
        return reps

    # a ledger of the phase's own, so the medians it writes calibrate no
    # later phase's gate; one traced run a plan, each record its group's
    main_ledger = os.environ.get("WELD_COST_LEDGER")
    main_min = os.environ.get(calibrate.ENV_MIN_SAMPLES)
    os.environ["WELD_COST_LEDGER"] = obs.ledger.ledger_path() + ".serve"
    os.environ[calibrate.ENV_MIN_SAMPLES] = "1"
    calibrate.invalidate()
    runtime.clear_cache()
    before = {n: r.costs() for n, (r, _) in auto_reports().items()}
    clock("(d), and the roofline's \"auto\" compiles")
    obs.enable()
    try:
        with QueryServer(workers=1, kernelize="always") as one:
            for name, make, _ in plans:
                one.run(make())
    finally:
        obs.disable()
        obs.clear()
    clock("one traced run a plan")
    calibrate.invalidate()
    card = torch.cuda.get_device_name()
    medians = {k: g for k, g in calibrate.medians().items()
               if k[3:] == ("cuda", card)}
    runtime.clear_cache()
    flipped, flip_times = [], {}
    for name, (rep, go) in auto_reports().items():
        costs = rep.costs()
        check(len(costs) == len(before[name]),
              f"serve.calibrate: {name} priced {len(before[name])} then "
              f"{len(costs)} candidates")
        for b, a in zip(before[name], costs):
            n = re.search(r"\bn=(\d+)", a["why"])
            calls = max([g["calls"] for (k, _, bk, _, _), g in medians.items()
                         if k == a["kernel"] and n is not None
                         and bk == obs.ledger.size_bucket(int(n.group(1)))]
                        or [0])
            check(a["source"] == "measured"
                  or calls < calibrate.min_samples(),
                  f"serve.calibrate: {name} {a['kernel']} stayed roofline "
                  f"with {calls} records: {a['why']}")
            if b["routed"] and not a["routed"]:
                flipped.append(f"{name}.{a['kernel']}")
            log(f"  serve.calibrate: {name} {a['kernel']} roofline "
                f"kernel_us={b['kernel_us']} -> {a['source']} kernel_us="
                f"{a['kernel_us']} generic_us={a['jnp_us']} routed "
                f"{b['routed']} -> {a['routed']} ({a['why']})")
        if any(a["source"] == "measured" for a in costs):
            check("source=measured" in rep.render(),
                  f"serve.calibrate: {name}: explain() shows no measured "
                  f"source")
        held(name, _served(go()))
        if any(f.startswith(f"{name}.") for f in flipped):
            flip_times[name] = _flip_times(torch, compiled, name, make_of[name])
            t_kernel, t_generic = flip_times[name]
            log(f"  serve.calibrate: {name} flipped: always {t_kernel:.3f} ms, "
                f"auto {t_generic:.3f} ms (min of 3, inputs on the card)")
            check(t_kernel >= t_generic * (1.0 - FLIP_SPREAD),
                  f"serve.calibrate: {name} flipped a route to the generic "
                  f"lowering, but its kernel route runs in {t_kernel:.3f} "
                  f"ms against {t_generic:.3f}")
    log(f"  serve.calibrate: flipped {flipped or 'none'}; every auto run "
        f"equal to numpy")
    clock("the calibrated \"auto\" compiles and runs")
    if main_ledger is None:
        del os.environ["WELD_COST_LEDGER"]
    else:
        os.environ["WELD_COST_LEDGER"] = main_ledger
    if main_min is None:
        del os.environ[calibrate.ENV_MIN_SAMPLES]
    else:
        os.environ[calibrate.ENV_MIN_SAMPLES] = main_min
    calibrate.invalidate()
    out["flip_times_ms"] = flip_times
    out["flipped"] = flipped
    out["calibrated"] = {f"{k}|{d}|{b}": g for (k, d, b, _, _), g in
                         medians.items()}
    del probe, date, want_m1, build, mn_probe, want_mn, gkeys, gvals, cq
    runtime.clear_cache()
    return out


def _routed_body(stats: dict):
    """The IR lambda of the (one) map chain a planned program routed."""
    from repro_torch.core import ir

    calls = [n for n in ir.walk(stats["plan.ir"])
             if isinstance(n, ir.KernelCall) and n.kernel == "map_elementwise"]
    check(len(calls) == 1, f"expected one routed map chain, got {len(calls)}")
    return calls[0].fns[0]


RISKFREE, VOL = 0.02, 0.30


def bs_data(n: int, seed: int) -> dict:
    """Options drawn as the JAX package's benchmarks/workloads.py
    (make_bs_data) draws them."""
    rng = np.random.RandomState(seed)
    return {"price": rng.uniform(10, 200, n),
            "strike": rng.uniform(10, 200, n),
            "t": rng.uniform(0.1, 2.0, n)}


def bs_numpy(d: dict) -> np.ndarray:
    from scipy.special import erf

    s, k, t = d["price"], d["strike"], d["t"]
    sig_t = VOL * np.sqrt(t)
    d1 = (np.log(s / k) + (RISKFREE + 0.5 * VOL * VOL) * t) / sig_t
    d2 = d1 - sig_t

    def cnd(x):
        return 0.5 * (1.0 + erf(x / np.sqrt(2.0)))

    return s * cnd(d1) - k * np.exp(-RISKFREE * t) * cnd(d2)


def bs_weld(d: dict):
    """The Black-Scholes call price as benchmarks/workloads.py writes it
    in weldnp (black_scholes_weld_expr, without the final sum)."""
    from repro_torch.frames import weldnp

    s, k, t = (weldnp.array(d[c]) for c in ("price", "strike", "t"))

    def cnd(x):
        return (weldnp.erf(x * (1.0 / np.sqrt(2.0))) + 1.0) * 0.5

    sig_t = weldnp.sqrt(t) * VOL
    d1 = (weldnp.log(s / k) + t * (RISKFREE + 0.5 * VOL * VOL)) / sig_t
    d2 = d1 - sig_t
    return s * cnd(d1) - k * weldnp.exp(t * (-RISKFREE)) * cnd(d2)


def close_vec(got, want, rtol: float, what: str) -> None:
    got = np.asarray(got)
    check(got.shape == want.shape, f"{what}: shape {got.shape} vs "
                                   f"{want.shape}")
    check(bool(np.isfinite(got).all()), f"{what}: non-finite values")
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    check(float(err.max()) <= rtol, f"{what}: max relative error "
                                    f"{float(err.max())} > {rtol}")


def phase_blackscholes(mp: MainPath) -> None:
    """Fig. 5a: the price vector under every mode (a map chain) and its
    sum under "always" (the filter-reduce route)."""
    from repro_torch.core.lazy import Evaluate

    t0 = time.perf_counter()
    d = bs_data(mp.sizes.bs_options, mp.seed + 1)
    want = bs_numpy(d)
    log(f"blackscholes: {mp.sizes.bs_options} options and the numpy prices "
        f"in {time.perf_counter() - t0:.3f} s")

    def vector(mode, stats):
        return Evaluate(bs_weld(d).obj, kernelize=mode,
                        collect_stats=stats).value

    for mode in ("always", "always", "auto", "off"):
        got, stats = mp.run("blackscholes", mode, vector, expect=[
            ("map_elementwise", "map_elementwise")])
        close_vec(got, want, 1e-9, f"blackscholes[{mode}]")
        if mode == "always":
            mp.bodies["blackscholes"] = _routed_body(stats)

    def total(mode, stats):
        return Evaluate(bs_weld(d).sum().obj, kernelize=mode,
                        collect_stats=stats).value

    got, _ = mp.run("blackscholes.sum", "always", total,
                    expect=[("filter_reduce_sum", "filter_reduce_sum")])
    close(got, float(want.sum()), 1e-9, "blackscholes.sum[always]")


def logreg_data(n: int, d: int, seed: int):
    """Features centred on 0 and normal weights, so that the scores span
    both classes (with all-positive features and weights every sigmoid
    rounds to 1 and the loss carries few significant digits)."""
    rng = np.random.RandomState(seed)
    return rng.rand(n, d) - 0.5, rng.randn(d)


def phase_logreg(mp: MainPath) -> None:
    """Fig. 5d: logistic-regression scoring through weldflow, in the
    paper's three sessions: native (one eager op per node), xla (the whole
    graph through one torch.compile, a baseline) and weld (the graph
    transformer, the optimizer and the kernels)."""
    from repro_torch.core import kernelplan
    from repro_torch.frames import weldflow

    n, dim = mp.sizes.logreg
    t0 = time.perf_counter()
    m, w = logreg_data(n, dim, mp.seed + 9)
    z = m @ w + 0.25
    want = float(np.mean(np.log(1.0 / (1.0 + np.exp(-z)))))
    log(f"logreg: {n} x {dim} rows generated in "
        f"{time.perf_counter() - t0:.3f} s")
    x = weldflow.placeholder()
    logits = weldflow.matvec(x, weldflow.constant(w)) + 0.25
    loss = weldflow.reduce_mean(weldflow.log(weldflow.sigmoid(logits)))
    feed = {x: m}
    results = {}
    for session, mode in (("native", "native"), ("native", "native"),
                          ("xla", "xla"), ("xla", "xla"),
                          ("weld", "always"), ("weld", "always"),
                          ("weld", "auto")):
        def run(mode, stats, session=session):
            # the weld session plans under the process default mode
            was = kernelplan.DEFAULT_KERNELIZE
            if session == "weld":
                kernelplan.set_default_kernelize(mode)
            try:
                return weldflow.Session(session).run(
                    loss, feed, collect_stats=stats)
            finally:
                kernelplan.set_default_kernelize(was)

        got, stats = mp.run(f"logreg.{session}", mode, run, expect=[
            ("matvec", "tiled_matmul"),
            ("map_elementwise", "map_elementwise"),
            ("filter_reduce_sum", "filter_reduce_sum")])
        close(got, want, 1e-9, f"logreg.{session}[{mode}]")
        if session != "weld":
            check(all(v == (0, 0) for v in mp.last_counts.values()),
                  f"logreg.{session}: a port kernel ran in a baseline session")
        if mode == "always":
            mp.bodies["logreg"] = _routed_body(stats)
        results.setdefault(session, []).append(float(got))
    log(f"  logreg values: { {k: v[0] for k, v in results.items()} } "
        f"numpy {want!r}")


def phase_matmul(mp: MainPath) -> None:
    """weldnp dots of two square matrices: f64 (the tiled kernel under
    "always", torch.matmul under "off"), then the same matrices rounded to
    f32 (``matmul.f32``: the kernel under "always" twice, bitwise equal;
    torch.matmul under "off"; "auto" takes the route the gate prices
    cheaper), each f32 result held element by element to the rounding
    bound of a k-term f32 dot product, gamma_k (|A| |B|), gamma_k =
    k u / (1 - k u) and u = 2**-24, around numpy's f64 product of the
    same f32 inputs."""
    from repro_torch.core.lazy import Evaluate
    from repro_torch.frames import weldnp

    side = mp.sizes.matmul
    rng = np.random.RandomState(mp.seed + 10)
    a, b = rng.rand(side, side), rng.rand(side, side)
    want = a @ b

    def product(x, y):
        def run(mode, stats):
            return Evaluate(weldnp.array(x).dot(weldnp.array(y)).obj,
                            kernelize=mode, collect_stats=stats).value
        return run

    for mode in ("always", "always", "off"):
        got, _ = mp.run("matmul", mode, product(a, b),
                        expect=[("matmul", "tiled_matmul")])
        got = np.asarray(got)
        check(got.shape == want.shape, f"matmul[{mode}]: shape {got.shape}")
        err = float(np.abs(got - want).max() / np.abs(want).max())
        check(err <= 1e-10, f"matmul[{mode}]: relative error {err}")

    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    del a, b, want
    exact = a32.astype(np.float64) @ b32.astype(np.float64)
    ku = side * 2.0 ** -24
    # the inputs are nonnegative, so |A| |B| is the product itself
    bound = ku / (1.0 - ku) * exact
    runs = []
    for mode in ("always", "always", "off", "auto"):
        got, stats = mp.run("matmul.f32", mode, product(a32, b32),
                            expect=[("matmul", "tiled_matmul")])
        got = np.asarray(got)
        check(got.dtype == np.float32 and got.shape == exact.shape,
              f"matmul.f32[{mode}]: {got.dtype} {got.shape}")
        worst = float((np.abs(got - exact) / bound).max())
        check(worst <= 1.0, f"matmul.f32[{mode}]: an element {worst} times "
                            f"its rounding bound from the exact product")
        routed = stats.get("kernelize.matmul", 0) > 0
        launched = mp.last_counts["tiled_matmul"][0]
        check(launched == (1 if routed else 0),
              f"matmul.f32[{mode}]: routed={routed}, {launched} launches")
        if mode == "off":
            check(not routed, "matmul.f32[off]: the kernel route was taken")
        log(f"  matmul.f32[{mode}]: route "
            f"{'tiled_matmul' if routed else 'torch.matmul'}, largest "
            f"|error| / bound {worst:.4f}")
        if mode == "always":
            runs.append(got)
    check(np.array_equal(runs[0].view(np.uint32), runs[1].view(np.uint32)),
          "matmul.f32[always]: two runs differ bitwise")


# -- the LM serving path ------------------------------------------------------

#: attention, kernel against the plain version (the hold and each layer
#: of lm_serve): the per-element limit of ``flash_attention.tolerance``
#: (f32: 2e-5 + 2e-4 |plain|, the JAX package's own kernel test; bf16:
#: 2**-7 |plain| for the two bf16 roundings of the result plus 2**-6 R for
#: the kernel's rounding of p, R the root of the squared softmax-weighted
#: values), read as the largest |kernel - plain| / limit, which must not
#: exceed 1
#: planted faults the bf16 limit must reject, each a copy of the Hopper
#: route's csrc/flash_attention_sm90.cu (the prefill shape's kernel) with
#: one text replaced: (name, text, by)
ATTN_FAULT_SOURCE = "flash_attention_sm90.cu"
ATTN_FAULTS = (
    ("causal_off_by_one", "(p.causal && kj > qi)",
     "(p.causal && kj > qi + 1)"),
    ("kv_head_interleaved", "const int hk = it.h / p.group;",
     "const int hk = it.h % (p.heads / p.group);"),
)
#: decode against prefill in bf16, as a share of the largest |logit|: 28
#: layers of bf16 (2**-8 per rounding) through two paths that round at
#: other places (the kernel's p, cuBLAS's shapes, the decode's f32
#: softmax over the bf16 cache)
DECODE_BF16_REL = 5e-2
#: the same f32 model on the card and on the CPU, as a share of the
#: largest |logit|: other summation orders only (TF32 off)
CROSS_F32_REL = 1e-4


def _device_profile(torch, fn, top: int = 6):
    """Device-busy ms of one call of ``fn`` (the CUDA activities of a
    profiler trace, summed: one stream, so they do not overlap) and its
    ``top`` kernels as [(name, ms, calls)]."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key[:60], us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return busy, [(n, round(ms, 3), c) for n, ms, c in rows[:top]]


class _Capture:
    """Swaps ``ops.attention`` (what every layer's prefill calls) for a
    wrapper that keeps each call's q, k, v, output and options; launches
    nothing of its own."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = []

    def __enter__(self):
        orig = self.orig = self.ops.attention

        def attention(q, k, v, **kw):
            out = orig(q, k, v, **kw)
            self.calls.append((q, k, v, out, kw))
            return out

        self.ops.attention = attention
        return self

    def __exit__(self, *exc):
        self.ops.attention = self.orig


def phase_lm_serve(torch, sizes: Sizes, seed: int, launches: dict,
                   dev="cuda") -> dict:
    """Serve ``sizes.lm_arch`` at full width and depth through
    ``repro_torch.launch.serve``: each prefill must launch flash_attention
    once per layer and serve no plain version; every layer's attention is
    held against ``ref.attention`` on its own q/k/v; teacher-forced decode
    against prefill; two runs bitwise equal; and a depth-cut f32 copy on
    the card against the same weights on the CPU."""
    import dataclasses

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lm
    from repro_torch.models import build_model

    dev = torch.device(dev)
    cfg = get_config(sizes.lm_arch, smoke=sizes.lm_smoke)
    model = build_model(cfg)
    b, prompt, gen_len = sizes.lm_batch, sizes.lm_prompt, sizes.lm_gen
    t0 = time.perf_counter()
    with torch.inference_mode():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen)
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    log(f"lm_serve: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} vocab={cfg.vocab} "
        f"{cfg.dtype}: {n_params} parameters drawn in "
        f"{time.perf_counter() - t0:.3f} s")

    def drive(what, capture=None):
        """One serve call on the main path, counters zeroed just before
        and read just after."""
        torch.cuda.synchronize()
        ops.reset_counts()
        if capture is None:
            out = lm.serve(cfg, batch=b, prompt_len=prompt, gen_len=gen_len,
                           seed=seed, verbose=False, params=params)
        else:
            with capture:
                out = lm.serve(cfg, batch=b, prompt_len=prompt,
                               gen_len=gen_len, seed=seed, verbose=False,
                               params=params)
        torch.cuda.synchronize()
        counts = ops.counts()
        for name, (n, _) in counts.items():
            launches[name] += n
        n_fa, plain = counts["flash_attention"]
        sm90 = fa.flash_attention.launches_sm90
        launches[SM90] += sm90
        check(n_fa == cfg.n_layers,
              f"lm_serve {what}: flash_attention launched {n_fa} times in "
              f"one prefill, the model has {cfg.n_layers} layers")
        check(sm90 == n_fa,
              f"lm_serve {what}: {n_fa - sm90} of {n_fa} bf16 D="
              f"{cfg.d_model // cfg.n_heads} flash_attention launches missed "
              f"the Hopper route")
        check(all(p == 0 for _, p in counts.values()),
              f"lm_serve {what}: plain versions served calls: {counts}")
        step_ms = out["decode_s"] / max(gen_len - 1, 1) * 1e3
        log(f"lm_serve {what}: prefill_ms={out['prefill_s'] * 1e3:.3f} "
            f"decode_ms_per_step={step_ms:.3f} tok_per_s="
            f"{out['tok_per_s']:.1f} flash_attention launches={n_fa} "
            f"(sm90 route {sm90}) "
            f"tokens[0][:8]={out['tokens'][0][:8].tolist()}")
        check(tuple(out["tokens"].shape) == (b, gen_len)
              and bool(torch.isfinite(out["logits"]).all()),
              f"lm_serve {what}: tokens {out['tokens'].shape} or logits not "
              f"finite")
        return out

    # run 1, with every layer's attention kept: each against ref.attention
    cap = _Capture(ops)
    first = drive("run 1 (layers captured)", cap)
    check(len(cap.calls) == cfg.n_layers,
          f"lm_serve: {len(cap.calls)} attention calls captured")
    worst = worst_ratio = 0.0
    for i, (q, k, v, out, kw) in enumerate(cap.calls):
        err, ratio, *_ = _attention_held(torch, out, q, k, v, kw["causal"],
                                         kw["group"])
        check(ratio <= 1.0,
              f"lm_serve: layer {i} attention differs from ref.attention "
              f"by {err}, {ratio} x its limit")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    log(f"lm_serve: {len(cap.calls)} layers x {b} sequences of attention "
        f"match ref.attention, max |kernel - plain| {worst:.3e}, at most "
        f"{worst_ratio:.4f} of the per-element limit (2**-7 |plain| + "
        f"2**-6 R)")
    del cap, q, k, v, out

    # runs 2 and 3: timed, bitwise equal to each other and to run 1
    second = drive("run 2")
    third = drive("run 3")
    for name, other in (("run 1", first), ("run 3", third)):
        check(np.array_equal(second["tokens"], other["tokens"])
              and torch.equal(second["logits"], other["logits"]),
              f"lm_serve: run 2 and {name} differ")
    log("lm_serve: runs 1-3 bitwise equal (tokens and logits)")

    # where the time goes: one prefill and decode steps under the profiler
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, (b, prompt)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        busy_p, top_p = _device_profile(
            torch, lambda: model.prefill(params, {"tokens": toks}))
        _, cache = model.prefill(params, {"tokens": toks})
        cache = lm._pad_cache_to(cache, model.cache_spec(b, prompt + 4))
        last = toks[:, -1:]

        def steps():
            for t in range(prompt, prompt + 4):
                model.decode_step(params, cache, last, t)

        busy_d, top_d = _device_profile(torch, steps)
        busy_d /= 4
    del cache
    wall_p = min(r["prefill_s"] for r in (second, third)) * 1e3
    wall_d = min(r["decode_s"] for r in (second, third)) / max(
        gen_len - 1, 1) * 1e3
    log(f"lm_serve profile: prefill device-busy {busy_p:.3f} ms of "
        f"{wall_p:.3f} ms wall (idle share {1 - busy_p / wall_p:.3f}); "
        f"top: {top_p}")
    log(f"lm_serve profile: decode step device-busy {busy_d:.3f} ms of "
        f"{wall_d:.3f} ms wall (idle share {1 - busy_d / wall_d:.3f}); "
        f"top (4 steps): {top_d}")

    # decode against prefill, teacher-forced over the prompt's last tokens
    n_dec = sizes.lm_decode_check
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": toks[:, :prompt - n_dec]})
        cache = lm._pad_cache_to(cache, model.cache_spec(b, prompt))
        for t in range(prompt - n_dec, prompt):
            step, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    full = second["logits"][:, 0]
    dec_err = float((step[:, 0] - full).abs().max())
    scale = float(full.abs().max())
    check(dec_err <= DECODE_BF16_REL * scale,
          f"lm_serve: decode differs from prefill by {dec_err} "
          f"(> {DECODE_BF16_REL} x {scale})")
    agree = int((step[:, 0].argmax(-1) == full.argmax(-1)).sum())
    log(f"lm_serve: teacher-forced decode of the last {n_dec} prompt tokens "
        f"vs prefill: max |diff| {dec_err:.4e} (max |logit| {scale:.4f}, "
        f"tolerance {DECODE_BF16_REL} of it), argmax equal in {agree}/{b}")
    del cache, step, params
    torch.cuda.empty_cache()

    # the same code on both devices: a depth-cut f32 copy, one set of weights
    layers, cb, cprompt, cgen = sizes.lm_cross
    small = dataclasses.replace(cfg, n_layers=layers, dtype="float32",
                                param_dtype="float32")
    with torch.inference_mode():
        cpu_params = build_model(small).init(torch.Generator().manual_seed(
            seed + 1))
    t0 = time.perf_counter()
    repro_torch.set_default_device("cpu")
    try:
        on_cpu = lm.serve(small, batch=cb, prompt_len=cprompt, gen_len=cgen,
                          seed=seed, verbose=False, params=cpu_params)
    finally:
        repro_torch.set_default_device(dev)
    cpu_s = time.perf_counter() - t0
    ops.reset_counts()
    on_card = lm.serve(small, batch=cb, prompt_len=cprompt, gen_len=cgen,
                       seed=seed, verbose=False, params=cpu_params)
    torch.cuda.synchronize()
    n_fa, plain = ops.counts()["flash_attention"]
    launches["flash_attention"] += n_fa
    check(n_fa == layers and plain == 0
          and fa.flash_attention.launches_sm90 == 0,
          f"lm_serve f32 on the card: flash_attention {n_fa} launches "
          f"({fa.flash_attention.launches_sm90} on the Hopper route), "
          f"{plain} plain calls")
    err = float((on_card["logits"].cpu() - on_cpu["logits"]).abs().max())
    scale = float(on_cpu["logits"].abs().max())
    check(np.array_equal(on_card["tokens"], on_cpu["tokens"])
          and err <= CROSS_F32_REL * max(scale, 1.0),
          f"lm_serve: f32 card vs CPU: tokens equal "
          f"{np.array_equal(on_card['tokens'], on_cpu['tokens'])}, max |diff| "
          f"{err} (tolerance {CROSS_F32_REL} x {scale})")
    log(f"lm_serve: {layers}-layer f32 copy, batch {cb} x prompt {cprompt} + "
        f"{cgen}: card vs CPU tokens equal, max |logit diff| {err:.3e} "
        f"(max |logit| {scale:.4f}, tolerance {CROSS_F32_REL} of it); CPU "
        f"run {cpu_s:.1f} s")
    del cpu_params, on_card, on_cpu
    torch.cuda.empty_cache()

    runs = (second, third)
    best = min(runs, key=lambda r: r["prefill_s"])
    return {
        "arch": cfg.name, "params": n_params, "batch": b, "prompt": prompt,
        "gen": gen_len,
        "prefill_ms": [r["prefill_s"] * 1e3 for r in runs],
        "decode_ms_per_step": [r["decode_s"] / max(gen_len - 1, 1) * 1e3
                               for r in runs],
        "tok_per_s": [r["tok_per_s"] for r in runs],
        "best_prefill_ms": best["prefill_s"] * 1e3,
        "layer_attention_max_err": worst,
        "layer_attention_max_limit_share": worst_ratio,
        "decode_vs_prefill_err": dec_err,
        "cross_device_f32_err": err, "prefill_device_busy_ms": busy_p,
        "decode_step_device_busy_ms": busy_d, "prefill_top": top_p,
        "decode_top": top_d,
    }


# -- the LM stack's other families --------------------------------------------

#: lm_families: (arch, config replacements of the card run (the depth
#: cuts), batch, prompt, generated, prompt tokens decoded teacher-forced
#: against prefill, the f32 copy's config replacements, (batch, prompt,
#: generated) of the f32 copy).  Full width throughout; depth is cut
#: where the bf16 weights do not fit the card (dbrx 264 GB whole, the
#: vision model 180 GB) and, for the f32 copy, to what the CPU serves in
#: seconds.  The SSM families decode 128 tokens: a prefill's length is a
#: multiple of their chunk (128).
FAMILIES = (
    ("deepseek-moe-16b", {}, 2, 512, 16, 8, {"n_layers": 2}, (2, 32, 3)),
    ("dbrx-132b", {"n_layers": 2}, 2, 512, 16, 8, {"n_layers": 1},
     (2, 32, 3)),
    ("zamba2-1.2b", {}, 2, 512, 16, 128, {"n_layers": 2}, (2, 32, 3)),
    ("xlstm-350m", {}, 2, 512, 16, 128, {"n_layers": 8}, (2, 32, 3)),
    ("whisper-large-v3", {}, 2, 448, 16, 8,
     {"n_layers": 2, "n_enc_layers": 2}, (2, 32, 3)),
    ("llama-3.2-vision-90b", {"n_layers": 5}, 2, 2048, 16, 8,
     {"n_layers": 2, "cross_attn_every": 2}, (2, 32, 3)),
)
#: the families whose decode against prefill is held in f32 at full width
#: and depth (to CROSS_F32_REL), their bf16 divergence logged beside it.
#: In bf16 two paths to the same logits round apart (a product's shape
#: changes its summation order), and these random-weight stacks carry
#: such roundings much further than the dense model of lm_serve: on the
#: CPU, where a prefill's rounding depends on its length, the same prompt
#: prefilled alone and as the prefix of a longer one — no decode
#: involved — differs by as much as decode and prefill do
#: (``repro_torch.launch.decode_drift``), while in f32 decode and prefill
#: agree to CROSS_F32_REL
DECODE_F32_FAMILIES = ("hybrid", "ssm")
#: the vision model's cross-attention gates, drawn at 0 by the reference's
#: init (which would leave the cross-attention out of every logit): set to
#: this before serving
VLM_GATE = 0.5


def _family_inputs(torch, cfg, seed: int, batch: int, prompt: int, dev):
    """What ``serve`` draws for its prefill, in its order."""
    from repro_torch.launch.serve import prompt_batch

    return prompt_batch(cfg, np.random.RandomState(seed), batch, prompt, dev)


def _family_decode_err(torch, model, params, batch_in, prompt: int,
                       n_dec: int, routing=None) -> tuple:
    """Teacher-forced decode of the prompt's last ``n_dec`` tokens after a
    prefill of the rest, against the prefill of the whole prompt: (max
    |diff| of the last logits, max |logit|, rows whose argmax agrees).
    With ``routing`` (MoE, a ``_MoeRouting`` entered by the caller) the
    full prefill's expert choices are recorded, and the prefix's prefill
    and each decode step either take them (``routing.pin``) or choose
    their own, counted where they differ (``routing.flips``)."""
    from repro_torch.launch import serve as lm

    b = batch_in["tokens"].shape[0]
    toks = batch_in["tokens"]
    with torch.inference_mode():
        if routing is not None:
            routing.begin(record=True)
        full, _ = model.prefill(params, batch_in)
        if routing is not None:
            routing.begin(window=(0, prompt - n_dec))
        _, cache = model.prefill(params, dict(
            batch_in, tokens=toks[:, :prompt - n_dec]))
        cache = lm._pad_cache_to(cache, model.cache_spec(b, prompt))
        for t in range(prompt - n_dec, prompt):
            if routing is not None:
                routing.begin(window=(t, t + 1))
            step, cache = model.decode_step(params, cache,
                                            toks[:, t:t + 1], t)
    full, step = full[:, 0], step[:, 0]
    err = float((step - full).abs().max())
    agree = int((step.argmax(-1) == full.argmax(-1)).sum())
    return err, float(full.abs().max()), agree


class _MoeRouting:
    """Wraps ``Moe.route`` while it is entered (launching nothing of its
    own): counts the slots dropped past capacity; and, for the decode
    check, records each MoE layer's expert choices in a prefill
    (``begin(record=True)``), then, for a later forward over the token
    window ``begin(window=(lo, hi))``, pins each layer to the recorded
    choices of those tokens (``pin``) or counts the (layer, token) whose
    own choice differs (``flips``)."""

    def __init__(self, moe_mod, pin: bool = False):
        self.moe, self.pin = moe_mod, pin
        self.dropped, self.slots = [], 0
        self.recorded, self.flips, self.compared = [], 0, 0
        self.mode, self.window, self.calls = None, None, 0

    def begin(self, record: bool = False, window=None):
        self.mode = "record" if record else "window"
        if record:
            self.recorded = []
        self.window, self.calls = window, 0

    def __enter__(self):
        orig = self.orig = self.moe.Moe.route

        def route(mod, xt, ids=None):
            k = mod.cfg.top_k
            if self.mode == "window":
                rec = self.recorded[self.calls]
                want = rec[:, self.window[0]:self.window[1]].reshape(-1, k)
                if self.pin:
                    ids = want
            r = orig(mod, xt, ids=ids)
            if self.mode == "record":
                b = self.batch
                self.recorded.append(r.ids.view(b, -1, k))
            elif self.mode == "window" and not self.pin:
                same = (r.ids.sort(-1).values == want.sort(-1).values).all(-1)
                self.flips += int((~same).sum())
                self.compared += same.numel()
            self.calls += 1
            self.dropped.append((~r.keep).sum())
            self.slots += r.keep.numel()
            return r

        self.moe.Moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.Moe.route = self.orig
        self.mode = None

    def count(self) -> int:
        return int(sum(int(d) for d in self.dropped))


def phase_lm_families(torch, sizes: Sizes, seed: int, launches: dict,
                      dev="cuda") -> list:
    """Serve each family of ``sizes.families`` in bf16 through
    ``repro_torch.launch.serve`` at full width (depth cut where the
    weights do not fit): each prefill launches flash_attention as often as
    the structure has attention calls, all on the Hopper route, no plain
    version serves a call; each captured attention call, causal or not,
    within its limit of ``ref.attention``; teacher-forced decode against
    prefill; two runs bitwise equal; and an f32 depth-cut copy on the card
    against the same weights on the CPU.  Each model is freed before the
    next is drawn."""
    import dataclasses

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lm
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.kernels.launch_counts import attention_calls

    dev = torch.device(dev)
    rows = []
    for (arch, cut, b, prompt, gen_len, n_dec, f32_cut,
         (cb, cprompt, cgen)) in sizes.families or FAMILIES:
        cfg = dataclasses.replace(get_config(arch, smoke=sizes.lm_smoke),
                                  **cut)
        name = cfg.name
        model = build_model(cfg)
        t0 = time.perf_counter()
        with torch.inference_mode():
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = model.init(gen)
            if cfg.family == "vlm":
                for k in params:
                    if k.endswith(".gate"):
                        params[k].fill_(VLM_GATE)
        torch.cuda.synchronize()
        n_params = model.param_count(params)
        want_fa = attention_calls(cfg)[0]
        log(f"lm_families {name}: {cfg.family}, {cfg.n_layers} layers"
            + (f" (cut from {get_config(arch).n_layers})" if cut else "")
            + f" d_model={cfg.d_model} heads={cfg.n_heads}/"
            f"{cfg.n_kv_heads} {cfg.dtype}: {n_params} parameters "
            f"({model.active_param_count()} active) drawn in "
            f"{time.perf_counter() - t0:.3f} s; batch {b} x prompt {prompt}"
            f" + {gen_len}; {want_fa} attention calls a prefill")

        def drive(what, capture=None):
            torch.cuda.synchronize()
            ops.reset_counts()
            if capture is None:
                out = lm.serve(cfg, batch=b, prompt_len=prompt,
                               gen_len=gen_len, seed=seed, verbose=False,
                               params=params)
            else:
                with capture:
                    out = lm.serve(cfg, batch=b, prompt_len=prompt,
                                   gen_len=gen_len, seed=seed,
                                   verbose=False, params=params)
            torch.cuda.synchronize()
            counts = ops.counts()
            for k, (n, _) in counts.items():
                launches[k] += n
            n_fa = counts["flash_attention"][0]
            sm90 = fa.flash_attention.launches_sm90
            launches[SM90] += sm90
            check(n_fa == want_fa,
                  f"lm_families {name} {what}: flash_attention launched "
                  f"{n_fa} times in one prefill, the structure has "
                  f"{want_fa} attention calls")
            check(sm90 == n_fa,
                  f"lm_families {name} {what}: {n_fa - sm90} of {n_fa} bf16 "
                  f"flash_attention launches missed the Hopper route")
            check(all(p == 0 for _, p in counts.values()),
                  f"lm_families {name} {what}: plain versions served "
                  f"calls: {counts}")
            check(tuple(out["tokens"].shape) == (b, gen_len)
                  and bool(torch.isfinite(out["logits"]).all()),
                  f"lm_families {name} {what}: tokens "
                  f"{out['tokens'].shape} or logits not finite")
            step_ms = out["decode_s"] / max(gen_len - 1, 1) * 1e3
            log(f"lm_families {name} {what}: prefill_ms="
                f"{out['prefill_s'] * 1e3:.3f} decode_ms_per_step="
                f"{step_ms:.3f} tok_per_s={out['tok_per_s']:.1f} "
                f"flash_attention launches={n_fa} (sm90 route {sm90}) "
                f"tokens[0][:8]={out['tokens'][0][:8].tolist()}")
            return out

        cap = _Capture(ops)
        drops = _MoeRouting(moe_mod)
        with drops:
            first = drive("run 1 (attention captured)", cap)
        check(len(cap.calls) == want_fa,
              f"lm_families {name}: {len(cap.calls)} attention calls "
              f"captured, want {want_fa}")
        worst = worst_ratio = 0.0
        kinds = {}
        for i, (q, k, v, out, kw) in enumerate(cap.calls):
            err, ratio, *_ = _attention_held(torch, out, q, k, v,
                                             kw["causal"], kw["group"])
            check(ratio <= 1.0,
                  f"lm_families {name}: attention call {i} (causal "
                  f"{kw['causal']}, Sq {q.shape[2]}, Skv {k.shape[2]}) "
                  f"differs from ref.attention by {err}, {ratio} x its "
                  f"limit")
            key = (bool(kw["causal"]), q.shape[2], k.shape[2])
            kinds[key] = kinds.get(key, 0) + 1
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        log(f"lm_families {name}: {len(cap.calls)} attention calls (causal, "
            f"Sq, Skv: count) {sorted(kinds.items())} match ref.attention, "
            f"max |kernel - plain| {worst:.3e}, at most {worst_ratio:.4f} "
            f"of the per-element limit")
        del cap
        if cfg.family == "moe":
            log(f"lm_families {name}: run 1 dropped {drops.count()} of "
                f"{drops.slots} MoE slots (capacity factor "
                f"{cfg.capacity_factor})")

        second = drive("run 2")
        check(np.array_equal(first["tokens"], second["tokens"])
              and torch.equal(first["logits"], second["logits"]),
              f"lm_families {name}: runs 1 and 2 differ")
        log(f"lm_families {name}: runs 1 and 2 bitwise equal (tokens and "
            f"logits)")
        del first

        # decode against prefill.  MoE: at a capacity factor where no slot
        # can drop (a prefill of the batch drops slots past an expert's
        # capacity, which one decoded token a row never reaches), and
        # with each layer's experts pinned to the full prefill's choices:
        # top-k is discontinuous, so bf16 rounding that differs between
        # the two paths can flip a near-tied choice (counted unpinned)
        batch_in = _family_inputs(torch, cfg, seed, b, prompt, dev)
        dec_model, dec_note, pinned = model, "", None
        if cfg.family == "moe":
            dec_model = build_model(dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k))
            free = _MoeRouting(moe_mod)
            free.batch = b
            with free:
                own_err, own_scale, own_agree = _family_decode_err(
                    torch, dec_model, params, batch_in, prompt, n_dec, free)
            pinned = _MoeRouting(moe_mod, pin=True)
            pinned.batch = b
            dec_note = (f" at capacity factor {cfg.n_experts / cfg.top_k}"
                        f" with the experts pinned to the prefill's (each "
                        f"layer choosing its own: {free.flips} of "
                        f"{free.compared} (layer, token) choices differ, "
                        f"max |diff| {own_err:.4e} of "
                        f"{own_scale:.4f}, argmax equal in {own_agree}/{b}; "
                        f"not held)")
        if pinned is None:
            dec_err, scale, agree = _family_decode_err(
                torch, dec_model, params, batch_in, prompt, n_dec)
        else:
            with pinned:
                dec_err, scale, agree = _family_decode_err(
                    torch, dec_model, params, batch_in, prompt, n_dec,
                    pinned)
        bf16_held = cfg.family not in DECODE_F32_FAMILIES
        if bf16_held:
            check(dec_err <= DECODE_BF16_REL * scale,
                  f"lm_families {name}: decode differs from prefill by "
                  f"{dec_err} (> {DECODE_BF16_REL} x {scale}){dec_note}")
        log(f"lm_families {name}: teacher-forced decode of the last {n_dec}"
            f" prompt tokens vs prefill{dec_note}: max |diff| "
            f"{dec_err:.4e} (max |logit| {scale:.4f}, "
            + (f"tolerance {DECODE_BF16_REL} of it" if bf16_held else
               "not held in bf16: held in f32 below")
            + f"), argmax equal in {agree}/{b}")
        del batch_in, params, dec_model
        gc.collect()
        torch.cuda.empty_cache()
        dec_f32 = None
        if not bf16_held:
            # the same decode check at full width and depth in f32
            full32 = dataclasses.replace(cfg, dtype="float32",
                                         param_dtype="float32")
            model32 = build_model(full32)
            with torch.inference_mode():
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed)
                params32 = model32.init(gen)
            dec_f32, scale32, agree32 = _family_decode_err(
                torch, model32, params32, _family_inputs(
                    torch, full32, seed, b, prompt, dev), prompt, n_dec)
            check(dec_f32 <= CROSS_F32_REL * max(scale32, 1.0),
                  f"lm_families {name}: f32 decode differs from prefill by "
                  f"{dec_f32} (> {CROSS_F32_REL} x {scale32})")
            log(f"lm_families {name}: the same in f32 at full depth: max "
                f"|diff| {dec_f32:.4e} (max |logit| {scale32:.4f}, "
                f"tolerance {CROSS_F32_REL} of it), argmax equal in "
                f"{agree32}/{b}")
            del model32, params32
            gc.collect()
            torch.cuda.empty_cache()

        # the same code on both devices: a depth-cut f32 copy, one set of
        # weights drawn on the card and copied to the host
        small = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32", **f32_cut)
        small_model = build_model(small)
        with torch.inference_mode():
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + 1)
            card_params = small_model.init(gen)
            if small.family == "vlm":
                for k in card_params:
                    if k.endswith(".gate"):
                        card_params[k].fill_(VLM_GATE)
            cpu_params = {k: t.cpu() for k, t in card_params.items()}
        t0 = time.perf_counter()
        repro_torch.set_default_device("cpu")
        try:
            on_cpu = lm.serve(small, batch=cb, prompt_len=cprompt,
                              gen_len=cgen, seed=seed, verbose=False,
                              params=cpu_params)
        finally:
            repro_torch.set_default_device(dev)
        cpu_s = time.perf_counter() - t0
        ops.reset_counts()
        on_card = lm.serve(small, batch=cb, prompt_len=cprompt, gen_len=cgen,
                           seed=seed, verbose=False, params=card_params)
        torch.cuda.synchronize()
        n_fa, plain = ops.counts()["flash_attention"]
        launches["flash_attention"] += n_fa
        want_small = attention_calls(small)[0]
        check(n_fa == want_small and plain == 0
              and fa.flash_attention.launches_sm90 == 0,
              f"lm_families {name} f32 on the card: flash_attention {n_fa} "
              f"launches (want {want_small}; "
              f"{fa.flash_attention.launches_sm90} on the Hopper route), "
              f"{plain} plain calls")
        err = float((on_card["logits"].cpu() - on_cpu["logits"]).abs().max())
        cscale = float(on_cpu["logits"].abs().max())
        check(np.array_equal(on_card["tokens"], on_cpu["tokens"])
              and err <= CROSS_F32_REL * max(cscale, 1.0),
              f"lm_families {name}: f32 card vs CPU: tokens equal "
              f"{np.array_equal(on_card['tokens'], on_cpu['tokens'])}, max "
              f"|diff| {err} (tolerance {CROSS_F32_REL} x {cscale})")
        cut_s = ", ".join(f"{k}={v}" for k, v in f32_cut.items())
        log(f"lm_families {name}: f32 copy ({cut_s}), "
            f"batch {cb} x prompt {cprompt} + {cgen}: card vs CPU tokens "
            f"equal, max |logit diff| {err:.3e} (max |logit| {cscale:.4f}, "
            f"tolerance {CROSS_F32_REL} of it), {n_fa} v1 launches; CPU run "
            f"{cpu_s:.1f} s")
        del card_params, cpu_params, on_card, on_cpu, small_model, model
        gc.collect()
        torch.cuda.empty_cache()

        rows.append({
            "arch": name, "family": cfg.family, "layers": cfg.n_layers,
            "cut": cut, "params": n_params, "batch": b, "prompt": prompt,
            "gen": gen_len, "attention_calls": want_fa,
            "prefill_ms": second["prefill_s"] * 1e3,
            "decode_ms_per_step": second["decode_s"] / max(gen_len - 1, 1)
            * 1e3,
            "tok_per_s": second["tok_per_s"],
            "attention_max_err": worst,
            "attention_max_limit_share": worst_ratio,
            "moe_dropped": drops.count() if cfg.family == "moe" else None,
            "decode_vs_prefill_err": dec_err, "decode_scale": scale,
            "decode_held": "bf16" if bf16_held else "f32",
            "decode_vs_prefill_f32_err": dec_f32,
            "cross_device_f32_err": err, "f32_cut": f32_cut,
            "f32_cpu_s": cpu_s,
        })
        del second
    return rows



#: the f32 depth-cut training copy, card against CPU: the losses to
#: TRAIN_LOSS_RTOL, each AdamW moment within TRAIN_GRAD_REL of its leaf's
#: largest value (m is linear in the gradients, v quadratic: 2x), and the
#: parameters within ``optim.adamw.second_step_limit`` of that gradient
#: error; other summation orders only, TF32 off
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-4


def _train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one step: 6 N per token, plus the causal attention's
    12 L B S**2 d_head H / 2."""
    return (6.0 * n_params * batch * seq
            + 12.0 * cfg.n_layers * batch * seq * seq * cfg.head_dim
            * cfg.n_heads / 2)


def _attention_backward_ms(torch, cfg, batch: int, seq: int, reps: int,
                           dev) -> float:
    """CUDA-event ms of one layer's attention backward at a micro-batch's
    shape (the plain version's recompute and autograd; the forward's
    kernel time subtracted)."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    hk, group = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads

    def draw(heads):
        x = torch.randn((batch, seq, heads, cfg.head_dim), generator=gen,
                        device=dev) * 0.5
        return x.to(cfg.act_dtype).transpose(1, 2).requires_grad_()

    q, k, v = draw(cfg.n_heads), draw(hk), draw(hk)
    dout = torch.randn((batch, cfg.n_heads, seq, cfg.head_dim),
                       generator=gen, device=dev).to(cfg.act_dtype)

    def fwd():
        return ops.attention(q, k, v, group=group,
                             chunk=min(cfg.attn_chunk, seq))

    def both():
        torch.autograd.backward(fwd(), dout)
        q.grad = k.grad = v.grad = None

    with torch.no_grad():
        t_fwd = event_ms(torch, fwd, reps)
    return event_ms(torch, both, reps) - t_fwd


def phase_lm_train(torch, sizes: Sizes, seed: int, launches: dict,
                   dev="cuda") -> dict:
    """Train ``sizes.lm_arch`` at full width and depth through
    ``repro_torch.launch.train.train`` for ``sizes.train_steps`` steps of
    ``TokenPipeline`` batches with gradient accumulation: every loss and
    gnorm finite, parameters moved, ``fused_adamw`` launched once per
    parameter tensor a step, ``flash_attention`` once per layer and
    micro-batch forward and once more in its checkpointed recompute, the
    attention backward once per layer and micro-batch, no plain version
    served.  Then a depth-cut f32 copy through ``build_train_step`` on the
    card and on the CPU from one set of weights and batches: card against
    CPU, card bitwise repeatable, and two steps bitwise equal to one step,
    a ``Checkpointer`` save and restore into a fresh state, and one step."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import adamw_scalars
    from repro_torch.launch import train as lm
    from repro_torch.models import build_model
    from repro_torch.optim import (adamw_init, adamw_update_tree,
                                   cosine_warmup)
    from repro_torch.optim.adamw import second_step_limit

    dev = torch.device(dev)
    cfg = get_config(sizes.lm_arch, smoke=sizes.lm_smoke)
    model = build_model(cfg)
    b, seq, accum, steps = (sizes.train_batch, sizes.train_seq,
                            sizes.train_accum, sizes.train_steps)
    n_params = model.param_count()
    n_tensors = len(list(model.impl.parameters()))
    log(f"lm_train: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} params {cfg.param_dtype} remat={cfg.remat}: "
        f"{n_params} parameters in {n_tensors} tensors; batch {b} x {seq} "
        f"tokens, accum {accum}, {steps} steps")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    out = lm.train(cfg, steps=steps, global_batch=b, seq_len=seq,
                   accum=accum, seed=seed, log_every=1, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = ops.counts()
    backward = fa.flash_attention.backward_calls
    sm90 = fa.flash_attention.launches_sm90
    for name, (n, _) in counts.items():
        launches[name] += n
    launches[SM90] += sm90
    check(sm90 == counts["flash_attention"][0],
          f"lm_train: {counts['flash_attention'][0] - sm90} of "
          f"{counts['flash_attention'][0]} bf16 flash_attention launches "
          f"missed the Hopper route")
    check(all(np.isfinite(x) for x in out["losses"] + out["gnorms"])
          and all(x > 0 for x in out["gnorms"]),
          f"lm_train: losses {out['losses']}, gnorms {out['gnorms']}")
    check(all(p == 0 for _, p in counts.values()),
          f"lm_train: plain versions served calls: {counts}")
    want_fa = cfg.n_layers * accum * (2 if cfg.remat else 1) * steps
    check(counts["fused_adamw"][0] == n_tensors * steps,
          f"lm_train: fused_adamw launched {counts['fused_adamw'][0]} "
          f"times in {steps} steps, the model has {n_tensors} tensors")
    check(counts["flash_attention"][0] == want_fa
          and backward == cfg.n_layers * accum * steps,
          f"lm_train: flash_attention {counts['flash_attention'][0]} "
          f"launches (want {want_fa}), {backward} backward calls (want "
          f"{cfg.n_layers * accum * steps})")
    tokens = b * seq
    flops = _train_flops(cfg, n_params, b, seq)
    step_ms = [s * 1e3 for s in out["step_s"]]
    best = min(step_ms)
    log(f"lm_train: losses {out['losses']} gnorms {out['gnorms']} lrs "
        f"{out['lrs']}")
    log(f"lm_train: step_ms {[round(x, 3) for x in step_ms]} (best "
        f"{best:.3f}), tokens/s {tokens / best * 1e3:.1f}, model FLOP "
        f"utilisation {flops / (best * 1e-3) / 989e12:.4f} ({flops:.4e} "
        f"FLOPs a step over 989 TFLOP/s bf16 dense); launches a step: "
        f"fused_adamw {counts['fused_adamw'][0] // steps}, flash_attention "
        f"{counts['flash_attention'][0] // steps} (sm90 route "
        f"{sm90 // steps}), attention backward "
        f"{backward // steps}; peak memory {peak / 1e9:.3f} GB; wall "
        f"{wall:.3f} s")

    lrs = out["lrs"]
    main_losses, main_gnorms = out["losses"], out["gnorms"]
    fa_counts = (counts["flash_attention"][0], backward, sm90)
    params, opt = out["params"], out["opt"]
    del out
    with torch.no_grad():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init = model.init(gen)
        changed = sum(int((params[k] != init[k]).sum()) for k in params)
    del init
    check(changed > 0, "lm_train: no parameter element changed")
    log(f"lm_train: {changed} of {n_params} parameter elements changed "
        f"(share {changed / n_params:.6f}) at lrs {lrs}: a bf16 element "
        f"moves only once its update reaches half a bf16 step")

    # where the time goes: one more step of the same shape, profiled
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=b,
                         seed=seed + 1)
    batch = {k: torch.from_numpy(x).to(dev)
             for k, x in pipe.next_batch().items()}
    busy, top = _device_profile(
        torch, lambda: lm.build_train_step(model, accum=accum)(
            params, opt, batch), top=8)
    del batch
    log(f"lm_train profile: a step device-busy {busy:.3f} ms against the "
        f"best unprofiled step's {best:.3f} ms wall (idle share "
        f"{1 - busy / best:.3f}); top: {top}")

    # the optimizer pass of a step alone (254 launches; f32 grads as at
    # accum > 1), and one layer's attention backward at a micro-batch
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for k, p in params.items()}
    opt_ms = event_ms(torch, lambda: adamw_update_tree(params, grads, opt,
                                                       0.0), 3)
    del grads, params, opt
    torch.cuda.empty_cache()
    # p read and written, an f32 grad read, m and v read and written
    p_bytes = torch.empty((), dtype=cfg.p_dtype).element_size()
    moved = (2 * p_bytes + 4 + 16) * n_params
    opt_bound = moved / HBM_BYTES_PER_S * 1e3
    bwd_ms = _attention_backward_ms(torch, cfg, b // accum, seq, 3, dev)
    bwd_share = bwd_ms * cfg.n_layers * accum / best
    log(f"lm_train: optimizer pass ({n_tensors} fused_adamw launches) "
        f"{opt_ms:.3f} ms, bound {opt_bound:.3f} ms ({moved / 1e9:.2f} GB at "
        f"3.35 TB/s); attention backward {bwd_ms:.3f} ms a layer and "
        f"micro-batch, x {cfg.n_layers * accum} = {bwd_share:.4f} of the "
        f"best step")

    # the same code on both devices: a depth-cut f32 copy
    layers, cb, cseq, csteps = sizes.train_cross
    small = dataclasses.replace(cfg, n_layers=layers, dtype="float32",
                                param_dtype="float32")
    smodel = build_model(small)
    with torch.no_grad():
        weights = smodel.init(torch.Generator().manual_seed(seed + 2))
    pipe = TokenPipeline(vocab=small.vocab, seq_len=cseq, global_batch=cb,
                         seed=seed + 3)
    batches = [pipe.next_batch() for _ in range(csteps)]
    step_fn = lm.build_train_step(smodel, warmup=1)

    def start(on):
        params = {k: v.to(on, copy=True) for k, v in weights.items()}
        return params, adamw_init(params)

    def run(on, params, opt, which):
        losses = []
        for batch in which:
            params, opt, m = step_fn(params, opt, {
                k: torch.from_numpy(x).to(on) for k, x in batch.items()})
            losses.append(float(m["loss"]))
        return params, opt, losses

    t0 = time.perf_counter()
    cpu_p, cpu_o, cpu_l = run(torch.device("cpu"), *start("cpu"), batches)
    cpu_s = time.perf_counter() - t0
    ops.reset_counts()
    card = [run(dev, *start(dev), batches) for _ in range(2)]
    torch.cuda.synchronize()
    counts = ops.counts()
    for name, (n, _) in counts.items():
        launches[name] += n
    check(counts["fused_adamw"] == (2 * csteps * len(weights), 0)
          and counts["flash_attention"][1] == 0
          and fa.flash_attention.launches_sm90 == 0,
          f"lm_train f32 on the card: counts {counts}, "
          f"{fa.flash_attention.launches_sm90} on the Hopper route")
    (p1, o1, l1), (p2, o2, l2) = card
    check(l1 == l2 and all(torch.equal(p1[k], p2[k])
                           and torch.equal(o1["m"][k], o2["m"][k])
                           and torch.equal(o1["v"][k], o2["v"][k])
                           for k in p1),
          "lm_train: the f32 copy's two card runs differ bitwise")
    del p2, o2, card

    # one step, a checkpoint, a restore into a fresh state, one step
    with tempfile.TemporaryDirectory(prefix="weld-ckpt-") as tmp:
        params, opt, la = run(dev, *start(dev), batches[:1])
        ck = Checkpointer(tmp)
        ck.save(1, {"params": params, "opt": opt}, extra={"step": 1})
        shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in params.items()}
        moments = {k: torch.empty(v.shape, dtype=torch.float32,
                                  device="meta") for k, v in params.items()}
        del params, opt
        ck.wait()
        state, extra = ck.restore(1, {
            "params": shapes, "opt": {"m": moments, "v": moments,
                                      "step": torch.zeros(
                                          (), dtype=torch.int32)}})
    params = {k: v.to(dev) for k, v in state["params"].items()}
    opt = {"m": {k: v.to(dev) for k, v in state["opt"]["m"].items()},
           "v": {k: v.to(dev) for k, v in state["opt"]["v"].items()},
           "step": state["opt"]["step"]}
    del state
    params, opt, lb = run(dev, params, opt, batches[1:])
    check(extra["step"] == 1 and la + lb == l1
          and all(torch.equal(params[k], p1[k])
                  and torch.equal(opt["m"][k], o1["m"][k])
                  and torch.equal(opt["v"][k], o1["v"][k]) for k in p1),
          "lm_train: two steps differ from one step, a checkpoint, a "
          "restore and one step")
    del params, opt
    log(f"lm_train: {layers}-layer f32 copy on the card: two runs bitwise "
        f"equal, and bitwise equal to 1 step + Checkpointer save/restore + "
        f"1 step")

    # card against CPU
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(l1, cpu_l))
    # the last step's lr and bias correction (build_train_step's defaults)
    last_lr = float(cosine_warmup(csteps - 1, peak_lr=3e-4, warmup=1,
                                  total=1000))
    lr, _, _, _, c2 = adamw_scalars(last_lr, csteps, 0.9, 0.999)
    worst = {"m": 0.0, "v": 0.0, "p": 0.0, "p_abs": 0.0}
    for k in weights:
        for mom, rel in (("m", TRAIN_GRAD_REL), ("v", 2 * TRAIN_GRAD_REL)):
            want = cpu_o[mom][k].to(dev)
            err = float((o1[mom][k] - want).abs().max())
            scale = float(want.abs().max())
            worst[mom] = max(worst[mom], err / max(scale, 1e-30) / rel)
        want = cpu_p[k].to(dev)
        limit = second_step_limit(want, cpu_o["v"][k].to(dev), lr, c2,
                                  TRAIN_GRAD_REL)
        diff = (p1[k] - want).abs()
        worst["p"] = max(worst["p"], float((diff / limit).max()))
        worst["p_abs"] = max(worst["p_abs"], float(diff.max()))
    check(loss_err <= TRAIN_LOSS_RTOL and max(worst["m"], worst["v"],
                                              worst["p"]) <= 1.0,
          f"lm_train: f32 card vs CPU: loss rel err {loss_err}, "
          f"shares of the limits {worst}")
    log(f"lm_train: {layers}-layer f32 copy, batch {cb} x {cseq}, {csteps} "
        f"steps (warmup 1, lr {last_lr:.3e} at the last): card vs CPU "
        f"losses {l1} / {cpu_l} (max rel err {loss_err:.3e}, limit "
        f"{TRAIN_LOSS_RTOL}); m, v at most {worst['m']:.4f}, "
        f"{worst['v']:.4f} of their limits; parameters at most "
        f"{worst['p']:.4f} of theirs (max |diff| {worst['p_abs']:.3e}); "
        f"CPU run {cpu_s:.1f} s")
    del p1, o1, cpu_p, cpu_o, weights
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "params": n_params, "tensors": n_tensors,
        "batch": b, "seq": seq, "accum": accum, "steps": steps,
        "losses": main_losses, "gnorms": main_gnorms,
        "flash_attention": fa_counts,
        "step_ms": step_ms, "best_step_ms": best,
        "tokens_per_s": tokens / best * 1e3,
        "mfu": flops / (best * 1e-3) / 989e12, "flops_per_step": flops,
        "peak_memory_bytes": peak, "changed_share": changed / n_params,
        "step_device_busy_ms": busy, "step_top": top,
        "optimizer_pass_ms": opt_ms, "optimizer_pass_bound_ms": opt_bound,
        "attention_backward_ms": bwd_ms,
        "attention_backward_share": bwd_share,
        "cross_device_loss_rel_err": loss_err,
        "cross_device_limit_shares": worst,
    }


# ---------------------------------------------------------------------------
# lm_train_mesh: the same training on the (1, 1) data x model mesh
# ---------------------------------------------------------------------------

#: lm_train_mesh against lm_train: the reference test's tolerance for a
#: (4, 2) mesh against (1, 1)
MESH_RTOL, MESH_ATOL = 2e-4, 2e-5


def phase_lm_train_mesh(torch, sizes: Sizes, seed: int, launches: dict,
                        single: dict, dev="cuda") -> dict:
    """``lm_train``'s run again through ``train(..., dp=1, tp=1)`` inside
    an NCCL process group of one rank (a ``file://`` store in a temporary
    directory), so on the mesh path: DTensor parameters placed by the
    rules on the (1, 1) mesh over ("data", "model"), ZeRO-1 moments,
    ``local_map`` into flash_attention, fused_adamw on local shards.
    Each loss and gnorm against ``single`` (``lm_train``'s), the launch
    counts against its, every parameter and moment a DTensor over a card
    tensor with the rules' placements; then ``compressed_psum`` of a
    card tensor through the group against the quantizer's formula."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as lm
    from repro_torch.models import build_model
    from repro_torch.optim.compress import (compressed_psum,
                                            dequantize_int8, quantize_int8)

    dev = torch.device(dev)
    cfg = get_config(sizes.lm_arch, smoke=sizes.lm_smoke)
    b, seq, accum, steps = (sizes.train_batch, sizes.train_seq,
                            sizes.train_accum, sizes.train_steps)
    n_tensors = len(list(build_model(cfg).impl.parameters()))
    store = tempfile.mkdtemp(prefix="weld-mesh-")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t0 = time.perf_counter()
        out = lm.train(cfg, steps=steps, global_batch=b, seq_len=seq,
                       accum=accum, seed=seed, dp=1, tp=1, log_every=1,
                       verbose=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = ops.counts()
        backward = fa.flash_attention.backward_calls
        sm90 = fa.flash_attention.launches_sm90
        for name, (n, _) in counts.items():
            launches[name] += n
        launches[SM90] += sm90
        check(all(p == 0 for _, p in counts.values()),
              f"lm_train_mesh: plain versions served calls: {counts}")
        check(counts["fused_adamw"][0] == n_tensors * steps,
              f"lm_train_mesh: fused_adamw launched "
              f"{counts['fused_adamw'][0]} times in {steps} steps, the "
              f"model has {n_tensors} tensors")
        check((counts["flash_attention"][0], backward, sm90)
              == tuple(single["flash_attention"]),
              f"lm_train_mesh: flash_attention (launches, backward, sm90) "
              f"{(counts['flash_attention'][0], backward, sm90)}, lm_train's "
              f"{tuple(single['flash_attention'])}")
        check(sm90 == counts["flash_attention"][0],
              f"lm_train_mesh: {counts['flash_attention'][0] - sm90} bf16 "
              f"flash_attention launches missed the Hopper route")
        pairs = list(zip(out["losses"] + out["gnorms"],
                         single["losses"] + single["gnorms"]))
        rel = max(abs(a - w) / abs(w) for a, w in pairs)
        bitwise = all(a == w for a, w in pairs)
        check(all(abs(a - w) <= MESH_ATOL + MESH_RTOL * abs(w)
                  for a, w in pairs),
              f"lm_train_mesh: losses {out['losses']} gnorms "
              f"{out['gnorms']} against lm_train's {single['losses']} "
              f"{single['gnorms']}")
        from torch.distributed.tensor import DTensor

        params, opt = out["params"], out["opt"]
        mesh = next(iter(params.values())).device_mesh
        pspecs, mspecs = lm.state_specs(build_model(cfg), mesh)
        for what, tree, specs in (("parameter", params, pspecs),
                                  ("m", opt["m"], mspecs),
                                  ("v", opt["v"], mspecs)):
            for k, t in tree.items():
                check(isinstance(t, DTensor)
                      and t.to_local().device.type == dev.type
                      and tuple(t.placements)
                      == sharding.placements(specs[k], mesh),
                      f"lm_train_mesh: {what} {k} is {type(t).__name__} "
                      f"{getattr(t, 'placements', None)}, the rules give "
                      f"{specs[k]}")
        check(tuple(mesh.mesh.shape) == (1, 1)
              and mesh.mesh_dim_names == ("data", "model"),
              f"lm_train_mesh: mesh {mesh}")
        del params, opt
        step_ms = [x * 1e3 for x in out["step_s"]]
        best = min(step_ms)
        tokens = b * seq
        log(f"lm_train_mesh: NCCL world 1, mesh (1, 1) over (data, model); "
            f"losses {out['losses']} gnorms {out['gnorms']}; against "
            f"lm_train's: max rel diff {rel:.3e} (limit rtol {MESH_RTOL} "
            f"atol {MESH_ATOL}), bitwise equal {bitwise}")
        log(f"lm_train_mesh: step_ms {[round(x, 3) for x in step_ms]} "
            f"(best {best:.3f}; lm_train's best "
            f"{single['best_step_ms']:.3f}), tokens/s "
            f"{tokens / best * 1e3:.1f}; launches a step: fused_adamw "
            f"{counts['fused_adamw'][0] // steps}, flash_attention "
            f"{counts['flash_attention'][0] // steps} (sm90 "
            f"{sm90 // steps}), attention backward {backward // steps}; "
            f"peak memory {peak / 1e9:.3f} GB (lm_train's "
            f"{single['peak_memory_bytes'] / 1e9:.3f}); wall {wall:.3f} s")
        del out
        gc.collect()
        torch.cuda.empty_cache()

        # compressed_psum through the group: at world 1 the mean is the
        # rank's own dequantized payload, the error its residual
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 4)
        g = torch.randn((1 << 20,), generator=gen, device=dev,
                        dtype=torch.float32)
        err = torch.randn((1 << 20,), generator=gen, device=dev,
                          dtype=torch.float32) * 1e-3
        mean, new_err = compressed_psum(g, err, dist.group.WORLD)
        corrected = g + err
        q, scale = quantize_int8(corrected)
        sent = dequantize_int8(q, scale)
        check(mean.device.type == dev.type and torch.equal(mean, sent / 1)
              and torch.equal(new_err, corrected - sent),
              "lm_train_mesh: compressed_psum through NCCL differs from "
              "the quantizer's formula")
        log(f"lm_train_mesh: compressed_psum of 1,048,576 f32 through NCCL "
            f"(world 1): mean and error bitwise equal to the quantizer's "
            f"formula on the card (scale {float(scale):.6e})")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return {"losses_rel_diff": rel, "bitwise": bitwise, "step_ms": step_ms,
            "best_step_ms": best, "tokens_per_s": tokens / best * 1e3,
            "peak_memory_bytes": peak, "wall_s": wall}


# ---------------------------------------------------------------------------
# lm_families_train: the other families in training
# ---------------------------------------------------------------------------


#: lm_families_train: (arch, depth cut, batch, tokens a sequence, the f32
#: copy's cut, the f32 copy's steps).  Full width, bf16, remat; the depth
#: cut only where the training state (bf16 p and g, f32 m and v: 12 bytes
#: a parameter, 16 for an f32 leaf) does not fit on the card: DeepSeek-MoE
#: 6 of 28 layers (1 dense + 5 MoE, 38.8 GB), DBRX 1 of 40 (46.5 GB; 2
#: would be 85.6 GB), Llama 3.2 Vision 5 of 100, one super-block, the
#: least its structure allows (64.1 GB, and 8.4 GB more for the tied
#: table's f32 copy and its f32 gradient).  The f32 copy runs its steps
#: through build_train_step on the card and on the CPU; with 0 steps it
#: holds one ``loss_and_grad`` instead: DBRX's and the vision model's
#: copies have 3.9 and 2.8 billion parameters, whose plain AdamW on the
#: host CPU would take minutes a step (the fused_adamw kernel is held on
#: the card by hold_fused_adamw and in the other copies, and two steps of
#: every family's smoke config, card against CPU, by
#: ``tests/test_torch_cuda.py``)
FAMILIES_TRAIN = (
    ("deepseek-moe-16b", {"n_layers": 6}, 2, 512, {"n_layers": 2}, 2),
    ("dbrx-132b", {"n_layers": 1}, 2, 512, {"n_layers": 1}, 0),
    ("zamba2-1.2b", {}, 2, 512, {"n_layers": 2}, 2),
    ("xlstm-350m", {}, 2, 512, {"n_layers": 8}, 2),
    ("whisper-large-v3", {}, 2, 448, {"n_layers": 2, "n_enc_layers": 2},
     2),
    ("llama-3.2-vision-90b", {"n_layers": 5}, 2, 512,
     {"n_layers": 2, "cross_attn_every": 2}, 0),
)
#: lm_families_train's steps a family, and its f32 copies' batch x tokens:
#: one sequence, since the copies' CPU runs at full width (Whisper's
#: encoder over 1,500 frames above all) are most of the phase's time
FAMILIES_TRAIN_STEPS = 3
FAMILIES_TRAIN_F32 = (1, 32)
#: bf16 peak of the H100 SXM's tensor cores (dense), the MFU's divisor
BF16_PEAK = 989e12


def _family_train_flops(cfg, model, b: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per parameter and position it
    multiplies (the active experts only; the encoder's layers and the
    cross-attentions' k and v projections at the frames or image tokens,
    the vision projection at the image tokens, every other parameter at the
    text tokens; the learned positions multiply nothing), plus 12 B hd H
    Sq Skv a call for the attention (halved when causal), as
    ``_train_flops``.  The SSM scans (Mamba2's, the mLSTM's) and the
    sLSTM's pointwise recurrence are left out."""
    fam = cfg.family
    other = {"encdec": cfg.n_frames, "vlm": cfg.n_image_tokens}.get(fam, 0)
    at_other = 0
    for name, p in model.impl.named_parameters():
        kv = name.rsplit(".", 1)[-1] in ("wk", "wv")
        if fam == "encdec" and (name.startswith("enc_") or (
                ".cross_attn." in name and kv)):
            at_other += p.numel()
        elif fam == "vlm" and (name == "img_proj" or (
                name.startswith("cross_layers.") and kv)):
            at_other += p.numel()
    skip = model.impl.pos.numel() if fam == "encdec" else 0
    at_text = model.active_param_count() - at_other - skip
    flops = 6.0 * b * (at_text * seq + at_other * other)
    unit = 12.0 * b * cfg.head_dim * cfg.n_heads
    if fam in ("dense", "moe"):
        flops += unit * cfg.n_layers * seq * seq / 2
    elif fam == "hybrid":
        flops += unit * -(-cfg.n_layers // cfg.attn_every) * seq * seq / 2
    elif fam == "encdec":
        n_enc = cfg.n_enc_layers or cfg.n_layers
        flops += unit * (n_enc * other * other + cfg.n_layers * (
            seq * seq / 2 + seq * other))
    elif fam == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        flops += unit * (cfg.n_layers - n_super) * seq * seq / 2 \
            + unit * n_super * seq * other
    return flops


def _family_batches(torch, cfg, seed: int, b: int, seq: int, steps: int,
                    dev) -> list:
    """``steps`` training batches: ``TokenPipeline``'s tokens and labels
    for ``seed`` (what ``train`` draws), and for encdec and vision the
    frames or images drawn from a numpy generator seeded with ``seed`` as
    ``serve.prompt_batch`` draws them, in the activation dtype."""
    from repro_torch.data import TokenPipeline

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=b,
                         seed=seed)
    rng = np.random.RandomState(seed)
    key, shape = {"encdec": ("frames", (cfg.n_frames, cfg.d_model)),
                  "vlm": ("images", (cfg.n_image_tokens, cfg.d_vision))}.get(
                      cfg.family, (None, None))
    out = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(x).to(dev)
                 for k, x in pipe.next_batch().items()}
        if key:
            batch[key] = torch.from_numpy(rng.randn(b, *shape)).to(
                cfg.act_dtype).to(dev)
        out.append(batch)
    return out


def _family_weights(torch, model, cfg, seed: int, dev) -> dict:
    """The weights ``train`` draws for ``seed`` (on ``dev``), the vision
    model's gates set to VLM_GATE (the reference's 0 would leave every
    cross-attention weight's gradient at 0)."""
    with torch.no_grad():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen)
        if cfg.family == "vlm":
            for k in params:
                if k.endswith(".gate"):
                    params[k].fill_(VLM_GATE)
    return params


#: an exact digest of a tensor's bits: each element's bits (int16 or
#: int32) times its position's weight, (index mod DIGEST_MOD) + 1, summed
#: in int64 over chunks of DIGEST_CHUNK elements (no chunk's sum can
#: overflow); two tensors with equal bits have equal digests
DIGEST_MOD = 1021
DIGEST_CHUNK = 1 << 22


def _bits_digest(torch, t):
    flat = t.detach().reshape(-1)
    ints = flat.view(torch.int16 if flat.element_size() == 2
                     else torch.int32)
    sums = []
    for lo in range(0, ints.numel(), DIGEST_CHUNK):
        part = ints[lo:lo + DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(lo, lo + part.numel(), device=part.device,
                         dtype=torch.int64) % DIGEST_MOD + 1
        sums.append((part * w).sum())
    return torch.stack(sums) if sums else torch.zeros(0, dtype=torch.int64)


def _state_digest(torch, params, opt) -> dict:
    return {(part, k): _bits_digest(torch, t)
            for part, tree in (("p", params), ("m", opt["m"]),
                               ("v", opt["v"]))
            for k, t in tree.items()}


def _f32_family_copy(torch, cfg, f32_cut: dict, steps: int, seed: int,
                     dev, launches: dict) -> dict:
    """The same code on both devices: a depth-cut f32 copy of ``cfg`` from
    one set of weights (drawn on the card, copied to the host) and one set
    of batches, through ``build_train_step`` for ``steps`` steps (the first
    at lr 0) on the card and on the CPU — losses to TRAIN_LOSS_RTOL, gnorms
    to TRAIN_GRAD_REL, the moments and parameters as lm_train's copy — or,
    with 0 steps, one ``loss_and_grad``: the loss to TRAIN_LOSS_RTOL and
    every gradient within TRAIN_GRAD_REL of its leaf's largest |value|.
    The card's launches: fused_adamw once a tensor a step, flash_attention
    the remat structure's count, all on v1, no plain version."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import adamw_scalars
    from repro_torch.launch import train as lm
    from repro_torch.models import build_model
    from repro_torch.kernels.launch_counts import attention_calls
    from repro_torch.optim import adamw_init, cosine_warmup
    from repro_torch.optim.adamw import second_step_limit

    name = cfg.name
    small = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                **f32_cut)
    model = build_model(small)
    cb, cseq = FAMILIES_TRAIN_F32
    n_batches = max(steps, 1)
    card_w = _family_weights(torch, model, small, seed + 2, dev)
    host_w = {k: t.to("cpu", copy=True) for k, t in card_w.items()}
    card_b = _family_batches(torch, small, seed + 3, cb, cseq, n_batches,
                             dev)
    host_b = [{k: x.cpu() for k, x in b.items()} for b in card_b]
    step_fn = lm.build_train_step(model, warmup=1)

    def run(params, batches):
        if not steps:
            loss, grads = model.loss_and_grad(params, batches[0])
            return float(loss), grads, None
        opt = adamw_init(params)
        losses, gnorms = [], []
        for batch in batches:
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
        return losses, gnorms, opt

    ops.reset_counts()
    card = run(card_w, card_b)
    torch.cuda.synchronize()
    counts = ops.counts()
    backward = fa.flash_attention.backward_calls
    for k, (n, _) in counts.items():
        launches[k] += n
    fwd, bwd = attention_calls(small, training=True)
    want_adamw = steps * len(card_w)
    check(counts["fused_adamw"] == (want_adamw, 0)
          and counts["flash_attention"] == (fwd * n_batches, 0)
          and backward == bwd * n_batches
          and fa.flash_attention.launches_sm90 == 0,
          f"lm_families_train {name} f32 on the card: counts {counts}, "
          f"backward {backward} (want {bwd * n_batches}), "
          f"{fa.flash_attention.launches_sm90} on the Hopper route")
    t0 = time.perf_counter()
    host = run(host_w, host_b)
    cpu_s = time.perf_counter() - t0
    cut_s = ", ".join(f"{k}={v}" for k, v in f32_cut.items())
    what = (f"lm_families_train {name}: f32 copy ({cut_s}, "
            f"{model.param_count()} parameters), batch {cb} x {cseq}")
    if not steps:
        (l_card, g_card, _), (l_cpu, g_cpu, _) = card, host
        loss_err = abs(l_card - l_cpu) / abs(l_cpu)
        worst = 0.0
        for k in g_cpu:
            want = g_cpu[k].to(dev)
            scale = float(want.abs().max())
            err = float((g_card[k] - want).abs().max())
            worst = max(worst, err / max(scale, 1e-30) / TRAIN_GRAD_REL)
        check(loss_err <= TRAIN_LOSS_RTOL and worst <= 1.0,
              f"{what}: card vs CPU loss rel err {loss_err}, gradients at "
              f"{worst} of their limit")
        log(f"{what}, one loss_and_grad: card vs CPU loss {l_card} / "
            f"{l_cpu} (rel err {loss_err:.3e}, limit {TRAIN_LOSS_RTOL}); "
            f"every gradient at most {worst:.4f} of its limit "
            f"({TRAIN_GRAD_REL} of its leaf's largest |value|); CPU run "
            f"{cpu_s:.1f} s")
        return {"f32_cut": f32_cut, "f32_steps": 0,
                "f32_loss_rel_err": loss_err, "f32_grad_limit_share": worst,
                "f32_cpu_s": cpu_s}
    (l_card, gn_card, o_card), (l_cpu, gn_cpu, o_cpu) = card, host
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(l_card, l_cpu))
    gnorm_err = max(abs(a - c) / abs(c) for a, c in zip(gn_card, gn_cpu))
    last_lr = float(cosine_warmup(steps - 1, peak_lr=3e-4, warmup=1,
                                  total=1000))
    lr, _, _, _, c2 = adamw_scalars(last_lr, steps, 0.9, 0.999)
    worst = {"m": 0.0, "v": 0.0, "p": 0.0}
    for k in host_w:
        for mom, rel in (("m", TRAIN_GRAD_REL), ("v", 2 * TRAIN_GRAD_REL)):
            want = o_cpu[mom][k].to(dev)
            err = float((o_card[mom][k] - want).abs().max())
            scale = float(want.abs().max())
            worst[mom] = max(worst[mom], err / max(scale, 1e-30) / rel)
        want = host_w[k].to(dev)
        limit = second_step_limit(want, o_cpu["v"][k].to(dev), lr, c2,
                                  TRAIN_GRAD_REL)
        worst["p"] = max(worst["p"],
                         float(((card_w[k] - want).abs() / limit).max()))
    check(loss_err <= TRAIN_LOSS_RTOL and gnorm_err <= TRAIN_GRAD_REL
          and max(worst.values()) <= 1.0,
          f"{what}: card vs CPU loss rel err {loss_err}, gnorm rel err "
          f"{gnorm_err}, shares of the limits {worst}")
    log(f"{what}, {steps} steps: card vs CPU losses {l_card} / {l_cpu} "
        f"(max rel err {loss_err:.3e}, limit {TRAIN_LOSS_RTOL}), gnorms max "
        f"rel err {gnorm_err:.3e} (limit {TRAIN_GRAD_REL}); m, v at most "
        f"{worst['m']:.4f}, {worst['v']:.4f} of their limits, parameters "
        f"{worst['p']:.4f}; CPU run {cpu_s:.1f} s")
    return {"f32_cut": f32_cut, "f32_steps": steps,
            "f32_loss_rel_err": loss_err, "f32_gnorm_rel_err": gnorm_err,
            "f32_limit_shares": worst, "f32_cpu_s": cpu_s}


def phase_lm_families_train(torch, sizes: Sizes, seed: int, launches: dict,
                            dev="cuda") -> list:
    """Train each family of ``sizes.families_train`` in bf16 with remat at
    full width (depth cut where the training state does not fit) for
    FAMILIES_TRAIN_STEPS steps through the entry points: the
    token families through ``repro_torch.launch.train.train``, Whisper and
    the vision model through ``build_train_step`` on batches that carry
    their frames or images.  Every loss and gnorm finite, the parameters
    moved, ``fused_adamw`` launched once a tensor a step,
    ``flash_attention`` the remat structure's count a step
    (``kernels.launch_counts.attention_calls``) all on the Hopper route,
    its backward once an attention call, no plain version; two runs of
    the first step from one state bitwise equal (loss, gnorm, and the
    digests of every parameter and moment; the second run's step profiled
    for the device's idle share against the best step's wall); then the
    f32 copy on the card against the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as lm
    from repro_torch.models import build_model
    from repro_torch.kernels.launch_counts import attention_calls
    from repro_torch.optim import adamw_init

    dev = torch.device(dev)
    steps = FAMILIES_TRAIN_STEPS
    rows = []
    for arch, cut, b, seq, f32_cut, f32_steps in (sizes.families_train
                                                  or FAMILIES_TRAIN):
        cfg = dataclasses.replace(get_config(arch, smoke=sizes.lm_smoke),
                                  **cut)
        name = cfg.name
        model = build_model(cfg)
        tensors = list(model.impl.parameters())
        n_params, n_active = model.param_count(), model.active_param_count()
        state = sum(p.numel() * (2 * p.element_size() + 8) for p in tensors)
        fwd, bwd = attention_calls(cfg, training=True)
        via_train = cfg.family not in lm.BATCH_KEYS
        log(f"lm_families_train {name}: {cfg.family}, {cfg.n_layers} layers"
            + (f" (cut from {get_config(arch).n_layers})" if cut else "")
            + f" d_model={cfg.d_model} {cfg.param_dtype} remat={cfg.remat}: "
            f"{n_params} parameters ({n_active} active) in {len(tensors)} "
            f"tensors, training state {state / 1e9:.3f} GB; batch {b} x "
            f"{seq} tokens, {steps} steps through "
            + ("train()" if via_train else "build_train_step")
            + f"; {fwd} flash_attention launches and {bwd} backwards a step")
        batches = _family_batches(torch, cfg, seed, b, seq, steps, dev)
        step_fn = lm.build_train_step(model, peak_lr=1e-3,
                                      total_steps=steps)
        params = _family_weights(torch, model, cfg, seed, dev)
        before = {k: _bits_digest(torch, t) for k, t in params.items()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t0 = time.perf_counter()
        if via_train:   # train() draws these weights and batches itself
            del params
            out = lm.train(cfg, steps=steps, global_batch=b, seq_len=seq,
                           seed=seed, log_every=1, verbose=True)
            params, losses, gnorms, step_s = (out["params"], out["losses"],
                                              out["gnorms"], out["step_s"])
            del out
        else:   # train()'s loop on batches that carry frames or images
            opt = adamw_init(params)
            losses, gnorms, step_s = [], [], []
            for s, batch in enumerate(batches):
                t1 = time.perf_counter()
                params, opt, m = step_fn(params, opt, batch)
                m = {k: float(v) for k, v in m.items()}
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
                losses.append(m["loss"])
                gnorms.append(m["gnorm"])
                log(f"[train] step {s:5d} loss {m['loss']:.4f} gnorm "
                    f"{m['gnorm']:.3f} lr {m['lr']:.2e}")
            del opt
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = ops.counts()
        backward = fa.flash_attention.backward_calls
        sm90 = fa.flash_attention.launches_sm90
        for k, (n, _) in counts.items():
            launches[k] += n
        launches[SM90] += sm90
        n_fa = counts["flash_attention"][0]
        check(all(np.isfinite(x) for x in losses + gnorms)
              and all(x > 0 for x in gnorms),
              f"lm_families_train {name}: losses {losses}, gnorms {gnorms}")
        check(all(p == 0 for _, p in counts.values()),
              f"lm_families_train {name}: plain versions served calls: "
              f"{counts}")
        check(counts["fused_adamw"][0] == len(tensors) * steps,
              f"lm_families_train {name}: fused_adamw launched "
              f"{counts['fused_adamw'][0]} times in {steps} steps, the "
              f"model has {len(tensors)} tensors")
        check(n_fa == fwd * steps and backward == bwd * steps,
              f"lm_families_train {name}: flash_attention {n_fa} launches "
              f"(want {fwd * steps}), {backward} backward calls (want "
              f"{bwd * steps})")
        check(sm90 == n_fa,
              f"lm_families_train {name}: {n_fa - sm90} of {n_fa} bf16 "
              f"flash_attention launches missed the Hopper route")
        moved = sum(not torch.equal(before[k], _bits_digest(torch, t))
                    for k, t in params.items())
        check(moved > 0, f"lm_families_train {name}: no parameter moved")
        del params, before
        gc.collect()
        torch.cuda.empty_cache()
        tokens = b * seq
        flops = _family_train_flops(cfg, model, b, seq)
        step_ms = [x * 1e3 for x in step_s]
        best = min(step_ms)
        log(f"lm_families_train {name}: losses {losses} gnorms {gnorms}; "
            f"{moved} of {len(tensors)} parameter tensors changed")

        # two runs of the first step from one state: bitwise equal; the
        # second's step alone profiled
        seen = []

        def first_step(profiled: bool):
            params = _family_weights(torch, model, cfg, seed, dev)
            opt = adamw_init(params)
            out = []

            def step():
                out.append(step_fn(params, opt, batches[0]))

            if profiled:
                busy_top = _device_profile(torch, step, top=8)
            else:
                step()
            params, opt, m = out[0]
            seen.append((float(m["loss"]), float(m["gnorm"]),
                         _state_digest(torch, params, opt)))
            return busy_top if profiled else None

        first_step(False)
        gc.collect()
        torch.cuda.empty_cache()
        busy, top = first_step(True)
        (la, ga, da), (lb, gb, db) = seen
        check(la == lb and ga == gb
              and all(torch.equal(da[k], db[k]) for k in da),
              f"lm_families_train {name}: two runs of the first step "
              f"differ: losses {la}/{lb}, gnorms {ga}/{gb}, "
              f"{sum(not torch.equal(da[k], db[k]) for k in da)} digests")
        check(la == losses[0] and ga == gnorms[0],
              f"lm_families_train {name}: the first step's rerun differs "
              f"from the run's ({la}/{losses[0]}, {ga}/{gnorms[0]})")
        del seen, da, db
        gc.collect()
        torch.cuda.empty_cache()
        mfu = flops / (best * 1e-3) / BF16_PEAK
        log(f"lm_families_train {name}: the first step run twice from one "
            f"state bitwise equal (loss, gnorm, {len(tensors)} parameters "
            f"and their moments)")
        log(f"lm_families_train {name}: step_ms "
            f"{[round(x, 3) for x in step_ms]} (best {best:.3f}), tokens/s "
            f"{tokens / best * 1e3:.1f}, model FLOP utilisation {mfu:.4f} "
            f"({flops:.4e} FLOPs a step over 989 TFLOP/s bf16 dense; SSM "
            f"scans left out); launches a step: fused_adamw "
            f"{counts['fused_adamw'][0] // steps}, flash_attention "
            f"{n_fa // steps} (sm90 route {sm90 // steps}), attention "
            f"backward {backward // steps}; peak memory "
            f"{peak / 1e9:.3f} GB; wall {wall:.3f} s")
        log(f"lm_families_train {name} profile: the first step device-busy "
            f"{busy:.3f} ms against the best unprofiled step's {best:.3f} "
            f"ms wall (idle share {1 - busy / best:.3f}); top: {top}")
        del batches
        f32 = _f32_family_copy(torch, cfg, f32_cut, f32_steps, seed, dev,
                               launches)
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(dict({
            "arch": name, "family": cfg.family, "layers": cfg.n_layers,
            "cut": cut, "params": n_params, "active_params": n_active,
            "tensors": len(tensors), "state_bytes": state, "batch": b,
            "seq": seq, "steps": steps, "step_ms": step_ms,
            "best_step_ms": best, "tokens_per_s": tokens / best * 1e3,
            "mfu": mfu, "flops_per_step": flops, "peak_memory_bytes": peak,
            "idle_share": 1 - busy / best, "step_device_busy_ms": busy,
            "step_top": top, "losses": losses, "gnorms": gnorms,
            "flash_attention_per_step": n_fa // steps,
            "backward_per_step": backward // steps,
            "fused_adamw_per_step": counts["fused_adamw"][0] // steps,
        }, **f32))
    return rows


# ---------------------------------------------------------------------------
# each kernel against its plain version, timed
# ---------------------------------------------------------------------------


def event_ms(torch, fn, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back calls, per call: for a
    small kernel this window holds the host's launch path (the wrapper's
    checks, allocations, ``ctypes``), since the card waits on it."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


#: the card's clock as ``torch.cuda._sleep`` counts it (cycles a ms),
#: measured once a process
_SLEEP_CYCLES_PER_MS: list = []


def _sleep_cycles_per_ms(torch) -> float:
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        stop.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(stop))
    return _SLEEP_CYCLES_PER_MS[0]


def window_ms(torch, fn, reps: int):
    """Device ms per call with the host's launch path out of the window:
    a ``torch.cuda._sleep`` kernel, longer than the host takes to enqueue
    ``reps`` calls, holds the stream while they queue behind it, and CUDA
    events bracket them, so the card runs them back to back.  Returns
    (ms, covered): ``covered`` is False when, as a call was enqueued, the
    card had already finished everything before it (it may have waited on
    the host); the sleep is then lengthened once.  A call that synchronises
    with the card (a data-dependent output size: ``torch.unique``,
    ``torch.bincount``) stays uncovered, and its window holds host time."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(min(2.0 * reps * host_ms + 0.5, 1000.0)
                 * _sleep_cycles_per_ms(torch))
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        before, covered = start, True
        for _ in range(reps):
            fn()
            covered = covered and not before.query()
            before = torch.cuda.Event()
            before.record()
        stop.record()
        torch.cuda.synchronize()
        if covered:
            break
        cycles *= 4
    return start.elapsed_time(stop) / reps, covered


#: the H100's L2: a row whose bytes fit may be served from it when the
#: calls run back to back, and then reads below its HBM bound
L2_BYTES = 50e6


def _random(torch, gen, shape, dtype, dev):
    if dtype.is_floating_point:
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)
    return torch.randint(0, 100, shape, generator=gen, device=dev,
                         dtype=dtype)


def _tolerance(torch, plain, dtype):
    if not dtype.is_floating_point:
        return 0.0
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    return rtol * max(float(plain.abs().max()), 1.0)


def hold_kernels(torch, sizes: Sizes, seed: int, launches: dict,
                 tuned: dict, dev="cuda") -> list:
    """B1, B2, B4 and B5 at the main path's shapes, each launched with
    the grid cap the main path's compile chose for that shape
    (``main_path_cap``), held against its plain version and timed."""
    from repro_torch.kernels import filter_reduce as fr
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr

    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    fdt = [torch.float32, torch.float64, torch.int32, torch.int64]
    cases = [
        # (name, wrapper, plain, library yardstick, make inputs, dtypes,
        #  source, TPU kernel)
        ("filter_reduce_sum", fr.filter_reduce_sum, ref.filter_reduce_sum,
         "torch.masked.sum(x, mask=pred)", fdt, "filter_reduce.cu",
         "src/repro/kernels/filter_reduce.py:44"),
        ("filter_reduce_sum_multi", fr.filter_reduce_sum_multi,
         ref.filter_reduce_sum_multi,
         "torch.masked.sum(vals, dim=1, mask=pred)", fdt,
         "filter_reduce.cu", "src/repro/kernels/filter_reduce.py:88"),
        ("segment_sum", sr.segment_sum, ref.segment_sum,
         "Tensor.index_add_", [torch.float32, torch.float64],
         "segment_reduce.cu", "src/repro/kernels/segment_reduce.py:50"),
        ("segment_sum_vectors", sr.segment_sum_vectors,
         ref.segment_sum_vectors, "Tensor.index_add_", fdt,
         "segment_reduce.cu", "src/repro/kernels/segment_reduce.py:98"),
    ]
    n_fr = sizes.lineitem
    n_sv = sizes.groupby_rows
    n_ss = sizes.pr_always[1]
    k = sizes.groupby_keys
    rows = []
    for name, kern, plain, lib_name, dtypes, src, tpu in cases:
        per_dtype = []
        n_main = (n_fr if name.startswith("filter_reduce") else
                  n_ss if name == "segment_sum" else n_sv)
        cap = main_path_cap(tuned, name, n_main)
        kern = functools.partial(kern, max_blocks=cap)
        for dt in dtypes:
            itemsize = torch.empty((), dtype=dt).element_size()
            if name.startswith("filter_reduce"):
                a = 1 if name == "filter_reduce_sum" else 4
                shape = (n_fr,) if a == 1 else (a, n_fr)
                x = _random(torch, gen, shape, dt, dev)
                pred = torch.rand(n_fr, generator=gen, device=dev) < 0.5
                args = (x, pred)
                if a == 1:
                    library = (lambda x=x, pred=pred:  # noqa: E731
                               torch.masked.sum(x, mask=pred))
                else:
                    library = (lambda x=x, pred=pred:  # noqa: E731
                               torch.masked.sum(x, dim=1, mask=pred[None, :]))
                kept = int(pred.sum())
                nbytes = n_fr * (a * itemsize + 1) + a * itemsize
                ops = a * kept
            else:
                n = n_ss if name == "segment_sum" else n_sv
                d = 1 if name == "segment_sum" else 2
                seg = torch.randint(0, k, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
                vals = _random(torch, gen, (n,) if d == 1 else (n, d), dt,
                               dev)
                args = (seg, vals, k)
                acc = torch.zeros((k,) + tuple(vals.shape[1:]), dtype=dt,
                                  device=dev)
                library = (lambda acc=acc, seg=seg, vals=vals:  # noqa: E731
                           acc.index_add_(0, seg, vals))
                nbytes = n * (4 + d * itemsize) + k * d * itemsize
                ops = n * d
            first = kern(*args)
            second = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(first, second),
                  f"{name}[{dt}]: two runs differ bitwise")
            err = float((first.double() - want.double()).abs().max())
            tol = _tolerance(torch, want, dt)
            check(err <= tol, f"{name}[{dt}]: max |kernel - plain| {err} "
                              f"exceeds {tol}")
            shape = tuple(args[0 if name.startswith("filter") else 1].shape)
            row = _timed_row(
                torch, f"{name}[{dt}]", lambda: kern(*args),
                lambda: plain(*args), library, sizes.timing_reps, nbytes,
                ops, PEAK_OPS[str(dt).split(".")[-1]],
                dtype=str(dt).split(".")[-1], max_abs_err=err, tolerance=tol,
                shape=list(shape))
            per_dtype.append(row)
            log(f"kernel {name}[{row['dtype']}] shape={shape} "
                f"max_blocks={cap or 'default'} {_times(row)} "
                f"({lib_name}) max_abs_err={err:.3e} (tol {tol:.3e}) "
                f"bitwise_repeat=ok")
            del args, first, second, want
            torch.cuda.empty_cache()
        # the line reports the f64 case (the dtype the main path ran);
        # the other dtypes are on the lines above and in --out
        main = next(r for r in per_dtype if r["dtype"] == "float64")
        if name == "segment_sum":
            main["windows"] = _hold_segment_windows(torch, gen, dev)
        if name == "segment_sum_vectors":
            main["skewed"] = _hold_segment_skew(torch, gen, dev, n_sv, k,
                                                sizes.timing_reps)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library": lib_name,
            "dtype": "float64", "max_blocks": cap, "per_dtype": per_dtype,
        })
    return rows


#: the gate's 20,000-key join build: its value sums past MAX_K keys
GATE_BUILD_KEYS = 20_000


def _hold_segment_windows(torch, gen, dev) -> dict:
    """segment_sum past MAX_K keys (the kernel's windows), at the gate's
    join build shape (20,000 rows, 20,000 keys, f64), against its plain
    version: within _tolerance, bitwise the same twice, no plain call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr

    k = n = GATE_BUILD_KEYS
    seg = torch.randint(0, k, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = _random(torch, gen, (n,), torch.float64, dev)
    plain_before = sr.segment_sum.plain_calls
    first, second = sr.segment_sum(seg, vals, k), sr.segment_sum(seg, vals, k)
    want = ref.segment_sum(seg, vals, k)
    torch.cuda.synchronize()
    check(sr.segment_sum.plain_calls == plain_before,
          "segment_sum past MAX_K served its plain version")
    check(torch.equal(first, second),
          "segment_sum past MAX_K: two runs differ bitwise")
    err = float((first - want).abs().max())
    tol = _tolerance(torch, want, torch.float64)
    check(err <= tol, f"segment_sum past MAX_K: max |kernel - plain| {err} "
                      f"exceeds {tol}")
    ms, covered = window_ms(torch, lambda: sr.segment_sum(seg, vals, k), 10)
    log(f"kernel segment_sum[float64] K={k} n={n} windows={sr.windows(k)} "
        f"kernel_ms={ms:.4f}{'' if covered else ' (uncovered)'} "
        f"max_abs_err={err:.3e} (tol {tol:.3e}) bitwise_repeat=ok")
    return {"k": k, "n": n, "windows": sr.windows(k), "ms": ms,
            "covered": covered, "max_abs_err": err}


def _hold_segment_skew(torch, gen, dev, n: int, k: int, reps: int) -> dict:
    """segment_sum_vectors (D = 2, f64) at the group-by's shape on skewed
    keys: half of the rows on one key (the rest uniform), and Zipf s = 1.1
    over the K keys.  Each is held to its plain version within _tolerance
    and bitwise across two runs, and timed beside ``index_add_``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr

    zipf = 1.0 / torch.arange(1, k + 1, device=dev, dtype=torch.float64) ** 1.1
    keys = {
        "half_one_key": lambda: torch.where(
            torch.rand(n, generator=gen, device=dev) < 0.5, 0,
            torch.randint(0, k, (n,), generator=gen, device=dev)),
        "zipf_1.1": lambda: torch.multinomial(zipf, n, replacement=True,
                                              generator=gen),
    }
    out = {}
    for case, draw in keys.items():
        seg = draw().to(torch.int32)
        vals = _random(torch, gen, (n, 2), torch.float64, dev)
        acc = torch.zeros((k, 2), dtype=torch.float64, device=dev)
        first = sr.segment_sum_vectors(seg, vals, k)
        second = sr.segment_sum_vectors(seg, vals, k)
        want = ref.segment_sum_vectors(seg, vals, k)
        torch.cuda.synchronize()
        check(torch.equal(first, second),
              f"segment_sum_vectors[{case}]: two runs differ bitwise")
        err = float((first - want).abs().max())
        tol = _tolerance(torch, want, torch.float64)
        check(err <= tol, f"segment_sum_vectors[{case}]: max |kernel - "
                          f"plain| {err} exceeds {tol}")
        row = _timed_row(
            torch, f"segment_sum_vectors[{case}]",
            lambda: sr.segment_sum_vectors(seg, vals, k),
            lambda: ref.segment_sum_vectors(seg, vals, k),
            lambda: acc.index_add_(0, seg, vals), reps, n * 20 + k * 16,
            2 * n, PEAK_OPS["float64"], max_abs_err=err, tolerance=tol,
            hottest_share=float(torch.bincount(seg, minlength=k).max()) / n)
        out[case] = row
        log(f"kernel segment_sum_vectors[float64,{case}] n={n} K={k} "
            f"hottest key {row['hottest_share']:.3f} of the rows "
            f"{_times(row)} (Tensor.index_add_) max_abs_err={err:.3e} "
            f"(tol {tol:.3e}) bitwise_repeat=ok")
        del seg, vals, acc, first, second, want
        torch.cuda.empty_cache()
    return out


def _exact_err(torch, got, want) -> float:
    """Largest |difference| over the outputs of an integer/bool kernel
    (0.0 when they are bitwise equal)."""
    return max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0.0 for g, w in zip(got, want))


#: group_probe's other tables: the whole key column in one bucket-indexed
#: block of splitters (4,096 keys), and MAX_CAP (65,536 keys)
PROBE_TABLES = (4096, 65_536)


def _hold_group_probe_tables(torch, gen, dev, n: int, reps: int) -> list:
    """group_probe at each of PROBE_TABLES: sorted distinct keys drawn from
    [0, 2K), CSR offsets of 4 rows a group, n queries drawn from [0, 2K)
    (about half of them hit), each result equal to the plain version's and
    bitwise the same twice; timed beside torch.searchsorted."""
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ref

    rows = []
    for k in PROBE_TABLES:
        keys = torch.sort(torch.randperm(2 * k, generator=gen, device=dev)
                          [:k]).values.to(torch.int64)
        offsets = torch.arange(0, 4 * k + 1, 4, dtype=torch.int32,
                               device=dev)
        count = torch.tensor(k, device=dev)
        queries = torch.randint(0, 2 * k, (n,), generator=gen, device=dev)

        def kern(keys=keys, offsets=offsets, count=count, queries=queries):
            return hp.group_probe(keys, offsets, count, queries)

        def plain(keys=keys, offsets=offsets, count=count, queries=queries):
            return ref.group_probe(keys, offsets, count, queries)

        first, second, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"group_probe[{k} keys]: two runs differ bitwise")
        err = _exact_err(torch, first, want)
        check(err == 0.0, f"group_probe[{k} keys]: kernel differs from its "
                          f"plain version (max |diff| {err})")
        row = _timed_row(
            torch, f"group_probe[{k} keys]", kern, plain,
            lambda keys=keys, queries=queries: torch.searchsorted(keys,
                                                                  queries),
            reps, n * (8 + 4 + 1 + 4) + k * 8 + (k + 1) * 4 + 8,
            n * max(int(np.ceil(np.log2(k))), 1), PEAK_OPS["int64"],
            dtype="int64", case=f"{k} keys", keys=k, n=n, max_abs_err=err,
            tolerance=0.0, hits=int(first[1].sum()))
        log(f"kernel group_probe[int64, {k} keys] n={n} hits={row['hits']} "
            f"{_times(row)} (torch.searchsorted) bitwise == plain, "
            f"bitwise_repeat=ok")
        rows.append(row)
        del keys, offsets, queries, first, second, want
    return rows


def _launch_split(torch, fn, reps: int) -> dict:
    """{kernel: [device us a launch, launches traced]} of the kernels
    ``reps`` calls of ``fn`` run, from one profiler trace (a trace late in
    a process may lose some launches: the count is what it kept)."""
    _, top = _device_profile(torch, lambda: [fn() for _ in range(reps)],
                             top=8)
    return {name: [ms * 1e3 / calls, calls] for name, ms, calls in top}


def _hold_hash_to_slot(torch, keys, ctab: int, what: str) -> float:
    """hash_to_slot twice on ``keys``: each result held to the contract,
    its compacted slots equal to the plain version's bitwise and to each
    other.  Returns the largest difference (0.0)."""
    from repro_torch.kernels import hash_table as ht
    from repro_torch.kernels import ref

    first, second = ht.hash_to_slot(keys, ctab), ht.hash_to_slot(keys, ctab)
    want = ref.hash_to_slot(keys, ctab)
    torch.cuda.synchronize()
    for out in (first, second):
        ht.check_contract(keys, ctab, *out)
    got = [ht.compact_slots(o[0], o[1], ctab) for o in (first, second)]
    check(torch.equal(got[0], got[1]),
          f"{what}: compacted slots differ between runs")
    return _exact_err(torch, [got[0], got[1], first[2]],
                      [want[0], want[0], want[2]])


def hold_join_kernels(torch, sizes: Sizes, seed: int, launches: dict,
                      dev="cuda") -> list:
    """The join's four kernels at the join phases' shapes: dict_probe at
    the m:1 probe (59,986,052 order dates against 365 date keys),
    group_probe at the m:n probe (16,777,216 part keys against 50,000
    groups; also against 4,096 and 65,536 keys), hash_to_slot and
    slot_hist at the m:n build (200,000 rows; hash_to_slot also at the
    m:1 build, 365 date keys in 1,024 slots).
    The probes and the histogram must equal their plain versions bitwise
    and repeat bitwise; hash_to_slot is held to its contract, and its
    compacted slots to the plain version's, run after run.  The builds'
    rows (one launch a call each) also carry the floor of one launch
    (``zero_()`` of one int32, host-free) and the device time a launch
    from a profiler trace."""
    from repro_torch.kernels import group_build as gb
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import hash_table as ht
    from repro_torch.kernels import ref

    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    n_m1 = sizes.join_m1_rows
    lut = torch.from_numpy(ssb_dates()).to(dev)
    dates = torch.from_numpy(date_1993(seed)["datekey"]).to(dev)
    orderdate = lut[torch.randint(0, SSB_DAYS, (n_m1,), generator=gen,
                                  device=dev)]
    n_dates = torch.tensor(dates.shape[0], device=dev)
    parts, fan = sizes.join_mn_parts, sizes.join_mn_fanout
    pk = torch.from_numpy(partsupp(parts, fan, seed)["partkey"]).to(dev)
    n_b = pk.shape[0]
    ctab = ht.table_size(parts)
    p_slots, p_table, _ = ref.hash_to_slot(pk, ctab)
    cslots = ht.compact_slots(p_slots, p_table, parts)
    groups = torch.unique(pk)
    offsets = torch.arange(0, n_b + 1, fan, dtype=torch.int32, device=dev)
    n_groups = torch.tensor(parts, device=dev)
    n_mn = sizes.join_mn_rows
    partkey = torch.randint(0, 2 * parts, (n_mn,), generator=gen, device=dev)
    def lg(c):  # dependent loads of one binary search over c keys
        return max(int(np.ceil(np.log2(max(c, 2)))), 1)

    cases = [
        # (name, kernel, plain, library, library name, bytes, operations,
        #  source, TPU kernel); keys int64, slot_hist's slots int32
        ("hash_to_slot", lambda: ht.hash_to_slot(pk, ctab),
         lambda: ref.hash_to_slot(pk, ctab),
         lambda: torch.unique(pk, return_inverse=True),
         "torch.unique(return_inverse=True)", n_b * (8 + 4) + ctab * 8 + 4,
         n_b, "hash_table.cu", "src/repro/kernels/hash_table.py:123"),
        ("dict_probe", lambda: hp.dict_probe(dates, n_dates, orderdate),
         lambda: ref.dict_probe(dates, n_dates, orderdate),
         lambda: torch.searchsorted(dates, orderdate), "torch.searchsorted",
         n_m1 * (8 + 4 + 1) + dates.shape[0] * 8 + 8,
         n_m1 * lg(dates.shape[0]), "hash_probe.cu",
         "src/repro/kernels/hash_probe.py:125"),
        ("group_probe",
         lambda: hp.group_probe(groups, offsets, n_groups, partkey),
         lambda: ref.group_probe(groups, offsets, n_groups, partkey),
         lambda: torch.searchsorted(groups, partkey), "torch.searchsorted",
         n_mn * (8 + 4 + 1 + 4) + parts * 8 + (parts + 1) * 4 + 8,
         n_mn * lg(parts), "hash_probe.cu",
         "src/repro/kernels/hash_probe.py:83"),
        ("slot_hist", lambda: gb.slot_hist(cslots, parts + 1),
         lambda: ref.slot_hist(cslots, parts + 1),
         lambda: torch.bincount(cslots, minlength=parts + 1),
         "torch.bincount(minlength=num_slots)", n_b * 4 + (parts + 1) * 4,
         n_b, "group_build.cu", "src/repro/kernels/group_build.py:73"),
    ]
    one = torch.zeros((1,), dtype=torch.int32, device=dev)
    floor_ms, _ = window_ms(torch, one.zero_, 100)
    log(f"kernel floor: one launch (zero_() of one int32) "
        f"kernel_ms={floor_ms:.4f} host-free")
    rows = []
    for name, kern, plain, library, lib_name, nbytes, ops, src, tpu in cases:
        dtype = "int32" if name == "slot_hist" else "int64"
        if name == "hash_to_slot":
            err = _hold_hash_to_slot(torch, pk, ctab, name)
            what = "contract ok, compacted slots == plain"
        else:
            first, second, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            first = first if isinstance(first, tuple) else (first,)
            second = second if isinstance(second, tuple) else (second,)
            want = want if isinstance(want, tuple) else (want,)
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"{name}: two runs differ bitwise")
            err = _exact_err(torch, first, want)
            what = "bitwise == plain, bitwise_repeat=ok"
            del first, second, want
        check(err == 0.0, f"{name}: kernel differs from its plain version "
                          f"(max |diff| {err})")
        row = _timed_row(torch, name, kern, plain, library, sizes.timing_reps,
                         nbytes, ops, PEAK_OPS[dtype], dtype=dtype,
                         max_abs_err=err, tolerance=0.0)
        log(f"kernel {name}[{dtype}] {_times(row)} ({lib_name}) {what}")
        per_dtype = [row]
        if name == "group_probe":
            row["case"] = f"{parts} keys"
            per_dtype += _hold_group_probe_tables(
                torch, gen, dev, n_mn, sizes.timing_reps)
        build = {}
        if name in ("hash_to_slot", "slot_hist"):
            row["case"] = f"{n_b} rows"
            row["launch_split"] = _launch_split(torch, kern, 50)
            log(f"  {name}[{row['case']}] device us a launch (profiler, 50 "
                f"calls: [us, launches traced]): {row['launch_split']}")
            if name == "hash_to_slot":
                per_dtype.append(_hold_dict_build(torch, dates,
                                                  sizes.timing_reps))
            build = {"floor_ms": floor_ms, "launch_split": row["launch_split"]}
            log(f"  {name}: one launch a call; the floor of one launch is "
                f"{floor_ms:.4f} ms of its {row['ms']:.4f}")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library": lib_name,
            "dtype": dtype, **build, "per_dtype": per_dtype,
        })
    return rows


def _hold_dict_build(torch, dates, reps: int) -> dict:
    """hash_to_slot at the m:1 dict build's shape (the 365 date keys of
    1993 in a 1,024-slot table): held as at the m:n build, timed beside
    its plain version and torch.unique."""
    from repro_torch.kernels import hash_table as ht
    from repro_torch.kernels import ref

    n, ctab = dates.shape[0], ht.table_size(dates.shape[0])
    err = _hold_hash_to_slot(torch, dates, ctab, "hash_to_slot[dates]")
    check(err == 0.0, f"hash_to_slot[dates]: kernel differs from its plain "
                      f"version (max |diff| {err})")

    def kern():
        return ht.hash_to_slot(dates, ctab)

    row = _timed_row(
        torch, "hash_to_slot[dates]", kern,
        lambda: ref.hash_to_slot(dates, ctab),
        lambda: torch.unique(dates, return_inverse=True), reps,
        n * (8 + 4) + ctab * 8 + 4, n, PEAK_OPS["int64"], dtype="int64",
        case=f"{n} rows", cap_table=ctab, max_abs_err=err, tolerance=0.0)
    row["launch_split"] = _launch_split(torch, kern, 50)
    log(f"kernel hash_to_slot[int64, {n} keys, {ctab} slots] {_times(row)} "
        f"(torch.unique(return_inverse=True)) contract ok, compacted slots "
        f"== plain; device us a launch (profiler, 50 calls: [us, launches "
        f"traced]): {row['launch_split']}")
    return row


#: FP64 tensor-core (DMMA) and FP32 peaks of the H100 SXM data sheet: the
#: least time the card could take for a product's 2mnk operations at full
#: precision (TF32 would be faster but is not the same function)
MATMUL_PEAK = {"float64": 67e12, "float32": 67e12}


def f32_body():
    """sqrt(a*a + b*b) / (1 + a*a) over two f32 columns: only + - * / and
    sqrt, so the kernel (-fmad=false) must equal the plain version
    bitwise."""
    from repro_torch.core import ir, wtypes as wt

    i = ir.Ident("i%hold", wt.I64)
    x = ir.Ident("x%hold", wt.Struct((wt.F32, wt.F32)))
    a, b = ir.GetField(x, 0), ir.GetField(x, 1)

    def sq(e):
        return ir.BinOp("*", e, e)

    body = ir.BinOp("/", ir.UnaryOp("sqrt", ir.BinOp("+", sq(a), sq(b))),
                    ir.BinOp("+", ir.Literal(1.0, wt.F32), sq(a)))
    return ir.Lambda((i, x), body)


def _timed_row(torch, what, kern, plain, library, reps, nbytes, ops, peak,
               **extra) -> dict:
    """Kernel (twice), plain version and library call timed host-free
    (``window_ms``), beside the kernel's and the library's CUDA-event
    times (``event_ms``, the host path included), and the bound: the
    larger of ``nbytes`` over the HBM rate and ``ops`` over ``peak``.  A
    host-free reading below the bound fails when ``nbytes`` exceed the
    L2: it is a fault in the measurement."""
    t_kernel, c_kernel = window_ms(torch, kern, reps)
    t_plain, c_plain = window_ms(torch, plain, reps)
    t_lib, c_lib = (window_ms(torch, library, reps) if library is not None
                    else (None, True))
    t_kernel2, c_kernel2 = window_ms(torch, kern, reps)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    row = dict(extra, ms=min(t_kernel, t_kernel2),
               ms_runs=[t_kernel, t_kernel2], plain_ms=t_plain,
               library_ms=t_lib, event_ms=event_ms(torch, kern, reps),
               library_event_ms=(event_ms(torch, library, reps)
                                 if library is not None else None),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, ops=ops, l2_resident=nbytes <= L2_BYTES,
               uncovered=[k for k, c in (("kernel", c_kernel and c_kernel2),
                                         ("plain", c_plain),
                                         ("library", c_lib)) if not c])
    if not row["l2_resident"]:
        for key in ("ms", "plain_ms", "library_ms"):
            check(row[key] is None or row[key] >= row["bound_ms"],
                  f"{what}: {key} {row[key]} reads below its bound "
                  f"{row['bound_ms']} ms ({nbytes} bytes, past the L2): a "
                  f"fault in the measurement")
    return row


def _times(row: dict) -> str:
    """The timing part of a kernel line."""
    lib = ("none" if row["library_ms"] is None
           else f"{row['library_ms']:.4f}")
    flags = (" l2_resident" if row["l2_resident"] else "") + (
        f" uncovered={','.join(row['uncovered'])}" if row["uncovered"]
        else "")
    return (f"kernel_ms={row['ms']:.4f} (runs "
            f"{', '.join(f'{x:.4f}' for x in row['ms_runs'])}; events "
            f"{row['event_ms']:.4f}) plain_ms={row['plain_ms']:.4f} "
            f"library_ms={lib} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}){flags}")


def hold_array_kernels(torch, sizes: Sizes, seed: int, launches: dict,
                       bodies: dict, by_phase: dict, tuned: dict,
                       dev="cuda") -> list:
    """The array path's three kernels at the phases' shapes:
    map_elementwise on the Black-Scholes body (33,554,432 options), the
    logreg body (4,194,304 logits) and an f32 body; tiled_matmul at 4096^3
    in f64 and f32 and at the logreg matvec (4,194,304 x 64) in f64 and
    f32, on an aligned A (the bulk row launch) and on one a element off
    16 bytes (a warp a row), each case with the launches of the phase
    that runs it (``by_phase``: matmul, matmul.f32, logreg.weld; no phase
    runs an f32 matvec or an unaligned one); and
    filter_reduce_q6 in f64 at SF10.  Each runs twice (bitwise equal) and
    is held against its plain version: bitwise where the arithmetic is
    IEEE-exact on both sides, else to the stated tolerance.  A map chain
    launches with the grid cap the main path's compile chose at its
    size (``main_path_cap``)."""
    from repro_torch.core import ir
    from repro_torch.kernels import filter_reduce as fr
    from repro_torch.kernels import map_chain as mc
    from repro_torch.kernels import ref
    from repro_torch.kernels import tiled_matmul as tm

    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    reps = sizes.timing_reps

    def uni(shape, lo, hi, dt=torch.float64):
        return torch.rand(shape, generator=gen, device=dev, dtype=dt) \
            * (hi - lo) + lo

    def name_of(dt):
        return str(dt).split(".")[-1]

    rows = []
    # -- B3: map_elementwise ------------------------------------------------
    n_bs = sizes.bs_options
    n_lr, d_lr = sizes.logreg
    lr_src = mc.source_for(bodies["logreg"])
    lr_env = {name: torch.tensor(0.25, dtype=torch.float64, device=dev)
              for name, _ in lr_src.scalars}
    cases = [
        ("blackscholes", bodies["blackscholes"],
         lambda: [uni(n_bs, 10, 200), uni(n_bs, 10, 200),
                  uni(n_bs, 0.1, 2.0)], {}, "libm"),
        ("logreg", bodies["logreg"], lambda: [uni(n_lr, -16, 16)], lr_env,
         "libm"),
        ("f32_norm", f32_body(),
         lambda: [uni(n_bs, -4, 4, torch.float32),
                  uni(n_bs, -4, 4, torch.float32)], {}, "bitwise"),
    ]
    per = []
    for label, lam, make, env, kind in cases:
        cols = make()
        plain_fn = mc.stage_plain(lam, env, dev)
        cap = main_path_cap(tuned, "map_elementwise", cols[0].shape[0])

        def kern(lam=lam, cols=cols, env=env, plain_fn=plain_fn, cap=cap):
            return mc.map_elementwise(plain_fn, cols, lam=lam, env=env,
                                      max_blocks=cap)

        def plain(cols=cols, plain_fn=plain_fn):
            return ref.map_elementwise(plain_fn, cols)

        first, second, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(first, second),
              f"map_elementwise[{label}]: two runs differ bitwise")
        check(first.dtype == want.dtype and first.shape == want.shape,
              f"map_elementwise[{label}]: {first.dtype}{tuple(first.shape)} "
              f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((first.double() - want.double()).abs().max())
        if kind == "bitwise":
            tol = 0.0
            check(torch.equal(first, want),
                  f"map_elementwise[{label}]: differs from the plain version "
                  f"(max |diff| {err}); + - * / sqrt must be bitwise")
        else:
            rel = float(((first.double() - want.double()).abs()
                         / want.double().abs().clamp_min(1.0)).max())
            tol = 1e-5 if want.dtype == torch.float32 else 1e-12
            check(rel <= tol, f"map_elementwise[{label}]: max relative "
                              f"error {rel} > {tol}")
        n = cols[0].shape[0]
        nbytes = n * (sum(c.element_size() for c in cols)
                      + first.element_size())
        # the operations the fused function needs: each distinct
        # subtree once (the generic closure repeats the inlined ones)
        ops = n * mc.source_for(lam).ops
        row = _timed_row(torch, f"map_elementwise[{label}]", kern, plain,
                         None, reps, nbytes, ops,
                         PEAK_OPS[name_of(want.dtype)], case=label,
                         dtype=name_of(want.dtype), max_abs_err=err,
                         tolerance=tol, n=n, max_blocks=cap)
        per.append(row)
        log(f"kernel map_elementwise[{label}] n={n} dtype={row['dtype']} "
            f"max_blocks={cap or 'default'} "
            f"{_times(row)} max_abs_err={err:.3e} ({kind}) "
            f"bitwise_repeat=ok")
        del cols, first, second, want
        torch.cuda.empty_cache()
    for tag, info in mc.build_info().items():
        log(f"  generated map chain {tag}: "
            f"{'nvcc' if info['built'] else 'cached'} {info['seconds']:.3f} s")
    # the host time a launch spends finding its body's kernel: by the
    # lambda's identity, as map_elementwise does, against the structural
    # key that lookup avoids
    bs_lam = bodies["blackscholes"]
    t0 = time.perf_counter()
    for _ in range(reps):
        mc.source_for(bs_lam)
    lookup_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    ir.canon_key(bs_lam)
    canon_ms = (time.perf_counter() - t0) * 1e3
    n_nodes = sum(1 for _ in ir.walk(bs_lam.body))
    log(f"  source lookup of the Black-Scholes body ({n_nodes} IR nodes), "
        f"host: by identity {lookup_ms:.4f} ms, ir.canon_key "
        f"{canon_ms:.3f} ms")
    main = per[0]
    rows.append({
        "name": "map_elementwise", "route": "cuda",
        "source": "src/repro_torch/kernels/map_chain.py",
        "replaces": "src/repro/kernels/map_chain.py:33",
        "launches": launches["map_elementwise"],
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None, "library": None,
        "dtype": main["dtype"], "max_blocks": main["max_blocks"],
        "per_dtype": per, "generated_builds": mc.build_info(),
        "host_lookup_ms": lookup_ms, "host_canon_key_ms": canon_ms,
    })

    # -- B10: tiled_matmul --------------------------------------------------
    side = sizes.matmul
    # (label, dtype, A, B, A's offset in elements, phase): "matvec_offset"
    # starts A one element past a 16-byte boundary, which the bulk copy
    # cannot read, so it takes the warp-a-row launch
    cases = [("square", torch.float64, (side, side), (side, side), 0,
              "matmul"),
             ("square", torch.float32, (side, side), (side, side), 0,
              "matmul.f32"),
             ("matvec", torch.float64, (n_lr, d_lr), (d_lr, 1), 0,
              "logreg.weld"),
             ("matvec", torch.float32, (n_lr, d_lr), (d_lr, 1), 0, None),
             ("matvec_offset", torch.float64, (n_lr, d_lr), (d_lr, 1), 1,
              None),
             ("matvec_offset", torch.float32, (n_lr, d_lr), (d_lr, 1), 1,
              None)]
    expected_launch = {"square": "tiles", "matvec": "rows_bulk",
                       "matvec_offset": "rows_warp"}
    per = []
    for label, dt, ashape, bshape, offset, phase in cases:
        a = uni((ashape[0] * ashape[1] + offset,), 0, 1, dt)[offset:] \
            .view(ashape)
        b = uni(bshape, 0, 1, dt)
        check(tm.plan(a, b) == expected_launch[label],
              f"tiled_matmul[{label},{dt}]: plan chose {tm.plan(a, b)}, "
              f"expected {expected_launch[label]}")

        def kern(a=a, b=b):
            return tm.tiled_matmul(a, b)

        def plain(a=a, b=b):
            return ref.tiled_matmul(a, b)

        def library(a=a, b=b):
            return torch.matmul(a, b)

        first, second, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(first, second),
              f"tiled_matmul[{label},{dt}]: two runs differ bitwise")
        err = float((first.double() - want.double()).abs().max())
        tol = _tolerance(torch, want, dt)
        check(err <= tol, f"tiled_matmul[{label},{dt}]: max |kernel - plain| "
                          f"{err} exceeds {tol}")
        (m, k), n = ashape, bshape[1]
        e = a.element_size()
        row = _timed_row(torch, f"tiled_matmul[{label},{dt}]", kern, plain,
                         library, reps,
                         (m * k + k * n + m * n) * e, 2 * m * n * k,
                         MATMUL_PEAK[name_of(dt)], case=label,
                         dtype=name_of(dt), shape=[m, k, n],
                         launch=tm.plan(a, b), max_abs_err=err,
                         tolerance=tol,
                         launches=by_phase.get(phase, {}).get(
                             "tiled_matmul", 0), phase=phase)
        per.append(row)
        log(f"kernel tiled_matmul[{label},{row['dtype']}] m,k,n={m},{k},{n} "
            f"launch={row['launch']} "
            f"{_times(row)} (torch.matmul) max_abs_err={err:.3e} "
            f"(tol {tol:.3e}) bitwise_repeat=ok launches={row['launches']} "
            f"({phase})")
        del a, b, first, second, want
        torch.cuda.empty_cache()
    main = per[0]
    rows.append({
        "name": "tiled_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tiled_matmul.cu",
        "replaces": "src/repro/kernels/tiled_matmul.py:43",
        "launches": launches["tiled_matmul"],
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "torch.matmul", "dtype": main["dtype"], "per_dtype": per,
    })

    # -- B11: filter_reduce_q6 ----------------------------------------------
    n = sizes.lineitem
    cols = torch.stack([
        torch.randint(0, 2557, (n,), generator=gen, device=dev).double(),
        uni(n, 0.0, 0.1), uni(n, 1.0, 50.0)])
    lo = torch.tensor([365.0, 0.05, -np.inf], dtype=torch.float64,
                      device=dev)
    hi = torch.tensor([730.0, np.nextafter(0.07, np.inf), 24.0],
                      dtype=torch.float64, device=dev)
    val = uni(n, 0.0, 1000.0)

    def kern():
        return fr.filter_reduce_q6(cols, lo, hi, val)

    def plain():
        return ref.filter_reduce_q6(cols, lo, hi, val)

    first, second, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    check(torch.equal(first, second),
          "filter_reduce_q6: two runs differ bitwise")
    err = float((first - want).abs())
    tol = _tolerance(torch, want, torch.float64)
    check(err <= tol, f"filter_reduce_q6: |kernel - plain| {err} > {tol}")
    kept = int(torch.all((cols >= lo[:, None]) & (cols < hi[:, None]),
                         dim=0).sum())
    row = _timed_row(torch, "filter_reduce_q6", kern, plain, None, reps,
                     n * (3 * 8 + 8) + 56,
                     n * 3 * 2 + kept, PEAK_OPS["float64"], case="sf10",
                     dtype="float64", n=n, kept=kept, max_abs_err=err,
                     tolerance=tol)
    log(f"kernel filter_reduce_q6[float64] n={n} kept={kept} "
        f"{_times(row)} max_abs_err={err:.3e} (tol {tol:.3e}) "
        f"bitwise_repeat=ok")
    rows.append({
        "name": "filter_reduce_q6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/filter_reduce.cu",
        "replaces": "src/repro/kernels/filter_reduce.py:132",
        "launches": launches["filter_reduce_q6"], "max_abs_err": err,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "library": None, "dtype": "float64",
        "per_dtype": [row],
    })
    del cols, val
    torch.cuda.empty_cache()
    return rows


def _attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """(q, kv) pairs the mask leaves, per (batch, head)."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(skv, i + off + 1) for i in range(sq))


def _start_fault_builds(tmp: Path) -> list:
    """One ``nvcc`` per planted fault, all started together: a copy of
    csrc/flash_attention_sm90.cu with the fault, built with the library's
    flags into ``tmp``.  Returns [(name, .so path, process)]."""
    from repro_torch.kernels import _build

    text = (_build.CSRC / ATTN_FAULT_SOURCE).read_text()
    builds = []
    for name, old, new in ATTN_FAULTS:
        check(old in text, f"planted fault {name}: {old!r} is not in "
                           f"{ATTN_FAULT_SOURCE}")
        src, so = tmp / f"{name}.cu", tmp / f"{name}.so"
        src.write_text(text.replace(old, new))
        builds.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return builds


def _v1_attention(torch, q, k, v, causal: bool, group: int):
    """A call of v1 (``csrc/flash_attention.cu``) on the operands of a
    Hopper-route call, straight through the library: the two kernels
    timed side by side on the same bf16 operands.  Uncounted."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    bsz, h, sq, d = q.shape
    skv = k.shape[2]
    q, k, v = (t if fa._aligned(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty((bsz, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *fa._strides(q), *fa._strides(k), *fa._strides(v),
        *out.stride()[:3])
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def call():
        rc = lib.weld_flash_attention(
            fa.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), strides, bsz, h, group, sq, skv,
            d, int(causal), float(d ** -0.5), stream)
        _build.check(rc, "flash_attention kernel launch (v1)")
        return out
    return call


def _with_fault(name: str, so: Path, proc, fn):
    """``fn()`` with the flash_attention wrapper launching the faulty
    build of the Hopper route instead of the library's kernel."""
    import ctypes

    from repro_torch.kernels import _build

    out, _ = proc.communicate()
    check(proc.returncode == 0, f"planted fault {name}: nvcc failed:\n{out}")
    lib = ctypes.CDLL(str(so))
    lib.weld_flash_attention_sm90.argtypes = list(
        _build._C_SIGNATURES["weld_flash_attention_sm90"])
    lib.weld_flash_attention_sm90.restype = ctypes.c_int
    orig = _build.library
    _build.library = lambda: lib
    try:
        return fn()
    finally:
        _build.library = orig


def _attention_held(torch, got, q, k, v, causal: bool, group: int):
    """``got`` (B, H, Sq, D) against ``ref.attention`` one sequence at a
    time (a sequence's scores at the serving prefill are 0.4 GB in f32):
    (max |diff|, max |diff| / limit, the same over the later half of
    the rows, and both over a fixed limit 2e-2 + 2e-2 |plain| for
    comparison)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    err = share = late = old = old_late = 0.0
    half = q.shape[2] // 2
    for j in range(q.shape[0]):
        want = ref.attention(q[j], k[j], v[j], causal=causal, group=group)
        limit = fa.tolerance(q[j], k[j], v[j], want, causal=causal,
                             group=group).clamp_min(1e-30)
        diff = (got[j].float() - want.float()).abs()
        rel = diff / limit
        err = max(err, float(diff.max()))
        share = max(share, float(rel.max()))
        late = max(late, float(rel[:, half:].max()))
        fixed = diff / (2e-2 + 2e-2 * want.float().abs())
        old = max(old, float(fixed.max()))
        old_late = max(old_late, float(fixed[:, half:].max()))
    return err, share, late, old, old_late


def _planted_faults(torch, builds, kern, q, k, v, group: int) -> dict:
    """Each planted fault's kernel at the case of ``kern`` (causal), held
    as the kernel is: the bf16 limit must reject it over all rows and over
    the later half of the rows."""
    faults = {}
    for name, so, proc in builds:
        err, share, late, old, old_late = _with_fault(
            name, so, proc,
            lambda: _attention_held(torch, kern(), q, k, v, True, group))
        faults[name] = dict(max_abs_err=err, max_limit_share=share,
                            late_rows_limit_share=late, fixed_limit_share=old,
                            late_rows_fixed_limit_share=old_late)
        log(f"planted fault {name} at the prefill shape: max |kernel - "
            f"plain| {err:.3e}, {share:.4g} x the limit ({late:.4g} x over "
            f"the later half of the rows); {old:.4g} x a fixed 2e-2 + 2e-2 "
            f"|plain| ({old_late:.4g} x over the later rows)")
        check(share > 1.0 and late > 1.0,
              f"planted fault {name} passed the bf16 limit: {share} x it, "
              f"{late} x over the later rows")
    return faults


def hold_attention_kernel(torch, sizes: Sizes, seed: int, launches: dict,
                          dev="cuda") -> list:
    """flash_attention against its plain version on the card: at the
    serving prefill's shape and the train micro-batch's, and without the
    mask at Whisper's encoder and the vision cross-attention (Sq > Skv)
    (each timed on the Hopper route beside v1 on the same operands and
    SDPA as the library yardstick, the last two also in f32 on v1), a
    ragged S, Sq < Skv, and f32 (v1); each case twice, bitwise equal.  At
    the prefill's shape the bf16 limit must also reject each planted fault
    (``ATTN_FAULTS``)."""
    import tempfile

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    bsz, h, hk, s, d = sizes.attn_shape
    bf16, f32 = torch.bfloat16, torch.float32
    # (case, dtype, B, H, Hkv, Sq, Skv, D, causal, timed)
    cases = [
        ("prefill", bf16, bsz, h, hk, s, s, d, True, True),
        ("train", bf16, sizes.train_batch // sizes.train_accum, h, hk, s, s,
         d, True, True),
        ("ragged", bf16, bsz, h, hk, sizes.attn_ragged, sizes.attn_ragged,
         d, True, False),
        ("sq_lt_skv", bf16, bsz, h, hk, sizes.attn_sq, s, d, True, False),
        ("f32", f32, bsz, h, hk, s, s, d, True, True),
    ]
    for case, (nb, hh, hkk, sq, skv, dd) in (
            ("whisper_enc", sizes.attn_whisper),
            ("vlm_cross", sizes.attn_vlm)):
        cases += [(case, bf16, nb, hh, hkk, sq, skv, dd, False, True),
                  (case + "_f32", f32, nb, hh, hkk, sq, skv, dd, False,
                   False)]
    per_case = []
    tmp = tempfile.TemporaryDirectory(prefix="weld-faults-")
    builds = _start_fault_builds(Path(tmp.name))
    try:
        for case, dt, nb, h, hk, sq, skv, d, causal, timed in cases:
            group = h // hk

            def draw(heads, n, mul):
                x = torch.randn((nb, n, heads, d), generator=gen,
                                device=dev)
                return (x * mul).to(dt).transpose(1, 2)  # (B, H, S, D)

            q, k, v = draw(h, sq, 0.5), draw(hk, skv, 0.5), draw(hk, skv, 1.)
            route = fa.route(dt, d)

            def kern():
                return fa.flash_attention(q, k, v, causal=causal, group=group)

            def plain():
                return ref.chunked_attention(q, k, v, causal=causal,
                                             group=group)

            fa.flash_attention.launches_sm90 = 0
            first, second = kern(), kern()
            torch.cuda.synchronize()
            check(torch.equal(first, second),
                  f"flash_attention[{case}]: two runs differ bitwise")
            check(fa.flash_attention.launches_sm90
                  == (2 if route == "sm90" else 0),
                  f"flash_attention[{case}]: {route} route expected, "
                  f"{fa.flash_attention.launches_sm90} Hopper launches")
            err, share, late, _, _ = _attention_held(torch, first, q, k, v,
                                                     causal, group)
            check(share <= 1.0, f"flash_attention[{case}]: |kernel - "
                                f"ref.attention| {err}, {share} x its limit")
            row = dict(case=case, route=route, kernel=fa.kernel(dt, d),
                       dtype=str(dt).replace("torch.", ""),
                       shape=[nb, h, hk, sq, skv, d], max_abs_err=err,
                       max_limit_share=share, late_rows_limit_share=late)
            log(f"kernel flash_attention[{case}] {row['dtype']} route={route}"
                f" kernel={row['kernel']} B={nb} H={h}/{hk} Sq={sq} "
                f"Skv={skv} D={d} max_abs_err={err:.3e} ({share:.4f} x the "
                f"limit, {late:.4f} x over the later half of the rows) "
                f"bitwise_repeat=ok")
            if case == "prefill":
                want = ref.attention(q[0], k[0], v[0], group=group)
                limit = fa.tolerance(q[0], k[0], v[0], want, group=group)
                row.update(
                    late_rows_median_abs_plain=float(
                        want[:, sq // 2:].float().abs().median()),
                    late_rows_median_limit=float(
                        limit[:, sq // 2:].median()))
                log(f"flash_attention[prefill] later half of the rows: "
                    f"median |plain| {row['late_rows_median_abs_plain']:.4e}"
                    f", median limit {row['late_rows_median_limit']:.4e}")
                del want, limit
                faults = _planted_faults(torch, builds, kern, q, k, v, group)
            if timed:
                qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

                def library():
                    return F.scaled_dot_product_attention(
                        qc, kc, vc, is_causal=causal, enable_gqa=True)

                nbytes = ((2 * nb * h * sq + 2 * nb * hk * skv) * d
                          * q.element_size())
                peak = 989e12 if dt == torch.bfloat16 else PEAK_OPS["float32"]
                row.update(_timed_row(
                    torch, f"flash_attention[{case}]", kern, plain, library,
                    sizes.timing_reps, nbytes,
                    4 * nb * h * d * _attention_pairs(sq, skv, causal),
                    peak))
                if route == "sm90":
                    # v1 on the same operands, between two kernel timings
                    row["v1_ms"], _ = window_ms(
                        torch, _v1_attention(torch, q, k, v, causal, group),
                        sizes.timing_reps)
                    again, _ = window_ms(torch, kern, sizes.timing_reps)
                    row["ms_runs"].append(again)
                    row["ms"] = min(row["ms_runs"])
                log(f"kernel flash_attention[{case}] route={route} "
                    + (f"v1_ms={row['v1_ms']:.4f} " if "v1_ms" in row else "")
                    + f"{_times(row)} (sdpa; {row['bound_ms'] / row['ms']:.3f}"
                    f" of the bound)")
                del qc, kc, vc
            per_case.append(row)
            del q, k, v, first, second
            torch.cuda.empty_cache()
    finally:  # every nvcc started has ended when this returns
        for _, _, proc in builds:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
        tmp.cleanup()
    main, train = per_case[0], per_case[1]
    by_case = {r["case"]: r for r in per_case}
    v1_launches = launches["flash_attention"] - launches[SM90]
    check(v1_launches > 0, "flash_attention: v1 (f32) never launched on the "
                           "main path")
    return [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/" + ATTN_FAULT_SOURCE,
        "replaces": "src/repro/kernels/flash_attention.py:74",
        "launches": launches[SM90],
        "max_abs_err": max(r["max_abs_err"] for r in per_case),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "dtype": "bfloat16", "v1_ms": main["v1_ms"],
        "train": {k: train[k] for k in ("ms", "v1_ms", "plain_ms",
                                        "library_ms", "bound_ms")},
        **{case: {k: by_case[case][k] for k in (
            "shape", "ms", "v1_ms", "plain_ms", "library_ms", "bound_ms",
            "max_abs_err")} for case in ("whisper_enc", "vlm_cross")},
        "v1": {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "launches": v1_launches},
        "per_dtype": per_case, "planted_faults": faults,
    }]


def hold_fused_adamw(torch, sizes: Sizes, seed: int, launches: dict,
                     dev="cuda") -> list:
    """fused_adamw against ``ref.adamw_update`` on the card: the largest
    parameter of the training run (the embedding table) with bf16 and f32
    p, bf16 and f32 g, t in {1, 5}, and an odd size for every dtype pair;
    each case launched twice on copies (bitwise equal, written in place).
    m, v and an f32 p within rtol 2e-5, atol 1e-7 (the JAX package's
    kernel test), a bf16 p within 2**-7 of the value (one bf16 step).  The
    main path's case (bf16 p, f32 g at accum > 1) and the all-f32 case
    are timed beside the plain version; the all-f32 case also beside
    ``torch.optim.AdamW(fused=True).step()`` on the same tensors (it keeps
    m and v in p's dtype, so with a bf16 p it is another function)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_adamw as aw
    from repro_torch.kernels import ref

    dev = torch.device(dev)
    cfg = get_config(sizes.lm_arch, smoke=sizes.lm_smoke)
    big = cfg.vocab * cfg.d_model
    bf16, f32 = torch.bfloat16, torch.float32
    pairs = [(bf16, f32), (f32, f32), (bf16, bf16), (f32, bf16)]
    cases = [(big, pd, gd, t) for pd, gd in pairs for t in (1, 5)]
    cases += [(sizes.adamw_odd, pd, gd, 5) for pd, gd in pairs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 30)
    lr = 3e-4
    per_case = []
    for n, pd, gd, t in cases:
        def draw(mul, dtype, positive=False):
            x = torch.randn((n,), generator=gen, device=dev) * mul
            return (x.abs() if positive else x).to(dtype)

        p, g = draw(1.0, pd), draw(0.1, gd)
        m, v = draw(0.01, f32), draw(0.001, f32, True)
        runs = []
        for _ in range(2):
            out = (p.clone(), m.clone(), v.clone())
            ptrs = [x.data_ptr() for x in out]
            got = aw.adamw_update(out[0], g, out[1], out[2], lr, t)
            check(all(a is b for a, b in zip(got, out))
                  and [x.data_ptr() for x in got] == ptrs,
                  "fused_adamw: the update is not in place")
            runs.append(out)
        want = ref.adamw_update(p, g, m, v, lr, t)
        torch.cuda.synchronize()
        name = (f"fused_adamw[n={n} p={str(pd)[6:]} g={str(gd)[6:]} "
                f"t={t}]")
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"{name}: two launches differ bitwise")
        errs, shares = [], []
        for i, (a, w) in enumerate(zip(runs[0], want)):
            diff = (a.float() - w.float()).abs()
            if i == 0 and pd == bf16:
                limit = w.float().abs() * 2.0 ** -7
            else:
                limit = 1e-7 + 2e-5 * w.float().abs()
            errs.append(float(diff.max()))
            shares.append(float((diff / limit.clamp_min(1e-30)).max()))
        plain_equal = all(torch.equal(a, w) for a, w in zip(runs[0], want))
        check(max(shares) <= 1.0,
              f"{name}: |kernel - plain| (p, m, v) {errs}, {shares} x the "
              f"limits")
        row = dict(n=n, p_dtype=str(pd)[6:], g_dtype=str(gd)[6:], t=t,
                   max_abs_err=max(errs), max_abs_err_pmv=errs,
                   max_limit_share=max(shares), plain_bitwise=plain_equal)
        del runs, want
        timed = n == big and t == 5 and gd == f32
        if timed:
            library = None
            if pd == f32:
                leaf = torch.nn.Parameter(p.clone())
                leaf.grad = g.clone()
                lib_opt = torch.optim.AdamW(
                    [leaf], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=0.01, fused=True)
                library = lib_opt.step
            nbytes = n * (2 * p.element_size() + g.element_size() + 16)
            row.update(_timed_row(
                torch, name, lambda: aw.adamw_update(p, g, m, v, lr, t),
                lambda: ref.adamw_update(p, g, m, v, lr, t), library,
                sizes.timing_reps, nbytes, 20 * n, PEAK_OPS["float32"]))
            log(f"kernel {name} {_times(row)} (library: "
                f"torch.optim.AdamW(fused))")
            if library is not None:
                del leaf, lib_opt, library
        log(f"kernel {name} max |kernel - plain| p, m, v "
            f"{[f'{e:.3e}' for e in errs]} ({max(shares):.4f} x the limit) "
            f"bitwise equal to the plain version: {plain_equal} "
            f"bitwise_repeat=ok")
        per_case.append(row)
        del p, g, m, v
        torch.cuda.empty_cache()
    timed = {r["p_dtype"]: r for r in per_case if "ms" in r}
    main, f32_row = timed["bfloat16"], timed["float32"]
    return [{
        "name": "fused_adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_adamw.cu",
        "replaces": "src/repro/kernels/fused_adamw.py:50",
        "launches": launches["fused_adamw"],
        "max_abs_err": max(r["max_abs_err"] for r in per_case),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": f32_row["library_ms"],
        "library": "torch.optim.AdamW(fused=True).step(), p and g f32 "
                   "(f32_case)",
        "dtype": "p bfloat16, g float32",
        "f32_case": {k: f32_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "library_ms")},
        "per_dtype": per_case,
    }]


# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    log(f"build: {'nvcc' if info['built'] else 'cached'} "
        f"{time.perf_counter() - t0:.3f} s -> {info['path']}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line.lower() \
                or "error" in line.lower() or line.startswith("==") \
                or "Compiling entry function" in line:
            log(f"  {line.strip()}")


def elapsed(what: str, t_all: float) -> None:
    """The script's clock at the end of a stage (where its time goes)."""
    log(f"[{time.perf_counter() - t_all:.1f} s] {what} done")


def run(torch, sizes: Sizes, seed: int) -> dict:
    import repro_torch

    repro_torch.set_default_device("cuda")
    # full-precision products on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    build_kernels()
    elapsed("build_kernels", t_all)
    mp = MainPath(torch, sizes, seed)
    t0 = time.perf_counter()
    cols = lineitem(sizes.lineitem, seed)
    log(f"lineitem: {sizes.lineitem} rows generated in "
        f"{time.perf_counter() - t0:.3f} s")
    phase_tpch(mp, cols)
    elapsed("phase_tpch", t_all)
    phase_join_m1(mp, cols)
    elapsed("phase_join_m1", t_all)
    pipeline = phase_pipeline(mp, cols)
    elapsed("phase_pipeline", t_all)
    serve = phase_serve(mp, cols)
    elapsed("phase_serve", t_all)
    del cols, mp.memo["join_m1"]
    phase_groupby(mp)
    elapsed("phase_groupby", t_all)
    phase_pagerank(mp)
    elapsed("phase_pagerank", t_all)
    phase_quickstart(mp)
    elapsed("phase_quickstart", t_all)
    phase_gate(mp)
    elapsed("phase_gate", t_all)
    phase_join_mn(mp)
    elapsed("phase_join_mn", t_all)
    mp.memo.pop(("join_mn", "left"), None)
    phase_recovery(mp)
    elapsed("phase_recovery", t_all)
    mp.memo.clear()
    phase_blackscholes(mp)
    elapsed("phase_blackscholes", t_all)
    phase_logreg(mp)
    elapsed("phase_logreg", t_all)
    phase_matmul(mp)
    elapsed("phase_matmul", t_all)
    gc.collect()
    torch.cuda.empty_cache()
    lm = phase_lm_serve(torch, sizes, seed, mp.launches)
    elapsed("phase_lm_serve", t_all)
    gc.collect()
    torch.cuda.empty_cache()
    lm_train = phase_lm_train(torch, sizes, seed, mp.launches)
    elapsed("phase_lm_train", t_all)
    gc.collect()
    torch.cuda.empty_cache()
    lm_train_mesh = phase_lm_train_mesh(torch, sizes, seed, mp.launches,
                                        lm_train)
    elapsed("phase_lm_train_mesh", t_all)
    gc.collect()
    torch.cuda.empty_cache()
    families = phase_lm_families(torch, sizes, seed, mp.launches)
    elapsed("phase_lm_families", t_all)
    gc.collect()
    torch.cuda.empty_cache()
    families_train = phase_lm_families_train(torch, sizes, seed,
                                             mp.launches)
    elapsed("phase_lm_families_train", t_all)
    for name, n in mp.launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")
    kernels = hold_kernels(torch, sizes, seed, mp.launches, mp.tuned)
    kernels += hold_join_kernels(torch, sizes, seed, mp.launches)
    kernels += hold_array_kernels(torch, sizes, seed, mp.launches, mp.bodies,
                                  mp.by_phase, mp.tuned)
    kernels += hold_attention_kernel(torch, sizes, seed, mp.launches)
    kernels += hold_fused_adamw(torch, sizes, seed, mp.launches)
    elapsed("the kernel holds", t_all)
    check(sorted(r["name"] for r in kernels)
          == sorted(k for k in mp.launches if k != SM90),
          f"the kernels line lists {sorted(r['name'] for r in kernels)}")
    window = {r["name"]: r["ms"] for r in kernels}
    for r in pipeline["ledger"]:
        wrappers = sorted({w for spec, w in JOIN_M1_EXPECT
                           if spec == r["kernel"]})
        log(f"pipeline.trace ledger beside the holds: {r['kernel']} "
            f"measured_ns={r['measured_ns']} event_ns={r['event_ns']} "
            f"predicted_ns={r['predicted_ns']}; window_ms "
            + ", ".join(f"{w} {window[w]:.4f}" for w in wrappers))
    check_no_quarantine({}, "the end of the run")
    gc.collect()
    torch.cuda.empty_cache()
    gate = run_gate_trace()
    return {"kernels": kernels, "phase_ms": mp.phase_ms, "lm_serve": lm,
            "lm_train": lm_train, "lm_train_mesh": lm_train_mesh,
            "lm_families": families,
            "lm_families_train": families_train, "gate": gate,
            "pipeline": pipeline,
            "serve": serve,
            "total_s": time.perf_counter() - t_all}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the full results as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    # a kernel health file or a cost ledger left on the machine must not
    # route a kernel away unseen: both start empty in a fresh directory;
    # and every compile verifies its IR after each pass and the planning
    state = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    os.environ["WELD_KERNEL_HEALTH"] = str(state / "kernel_health.json")
    os.environ["WELD_COST_LEDGER"] = str(state / "cost_ledger.jsonl")
    os.environ["WELD_AUTOTUNE_CACHE"] = str(state / "autotune.json")
    os.environ["WELD_VERIFY"] = "1"
    try:
        result = run(torch, Sizes(), args.seed)
    finally:
        shutil.rmtree(state, ignore_errors=True)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"total {result['total_s']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(result, card=card),
                                             indent=1))
    summary = [{k: v for k, v in row.items()
                if k not in ("per_dtype", "generated_builds",
                             "host_lookup_ms", "host_canon_key_ms")}
               for row in result["kernels"]]
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
