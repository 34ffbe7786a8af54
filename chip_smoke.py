#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout on a machine with a CUDA card (and
``nvcc``): it builds the port's CUDA kernels from ``src/repro_torch/
kernels/csrc`` and then

1. runs five phases through the frames a user calls — TPC-H Q6 and a
   Q1-style four-aggregate query on an SF10-sized lineitem (59,986,052
   rows), a 4096-key group-by over the same row count, PageRank
   iterations (4,096 vertices x 16,777,216 edges under
   ``kernelize="always"``, 1,000,000 x 10,000,000 under ``"auto"``) and
   the quickstart workflow (2,000,000 rows) — each checked against numpy
   computed here, with every kernel launch counter zeroed just before a
   phase and read just after;
2. holds each kernel against its plain PyTorch version on the card at the
   phases' shapes, for every dtype its planner spec takes, runs it twice
   (the two results must be bitwise equal) and times kernel, plain
   version and a one-call PyTorch yardstick with CUDA events;
3. prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

It exits non-zero, with no result line, when there is no CUDA device or
any check fails.  Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and the non-tensor-core
#: peaks (FP64, FP32; integer adds are priced at the FP32 rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float64": 34e12, "float32": 67e12, "int32": 67e12,
            "int64": 67e12}

SF10_ROWS = 59_986_052


@dataclass
class Sizes:
    lineitem: int = SF10_ROWS
    groupby_rows: int = SF10_ROWS
    groupby_keys: int = 4096
    pr_always: tuple = (4096, 16_777_216)
    pr_auto: tuple = (1_000_000, 10_000_000)
    quickstart: int = 2_000_000
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
        self.phase_ms = {}

    def run(self, phase: str, mode: str, fn, expect=()):
        """Zero the counters, drive ``fn(mode, stats)`` and read them.
        Under "always" every wrapper in ``expect`` must have launched and
        no wrapper may have served its plain version."""
        torch = self.torch
        torch.cuda.synchronize()
        self.ops.reset_counts()
        stats: dict = {}
        t0 = time.perf_counter()
        value = fn(mode, stats)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = self.ops.counts()
        for name, (launches, _) in counts.items():
            self.launches[name] += launches
        routed = {k[len("kernelize."):]: v for k, v in stats.items()
                  if k.startswith("kernelize.") and k != "kernelize.matched"}
        key = f"{phase}[{mode}]"
        while key in self.phase_ms:
            key += "'"
        self.phase_ms[key] = {"wall_ms": wall, "encode_ms": stats["encode_ms"],
                              "run_ms": stats["run_ms"]}
        compile_ms = 0.0 if stats.get("cache.hit") else stats["compile_ms"]
        log(f"phase {phase} kernelize={mode}: wall_ms={wall:.3f} "
            f"(encode_ms={stats['encode_ms']:.3f} compile_ms={compile_ms:.3f} "
            f"run_ms={stats['run_ms']:.3f}) routed={routed} launches="
            f"{ {k: v[0] for k, v in counts.items() if v[0]} } "
            f"plain_calls={ {k: v[1] for k, v in counts.items() if v[1]} }")
        if mode == "auto":
            plan = stats.get("kernelplan", {})
            for c in plan.get("costs", []):
                log(f"  auto decision: {c['kernel']} routed={c['routed']} "
                    f"kernel_us={c['kernel_us']} generic_us={c['jnp_us']} "
                    f"({c['why']})")
        if mode == "always":
            for spec, wrapper in expect:
                check(stats.get(f"kernelize.{spec}", 0) > 0,
                      f"{phase}: spec {spec} not routed under always")
                check(counts[wrapper][0] > 0,
                      f"{phase}: kernel {wrapper} never launched")
            check(all(p == 0 for _, p in counts.values()),
                  f"{phase}: plain versions served kernel calls: {counts}")
        return value, stats


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
    for mode in ("always", "auto"):
        got, _ = mp.run("q6", mode, q6,
                        expect=[("filter_reduce_sum", "filter_reduce_sum")])
        close(got, want, 1e-9, f"q6[{mode}]")

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
        got, _ = mp.run("groupby", mode, groupby, expect=[
            ("dict_group_sum", "segment_sum_vectors")])
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


def phase_pagerank(mp: MainPath) -> None:
    for (nv, ne), mode in ((mp.sizes.pr_always, "always"),
                           (mp.sizes.pr_auto, "auto")):
        rng = np.random.RandomState(mp.seed + 2)
        src = rng.randint(0, nv, ne).astype(np.int64)
        dst = rng.randint(0, nv, ne).astype(np.int64)
        deg = np.maximum(np.bincount(src, minlength=nv), 1).astype(np.float64)
        rank = rng.rand(nv)
        rank /= rank.sum()
        invdeg = 1.0 / deg
        want = 0.15 / nv + 0.85 * np.bincount(
            dst, weights=rank[src] * invdeg[src], minlength=nv)
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
                  f"path (the gate rejects K > MAX_K), got {stats['kernelplan']}")


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


# ---------------------------------------------------------------------------
# each kernel against its plain version, timed
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps: int) -> float:
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
                 dev="cuda") -> list:
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
            reps = sizes.timing_reps
            t_kernel = time_ms(torch, lambda: kern(*args), reps)
            t_plain = time_ms(torch, lambda: plain(*args), reps)
            t_lib = time_ms(torch, library, reps)
            t_kernel2 = time_ms(torch, lambda: kern(*args), reps)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[str(dt).split(".")[-1]] * 1e3
            row = {
                "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                "tolerance": tol, "ms": min(t_kernel, t_kernel2),
                "ms_runs": [t_kernel, t_kernel2], "plain_ms": t_plain,
                "library_ms": t_lib, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops,
            }
            per_dtype.append(row)
            shape = tuple(args[0 if name.startswith("filter") else 1].shape)
            log(f"kernel {name}[{row['dtype']}] shape={shape} "
                f"kernel_ms={row['ms']:.4f} (runs {t_kernel:.4f}, "
                f"{t_kernel2:.4f}) plain_ms={t_plain:.4f} "
                f"library_ms={t_lib:.4f} ({lib_name}) "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"max_abs_err={err:.3e} (tol {tol:.3e}) bitwise_repeat=ok")
            del args, first, second, want
            torch.cuda.empty_cache()
        # the line reports the f64 case (the dtype the main path ran);
        # the other dtypes are on the lines above and in --out
        main = next(r for r in per_dtype if r["dtype"] == "float64")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library": lib_name,
            "dtype": "float64", "per_dtype": per_dtype,
        })
    return rows


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
                or "error" in line.lower() or line.startswith("=="):
            log(f"  {line.strip()}")


def run(torch, sizes: Sizes, seed: int) -> dict:
    import repro_torch

    repro_torch.set_default_device("cuda")
    t_all = time.perf_counter()
    build_kernels()
    mp = MainPath(torch, sizes, seed)
    t0 = time.perf_counter()
    cols = lineitem(sizes.lineitem, seed)
    log(f"lineitem: {sizes.lineitem} rows generated in "
        f"{time.perf_counter() - t0:.3f} s")
    phase_tpch(mp, cols)
    del cols
    phase_groupby(mp)
    phase_pagerank(mp)
    phase_quickstart(mp)
    for name, n in mp.launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")
    kernels = hold_kernels(torch, sizes, seed, mp.launches)
    return {"kernels": kernels, "phase_ms": mp.phase_ms,
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
    result = run(torch, Sizes(), args.seed)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"total {result['total_s']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(result, card=card),
                                             indent=1))
    summary = [{k: v for k, v in row.items() if k != "per_dtype"}
               for row in result["kernels"]]
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
