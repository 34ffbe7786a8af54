"""Device times of the join's build kernels, ``hash_to_slot`` and
``slot_hist``, at the shapes the port's joins build, for one checkout of
the repo, so that two checkouts can be compared on one card in one call:

    python src/repro_torch/launch/join_build_times.py --tree OTHER_CHECKOUT
    python src/repro_torch/launch/join_build_times.py --tree .

It is run by path, not with ``-m``: it imports ``repro_torch`` from
``TREE/src``, builds that checkout's kernel library there and times

* ``hash_to_slot`` at ``partsupp``, the m:n build of TPC-H partsupp at
  50,000 parts (200,000 rows, each part key four times in adjacent rows,
  a table of 131,072 slots), and at ``dates``, the m:1 build of SSB's
  1993 date rows (365 keys, a table of 1,024);
* ``slot_hist`` at ``partsupp``: the compacted slots of that build,
  50,001 counts;
* ``floor``: one trivial launch, ``zero_()`` of a one-element card
  tensor.

Times are host-free: the calls queue behind a ``torch.cuda._sleep``
that outlasts their enqueueing and CUDA events bracket them; the least
of three windows is kept.  ``split`` gives each kernel's device time a call from a
``torch.profiler`` trace of the same calls.  Each output is checked:
``hash_to_slot`` against ``hash_table.check_contract`` with its compacted
slots equal to the plain version's, ``slot_hist`` bitwise equal to its
plain version, each twice.  Prints the card's name and power limit, then
one JSON object a row; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PARTS, FANOUT = 50_000, 4
REPS = 200


def _sleep_cycles_per_ms(torch) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(stop)


def window_ms(torch, fn, reps: int, cycles_per_ms: float):
    """(ms a call, covered) of ``reps`` calls queued behind a sleep twice
    as long as the host takes to enqueue them; ``covered`` is False when
    the card ran out of queued work before the last call was enqueued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (2.0 * reps * host_ms + 1.0)))
    start.record()
    for _ in range(reps):
        fn()
    covered = not start.query()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, covered


def launch_split(torch, fn, reps: int) -> dict:
    """{kernel name: [us a launch, launches a call]} from a profiler trace
    of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)
        if us and e.count:
            out[e.key[:60]] = [us / e.count, e.count / reps]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose src/repro_torch is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    from repro_torch.kernels import group_build as gb
    from repro_torch.kernels import hash_table as ht
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("join_build_times: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    cycles = _sleep_cycles_per_ms(torch)
    days = np.datetime64("1993-01-01") + np.arange(365)
    dates = (days.astype("datetime64[Y]").astype(np.int64) + 1970) * 10000 \
        + (days.astype("datetime64[M]").astype(np.int64) % 12 + 1) * 100 \
        + (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    keys = {
        "partsupp": torch.from_numpy(np.repeat(
            np.arange(1, PARTS + 1, dtype=np.int64), FANOUT)).to(dev),
        "dates": torch.from_numpy(dates.astype(np.int64)).to(dev),
    }
    caps = {"partsupp": PARTS, "dates": 365}
    p_slots, p_table, _ = ref.hash_to_slot(keys["partsupp"],
                                           ht.table_size(PARTS))
    cslots = ht.compact_slots(p_slots, p_table, PARTS)
    ok = True

    def row(kernel, shape, fn, check, **extra):
        nonlocal ok
        first, second = fn(), fn()
        torch.cuda.synchronize()
        good = check(first) and check(second)
        runs = [window_ms(torch, fn, REPS, cycles) for _ in range(3)]
        print(json.dumps(dict(
            tree=args.tree, kernel=kernel, shape=shape,
            ms=min(r[0] for r in runs), ms_runs=[r[0] for r in runs],
            covered=all(r[1] for r in runs),
            split=launch_split(torch, fn, REPS), ok=good, **extra)),
            flush=True)
        ok = ok and good

    for shape, k in keys.items():
        ctab = ht.table_size(caps[shape])
        want = ref.hash_to_slot(k, ctab)[0]

        def check_h(out, k=k, ctab=ctab, want=want):
            try:
                ht.check_contract(k, ctab, *out)
            except AssertionError as e:
                print(f"hash_to_slot[{shape}]: {e}", file=sys.stderr)
                return False
            return bool(torch.equal(ht.compact_slots(out[0], out[1], ctab),
                                    want))

        row("hash_to_slot", shape,
            lambda k=k, ctab=ctab: ht.hash_to_slot(k, ctab), check_h,
            rows=k.shape[0], cap_table=ctab)
    want_hist = ref.slot_hist(cslots, PARTS + 1)
    row("slot_hist", "partsupp", lambda: gb.slot_hist(cslots, PARTS + 1),
        lambda out: bool(torch.equal(out, want_hist)),
        rows=cslots.shape[0], num_slots=PARTS + 1)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    runs = [window_ms(torch, one.zero_, REPS, cycles) for _ in range(3)]
    print(json.dumps(dict(
        tree=args.tree, kernel="floor", shape="zero_() of one int32",
        ms=min(r[0] for r in runs), ms_runs=[r[0] for r in runs],
        covered=all(r[1] for r in runs),
        split=launch_split(torch, one.zero_, REPS))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
