#!/usr/bin/env python
"""Where the weldlint corpus's verify and bounds-admission time goes, on
the port (``repro_torch``).

Compiles ``tools/weldlint_torch.py``'s corpus once, keeps each item's
input program (the one full verify of a compile) and its planned program
(the one admission analyses), then times, each as the median of
``--reps`` rounds of ``--inner`` calls summed over the five items:

* ``check.verify`` on the input programs, then each analysis alone:
  the type annotation (``verify_types.walk`` where the package has it:
  the types and the lints' facts in one walk), every lint of
  ``check.ANALYSES`` on what it gives, and the free variables of
  ``checkpoint``'s reuse test (``check._free_env``);
* ``runtime._admit`` on the planned programs, then ``bounds.analyze``,
  and the report's ``peak``, ``certificate``, ``builder_lines`` and
  ``result_rows``;
* with ``--cold``, only each item's first verify and first admission
  in this process, in a compile's order (verify, then admission).

``--src DIR`` profiles the package under ``DIR`` (another checkout's
``src``) with this script; the corpus evaluates on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python tools/weldlint_profile_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _median_ms(fn, reps: int, inner: int) -> float:
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        runs.append((time.perf_counter() - t0) / inner * 1e3)
    return statistics.median(runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="profile the repro_torch package under this dir")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--cold", action="store_true",
                    help="time only the first call of each item")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(args.src or os.path.join(
        here, "..", "src")))
    import repro_torch

    sys.path.insert(1, here)
    import weldlint_torch
    from repro_torch.core import check, runtime
    from repro_torch.core.analysis import bounds
    from repro_torch.core.check import verify_types

    repro_torch.set_default_device(args.device)
    inputs = []
    checkpoint = runtime.check.checkpoint

    def spy(phase, e, env=None, stats=None, shapes=None):
        if phase == "input":
            inputs.append((e, env, shapes))
    runtime.check.checkpoint = spy
    admit = runtime._admit
    runtime._admit = lambda *a, **k: None
    try:
        plans = [(st["plan.ir"], st["plan.inputs"][2])
                 for _, st in weldlint_torch.corpus()]
    finally:
        runtime.check.checkpoint = checkpoint
        runtime._admit = admit
    out = {"package": os.path.dirname(repro_torch.__file__),
           "device": args.device}
    if args.cold:
        # as a compile meets them: each item's verify, then its admission
        T = time.perf_counter
        out["cold.verify"], out["cold.admit"] = [], []
        for (e, env, shp), (plan, pshp) in zip(inputs, plans):
            t0 = T()
            check.verify(e, env=env, shapes=shp)
            t1 = T()
            admit(plan, pshp, None, {})
            t2 = T()
            out["cold.verify"].append(round((t1 - t0) * 1e3, 4))
            out["cold.admit"].append(round((t2 - t1) * 1e3, 4))
        print(json.dumps(out))
        return 0

    def over_inputs(fn):
        return lambda: [fn(e, env, shp) for e, env, shp in inputs]

    # a package whose type walk gathers the lints' facts hands them on
    walk = getattr(verify_types, "walk", None)
    typed = [walk(e, env) if walk else verify_types.annotate(e, env)
             for e, env, _ in inputs]

    def lint(name):
        def run():
            for (e, env, shp), got in zip(inputs, typed):
                kw = {"facts": got[2]} if walk else {}
                if name == "bounds":
                    kw["shapes"] = shp
                check.ANALYSES[name](e, got[0], **kw)
        return run

    timed = {
        "verify": over_inputs(lambda e, env, shp: check.verify(
            e, env=env, shapes=shp)),
        "verify.annotate": over_inputs(
            lambda e, env, shp: (walk or verify_types.annotate)(e, env)),
        **{f"verify.{name}": lint(name) for name in check.ANALYSES},
        "verify.free_env": over_inputs(
            lambda e, env, shp: check._free_env(e)),
        "admit": lambda: [admit(e, shp, None, {}) for e, shp in plans],
        "admit.analyze": lambda: [bounds.analyze(e) for e, _ in plans],
    }
    reports = [(bounds.analyze(e), shp) for e, shp in plans]
    for part in ("peak", "certificate", "builder_lines", "result_rows"):
        timed[f"admit.{part}"] = (
            lambda part=part: [getattr(r, part)() if part == "certificate"
                               else getattr(r, part)(shp)
                               for r, shp in reports])
    for name, fn in timed.items():
        out[name] = round(_median_ms(fn, args.reps, args.inner), 4)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
