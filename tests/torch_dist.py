"""Multi-rank runs of the port on the CPU, for the distributed tests.

``launch(case, world, tmp_path, **kw)`` starts ``world`` child processes,
each ``python tests/torch_dist.py`` with its rank: one thread, the port's
default device the CPU, a gloo process group over a ``file://`` store
under ``tmp_path`` (no TCP port, so parallel test workers cannot
collide).  Each runs ``torch_dist_cases.<case>(**kw)`` and pickles what
it returns; ``launch`` returns the ranks' results in rank order, or
raises with the failing ranks' output.  A launch that outlives its
timeout is killed and fails its test alone.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 300


def launch(case: str, world: int, tmp_path, timeout: float = TIMEOUT,
           **kwargs):
    run = os.path.join(str(tmp_path), f"run_{case}_{time.monotonic_ns()}")
    os.makedirs(run)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    env["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    spec = json.dumps({"case": case, "world": world, "dir": run,
                       "kwargs": kwargs})
    procs = []
    for rank in range(world):
        log = open(os.path.join(run, f"log{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, str(rank)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = []
        for r in bad[:2]:
            with open(os.path.join(run, f"log{r}.txt")) as f:
                logs.append(f"--- rank {r} (rc {procs[r][0].returncode}):\n"
                            + f.read()[-6000:])
        raise AssertionError(f"{case} on {world} ranks failed on ranks "
                             f"{bad}\n" + "\n".join(logs))
    out = []
    for r in range(world):
        with open(os.path.join(run, f"result{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child(spec: dict, rank: int) -> None:
    import warnings

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    import logging
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    import repro_torch
    repro_torch.set_default_device("cpu")
    dist.init_process_group(
        "gloo", init_method=f"file://{spec['dir']}/store", rank=rank,
        world_size=spec["world"])
    import torch_dist_cases
    try:
        res = getattr(torch_dist_cases, spec["case"])(**spec["kwargs"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(spec["dir"], f"result{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    _child(json.loads(sys.argv[1]), int(sys.argv[2]))
