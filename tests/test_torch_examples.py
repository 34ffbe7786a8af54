"""The port's runnable examples (``examples/*_torch.py``), each run as a
child process on the CPU (``--device cpu``) at its smallest arguments,
beside the JAX package's example where one is compared:

* each exits 0;
* ``quickstart_torch.py`` prints the total of ``examples/quickstart.py``
  (rtol 1e-12 on the printed values) and checks it against numpy itself;
* ``serve_lm_torch.py --arch qwen2-7b`` (head dimension 14; 2 prompts
  of 8 tokens, 8 generated, for both) prints the fields of
  ``examples/serve_lm.py``'s line, the same generated shape;
* ``train_lm_torch.py`` keeps the reference's "loss decreased" assert;
* ``moe_weld_routing_torch.py`` checks the Weld routing against the MoE
  layer itself;
* without ``--device cpu`` each runs on CUDA, and here, with no card, it
  exits non-zero with the port's ``DeviceUnavailableError``: nothing
  falls back to the CPU.

No example imports ``jax``, ``repro`` or ``benchmarks``.  The children
run side by side (module fixture ``runs``).
"""
from __future__ import annotations

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: serve's smallest run: 2 prompts of 8 tokens, 8 generated
SERVE = ["--arch", "qwen2-7b", "--batch", "2", "--prompt-len", "8",
         "--gen-len", "8"]
EXAMPLES = {
    "quickstart": ["quickstart_torch.py"],
    "serve": ["serve_lm_torch.py", *SERVE],
    "train": ["train_lm_torch.py", "--steps", "20"],
    "moe": ["moe_weld_routing_torch.py"],
}
REFERENCE = {
    "quickstart": ["quickstart.py"],
    "serve": ["serve_lm.py", *SERVE],
}
TIMEOUT = 600


def _start(args, extra=(), env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2", **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", args[0]), *args[1:],
         *extra], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ckpt"))
    procs = {}
    for name, args in EXAMPLES.items():
        extra = ["--ckpt-dir", ck] if name == "train" else []
        procs[("cpu", name)] = _start(args, extra + ["--device", "cpu"])
        procs[("default", name)] = _start(args, extra)
    for name, args in REFERENCE.items():
        procs[("reference", name)] = _start(
            args, env_extra={"JAX_PLATFORMS": "cpu"})
    return {k: _finish(p) for k, p in procs.items()}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(runs, name):
    rc, out, err = runs[("cpu", name)]
    assert rc == 0, out[-2000:] + err[-4000:]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_needs_a_card_unless_asked_for_the_cpu(runs, name):
    rc, out, err = runs[("default", name)]
    assert rc != 0
    assert "DeviceUnavailableError" in err, err[-2000:]


def _total(out):
    m = re.search(r"total crime index\s*:\s*([\d,.]+)", out)
    assert m, out
    return float(m.group(1).replace(",", ""))


def test_quickstart_total_equals_the_reference(runs):
    rc, out, _ = runs[("cpu", "quickstart")]
    rrc, rout, rerr = runs[("reference", "quickstart")]
    assert rc == 0 and rrc == 0, rerr[-2000:]
    assert _total(out) == pytest.approx(_total(rout), rel=1e-12)
    assert "matches native NumPy   : True" in out


LINE = re.compile(r"generated shape: \((\d+), (\d+)\); ([\d.]+) tok/s decode")


def test_serve_prints_the_reference_fields(runs):
    rc, out, _ = runs[("cpu", "serve")]
    rrc, rout, rerr = runs[("reference", "serve")]
    assert rc == 0 and rrc == 0, rerr[-2000:]
    got, want = LINE.search(out), LINE.search(rout)
    assert got and want, (out, rout)
    assert got.groups()[:2] == want.groups()[:2] == ("2", "8")
    assert float(got.group(3)) > 0
    # head dimension 14: the CPU takes the plain version
    assert "flash_attention (D 14" in out and "plain=" in out


def test_train_loss_decreased(runs):
    rc, out, _ = runs[("cpu", "train")]
    assert rc == 0 and "loss decreased" in out


def test_moe_routing_checked_against_the_layer(runs):
    rc, out, _ = runs[("cpu", "moe")]
    assert rc == 0
    assert "dispatch matches the layer's sort-based buckets" in out
    assert "combine (vecmerger) matches the layer's output" in out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_imports_neither_jax_nor_the_reference(name):
    path = os.path.join(ROOT, "examples", EXAMPLES[name][0])
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert not mods & {"jax", "repro", "benchmarks"}, mods
