"""``tools/weldlint_torch.py`` (the port's weldlint) against the JAX
package's ``tools/weldlint.py``, on the CPU, each tool run as a child
process (side by side, module fixture ``runs``):

* ``--bounds-smoke --device cpu`` exits 0 (certificates on every corpus
  item, the analysis under 10 % of compile time, the symbolic m:n
  certificate rendered);
* ``--smoke --device cpu``: every corpus item's checkpoints run clean,
  and the exit code is the reference's overhead gate (verify time under
  10 % of compile time) applied to the printed total — the gates'
  values are the reference's (``OVERHEAD_GATE``, ``RECALL_GATE``); the
  gate is missed on the port, so its verify time is also held to at
  most twice the reference's on the same corpus;
* ``--mutate 1 --device cpu`` applies and catches the same mutants as
  ``tools/weldlint.py --mutate 1``;
* each corpus item's pinned ``kernelize`` (``PINNED``) is the route the
  reference's ``"auto"`` takes on it, read from its own stats: "off"
  where its gate routed nothing, "always" where it routed every
  candidate;
* without ``--device cpu`` the tool evaluates on CUDA and, with no card
  here, exits non-zero with ``DeviceUnavailableError``.
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
TIMEOUT = 600

#: the reference's corpus under its default ``"auto"``: each item's
#: routed and rejected kernels and its verify time, from the stats the
#: corpus collects
REF_ROUTES = """
import json, sys
sys.path.insert(0, sys.argv[1])
import weldlint
out = {}
for label, st in weldlint.corpus():
    kp = st.get("kernelplan") or {}
    out[label] = {"routed": sorted(kp.get("routed", {})),
                  "rejected": sorted(kp.get("rejected", {})),
                  "mode": kp.get("mode"), "verify_ms": st["verify.ms"]}
print("RESULT " + json.dumps(out))
"""


def _env(jax=False):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(tool, *args, jax=False):
    return subprocess.Popen([sys.executable, os.path.join(TOOLS, tool),
                             *args], env=_env(jax), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs():
    procs = {
        "smoke": _start("weldlint_torch.py", "--smoke", "--device", "cpu"),
        "bounds": _start("weldlint_torch.py", "--bounds-smoke", "--device",
                         "cpu"),
        "mutate": _start("weldlint_torch.py", "--mutate", "1", "--device",
                         "cpu"),
        "no_device": _start("weldlint_torch.py", "--bounds-smoke"),
        "ref_mutate": _start("weldlint.py", "--mutate", "1", jax=True),
        "ref_routes": subprocess.Popen(
            [sys.executable, "-c", REF_ROUTES, TOOLS], env=_env(True),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
    }
    out = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=TIMEOUT)
            out[k] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _constants(tool):
    """The module-level constants of a tool, read from its source."""
    with open(os.path.join(TOOLS, tool)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_gates_are_the_reference_gates():
    port, ref = _constants("weldlint_torch.py"), _constants("weldlint.py")
    for name in ("OVERHEAD_GATE", "RECALL_GATE"):
        assert port[name] == ref[name], name


def test_bounds_smoke_exits_0_on_the_cpu(runs):
    rc, out, err = runs["bounds"]
    assert rc == 0, out[-3000:] + err[-3000:]
    assert "OK: certificates on corpus" in out


def test_smoke_corpus_runs_clean_and_the_gate_decides_the_exit(runs):
    rc, out, err = runs["smoke"]
    gate = _constants("weldlint_torch.py")["OVERHEAD_GATE"]
    for label in _constants("weldlint_torch.py")["PINNED"]:
        line = [ln for ln in out.splitlines()
                if ln.strip().startswith(label + " ")]
        assert line and "checkpoints=" in line[0], (label, out)
        assert int(re.search(r"checkpoints=(\d+)", line[0]).group(1)) > 0
    assert not re.search(r"^FAIL \S+:", out, re.M), out
    total = re.search(r"TOTAL .* verify=\s*([\d.]+)ms compile=\s*([\d.]+)ms",
                      out)
    assert total, out + err[-3000:]
    frac = float(total.group(1)) / float(total.group(2))
    assert rc == (0 if frac < gate else 1), (rc, frac, out)


#: the most the port's verifier may take over the corpus, as a multiple
#: of the reference's on the same corpus in the same run (the same
#: checks on the same planned programs); the overhead gate against
#: compile time is missed on the port
VERIFY_SLACK = 2.0


def test_smoke_verifier_costs_no_more_than_the_references(runs):
    """The reference's gate, verify time under 10 % of compile time, is
    missed on the port (whose compile has no XLA step); its verifier's
    own time is held to the reference's instead, so a slower verifier
    fails here."""
    rc, out, err = runs["smoke"]
    total = re.search(r"TOTAL .* verify=\s*([\d.]+)ms", out)
    assert total, out + err[-3000:]
    rrc, rout, rerr = runs["ref_routes"]
    assert rrc == 0, rerr[-3000:]
    line = [ln for ln in rout.splitlines() if ln.startswith("RESULT ")]
    ref = sum(r["verify_ms"] for r in json.loads(
        line[-1][len("RESULT "):]).values())
    assert float(total.group(1)) <= VERIFY_SLACK * ref, (out, ref)


def _mutants(out):
    applied = re.search(r"mutants applied: (\d+)", out)
    caught = re.search(r"caught \(right code, right node\): (\d+)", out)
    assert applied and caught, out
    return int(applied.group(1)), int(caught.group(1))


def test_mutate_matches_the_reference(runs):
    rc, out, err = runs["mutate"]
    rrc, rout, rerr = runs["ref_mutate"]
    assert rc == 0 and rrc == 0, err[-3000:] + rerr[-3000:]
    got, want = _mutants(out), _mutants(rout)
    assert got == want and got[0] > 0
    assert got[1] / got[0] >= _constants("weldlint_torch.py")["RECALL_GATE"]


def test_pinned_modes_are_the_reference_auto_routes(runs):
    rc, out, err = runs["ref_routes"]
    assert rc == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    ref = json.loads(line[-1][len("RESULT "):])
    pinned = _constants("weldlint_torch.py")["PINNED"]
    assert set(pinned) == set(ref)
    for label, r in ref.items():
        assert r["mode"] == "auto", (label, r)
        assert r["routed"] or r["rejected"], (label, r)
        want = ("always" if r["routed"] and not r["rejected"]
                else "off" if not r["routed"] else None)
        assert want is not None, (label, r)   # a mixed route pins nothing
        assert pinned[label] == want, (label, r)


def test_the_card_is_the_default_device(runs):
    rc, out, err = runs["no_device"]
    assert rc != 0 and "DeviceUnavailableError" in err, err[-2000:]
