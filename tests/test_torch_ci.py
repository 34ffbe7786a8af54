"""``tools/ci_torch.sh``, the port's CI script, read beside ``tools/ci.sh``
(static: nothing is run but ``bash -n``).

* Each stage of ``ci.sh`` (an ``echo "== ... =="`` line) has a stage of
  the same title in ``ci_torch.sh``, in the same order, but for the two
  bench stages, which stand there as comments naming ROADMAP A6;
* each ``python tools/<tool>.py <args>`` of ``ci.sh`` is run as
  ``python tools/<tool>_torch.py <args>`` (``WELD_TRACE=1`` where ``ci.sh``
  sets it), with the script's ``--device`` passed to every tool whose
  parser takes one;
* every script it names exists, and its pytest stage runs the port's
  test files under ``WELD_VERIFY=1``;
* no line it runs names ``benchmarks``;
* ``bash -n`` accepts it.
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
CI = ROOT / "tools" / "ci.sh"
CI_TORCH = ROOT / "tools" / "ci_torch.sh"
BENCHES = ("kernelplan smoke ablation", "join smoke ablation")
STAGE = re.compile(r'^echo "== (.+?) (\(.*\) )?=="$')
DEFERRED = re.compile(r"^# == (.+?) ==$")


def _lines(path):
    return path.read_text().splitlines()


def _run_lines(path):
    """The lines that run something: no comment, no blank."""
    return [ln.strip() for ln in _lines(path)
            if ln.strip() and not ln.strip().startswith("#")]


def _stages(path):
    out = []
    for ln in _lines(path):
        m = STAGE.match(ln.strip())
        if m:
            out.append(("run", m.group(1)))
        m = DEFERRED.match(ln.strip())
        if m:
            out.append(("deferred", m.group(1)))
    return out


def test_every_stage_of_ci_sh_has_its_counterpart_in_order():
    ref = [title for _, title in _stages(CI)]
    port = _stages(CI_TORCH)
    assert [title for _, title in port] == ref
    for kind, title in port:
        assert kind == ("deferred" if title in BENCHES else "run"), title
    text = CI_TORCH.read_text()
    for title in BENCHES:
        block = text[text.index(f"# == {title} =="):]
        block = block[:block.index("\n\n")]
        assert "ROADMAP A6" in block, block


def _tool_calls(path):
    """(env prefix, tool script, arguments) of each ``python tools/...``
    line."""
    out = []
    for ln in _run_lines(path):
        m = re.match(r"^((?:\w+=\S+ )*)python (tools/\S+\.py)(.*)$", ln)
        if m:
            out.append((m.group(1).strip(), m.group(2),
                        m.group(3).split()))
    return out


def _takes_device(script):
    return '"--device"' in (ROOT / script).read_text()


def test_each_tool_of_ci_sh_runs_as_its_torch_counterpart():
    ref = _tool_calls(CI)
    port = _tool_calls(CI_TORCH)
    assert len(port) == len(ref)
    for (renv, rtool, rargs), (tenv, ttool, targs) in zip(ref, port):
        assert ttool == rtool[:-len(".py")] + "_torch.py"
        assert tenv == renv
        device = '${DEVICE[@]+"${DEVICE[@]}"}'
        assert targs == rargs + ([device] if _takes_device(ttool) else [])
        assert _takes_device(ttool)


def test_every_script_it_names_exists_and_the_tests_run_verified():
    for _, tool, _ in _tool_calls(CI_TORCH):
        assert (ROOT / tool).is_file(), tool
    run = "\n".join(_run_lines(CI_TORCH))
    assert "export WELD_VERIFY=1" in run
    assert re.search(r"python -m pytest .*tests/test_torch_\*\.py", run)
    assert list((ROOT / "tests").glob("test_torch_*.py"))
    assert "python -m compileall -q src/repro_torch tests tools" in run


def test_it_never_imports_or_runs_the_benchmarks():
    for ln in _run_lines(CI_TORCH):
        assert "benchmarks" not in ln, ln


def test_bash_parses_it():
    out = subprocess.run(["bash", "-n", str(CI_TORCH)], capture_output=True,
                         text=True, timeout=30)
    assert out.returncode == 0, out.stderr
