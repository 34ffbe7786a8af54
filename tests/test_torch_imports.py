"""The port stands alone: importing every module of ``repro_torch``
loads neither ``jax`` nor the JAX package, every module of the JAX
package has a counterpart, and an entry point with no device chosen
refuses to run on a machine without CUDA.  Both checks
run in a fresh interpreter, since other tests in this process import
jax."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_no_reference():
    code = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 116, names
for want in ("repro_torch.kernels.flash_attention", "repro_torch.configs.base",
             "repro_torch.models.transformer", "repro_torch.models.convert",
             "repro_torch.launch.serve", "repro_torch.kernels.fused_adamw",
             "repro_torch.optim.adamw", "repro_torch.optim.schedule",
             "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
             "repro_torch.distributed.straggler", "repro_torch.launch.train",
             "repro_torch.core.faults", "repro_torch.core.obs",
             "repro_torch.core.obs.tracer", "repro_torch.core.obs.ledger",
             "repro_torch.core.analysis", "repro_torch.core.analysis.domain",
             "repro_torch.core.analysis.bounds", "repro_torch.core.check",
             "repro_torch.core.check.diagnostics",
             "repro_torch.core.check.verify_types",
             "repro_torch.core.check.capacity",
             "repro_torch.core.check.linear", "repro_torch.core.check.races",
             "repro_torch.core.check.bounds_lint",
             "repro_torch.core.recovery", "repro_torch.errors",
             "repro_torch.faults", "repro_torch.obs",
             "repro_torch.core.interp", "repro_torch.frames.pyudf",
             "repro_torch.core.check.mutate",
             "repro_torch.core.kernelplan.quarantine",
             "repro_torch.core.kernelplan.autotune",
             "repro_torch.core.kernelplan.calibrate",
             "repro_torch.core.serve", "repro_torch.kernels._count",
             "repro_torch.models.moe", "repro_torch.models.ssm",
             "repro_torch.models.xlstm", "repro_torch.models.encdec",
             "repro_torch.models.vlm", "repro_torch.configs.dbrx_132b",
             "repro_torch.configs.whisper_large_v3",
             "repro_torch.distributed.sharding",
             "repro_torch.distributed.elastic",
             "repro_torch.distributed.mesh_ops", "repro_torch.launch.mesh",
             "repro_torch.optim.compress", "repro_torch.launch.dryrun",
             "repro_torch.roofline", "repro_torch.roofline.analysis",
             "repro_torch.roofline.report"):
    assert want in names, want
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print("LEAKED", bad)
assert not bad, bad
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: reference modules whose port carries another name
RENAMED = {"core/backend/jaxgen.py": "core/backend/torchgen.py"}


def test_every_reference_module_has_a_port():
    ref = SRC / "repro"
    missing = sorted(
        str(rel) for rel in (p.relative_to(ref) for p in ref.rglob("*.py"))
        if not (SRC / "repro_torch" / RENAMED.get(str(rel), str(rel))).exists())
    assert not missing, missing


def test_entry_point_without_a_device_refuses_the_cpu():
    code = r"""
import numpy as np, torch
assert not torch.cuda.is_available()
from repro_torch import DeviceUnavailableError
from repro_torch.frames import weldnp
try:
    weldnp.array(np.arange(5.0)).sum().evaluate()
except DeviceUnavailableError as e:
    print("REFUSED", e)
else:
    raise SystemExit("evaluated on the CPU without being asked to")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REFUSED" in proc.stdout
