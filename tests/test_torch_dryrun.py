"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

Two child processes run side by side (module fixture ``runs``): the port's
``dryrun_cell`` on a "fake" process group of 8 ranks as a (2, 4) mesh over
("data", "model"), fake tensors on the CPU, and the reference's on its own
(2, 4) mesh of 8 XLA host devices (``XLA_FLAGS`` set before jax starts, as
``tests/test_distributed.py``'s ``run_sub``).  Both trace (or lower and
compile) every arch's smoke config at batch 4 and sequence 32 for
train_4k, decode_32k and long_500k.

* Every port cell is ``ok`` (the counterpart of
  ``test_distributed.py::test_dryrun_small_mesh_all_archs_smoke``).
* ``n_params``, ``param_bytes_per_dev``, ``cache_bytes_per_dev``,
  ``model_flops_global`` and the long_500k skip reasons equal the
  reference's exactly; ``opt_bytes_per_dev`` too wherever the ZeRO-1
  dimension divides (:data:`ZERO1_APART` names the cells where it does
  not, and why).
* The dense smoke config's step on a (1, 1) mesh counts exactly the
  FLOPs written out in :func:`dense_train_flops`.
* ``Model.input_specs`` and ``input_axes`` equal the reference's shapes,
  dtypes and logical axes for every arch and kind.
* ``roofline.report.summarize`` of the port's results equals the
  reference's, table for table (the roofline table's header names the
  H100's peaks in place of the v5e's).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.roofline import report as r_report
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.models import build_model
from repro_torch.roofline import report

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCHS = [a for a in list_configs() if a != "weld-bench"]
CELLS = ("train_4k", "decode_32k", "long_500k")
TIMEOUT = 900

#: the record fields held equal to the reference's
SAME = ("ok", "skipped", "n_params", "param_bytes_per_dev",
        "cache_bytes_per_dev", "model_flops_global")

#: cells whose ZeRO-1 moment bytes part from the reference's, by how many
#: bytes and why: the port shards each layer's own leaf (ROADMAP A9), the
#: reference its layer stack, whose first free dimension is often the stack
ZERO1_APART = {
    "llama-3.2-vision-90b|train_4k": (
        8, "the cross-attention gates: the reference's stacked (2, 1) leaf "
           "shards its stack of 2 super-blocks over data = 2; the port's "
           "per-layer (1,) leaves have no dimension that data divides, so "
           "rank 0 holds both gates' m and v (4 more bytes each)"),
}

PORT = """
import json, sys, time
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
import repro_torch
repro_torch.set_default_device("cpu")
from repro_torch.launch.dryrun import dryrun_cell
archs, cells = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
for arch in archs:
    for shape in cells:
        r = dryrun_cell(arch, shape, mesh, smoke=True, batch_override=4,
                        seq_override=32, device="cpu")
        r.pop("traceback", None)
        out[arch + "|" + shape] = r
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
out["dense_1x1"] = dryrun_cell("llama3.2-3b", "train_4k", mesh, smoke=True,
                               batch_override=4, seq_override=32,
                               device="cpu")
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""

REF = """
import json, sys
import jax
from repro.launch.dryrun import dryrun_cell
archs, cells, keep = (json.loads(a) for a in sys.argv[1:4])
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for arch in archs:
    for shape in cells:
        r = dryrun_cell(arch, shape, mesh, smoke=True, batch_override=4,
                        seq_override=32)
        out[arch + "|" + shape] = {k: r.get(k) for k in keep + ["error"]}
print("RESULT " + json.dumps(out))
"""


def _start(code: str, args, env_extra: dict):
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"stderr:\n{err[-4000:]}"
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, out[-4000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    args = [json.dumps(ARCHS), json.dumps(list(CELLS))]
    port = _start(PORT, args, {"OMP_NUM_THREADS": "1"})
    ref = _start(REF, args + [json.dumps(list(SAME) + [
        "opt_bytes_per_dev"])], {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})
    return _result(port), _result(ref)


def test_every_arch_traces_on_a_small_mesh(runs):
    port, _ = runs
    bad = {k: r.get("error") for k, r in port.items() if not r["ok"]}
    assert not bad, bad
    assert all("cost" in port[f"{a}|train_4k"] for a in ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_records_equal_the_reference(runs, arch):
    port, ref = runs
    for shape in CELLS:
        key = f"{arch}|{shape}"
        assert ref[key]["ok"], ref[key]
        got = {k: port[key].get(k) for k in SAME}
        assert got == {k: ref[key].get(k) for k in SAME}, key
    key = f"{arch}|train_4k"
    apart = ZERO1_APART.get(key, (0, ""))[0]
    assert port[key]["opt_bytes_per_dev"] \
        == ref[key]["opt_bytes_per_dev"] + apart, ZERO1_APART.get(key)


def dense_train_flops(cfg, b: int, s: int) -> int:
    """FLOPs of one training step of a dense config with remat off on one
    device, as the port runs it on the CPU: every product of the forward
    (the q, k, v and output projections, the SwiGLU MLP, the plain
    attention's two products over its one kv chunk of all s positions,
    the tied f32 logits), each once more for each of its two operands'
    gradients."""
    assert cfg.family == "dense" and cfg.mlp_variant == "swiglu" \
        and not cfg.remat and cfg.attn_chunk >= s
    n = b * s
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * n * d * (h + 2 * hk) * hd      # q, k, v
             + 2 * n * h * hd * d               # output projection
             + 2 * 2 * b * h * s * s * hd       # q k^T and p v
             + 3 * 2 * n * d * cfg.d_ff)        # wi, wg, wo
    logits = 2 * n * d * cfg.vocab
    return 3 * (cfg.n_layers * layer + logits)


def test_dense_smoke_step_counts_the_written_flops(runs):
    port, _ = runs
    rec = port["dense_1x1"]
    assert rec["ok"], rec.get("error")
    cfg = get_config("llama3.2-3b", smoke=True)
    assert rec["cost"]["flops"] == dense_train_flops(cfg, 4, 32)


def _specs(tree, prefix=""):
    """{path: (shape, dtype name)} of a (nested) dict of jax
    ShapeDtypeStructs or torch tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("kind,shape", [("train", "train_4k"),
                                        ("prefill", "prefill_32k"),
                                        ("decode", "decode_32k")])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_axes_equal_the_reference(arch, kind, shape):
    ref = r_build_model(r_get_config(arch))
    port = build_model(get_config(arch))
    got = port.input_specs(SHAPES[shape], kind)
    assert all(t.device.type == "meta" for t in _leaves(got))
    assert _specs(got) == _specs(ref.input_specs(R_SHAPES[shape], kind))
    assert port.input_axes(kind) == ref.input_axes(kind)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_report_equals_the_reference_table_for_table(runs):
    port, _ = runs
    results = {}
    for key, rec in port.items():
        if key == "dense_1x1":
            continue
        results[key + "|16x16"] = dict(rec, mesh_name="16x16")
    got = report.summarize(results).splitlines()
    want = r_report.summarize(results).splitlines()
    head = [i for i, ln in enumerate(want) if ln.startswith("## Roofline")]
    assert len(head) == 1 and len(got) == len(want)
    assert got[head[0]].startswith("## Roofline, predicted")
    assert "989 TFLOP/s bf16" in got[head[0]]
    del got[head[0]], want[head[0]]
    assert got == want
    assert sum(ln.count("**") for ln in got) > 0   # the roofline rows


@pytest.mark.parametrize("name", ["_propagate_tensor_meta_non_cached",
                                  "local_shard_size_and_offset"])
def test_trace_refuses_a_torch_without_a_patched_internal(monkeypatch,
                                                          name):
    from torch.distributed.tensor import _sharding_prop, placement_types

    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import StepCounter

    owners = (_sharding_prop.ShardingPropagator,
              placement_types._StridedShard)
    before = {o: dict(o.__dict__) for o in owners}
    owner = next(o for o in owners if name in o.__dict__)
    monkeypatch.delattr(owner, name)
    with pytest.raises(RuntimeError, match=name):
        with dryrun._dtensor_under_fake(StepCounter()):
            pass
    # nothing was left patched
    for o in owners:
        for k, f in before[o].items():
            if k != name:
                assert o.__dict__[k] is f, (o, k)
