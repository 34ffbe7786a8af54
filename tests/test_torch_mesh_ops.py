"""The mesh path as torch 2.11 runs it, on this machine's torch.

DTensor on torch 2.11 (the card's) cannot do three things that 2.13
(this machine's) does: flatten dimensions of which an inner one is
sharded (a weight sharded on ``head_dim`` merged behind its heads; the
(batch, kv head) of decode attention's einsums), pad on a mesh of more
than one dimension, and flip.  ``distributed/mesh_ops`` runs decode
attention under ``local_map`` (``batched``), pads by concatenation
(``pad``) and takes the cumulative sum's gradient on local tensors
(``cumsum``) on either torch; only ``mergeable``'s all-gather waits on
a probe of DTensor's rule (``flattens_inner_shards``), true here and
false on the card (``tests/test_torch_cuda.py``).  Its 2.11 path runs
here with the probe set false (``torch_dist_cases._torch_211_path``):

* the probe is true on this torch;
* with the probe false, the dry run traces the decode and prefill cells
  that torch 2.11 refused on a (2, 4) mesh (each smoke config, batch 4,
  sequence 32); the train cells it refused run for real below;
* on a (1, 2) mesh of 2 gloo ranks (heads sharded over "model", a mesh
  of two dimensions), a training step of zamba2 and of xLSTM (padding,
  the cumulative sum's gradient) and decoding deepseek-moe, zamba2 and
  Whisper (attention over a head-sharded cache) give the losses,
  gradient norms and logits of one device, with the probe as it is and
  with it false.  ``tests/test_torch_cuda.py`` runs the same cases on
  the card's torch.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_dist
from repro_torch.distributed import mesh_ops

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
#: the cells torch 2.11 refused on the card's (2, 4) mesh before these
#: workarounds (the error each raised)
REFUSED_ON_211 = {
    "deepseek-moe-16b|decode_32k": "einsum flattens (batch, head)",
    "whisper-large-v3|decode_32k": "einsum flattens (batch, head)",
    "zamba2-1.2b|decode_32k": "einsum flattens (batch, head)",
    "zamba2-1.2b|train_4k": "IndexError planning F.pad's redistribution",
    "zamba2-1.2b|prefill_32k": "IndexError planning F.pad's redistribution",
    "xlstm-350m|train_4k": "aten.flip has no sharding strategy",
}
#: what the dry run traces on the 2.11 path (the train cells run below)
TRACED = sorted(k for k in REFUSED_ON_211 if not k.endswith("train_4k"))
#: the mesh and one device sum in other orders: the tolerance of
#: ``test_torch_distributed_train.py`` (the reference's for (4, 2)
#: against (1, 1))
RTOL, ATOL = 2e-4, 2e-5
#: the gloo cases: (name, case, kwargs) on a (1, 2) mesh
MESH = {"dp": 1, "tp": 2}
CASES = [(f"train_{a}", "step_mesh",
          {"arch": a, "steps": 1, "remat": False, **MESH})
         for a in ("zamba2-1.2b", "xlstm-350m")] + [
        (f"decode_{a}", "decode_mesh", {"arch": a, "steps": 2, **MESH})
        for a in ("deepseek-moe-16b", "zamba2-1.2b", "whisper-large-v3")]

DRY = """
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
import repro_torch
repro_torch.set_default_device("cpu")
import torch_dist_cases
torch_dist_cases._torch_211_path()
from repro_torch.launch.dryrun import dryrun_cell
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out = {}
for key in json.loads(sys.argv[1]):
    arch, shape = key.split("|")
    r = dryrun_cell(arch, shape, mesh, smoke=True, batch_override=4,
                    seq_override=32, device="cpu")
    out[key] = {"ok": r["ok"], "error": r.get("error")}
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def test_flattens_inner_shards_is_true_on_this_torch():
    import torch

    assert tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 13)
    mesh_ops.flattens_inner_shards.cache_clear()
    assert mesh_ops.flattens_inner_shards() is True


def launch_cases(tmp_path, torch_211=True):
    """:data:`CASES` on 2 gloo ranks, each on the mesh and on one device
    (``torch_dist_cases.on_mesh_and_one_device``)."""
    cases = [(name, "on_mesh_and_one_device",
              {"case": case, "torch_211": torch_211, **kw})
             for name, case, kw in CASES]
    return torch_dist.launch("several", 2, tmp_path, cases=cases)


def check_against_one_device(ranks, name, path):
    for rank in ranks:
        got, want = rank[name][path], rank[name]["one"]
        if name.startswith("train"):
            for k in ("losses", "gnorms"):
                assert np.isfinite(want[k]).all()
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=ATOL)
        else:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert np.isfinite(w).all()
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dry run's child process and the 2 gloo ranks, side by side."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([SRC, HERE, env.get("PYTHONPATH",
                                                             "")])
    dry = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(DRY),
         json.dumps(TRACED)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = launch_cases(tmp_path_factory.mktemp("two"))
        out, err = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    assert dry.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):]), ranks


@pytest.mark.parametrize("cell", TRACED)
def test_the_torch_211_path_traces_what_211_refused(runs, cell):
    dry, _ = runs
    assert dry[cell]["ok"], dry[cell]["error"]


@pytest.mark.parametrize("path", ["native", "torch_211"])
@pytest.mark.parametrize("name", [name for name, _, _ in CASES])
def test_the_mesh_path_computes_what_one_device_does(runs, name, path):
    check_against_one_device(runs[1], name, path)
