"""The port's ``train`` on a data × model mesh of gloo ranks, against its
own single-device ``train`` on the CPU (which ``test_torch_train.py``
holds to the JAX package; the reference's own sharded runs fail here,
ROADMAP C2).

Each launch (``torch_dist.launch``: one child process a rank, one
thread each, a ``file://`` store, 300 s) runs several cases:

* 8 ranks: dense llama3.2-3b (smoke) 3 steps on (4, 2) — heads sharded —
  and on (2, 4), where its 2 kv heads do not divide "model" and the
  rules shard ``head_dim`` instead; deepseek-moe-16b (smoke) on (2, 4),
  its 8 experts on "model"; and the first half of the elastic restart,
  4 steps on (4, 2) with a checkpoint at step 4.
* 4 ranks on (2, 2): accum 2; remat through ``build_train_step``;
  zamba2-1.2b and xlstm-350m (smoke).
* 2 ranks: (2, 1) and (1, 2), and the elastic restart resumed from the
  (4, 2) checkpoint on (2, 1) to step 8.

Losses and gnorms equal the single-device run's to rtol 2e-4 and atol
2e-5 (the reference test's tolerance for (4, 2) against (1, 1)), final
parameters (``full_tensor``) to atol 1e-5; the resumed run's last 4
losses equal an uninterrupted 8-step run's to rtol 5e-4, atol 5e-5 (the
reference's elastic test).  Every rank's local shapes of parameters and
moments are what ``spec_for_leaf`` and ZeRO-1 give (the state is really
sharded), fused AdamW runs once per parameter tensor a step on each
rank, and no DTensor reaches the attention or AdamW plain versions the
CPU wrappers call.  Without a process group, ``dp * tp > 1`` raises,
naming torchrun.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed import sharding
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.optim import adamw_init

import torch_dist

RTOL, ATOL = 2e-4, 2e-5
LLAMA = "llama3.2-3b"


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_default_device("cpu")


def _single(arch=LLAMA, steps=3, accum=1):
    return t_train.train(arch, steps=steps, global_batch=4, seq_len=16,
                         accum=accum, verbose=False)


def _single_steps(arch, remat, steps=3):
    """``build_train_step`` on one device with the config's remat set."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    with torch.no_grad():
        params = model.init(gen)
    opt = adamw_init(params)
    step = t_train.build_train_step(model, peak_lr=1e-3, total_steps=steps)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4,
                         seed=0)
    losses, gnorms = [], []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    return {"losses": losses, "gnorms": gnorms}


def _same_run(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"], rtol=RTOL,
                               atol=ATOL)


def _expected_local(shape, spec, sizes):
    out = []
    for dim, part in zip(shape, spec):
        flat = () if part is None else (part if isinstance(part, tuple)
                                        else (part,))
        n = 1
        for a in flat:
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def _check_sharded(res, arch, dp, tp):
    """Every rank's local shapes follow the rules (params) and ZeRO-1
    (moments); fused AdamW ran once per parameter tensor a step."""
    model = build_model(get_config(arch, smoke=True))
    sizes = {"data": dp, "model": tp}
    shapes = {n: tuple(p.shape) for n, p in model.impl.named_parameters()}
    pspecs = sharding.tree_shardings(model.param_specs(), shapes, sizes)
    mspecs = sharding.zero1_moment_shardings(model.param_specs(), shapes,
                                             sizes)
    for r in res:
        assert r["n_params"] == len(shapes)
        assert r["adamw_per_step"] == len(shapes)
        for k, shp in shapes.items():
            assert r["local"][k] == _expected_local(shp, pspecs[k], sizes), k
            want_m = _expected_local(shp, mspecs[k], sizes)
            assert r["local_m"][k] == want_m == r["local_v"][k], k
    return pspecs, mspecs


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic") / "ck")


@pytest.fixture(scope="module")
def eight(tmp_path_factory, ckpt_dir):
    return torch_dist.launch("several", 8, tmp_path_factory.mktemp("eight"),
                             cases=[
        ("d42", "train_mesh", {"dp": 4, "tp": 2}),
        ("d24", "train_mesh", {"dp": 2, "tp": 4}),
        ("moe24", "train_mesh", {"arch": "deepseek-moe-16b", "dp": 2,
                                 "tp": 4}),
        ("elastic", "train_mesh", {"dp": 4, "tp": 2, "steps": 4,
                                   "ckpt_dir": ckpt_dir, "ckpt_every": 4,
                                   "full": False}),
    ])


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return torch_dist.launch("several", 4, tmp_path_factory.mktemp("four"),
                             cases=[
        ("accum", "train_mesh", {"dp": 2, "tp": 2, "accum": 2}),
        ("remat", "step_mesh", {"dp": 2, "tp": 2, "remat": True}),
        ("zamba2", "train_mesh", {"arch": "zamba2-1.2b", "dp": 2, "tp": 2}),
        ("xlstm", "train_mesh", {"arch": "xlstm-350m", "dp": 2, "tp": 2}),
    ])


@pytest.fixture(scope="module")
def two(tmp_path_factory, eight, ckpt_dir):
    # after ``eight``: the resume reads its checkpoint
    return torch_dist.launch("several", 2, tmp_path_factory.mktemp("two"),
                             cases=[
        ("d21", "train_mesh", {"dp": 2, "tp": 1}),
        ("d12", "train_mesh", {"dp": 1, "tp": 2}),
        ("resumed", "train_mesh", {"dp": 2, "tp": 1, "steps": 8,
                                   "ckpt_dir": ckpt_dir, "resume": True,
                                   "ckpt_every": 100, "full": False}),
    ])


@pytest.fixture(scope="module")
def llama():
    repro_torch.set_default_device("cpu")
    return _single()


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["d42", "d24"])
def test_dense_on_eight_ranks_matches_one_device(eight, llama, mesh):
    res = [r[mesh] for r in eight]
    _same_run(res[0], llama)
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
    for k, want in llama["params"].items():
        np.testing.assert_allclose(res[0]["params"][k], want.numpy(),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mesh,dp,tp", [("d42", 4, 2), ("d24", 2, 4)])
def test_dense_state_is_sharded_by_the_rules(eight, mesh, dp, tp):
    res = [r[mesh] for r in eight]
    pspecs, mspecs = _check_sharded(res, LLAMA, dp, tp)
    wk = "dense_layers.0.attn.wk"
    if tp == 2:      # 2 kv heads on 2: heads sharded
        assert pspecs[wk] == (None, "model", None)
    else:            # 2 kv heads on 4: the head_dim fallback
        assert pspecs[wk] == (None, None, "model")
    # ZeRO-1: the first free dimension of each moment over "data"
    assert mspecs[wk][0] == "data"
    assert res[0]["placements_m"][wk][0] == "S0"


@pytest.mark.parametrize("mesh,dp,tp", [("d21", 2, 1), ("d12", 1, 2)])
def test_dense_on_two_ranks_matches_one_device(two, llama, mesh, dp, tp):
    res = [r[mesh] for r in two]
    _same_run(res[0], llama)
    _check_sharded(res, LLAMA, dp, tp)
    for k, want in llama["params"].items():
        np.testing.assert_allclose(res[0]["params"][k], want.numpy(),
                                   atol=1e-5, err_msg=k)


def test_accumulation_on_a_mesh_matches_one_device(four):
    want = _single(accum=2)
    res = [r["accum"] for r in four]
    _same_run(res[0], want)
    _check_sharded(res, LLAMA, 2, 2)
    for k, w in want["params"].items():
        np.testing.assert_allclose(res[0]["params"][k], w.numpy(),
                                   atol=1e-5, err_msg=k)


def test_remat_step_on_a_mesh_matches_one_device(four):
    _same_run(four[0]["remat"], _single_steps(LLAMA, remat=True))


# ---------------------------------------------------------------------------
# the other families
# ---------------------------------------------------------------------------


def test_moe_expert_parallel_matches_one_device(eight):
    arch = "deepseek-moe-16b"
    res = [r["moe24"] for r in eight]
    _same_run(res[0], _single(arch))
    pspecs, _ = _check_sharded(res, arch, 2, 4)
    # 8 experts on 4 ranks: 2 each
    assert pspecs["moe_layers.0.mlp.experts.wi"][0] == "model"
    assert res[0]["local"]["moe_layers.0.mlp.experts.wi"][0] == 2


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_families_on_a_mesh_match_one_device(four, arch):
    key = arch.split("-")[0]
    res = [r[key] for r in four]
    _same_run(res[0], _single(arch))
    _check_sharded(res, arch, 2, 2)


# ---------------------------------------------------------------------------
# elastic restart
# ---------------------------------------------------------------------------


def test_elastic_restart_across_meshes(two):
    resumed = two[0]["resumed"]
    assert len(resumed["losses"]) == 4      # steps 4..7
    ref = _single(steps=8)
    np.testing.assert_allclose(resumed["losses"], ref["losses"][-4:],
                               rtol=5e-4, atol=5e-5)


def test_elastic_first_half_matches_one_device(eight):
    ref = _single(steps=4)
    _same_run(eight[0]["elastic"], ref)


# ---------------------------------------------------------------------------
# without a process group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (4, 2)])
def test_a_mesh_without_a_process_group_raises(dp, tp):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        t_train.train(LLAMA, steps=1, dp=dp, tp=tp, verbose=False)
