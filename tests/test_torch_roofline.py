"""The port's roofline (``repro_torch.roofline.analysis``) against the JAX
package's, on the CPU.

* The reference's cases of ``tests/test_roofline.py`` that do not parse
  HLO text, against ``HW_H100``: ``extract_cost`` normalisation, the
  three terms and the bottleneck, the collective-bound case.
* Parity: ``roofline_terms`` and ``model_flops`` of both packages on the
  same inputs, the reference handed the same hw dict (the v5e table, and
  the H100 table with its network rate as the one link); every config's
  ``active_param_count`` in both packages.
* ``collective_bytes`` (a dispatch mode over the ``c10d`` and
  ``_c10d_functional`` ops) on hand-written collectives over a "fake"
  process group of 8 gives the bytes ``test_collective_parser_kinds_and_
  bytes`` asserts for the same shapes.
* In place of ``test_cost_while_loop_motivation`` (XLA counts a loop body
  once): the counted FLOPs of the same ``tanh(h @ w)`` stack grow four
  times from 2 to 8 layers.
* The fake forms of the B12 and B13 launches (``weld::flash_attention``,
  ``weld::fused_adamw``) on fake CUDA tensors: the output's shape and
  strides, B12's FLOPs by the pairs its mask leaves, nothing launched,
  counted or clocked.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.roofline import analysis as r_analysis
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import _count, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import adamw_scalars
from repro_torch.models import build_model
from repro_torch.roofline.analysis import (
    HW_H100, KINDS, StepCounter, collective_bytes, extract_cost,
    model_flops, roofline_terms)


def test_extract_cost_normalizes():
    assert extract_cost({"flops": 10.0, "bytes accessed": 5.0}) == \
        {"flops": 10.0, "bytes": 5.0}
    # already-normalized dicts pass through (idempotent)
    assert extract_cost({"flops": 10.0, "bytes": 5.0}) == \
        {"flops": 10.0, "bytes": 5.0}
    # per-operand byte keys summed when the aggregate key is missing
    c = extract_cost({"flops": 1.0, "bytes accessed0{}": 3.0,
                      "bytes accessed1{}": 4.0})
    assert c["bytes"] == 7.0


def test_roofline_terms_and_bottleneck():
    cost = {"flops": HW_H100["peak_flops_bf16"],          # 1 s of compute
            "bytes": HW_H100["hbm_bw"] / 2}               # 0.5 s of memory
    out = roofline_terms(cost, int(HW_H100["nvlink_bw"] / 4))  # 0.25 s
    assert out["bottleneck"] == "compute"
    assert abs(out["t_compute_s"] - 1.0) < 1e-9
    assert abs(out["t_memory_s"] - 0.5) < 1e-9
    assert abs(out["t_collective_s"] - 0.25) < 1e-9
    assert out["bound_s"] == out["t_compute_s"]
    assert (out["peak_key"], out["link_key"]) == ("peak_flops_bf16",
                                                  "nvlink_bw")


def test_roofline_collective_bound():
    cost = {"flops": 1.0, "bytes": 1.0}
    out = roofline_terms(cost, int(HW_H100["nvlink_bw"]))    # 1 s of comms
    assert out["bottleneck"] == "collective"


def test_roofline_peak_follows_dtype_and_link_follows_hosts():
    cost = {"flops": HW_H100["peak_flops_f32"], "bytes": 0.0}
    out = roofline_terms(cost, int(HW_H100["net_bw"]), dtype="float32",
                         chips=256)
    assert out["peak_key"] == "peak_flops_f32"
    assert out["t_compute_s"] == 1.0
    assert out["link_key"] == "net_bw" and out["t_collective_s"] == 1.0
    assert roofline_terms(cost, 0, chips=8)["link_key"] == "nvlink_bw"


_HW_TABLES = {
    "v5e": r_analysis.HW_V5E,
    "h100": dict(HW_H100, ici_bw=HW_H100["net_bw"]),
}


@pytest.mark.parametrize("hw", sorted(_HW_TABLES))
@pytest.mark.parametrize("cost,coll", [
    ({"flops": 3.7e14, "bytes": 2.2e12}, 5_000_000_000),
    ({"flops": 1.0e9, "bytes": 9.9e12}, 0),
    ({"flops": 2.5e15, "bytes accessed": 1.0e11}, 123_456_789),
    ({"flops": 0.0, "bytes": 1.0}, 10 ** 12),
])
def test_roofline_terms_equal_the_reference(hw, cost, coll):
    table = _HW_TABLES[hw]
    want = r_analysis.roofline_terms(cost, coll, hw=table)
    got = roofline_terms(cost, coll, hw=table)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n,tokens", [(3_212_749_824, 1_048_576),
                                      (65_856, 128), (1, 1)])
def test_model_flops_equal_the_reference(kind, n, tokens):
    cfg = get_config("llama3.2-3b")
    assert model_flops(cfg, n, tokens, kind) == r_analysis.model_flops(
        r_get_config("llama3.2-3b"), n, tokens, kind)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", [a for a in list_configs()
                                  if a != "weld-bench"])
def test_active_param_count_equals_the_reference(arch, smoke):
    want = r_build_model(r_get_config(arch, smoke=smoke)).active_param_count()
    assert build_model(get_config(arch, smoke=smoke)).active_param_count() \
        == want


@pytest.fixture
def fake_group_of_8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_bytes_kinds_match_the_hlo_parser(fake_group_of_8):
    import torch.distributed._functional_collectives as fc

    four = dist.new_group([0, 1, 2, 3])
    world = dist.group.WORLD

    def step():
        # each op's result the HLO sample's; its operand is what is counted
        outs = [
            fc.all_reduce(torch.empty(128, 512), "sum", world),  # [128,512]
            fc.all_gather_tensor(torch.empty(512, 512), 0, four),  # [2048,.]
            fc.all_gather_tensor(torch.empty(16), 0, four),        # f32[64]
            fc.reduce_scatter_tensor(
                torch.empty(128, 64, dtype=torch.bfloat16), "sum", 0,
                world),                                         # bf16[16,64]
            fc.all_to_all_single(torch.empty(32, 8), None, None, world),
        ]
        dist.send(torch.empty(256), dst=1)                      # f32[256]
        for t in outs:
            fc.wait_tensor(t)

    out = collective_bytes(step)
    # the reference parser's assertions for the same shapes
    assert out["all-reduce"] == 128 * 512 * 4
    assert out["all-gather"] == (2048 * 512 * 4) // 4 + (64 * 4) // 4
    assert out["reduce-scatter"] == 16 * 64 * 2 * 8
    assert out["collective-permute"] == 256 * 4
    assert out["all-to-all"] == 32 * 8 * 4
    assert out["total"] == sum(out[k] for k in KINDS)
    ref = r_analysis.collective_bytes_from_hlo("""
  %all-reduce = f32[128,512]{1,0} all-reduce(%x), channel_id=1, replica_groups=[2,4]<=[8], use_global_device_ids=true, to_apply=%add
  %all-gather.5 = f32[2048,512]{1,0} all-gather(%y), channel_id=2, replica_groups=[2,4]<=[8], dimensions={0}, use_global_device_ids=true
  %reduce-scatter.1 = bf16[16,64]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[1,8]<=[8], dimensions={0}, to_apply=%add
  %cp = f32[256]{0} collective-permute(%w), channel_id=4, source_target_pairs={{0,1}}
  %ag2 = f32[64]{0} all-gather-start(%q), channel_id=5, replica_groups=[2,4]<=[8], dimensions={0}
  %a2a = f32[32,8]{1,0} all-to-all(%r), channel_id=6, replica_groups=[2,4]<=[8], dimensions={0}
""")
    assert out == ref


def _stack_flops(n_layers: int) -> int:
    x = torch.zeros(8, 16)
    w = torch.zeros(n_layers, 16, 16)
    with StepCounter() as c:
        h = x
        for i in range(n_layers):
            h = torch.tanh(h @ w[i])
        h.sum()
    return c.flops


def test_counted_flops_follow_the_depth():
    """The eager trace runs every layer, so its count is the whole
    depth's (the reference's XLA count of a scan is not: it counts the
    body once, ``test_cost_while_loop_motivation``)."""
    assert _stack_flops(2) == 2 * (2 * 8 * 16 * 16)
    assert _stack_flops(8) == 4 * _stack_flops(2)


@pytest.mark.parametrize("causal,sq,skv", [(True, 64, 64), (True, 16, 48),
                                           (False, 40, 24)])
def test_fake_attention_launch_counts_the_pairs_the_mask_leaves(causal, sq,
                                                                skv):
    before = ops.counts()
    with FakeTensorMode():
        q = torch.empty(2, 8, sq, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 2, skv, 64, dtype=torch.bfloat16, device="cuda")
        with _count.device_clock() as marks, StepCounter() as c:
            out = ops.attention(q, k, k, causal=causal, group=4)
        want = fa._output(q)
        assert (out.shape, out.stride(), out.dtype, out.device) == (
            want.shape, want.stride(), want.dtype, want.device)
    pairs = (sum(min(skv, i + skv - sq + 1) for i in range(sq)) if causal
             else sq * skv)
    assert fa.attention_pairs(sq, skv, causal) == pairs
    assert c.flops == 4 * 2 * 8 * 64 * pairs
    assert c.flops_by_dtype == {"bfloat16": c.flops}
    assert marks == [] and ops.counts() == before


def test_fake_adamw_launch_mutates_nothing_and_counts_nothing():
    before = ops.counts()
    with FakeTensorMode():
        p = torch.empty(1000, dtype=torch.bfloat16, device="cuda")
        g = torch.empty(1000, dtype=torch.float32, device="cuda")
        m = torch.empty(1000, dtype=torch.float32, device="cuda")
        v = torch.empty(1000, dtype=torch.float32, device="cuda")
        with StepCounter() as c:
            got = ops.adamw_update(p, g, m, v, 3e-4, torch.tensor(1))
        with StepCounter() as host:   # the step's f32 scalars, on the CPU
            adamw_scalars(3e-4, torch.tensor(1), 0.9, 0.999)
    assert got[0] is p and got[1] is m and got[2] is v
    # p, g, m, v read; p, m, v written (the op mutates them)
    assert c.bytes == host.bytes + 2 * 1000 * 2 + 5 * 1000 * 4
    assert c.flops == 0 and ops.counts() == before
