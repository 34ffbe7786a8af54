"""The port's kernel planner, autotuner and staging against the JAX
package's, on the CPU.

The cases of ``test_kernelplan.py`` run against ``repro_torch``
(``torch_refcases``), except these, each with its port counterpart
below or in the file named:

* ``test_interpret_matches_ref``, ``test_multi_agg_fused_matches_per_
  aggregate_kernel`` — the reference's ``impl="interpret"`` (its Pallas
  bodies on the CPU) has no counterpart in the port, whose kernels run
  only on a card: here the port's plain versions are held to the
  reference's interpret mode on the same inputs (the kernels themselves
  against the plain versions: ``tests/test_torch_cuda.py``);
* ``test_multi_agg_forced_per_aggregate_path_parity`` — its harness
  stages the bodies with the JAX emitter and ``jnp`` arrays: here the
  same case through the port's emitter and tensors;
* ``test_autotune_times_grid_then_hits_cache``, ``test_autotune_
  invalidate_and_fingerprint`` — they tune through ``impl="interpret"``
  and the reference's ``block`` space: here through ``impl="cuda"`` with
  a no-op ``make_bench`` (the CPU has no kernel to time) and the port's
  grid cap ``max_blocks``;
* ``test_tuned_plan_prints_block_shape`` — ``block=`` becomes the port's
  ``max_blocks=``;
* ``test_cost_gate_rejects_tiny_input``, ``test_cost_gate_rejects_large_
  key_vecmerger`` — the gates' documented difference (ROADMAP C, F2):
  ``tests/test_torch_cost.py`` holds both packages to their own
  decisions on these inputs.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import kernelplan as r_kp
from repro.core.lazy import Evaluate as r_Evaluate
from repro.frames import weldnp as r_weldnp
from repro.kernels import ops as r_kops
from repro_torch.core import ir as t_ir, wtypes as t_wt
from repro_torch.core import kernelplan as t_kp
from repro_torch.core.kernelplan import autotune as t_autotune
from repro_torch.core.kernelplan import registry as t_registry
from repro_torch.core.lazy import Evaluate as t_Evaluate
from repro_torch.core.lazy import NewWeldObject as t_New
from repro_torch.frames import weldnp as t_weldnp
from repro_torch.kernels import ops as t_kops
from torch_refcases import port_cases

port_cases("test_kernelplan", globals(), leave_out=(
    "test_interpret_matches_ref",
    "test_multi_agg_fused_matches_per_aggregate_kernel",
    "test_multi_agg_forced_per_aggregate_path_parity",
    "test_autotune_times_grid_then_hits_cache",
    "test_autotune_invalidate_and_fingerprint",
    "test_tuned_plan_prints_block_shape",
    "test_cost_gate_rejects_tiny_input",
    "test_cost_gate_rejects_large_key_vecmerger",
))

_rng = np.random.RandomState(11)


@pytest.fixture
def port_tuner(tmp_path, monkeypatch):
    """A private cache, and a filter-reduce spec whose bench is a no-op,
    tuned through ``impl="cuda"`` (timed on the host clock here)."""
    monkeypatch.setenv(t_autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    t_autotune.clear_cache(disk=False)
    spec = dataclasses.replace(t_registry.get("filter_reduce_sum"),
                               make_bench=lambda m, p, i: (lambda: None))
    monkeypatch.setitem(t_registry._REGISTRY, "filter_reduce_sum", spec)
    yield t_autotune, spec
    t_autotune.clear_cache(disk=False)


def test_autotune_times_grid_then_hits_cache_port(port_tuner, monkeypatch):
    tuner, spec = port_tuner
    timed = []
    real = tuner._time_candidate
    monkeypatch.setattr(tuner, "_time_candidate",
                        lambda go: timed.append(1) or real(go))
    params, cached = tuner.tune(spec, {"n": 2000, "dtype": np.float64},
                                impl="cuda")
    assert not cached
    assert params["max_blocks"] in spec.tune_space["max_blocks"]
    assert len(timed) == len(spec.tune_space["max_blocks"])
    disk = json.load(open(tuner.cache_path()))
    assert any(k.startswith("filter_reduce_sum|float64|") for k in disk)
    (ent,) = disk.values()
    assert ent["default_us"] is not None and ent["us"] <= ent["default_us"]
    # same size-bucket: cache hit, no re-timing
    timed.clear()
    params2, cached2 = tuner.tune(spec, {"n": 1800, "dtype": np.float64},
                                  impl="cuda")
    assert cached2 and params2 == params and not timed


def test_autotune_invalidate_and_fingerprint_port(port_tuner):
    tuner, spec = port_tuner
    f0 = tuner.fingerprint()
    tuner.tune(spec, {"n": 1500, "dtype": np.float64}, impl="cuda")
    f1 = tuner.fingerprint()
    assert f1 != f0  # a new tuning must change the compile-cache key
    assert tuner.invalidate("filter_reduce_sum") == 1
    assert tuner.lookup("filter_reduce_sum", np.float64, 1500,
                        "cuda") is None
    assert tuner.fingerprint() != f1


def test_tuned_plan_prints_grid_cap():
    """pretty() surfaces the chosen grid cap on KernelCall nodes."""
    from repro_torch.core.lazy import build_program
    from repro_torch.core.passes import optimize
    from repro_torch.core.pretty import pretty

    obj, _ = _q6_like_obj(1024)
    prog = build_program(obj)
    shapes = {k: tuple(np.asarray(v[2]).shape)
              for k, v in prog.inputs.items()}
    opt = optimize(prog.expr, stats={}, input_shapes=shapes)
    planned = t_kp.plan_kernels(opt, input_shapes=shapes, stats={})
    tuned = t_autotune.tune_plan(planned, impl="ref")
    assert "kernel[filter_reduce_sum]@{max_blocks=1024}" in pretty(tuned)


def _q6_pair(n):
    """The q6-like program of ``test_kernelplan.py`` in both packages on
    the same numpy columns."""
    from repro.core import ir as r_ir, macros as r_M, wtypes as r_wt
    from repro.core.lazy import NewWeldObject as r_New
    from repro_torch.core import macros as t_M

    price, disc = _rng.rand(n), _rng.rand(n)
    out = []
    for ir_, M, wt, New in ((r_ir, r_M, r_wt, r_New),
                            (t_ir, t_M, t_wt, t_New)):
        p, d = New(price, None), New(disc, None)

        def ident(o, ir_=ir_):
            return ir_.Ident(o.obj_id, o.weld_type())

        expr = M.filter_reduce(
            M.zip_map([ident(p), ident(d)],
                      lambda a, b, ir_=ir_: ir_.MakeStruct((a, b))),
            lambda x, ir_=ir_, wt=wt: ir_.BinOp(
                "<", ir_.GetField(x, 0), ir_.Literal(0.5, wt.F64)),
            "+",
            lambda x, ir_=ir_: ir_.BinOp("*", ir_.GetField(x, 0),
                                         ir_.GetField(x, 1)))
        out.append(New([p, d], expr))
    return out


@pytest.mark.parametrize("pattern", ["q6", "mapchain"])
def test_port_plain_versions_match_the_reference_interpret(pattern):
    """The port's routed plain versions on the CPU against the
    reference's Pallas bodies in interpret mode, same inputs."""
    if pattern == "q6":
        r_obj, t_obj = _q6_pair(512)
        ri = r_Evaluate(r_obj, kernelize=True, kernel_impl="interpret")
        st: dict = {}
        tr = t_Evaluate(t_obj, kernelize=True, collect_stats=st)
        assert st["kernelize.filter_reduce_sum"] == 1
        np.testing.assert_allclose(tr.value, ri.value, rtol=1e-12)
    else:
        x = _rng.rand(512)
        gi = np.asarray((r_weldnp.exp(r_weldnp.array(x) * 2.0) + 1.0)
                        .evaluate(kernelize=True, kernel_impl="interpret"))
        gt = np.asarray((t_weldnp.exp(t_weldnp.array(x) * 2.0) + 1.0)
                        .evaluate(kernelize=True))
        np.testing.assert_allclose(gt, gi, rtol=1e-12)


def test_multi_agg_fused_matches_per_aggregate_plain_versions():
    vals = _rng.rand(3, 5000)
    pred = _rng.rand(5000) > 0.4
    tv, tp = torch.from_numpy(vals), torch.from_numpy(pred)
    fused = t_kops.filter_reduce_sum_multi(tv, tp).numpy()
    single = np.array([t_kops.filter_reduce_sum(tv[a], tp).item()
                       for a in range(3)])
    np.testing.assert_allclose(fused, single, rtol=1e-12)
    np.testing.assert_allclose(fused, vals[:, pred].sum(axis=1), rtol=1e-10)
    ref = np.asarray(r_kops.filter_reduce_sum_multi(vals, pred,
                                                    impl="interpret"))
    np.testing.assert_allclose(fused, ref, rtol=1e-12)


def test_multi_agg_forced_per_aggregate_path_parity_port():
    """The adapter's multi=False ablation param takes the per-aggregate
    path and must agree with the fused one (the port's emitter and
    tensors)."""
    from repro_torch.core.backend.torchgen import Emitter
    from repro_torch.core.backend.values import WVec

    n = 3000
    a, b = _rng.rand(n), _rng.rand(n)
    i = t_ir.Ident("i", t_wt.I64)
    x = t_ir.Ident("x", t_wt.Struct((t_wt.F64, t_wt.F64)))
    fns = [
        t_ir.Lambda((i, x), t_ir.GetField(x, 0)),
        t_ir.Lambda((i, x), t_ir.GetField(x, 1)),
        t_ir.Lambda((i, x), t_ir.BinOp("<", t_ir.GetField(x, 0),
                                       t_ir.Literal(0.5, t_wt.F64))),
    ]

    def run(multi):
        em = Emitter({}, torch.device("cpu"), kernel_impl="ref")
        staged = [em._stage_elem_fn(f, {}) for f in fns]
        return t_registry.get("filter_reduce_sum").execute(
            [WVec(torch.from_numpy(a)), WVec(torch.from_numpy(b))],
            {"n_aggs": 2, "has_pred": True, "struct": True, "multi": multi},
            staged, "ref")

    fused = [v.item() for v in run(True)]
    per_agg = [v.item() for v in run(False)]
    np.testing.assert_allclose(fused, per_agg, rtol=1e-12)
    mask = a < 0.5
    np.testing.assert_allclose(fused[0], a[mask].sum(), rtol=1e-10)
    np.testing.assert_allclose(fused[1], b[mask].sum(), rtol=1e-10)


def test_every_tune_space_holds_its_default():
    """A tuned plan can only match or beat the default by the tuner's
    clock: the default is a candidate, and every candidate is >= 1."""
    tuned = {s.name: s for s in t_registry.all_specs() if s.tune_space}
    assert sorted(tuned) == ["dict_group_sum", "filter_reduce_sum",
                             "map_elementwise", "vecmerger_segment_sum"]
    for spec in tuned.values():
        assert spec.make_bench is not None
        for name, space in spec.tune_space.items():
            assert spec.tune_defaults[name] in space, spec.name
            assert all(int(v) >= 1 for v in space)


@pytest.mark.parametrize("name", ["filter_reduce_sum",
                                  "vecmerger_segment_sum", "dict_group_sum",
                                  "map_elementwise"])
def test_benches_build_their_workload_on_the_cpu(name):
    """Each bench makes its synthetic tensors on the default device and
    runs the plain version there with a candidate cap."""
    spec = t_registry.get(name)
    meta = {"n": 4096, "k": 64, "dtype": np.float64}
    for cap in spec.tune_space["max_blocks"]:
        spec.make_bench(meta, {"max_blocks": cap}, "ref")()


@pytest.mark.parametrize("mod", ["filter_reduce", "segment_reduce",
                                 "map_chain"])
def test_grid_cap_below_one_is_refused(mod):
    from repro_torch.kernels import filter_reduce, map_chain, segment_reduce

    m = {"filter_reduce": filter_reduce, "segment_reduce": segment_reduce,
         "map_chain": map_chain}[mod]
    assert m.MAX_BLOCKS in m.GRID_CAPS
    if mod == "filter_reduce":
        assert m.grid_blocks(10 ** 8, 132) == 132
        assert m.grid_blocks(10, 132) == 1
        with pytest.raises(ValueError, match="grid cap"):
            m.grid_blocks(100, 0)
    elif mod == "segment_reduce":
        assert m.launch_config(10 ** 8, 4096, 2, 8, 33).blocks == 33
        with pytest.raises(ValueError, match="grid cap"):
            m.launch_config(100, 16, 1, 8, 0)


def test_registry_fingerprint_carries_tune_defaults(monkeypatch):
    f0 = t_registry.fingerprint()
    spec = t_registry.get("map_elementwise")
    monkeypatch.setitem(t_registry._REGISTRY, "map_elementwise",
                        dataclasses.replace(spec,
                                            tune_defaults={"max_blocks": 264}))
    assert t_registry.fingerprint() != f0


def test_kernelplan_lazy_exports():
    assert t_kp.tune_plan is t_autotune.tune_plan
    assert t_kp.autotune is t_autotune
    assert t_kp.calibrate.__name__.endswith("kernelplan.calibrate")
    assert r_kp.tune_plan.__name__ == t_kp.tune_plan.__name__


def test_calls_made_aside_leave_the_wrappers_counts():
    """The tuner's timing runs are not counted, so a phase's counts hold
    its program's own calls only."""
    from repro_torch.kernels import _count

    x = torch.ones(16, dtype=torch.float64)
    p = torch.ones(16, dtype=torch.bool)
    t_kops.reset_counts()
    with _count.aside():
        t_kops.filter_reduce_sum(x, p)
    assert t_kops.counts()["filter_reduce_sum"] == (0, 0)
    t_kops.filter_reduce_sum(x, p)
    assert t_kops.counts()["filter_reduce_sum"] == (0, 1)

