"""The port's optimizer passes against the JAX package's.

The cases of ``test_passes.py`` (each pass preserves semantics, checked
against ``interp``, and does its structural job) and of
``test_property.py`` (hypothesis sweeps: optimizer and backend against
``interp``, merge order, fusion, predication) run against
``repro_torch`` unchanged (``torch_refcases``).  Then random map/filter/
reduce pipelines are built once per package over the same numpy data:
the optimized programs must have the same loop count and the same
alpha-invariant key, and both packages' evaluations must return the
same integers exactly (i64 end to end).
"""
from __future__ import annotations

import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import ir as r_ir, lazy as r_lazy, macros as r_M
from repro.core import passes as r_passes, wtypes as r_wt
from repro_torch.core import ir as t_ir, lazy as t_lazy, macros as t_M
from repro_torch.core import passes as t_passes, wtypes as t_wt
from torch_refcases import port_cases

port_cases("test_passes", globals())
port_cases("test_property", globals())

STAGES = ["map_add", "map_mul", "map_abs", "filter_gt", "filter_even"]


def _pipeline(ir, M, src, stages, final):
    e = src
    for kind, c in stages:
        if kind == "map_add":
            e = M.map_(e, lambda x, c=c: ir.BinOp("+", x, M.lit(c)))
        elif kind == "map_mul":
            e = M.map_(e, lambda x, c=c: ir.BinOp("*", x, M.lit(c % 3)))
        elif kind == "map_abs":
            e = M.map_(e, lambda x: ir.UnaryOp("abs", x))
        elif kind == "filter_gt":
            e = M.filter_(e, lambda x, c=c: ir.BinOp(">", x, M.lit(c)))
        else:
            e = M.filter_(e, lambda x: ir.BinOp(
                "==", ir.BinOp("%", x, M.lit(2)), M.lit(0)))
    return M.reduce_(e, final) if final != "none" else e


def _evaluate(ir, M, wt, lazy, data, stages, final):
    d = lazy.NewWeldObject(np.asarray(data, dtype=np.int64), None)
    src = ir.Ident(d.obj_id, d.weld_type())
    obj = lazy.NewWeldObject([d], _pipeline(ir, M, src, stages, final))
    return np.asarray(lazy.Evaluate(obj).value)


@settings(max_examples=30, deadline=None)
@given(data=st.lists(st.integers(0, 100), min_size=1, max_size=30),
       stages=st.lists(st.tuples(st.sampled_from(STAGES),
                                 st.integers(-20, 20)),
                       min_size=1, max_size=4),
       final=st.sampled_from(["+", "max", "min", "none"]))
def test_pipelines_optimize_and_evaluate_alike(data, stages, final):
    r_src = r_ir.Ident("v", r_wt.Vec(r_wt.I64))
    t_src = t_ir.Ident("v", t_wt.Vec(t_wt.I64))
    r_opt = r_passes.optimize(_pipeline(r_ir, r_M, r_src, stages, final))
    t_opt = t_passes.optimize(_pipeline(t_ir, t_M, t_src, stages, final))
    assert t_passes.loop_count(t_opt) == r_passes.loop_count(r_opt)
    assert t_ir.canon_key(t_opt) == r_ir.canon_key(r_opt)
    want = _evaluate(r_ir, r_M, r_wt, r_lazy, data, stages, final)
    got = _evaluate(t_ir, t_M, t_wt, t_lazy, data, stages, final)
    np.testing.assert_array_equal(got, want)
