"""The port's IR, types and interpreter against the JAX package's.

The cases of ``test_ir.py`` (types, typecheck, linearity, canonical
keys, ``interp`` as the oracle) run against ``repro_torch`` unchanged
(``torch_refcases``); then every case's programs, built once per
package, must type, key (alpha-invariant ``canon_key``) and interpret
the same in both.  Exact
equality throughout: nothing here is computed in floating point on a
device.
"""
from __future__ import annotations

import pytest

from repro.core import interp as r_interp, ir as r_ir, macros as r_M
from repro.core import wtypes as r_wt
from repro_torch.core import interp as t_interp, ir as t_ir, macros as t_M
from repro_torch.core import wtypes as t_wt
from torch_refcases import port_cases

port_cases("test_ir", globals())


def _programs(ir, M, wt):
    """A few programs covering loops, structs of builders, dicts and
    groups, each with the env it is interpreted in."""
    v = ir.Ident("v", wt.Vec(wt.I64))
    one = ir.Literal(1, wt.I64)
    return {
        "map": (M.map_(v, lambda x: ir.BinOp("+", x, one)),
                {"v": [1, 2, 3]}),
        "filter": (M.filter_(v, lambda x: ir.BinOp(">", x, one)),
                   {"v": [0, 1, 2, 5]}),
        "reduce": (M.reduce_(v, "+"), {"v": [4, 5, 6]}),
        "let": (ir.Let("t", M.reduce_(v, "max"),
                       ir.BinOp("*", ir.Ident("t", wt.I64),
                                ir.Literal(3, wt.I64))),
                {"v": [7, 2, 9]}),
        "groupby": (M.groupby_agg(v, v, "+", capacity=8),
                    {"v": [1, 2, 1, 3, 2, 1]}),
    }


@pytest.mark.parametrize("name", ["map", "filter", "reduce", "let",
                                  "groupby"])
def test_programs_type_key_and_interpret_alike(name):
    r_e, env = _programs(r_ir, r_M, r_wt)[name]
    t_e, _ = _programs(t_ir, t_M, t_wt)[name]
    assert t_ir.canon_key(t_e) == r_ir.canon_key(r_e)
    assert str(t_ir.typeof(t_e)) == str(r_ir.typeof(r_e))
    assert t_interp.interpret(t_e, env) == r_interp.interpret(r_e, env)
