"""The port's Python-UDF frontend against the JAX package's.

The cases of ``test_pyudf.py`` run against ``repro_torch`` unchanged
(``torch_refcases``): translation checked through ``interp``, and the
UDFs evaluated in a weldnp-style map against numpy.  Then each UDF is
translated by both packages, and its lambda must type and key alike and
interpret to the same value on the same inputs (exact: the interpreter
runs Python floats in both).
"""
from __future__ import annotations

import math

import numpy as np
import pytest

from repro.core import interp as r_interp, ir as r_ir, wtypes as r_wt
from repro.frames import pyudf as r_pyudf
from repro_torch.core import interp as t_interp, ir as t_ir
from repro_torch.core import wtypes as t_wt
from repro_torch.frames import pyudf as t_pyudf
from torch_refcases import port_cases

port_cases("test_pyudf", globals())

K = 0.25  # a closure constant both translations read


def _udfs(weld):
    @weld("(f64) => f64")
    def logistic(x):
        return 1.0 / (1.0 + math.exp(-x * K))

    @weld("(f64, f64) => f64")
    def hinge(x, y):
        return x - y if x > y else 0.0

    @weld("(i64) => bool")
    def odd_small(x):
        return x % 2 == 1 and x < 10

    return {"logistic": (logistic, [[0.3], [-2.0]]),
            "hinge": (hinge, [[3.0, 1.5], [1.0, 2.0]]),
            "odd_small": (odd_small, [[3], [12], [4]])}


@pytest.mark.parametrize("name", ["logistic", "hinge", "odd_small"])
def test_udfs_translate_alike(name):
    r_udf, inputs = _udfs(r_pyudf.weld)[name]
    t_udf, _ = _udfs(t_pyudf.weld)[name]
    for args in inputs:
        r_ty = [r_wt.I64 if isinstance(a, int) else r_wt.F64 for a in args]
        t_ty = [t_wt.I64 if isinstance(a, int) else t_wt.F64 for a in args]
        r_e = r_udf.to_ir([r_ir.Literal(a, ty) for a, ty in zip(args, r_ty)])
        t_e = t_udf.to_ir([t_ir.Literal(a, ty) for a, ty in zip(args, t_ty)])
        assert t_ir.canon_key(t_e) == r_ir.canon_key(r_e)
        assert str(t_ir.typeof(t_e)) == str(r_ir.typeof(r_e))
        got = t_interp.interpret(t_e)
        assert got == r_interp.interpret(r_e)
        assert np.asarray(got).item() == t_udf(*args)
