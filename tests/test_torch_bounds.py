"""The port's weldbound analysis and admission against the JAX
package's.

The cases of ``test_bounds.py`` run against ``repro_torch`` unchanged
(``torch_refcases``).  Then the
``bounds_soundness`` profile of ``test_join_fuzz.py`` runs through both
packages on the same seeded cases: each observed output size lies in
its derived interval, the intervals of the two packages are equal, and a
``memory_limit`` equal to a package's own certified peak admits and
survives its own emitter's charging.  The peaks are not compared across
packages: the port's kernel footprints are its own (``registry.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from repro.core import runtime as r_runtime
from repro.core.analysis import bounds as r_bounds
from repro.frames import weldrel as r_weldrel
from repro_torch.core import runtime as t_runtime
from repro_torch.core.analysis import bounds as t_bounds
from repro_torch.frames import weldrel as t_weldrel
from test_join_fuzz import make_case
from torch_refcases import port_cases

port_cases("test_bounds", globals())

REF = SimpleNamespace(weldrel=r_weldrel, runtime=r_runtime,
                      bounds=r_bounds)
PORT = SimpleNamespace(weldrel=t_weldrel, runtime=t_runtime,
                       bounds=t_bounds)


def _run(pkg, case, memory_limit=None):
    lcols, rcols, on, how, filtered = case
    w = pkg.weldrel
    t = w.Table(lcols, eager=False)
    r = w.Table(rcols, eager=False)
    q = w.Query(t)
    if filtered:
        q = q.filter(t.col("lv") > 0.5)
    st: dict = {}
    out = q.join(r, on=on, how=how, memory_limit=memory_limit,
                 collect_stats=st)
    return np.asarray(w._host(out.cols["k"])).size, st


@pytest.mark.parametrize("seed", [424, 425])
def test_join_fuzz_bounds_soundness(seed):
    rng = np.random.RandomState(seed)
    checked = admitted = 0
    for _ in range(15):
        case = make_case(rng)
        lcols, rcols, on, how, filtered = case
        on_list = on if isinstance(on, list) else [on]
        if how == "anti" \
                and pd.DataFrame(rcols)[on_list].duplicated().any():
            continue  # error-parity shape: held by test_torch_join.py
        rows = {}
        for pkg in (PORT, REF):
            observed, st = _run(pkg, case)
            lo, hi = st["bounds.out_rows"]
            assert lo <= observed and (hi is None or observed <= hi)
            rep = pkg.bounds.analyze(st["plan.ir"])
            lo2, hi2 = rep.result_rows(st["plan.inputs"][2])
            assert lo2 <= observed and (hi2 is None or observed <= hi2)
            rows[id(pkg)] = (observed, st["bounds.out_rows"],
                             st.get("kernelize.matched", 0))
            peak = st["bounds.peak_bytes"]
            if peak > 0:
                pkg.runtime.clear_cache()
                observed2, st2 = _run(pkg, case, memory_limit=peak)
                assert observed2 == observed
                assert st2["bounds.admitted"] is True
                admitted += pkg is PORT
        port, ref = rows[id(PORT)], rows[id(REF)]
        assert port[0] == ref[0]
        if port[2] == ref[2]:  # the same routes: the same intervals
            assert port[1] == ref[1]
        checked += 1
    assert checked >= 8 and admitted >= 1
