"""``Query.explain()`` on the port, on the CPU: the reference's EXPLAIN
cases of ``test_obs.py`` and ``test_recovery.py`` run against
``repro_torch`` unchanged (``torch_refcases``), and the port's report is
held to the reference's on the same query (the sections, the routed
kernels, the gate's decisions with their source).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.frames import weldrel as r_weldrel
from repro_torch.frames import weldrel as t_weldrel
from torch_refcases import port_cases

port_cases("test_obs", globals(), only=(
    "test_explain_reports_plan_without_tracing",
    "test_explain_analyze_mn_join_measures_group_kernels",
    "test_explain_rejects_eager_tables",
))
port_cases("test_recovery", globals(),
           only=("test_explain_analyze_shows_recovery",))


def _tables(weldrel, n=2048, k=32):
    rng = np.random.RandomState(9)
    left = weldrel.Table({"key": rng.randint(0, 2 * k, n).astype(np.int64),
                          "price": rng.rand(n)})
    right = weldrel.Table({"key": np.arange(k, dtype=np.int64),
                           "rate": rng.rand(k)})
    return left, right


@pytest.mark.parametrize("mode", ["always", "auto"])
def test_port_report_has_the_reference_sections(mode):
    reps = {}
    for name, weldrel in (("ref", r_weldrel), ("port", t_weldrel)):
        left, right = _tables(weldrel)
        reps[name] = weldrel.Query(left).explain().join(
            right, on="key", validate="m:1", kernelize=mode)
    ref, port = reps["ref"], reps["port"]
    for section in ("-- fused IR (post-planning) --", "-- verify --",
                    "-- bounds --"):
        assert (section in ref.render()) == (section in port.render()), \
            section
    ptxt = port.render()
    assert "EXPLAIN weldrel.join" in ptxt
    if mode == "always":
        assert {r["kernel"] for r in port.kernels()} == {
            "dict_hash_build", "hash_probe"}
        assert "-- routed kernels --" in ptxt
    else:
        costs = port.costs()
        assert costs and all(c["source"] == "roofline" for c in costs)
        assert "-- cost-gate decisions --" in ptxt
        assert "source=roofline" in ptxt
    assert sorted(port.result.cols) == sorted(ref.result.cols)
    for c in ref.result.cols:
        np.testing.assert_array_equal(
            np.asarray(t_weldrel._host(port.result.cols[c])),
            np.asarray(r_weldrel._host(ref.result.cols[c])))
