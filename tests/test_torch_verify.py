"""The port's weldcheck verifier, its mutation harness and its pipeline
checkpoints against the JAX package's.

The cases of ``test_verify.py`` run against ``repro_torch`` unchanged
(``torch_refcases``), except one:

* ``test_mutation_harness_recall`` captures its corpus under the default
  ``"auto"``, where the two packages' gates route apart at 64 rows (the
  port routes the join's kernels, the reference does not).  It is held
  here per mode instead: on the same routes both packages' verifiers
  catch the same mutants, and the generic plans keep the reference's 95%
  bar.

Counts are compared exactly: the mutation harness is seeded.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core.check import diagnostics as r_diagnostics
from repro.core.check import mutate as r_mutate
from repro.frames import weldrel as r_weldrel
from repro_torch.core.check import diagnostics as t_diagnostics
from repro_torch.core.check import mutate as t_mutate
from repro_torch.frames import weldrel as t_weldrel
from torch_refcases import port_cases

port_cases("test_verify", globals(),
           leave_out=("test_mutation_harness_recall",))


def _corpus(weldrel, mode, impl):
    """``test_verify.py``'s captured pipelines, planned under ``mode``."""
    rng = np.random.RandomState(7)
    n = 64
    progs, shapes = [], []
    kw = {"kernelize": mode, "kernel_impl": impl}

    def cap(st):
        progs.append(st["plan.ir"])
        shapes.append(st["plan.inputs"][2])

    left = weldrel.Table({"k": rng.randint(0, 8, n).astype(np.int64),
                          "lv": rng.rand(n)})
    right1 = weldrel.Table({"k": np.arange(8, dtype=np.int64),
                            "rv": rng.rand(8)})
    st: dict = {}
    weldrel.Query(left).join(right1, on="k", how="inner", collect_stats=st,
                             **kw)
    cap(st)
    st = {}
    weldrel.Query(left).group_agg(
        [left.col("k")], {"s": (left.col("lv"), "+")}, collect_stats=st,
        **kw)
    cap(st)
    rightmn = weldrel.Table({"k": rng.randint(0, 4, 16).astype(np.int64),
                             "rv": rng.rand(16)})
    for how in ("inner", "left"):
        st = {}
        weldrel.Query(left).join(rightmn, on="k", how=how,
                                 collect_stats=st, **kw)
        cap(st)
    return progs, shapes


@pytest.mark.parametrize("mode", ["off", "always"])
def test_mutation_recall_matches_the_reference(mode):
    impl = "ref" if mode != "off" else None
    r_progs, r_shapes = _corpus(r_weldrel, mode, impl)
    t_progs, t_shapes = _corpus(t_weldrel, mode, None)
    want = r_mutate.run_mutations(r_progs, seed=2026, rounds=3,
                                  shapes=r_shapes)
    got = t_mutate.run_mutations(t_progs, seed=2026, rounds=3,
                                 shapes=t_shapes)
    assert (got.applied, got.caught) == (want.applied, want.caught)
    assert got.applied >= 30
    if mode == "off":
        assert got.rate >= 0.95, got.misses


def test_diagnostic_codes_match_the_reference():
    assert t_diagnostics.CODES == r_diagnostics.CODES


def test_every_port_evaluation_verifies_each_pass_and_the_plan():
    """With ``WELD_VERIFY=1`` (the suite's default) one compile verifies
    the input, each pass of every fixpoint round, the planned program
    and the tuned one (the autotuner's checkpoint, as the reference's
    runtime takes it)."""
    rng = np.random.RandomState(3)
    left = t_weldrel.Table({"k": rng.randint(0, 8, 64).astype(np.int64),
                            "lv": rng.rand(64)})
    right = t_weldrel.Table({"k": np.arange(8, dtype=np.int64),
                             "rv": rng.rand(8)})
    st: dict = {}
    t_weldrel.Query(left).join(right, on="k", kernelize="always",
                               collect_stats=st)
    phases = [p for p, _ in st["verify.phases"]]
    assert phases[0] == "input" and phases[-2:] == ["kernelplan",
                                                    "autotune"]
    assert any(p.startswith("pass.") for p in phases)
    assert st["verify.runs"] == len(phases)
