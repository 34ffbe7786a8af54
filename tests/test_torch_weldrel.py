"""weldrel's eager/lazy parity and the autotune cache's robustness, on the
port, on the CPU.

The cases of ``test_weldrel_parity.py`` run against ``repro_torch``
(``torch_refcases``), except its two autotune-cache cases, which tune
through ``impl="interpret"`` (the reference's Pallas bodies on the CPU)
and read its ``block`` space.  Their counterparts below tune through
``impl="cuda"`` with a no-op ``make_bench`` (the CPU has no kernel to
time) and read the port's grid cap ``max_blocks``; every other line of
the two cases is the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

from repro_torch.core import faults as t_faults
from repro_torch.core.kernelplan import autotune as t_autotune
from repro_torch.core.kernelplan import registry as t_registry
from torch_refcases import port_cases

port_cases("test_weldrel_parity", globals(), leave_out=(
    "test_autotune_corrupt_cache_warns_and_recovers",
    "test_autotune_save_is_atomic_no_temp_left",
))


@pytest.fixture
def port_tuner(tmp_path, monkeypatch):
    monkeypatch.setenv(t_autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    t_autotune.clear_cache(disk=False)
    t_autotune._cache = None
    spec = dataclasses.replace(t_registry.get("filter_reduce_sum"),
                               make_bench=lambda m, p, i: (lambda: None))
    monkeypatch.setitem(t_registry._REGISTRY, "filter_reduce_sum", spec)
    yield t_autotune, spec
    t_autotune.clear_cache(disk=False)


def test_autotune_corrupt_cache_warns_and_recovers_port(port_tuner):
    tuner, spec = port_tuner
    with open(tuner.cache_path(), "w") as f:
        f.write('{"filter_reduce_sum|float64|2048|cuda')  # truncated write
    with pytest.warns(RuntimeWarning, match="corrupt") as rec:
        assert tuner._load() == {}
    msg = str(rec[0].message)
    assert tuner.cache_path() in msg
    assert "delete the file" in msg
    assert any(w in msg for w in ("Unterminated", "Expecting", "char")), msg
    # tuning proceeds and the next save replaces the bad file atomically
    params, cached = tuner.tune(spec, {"n": 1500, "dtype": np.float64},
                                impl="cuda")
    assert params["max_blocks"] in spec.tune_space["max_blocks"]
    assert not cached
    disk = json.load(open(tuner.cache_path()))
    assert any(k.startswith("filter_reduce_sum|") for k in disk)


def test_autotune_save_is_atomic_no_temp_left_port(port_tuner):
    tuner, spec = port_tuner
    tuner.tune(spec, {"n": 1200, "dtype": np.float64}, impl="cuda")
    d = os.path.dirname(tuner.cache_path())
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    json.load(open(tuner.cache_path()))  # valid JSON on disk


def test_autotune_injected_cache_write_failure_keeps_tuning(port_tuner):
    """The ``io.autotune_cache`` failpoint: persistence fails, the tuning
    still applies in the process."""
    tuner, spec = port_tuner
    t_faults.inject("io.autotune_cache", "raise", times=1)
    try:
        params, _ = tuner.tune(spec, {"n": 1300, "dtype": np.float64},
                               impl="cuda")
    finally:
        t_faults.clear()
    assert not os.path.exists(tuner.cache_path())
    assert tuner.lookup("filter_reduce_sum", np.float64, 1300,
                        "cuda") == params
