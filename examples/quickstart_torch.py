"""Quickstart on the PyTorch port: Weld's cross-library optimization in
40 lines (the counterpart of ``examples/quickstart.py``).

The paper's Listing 7: filter a dataframe with (weld)Pandas, total a
column with (weld)NumPy — two libraries, one fused loop at evaluation,
on the CUDA card (``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

import repro_torch
from repro_torch.core.lazy import Evaluate
from repro_torch.frames import welddf, weldnp  # noqa: F401

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = ap.parse_args()
repro_torch.set_default_device(args.device)

rng = np.random.RandomState(0)
n = 2_000_000
data = {
    "population": rng.randint(0, 1_000_000, n).astype(np.float64),
    "crime": rng.rand(n),
}

# -- welddf: lazy dataframe; nothing computes yet ---------------------------
df = welddf.DataFrame(data)
big = df[df["population"] > 500_000]

# -- weldnp math on the *filtered* pandas columns (cross-library!) ----------
crime_index = big["population"] * 0.1 + big["crime"] * 2.0
total = crime_index.sum()

# -- print forces evaluation: the whole workflow compiles to ONE program ----
stats = {}
result = Evaluate(total.obj, collect_stats=stats)
print(f"total crime index      : {result.value:,.2f}")
print(f"loops before optimizer : {stats['loops.before']}")
print(f"loops after fusion     : {stats['loops.after']}")
print(f"vertical fusions       : {stats.get('fusion.vertical', 0)}")
print(f"horizontal fusions     : {stats.get('fusion.horizontal', 0)}")
print(f"predicated merges      : {stats.get('predication', 0)}")
print(f"compile time           : {result.compile_ms:.0f} ms "
      f"(cached on re-evaluation)")

# validate against native NumPy
m = data["population"] > 500_000
want = (data["population"][m] * 0.1 + data["crime"][m] * 2.0).sum()
assert abs(result.value - want) < 1e-6 * abs(want)
print("matches native NumPy   : True")
print(f"device                 : {args.device}")
