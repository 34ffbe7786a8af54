"""The port's distribution layer against the JAX package's, on the CPU.

* ``spec_for_leaf`` and the ZeRO-1 moment spec, for every parameter of
  every smoke config on the meshes (2, 4) and (4, 2) over ("data",
  "model") and (2, 2, 2) over ("pod", "data", "model"): the port's rule
  walk on its per-layer leaf equals the reference's on the matching
  layer-stacked leaf (``models/convert.py``'s naming) with the stack
  entries dropped, both in one process on ``jax.sharding.AbstractMesh``
  (no devices).  ZeRO-1 departs from the reference by design: the port
  applies the reference's ``zero1_moment_shardings`` to the per-layer
  leaf, whose first replicated dimension is not a layer stack, so that
  is what it is held to.
* The reference's spec cases of ``test_distributed.py`` (the divisibility
  fallback, the multi-axis batch rule), through both packages.
* ``placements`` of a spec, a multi-axis one included.
* ``quantize_int8`` and ``dequantize_int8`` bitwise against the
  reference's on f32 inputs.
* Over gloo ranks (``torch_dist.launch``: child processes, a ``file://``
  store, 300 s a launch): ``remesh`` from (4, 2) to (2, 4) keeps every
  value bitwise with the new mesh's placements and local shapes;
  ``compressed_psum`` over 8 ranks for 5 steps with the error carried
  keeps each step's relative error below 0.05 (the reference test's
  gate), its per-rank q, scale and error equal the reference's quantizer
  on that rank's corrected input bitwise, and its mean is the rank-order
  sum of q · scale / n (rtol 1e-6).
* ``make_production_mesh`` on the ``"fake"`` backend at 256 and 512
  ranks, in a child process: shapes, names and ``mesh_axis_size``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as r_get_config
from repro.distributed import sharding as r_sharding
from repro.models import build_model as r_build_model
from repro.optim import compress as r_compress
from repro_torch.configs import get_config, list_configs
from repro_torch.distributed import sharding
from repro_torch.models import build_model
from repro_torch.models.convert import _stacks
from repro_torch.optim import compress

import torch_dist

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def _ref_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_ref_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_name(port_name: str, stacks) -> tuple:
    """(reference leaf path, stack depth) of a port parameter."""
    parts = port_name.split(".")
    depth = len(stacks.get(parts[0], ()))
    return ".".join([parts[0]] + parts[1 + depth:]), depth


def _spec(p) -> tuple:
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a for a in p)


@pytest.mark.parametrize("arch", list_configs())
@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["2x4", "4x2", "pod2x2x2"])
def test_param_and_moment_specs_match_the_reference(arch, shape, names):
    amesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    model = build_model(get_config(arch, smoke=True))
    stacks = _stacks(model.impl)
    rmodel = r_build_model(r_get_config(arch, smoke=True))
    r_axes = _ref_leaves(rmodel.param_specs())
    r_shapes = _ref_leaves(jax.eval_shape(rmodel.init,
                                          jax.random.PRNGKey(0)))
    shapes = {n: tuple(p.shape) for n, p in model.impl.named_parameters()}
    axes = model.param_specs()
    got = sharding.tree_shardings(axes, shapes, sizes)
    got_m = sharding.zero1_moment_shardings(axes, shapes, sizes)
    assert set(got) == set(shapes)
    for name, shp in shapes.items():
        rname, depth = _ref_name(name, stacks)
        rshape, raxes = tuple(r_shapes[rname].shape), r_axes[rname]
        assert rshape[depth:] == shp, name
        assert tuple(raxes[depth:]) == tuple(axes[name]), name
        want = _spec(r_sharding.spec_for_leaf(rshape, raxes, amesh))
        assert want[:depth] == (None,) * depth, name
        assert got[name] == want[depth:], (name, got[name], want)
        want_m = r_sharding.zero1_moment_shardings(
            {"x": tuple(raxes[depth:])},
            {"x": jax.ShapeDtypeStruct(shp, jnp.float32)}, amesh)["x"]
        assert got_m[name] == _spec(want_m.spec) + (None,) * (
            len(shp) - len(want_m.spec)), (name, got_m[name], want_m.spec)


REF_CASES = [
    # kv_heads=2 not divisible by model=4 -> falls back to head_dim
    ((2, 4), ("data", "model"), (64, 2, 16), ("embed", "kv_heads",
                                              "head_dim"),
     (None, None, "model")),
    # heads divisible -> model; head_dim must stay unsharded (axis used)
    ((2, 4), ("data", "model"), (64, 8, 16), ("embed", "heads", "head_dim"),
     (None, "model", None)),
    # experts take model; mlp falls back to nothing
    ((2, 4), ("data", "model"), (8, 64, 32), ("experts", "embed", "mlp"),
     ("model", None, None)),
    ((2, 4), ("data", "model"), (8, 128), ("batch", None), ("data", None)),
    # the multi-axis batch rule
    ((2, 2, 2), ("pod", "data", "model"), (8, 32), ("batch", None),
     (("pod", "data"), None)),
]


@pytest.mark.parametrize("shape,names,leaf,axes,want", REF_CASES,
                         ids=["kv_fallback", "heads", "experts", "batch",
                              "pod_batch"])
def test_reference_spec_cases_in_both_packages(shape, names, leaf, axes,
                                               want):
    amesh = AbstractMesh(shape, names)
    assert _spec(r_sharding.spec_for_leaf(leaf, axes, amesh)) == want
    assert sharding.spec_for_leaf(leaf, axes,
                                  dict(zip(names, shape))) == want


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert sharding.placements((("pod", "data"), None, "model"), Mesh()) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), Mesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"),), Mesh())


@pytest.mark.parametrize("seed,n", [(0, 256), (1, 4096), (2, 7)])
def test_int8_quantizer_matches_the_reference_bitwise(seed, n):
    import torch

    x = (np.random.RandomState(seed).randn(n) * 10 ** seed).astype(
        np.float32)
    rq, rs = r_compress.quantize_int8(jnp.asarray(x, dtype=jnp.float32))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs, np.float32).tobytes()
    rd = r_compress.dequantize_int8(rq, rs)
    d = compress.dequantize_int8(q, s)
    assert d.numpy().tobytes() == np.asarray(rd, np.float32).tobytes()


# ---------------------------------------------------------------------------
# over gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """One launch of 8 ranks: the remesh case and 5 compressed_psum
    steps."""
    return torch_dist.launch(
        "several", 8, tmp_path_factory.mktemp("eight"),
        cases=[("remesh", "remesh_case", {}),
               ("psum", "psum_case", {"steps": 5, "n": 256, "seed": 0})])


def test_remesh_keeps_values_and_takes_the_new_placements(eight):
    for rank, res in enumerate(eight):
        r = res["remesh"]
        assert r["same"] == {"w": True, "b": True}
        assert r["mesh"] == (2, 4)
        # w ("batch", "mlp"): rows over data (2), columns over model (4)
        assert r["placements"]["w"] == ["S0", "S1"]
        assert r["local"]["w"] == (4, 2)
        assert r["placements"]["b"] == ["R", "S0"]
        assert r["local"]["b"] == (2,)


def test_compressed_psum_keeps_the_error_small(eight):
    g = np.random.RandomState(0).randn(8, 256).astype(np.float32)
    exact = g.mean(axis=0)
    for step in range(5):
        mean = eight[0]["psum"][step]["mean"]
        for res in eight[1:]:
            np.testing.assert_array_equal(res["psum"][step]["mean"], mean)
        rel = np.linalg.norm(mean - exact) / np.linalg.norm(exact)
        assert rel < 0.05, (step, rel)


def test_compressed_psum_is_the_reference_quantizer_per_rank(eight):
    for step in range(5):
        total = np.zeros(256, np.float32)
        for rank, res in enumerate(eight):
            s = res["psum"][step]
            corrected = jnp.asarray(s["corrected"], dtype=jnp.float32)
            rq, rs = r_compress.quantize_int8(corrected)
            np.testing.assert_array_equal(s["q"], np.asarray(rq))
            assert s["scale"].tobytes() == np.asarray(
                rs, np.float32).tobytes()
            sent = np.asarray(r_compress.dequantize_int8(rq, rs))
            np.testing.assert_array_equal(
                s["err"], np.asarray(corrected) - sent)
            total = total + np.asarray(rq).astype(np.float32) \
                * np.float32(np.asarray(rs))
        np.testing.assert_allclose(eight[0]["psum"][step]["mean"],
                                   total / np.float32(8), rtol=1e-6)


def test_compressed_psum_error_carries_over(eight):
    for res in eight:
        for step in range(1, 5):
            prev, cur = res["psum"][step - 1], res["psum"][step]
            g = cur["corrected"] - prev["err"]
            np.testing.assert_allclose(g, res["psum"][0]["corrected"],
                                       rtol=1e-6, atol=1e-6)


PROD = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
import repro_torch
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_size
repro_torch.set_default_device("cpu")
out = {}
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi)
    out[world] = {"shape": list(m.mesh.shape),
                  "names": list(m.mesh_dim_names),
                  "pod_data": mesh_axis_size(m, ("pod", "data")),
                  "model": mesh_axis_size(m, "model")}
    try:
        make_production_mesh(multi_pod=not multi)
        out[world]["refused"] = False
    except ValueError:
        out[world]["refused"] = True
    dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def test_production_meshes_on_the_fake_backend():
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = torch_dist.SRC + os.pathsep + env.get("PYTHONPATH",
                                                              "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(PROD)],
                         env=env, capture_output=True, text=True,
                         timeout=torch_dist.TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["256"] == {"shape": [16, 16], "names": ["data", "model"],
                          "pod_data": 16, "model": 16, "refused": True}
    assert res["512"] == {"shape": [2, 16, 16],
                          "names": ["pod", "data", "model"],
                          "pod_data": 32, "model": 16, "refused": True}


def test_local_mesh_refuses_a_shape_the_world_cannot_hold(tmp_path):
    res = torch_dist.launch("mesh_case", 2, tmp_path)
    assert res[0] == {"default": [2, 1], "tp2": [1, 2],
                      "refused": True}


MERGE = """
import json, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed import mesh_ops
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
# a (d, kv heads, head_dim) projection sharded on head_dim over "model"
w = distribute_tensor(torch.zeros(8, 2, 8), mesh, [Replicate(), Shard(2)])
out = {"gate": mesh_ops.flattens_inner_shards()}
try:
    out["views"] = list(w.reshape(8, -1).shape)
except RuntimeError:
    out["views"] = None
out["kept"] = mesh_ops.mergeable(w, 1, -1) is w
mesh_ops.flattens_inner_shards = lambda: False
g = mesh_ops.mergeable(w, 1, -1)
out["gathered"] = [type(p).__name__ for p in g.placements]
out["gathered_view"] = list(g.reshape(8, -1).shape)
lead = distribute_tensor(torch.zeros(8, 4, 2), mesh, [Replicate(), Shard(1)])
out["lead_kept"] = mesh_ops.mergeable(lead, 1, -1) is lead
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def merge():
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = torch_dist.SRC + os.pathsep + env.get("PYTHONPATH",
                                                              "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(MERGE)],
                         env=env, capture_output=True, text=True,
                         timeout=torch_dist.TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_mergeable_keeps_a_shard_where_dtensor_views_it(merge):
    # the gate says what the installed DTensor does with the view
    assert merge["gate"] == (merge["views"] is not None)
    if merge["gate"]:
        assert merge["views"] == [8, 16]
    assert merge["kept"] == merge["gate"]


def test_mergeable_replicates_an_inner_shard_where_dtensor_cannot(merge):
    assert merge["gathered"] == ["Replicate", "Replicate"]
    assert merge["gathered_view"] == [8, 16]
    # a shard of the merge's first dimension stays: no strided shard
    assert merge["lead_kept"]
