"""Logical-axis sharding rules on ``torch.distributed.tensor`` (the port
of the JAX package's ``distributed/sharding.py``).

Models annotate every parameter with *logical* axis names (each module's
``SPECS``); this module maps them to mesh axes with a priority-rule
table, respecting divisibility and never using a mesh axis twice in one
spec.  The Megatron column/row TP pattern, EP for experts, and
hierarchical DP over (pod, data) all fall out of one rule table:

    heads/kv_heads/mlp/vocab/experts -> model   (TP / EP)
    head_dim -> model                           (fallback when the head
                                                 count doesn't divide)
    batch -> (pod, data)                        (hierarchical DP)

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (one dimension split
over several mesh axes, major first) — the reference's
``PartitionSpec``.  :func:`placements` turns it into DTensor placements
and :func:`distribute` builds the DTensors; GSPMD's propagation is
DTensor's.

ZeRO-1: optimizer-moment leaves additionally shard their first
replicated-and-divisible dimension over 'data'.  The reference applies
that to its layer-stacked leaves, whose first free dimension is often
the stack; the port keeps one module per layer (``models/convert.py``),
so the same rule applies to the per-layer leaf.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[Axis], ...]

#: priority-ordered mesh-axis candidates per logical axis
DEFAULT_RULES: Dict[str, List] = {
    "mlp": ["model"],
    "heads": ["model"],
    "kv_heads": ["model"],
    "head_dim": ["model"],
    "vocab": ["model"],
    "experts": ["model"],
    "embed": [],            # replicated (activations gather over it anyway)
    "state": [],
    "layers": [],
    "batch": [("pod", "data"), "data"],
    "seq": ["model"],       # sequence parallelism for long-context decode
}

#: the mesh axes a batch is split over, major first
BATCH_AXES = ("pod", "data")


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` with ``mesh_dim_names`` or
    of a mapping of axis name to size (rules need no process group)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _size(shape: Dict[str, int], axis: Axis) -> int:
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= _size(shape, a)
        return out
    return shape.get(axis, 0)


def _flat(axis: Optional[Axis]) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def spec_for_leaf(shape: Sequence[int], axes: Sequence[Optional[str]],
                  mesh, rules: Optional[Dict] = None) -> Spec:
    """The spec of one leaf: walk dims left to right, take the first
    unused, divisible candidate for each logical axis."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sizes = mesh_shape(mesh)
    used: set = set()
    parts = []
    assert len(axes) == len(shape), f"spec rank mismatch {axes} vs {shape}"
    for dim, name in zip(shape, axes):
        chosen = None
        if name is not None:
            for cand in rules.get(name, []):
                flat = _flat(cand)
                if any(a in used for a in flat):
                    continue
                if any(a not in sizes for a in flat):
                    continue
                sz = _size(sizes, cand)
                if sz and dim % sz == 0:
                    chosen = cand
                    used.update(flat)
                    break
        parts.append(chosen)
    return tuple(parts)


def zero1_spec(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
               rules: Optional[Dict] = None) -> Spec:
    """A moment's spec: the parameter's, with its first replicated
    dimension that 'data' divides also given to 'data' (when 'data' is
    larger than 1 and not used yet)."""
    sizes = mesh_shape(mesh)
    parts = list(spec_for_leaf(shape, axes, mesh, rules))
    used = {a for p in parts for a in _flat(p)}
    dsz = sizes.get("data", 1)
    if "data" in sizes and dsz > 1 and "data" not in used:
        for i, (dim, cur) in enumerate(zip(shape, parts)):
            if cur is None and dim % dsz == 0 and dim >= dsz:
                parts[i] = "data"
                break
    return tuple(parts)


def tree_shardings(specs: Mapping[str, Sequence], shapes: Mapping, mesh,
                   rules: Optional[Dict] = None) -> Dict[str, Spec]:
    """{name: spec} for a flat dict of logical axes and a dict of the same
    names' shapes (tensors or shape tuples)."""
    return {k: spec_for_leaf(_shape(shapes[k]), specs[k], mesh, rules)
            for k in specs}


def zero1_moment_shardings(specs: Mapping[str, Sequence], shapes: Mapping,
                           mesh, rules: Optional[Dict] = None
                           ) -> Dict[str, Spec]:
    """{name: spec} of the moments, ZeRO-1: :func:`zero1_spec` of each."""
    return {k: zero1_spec(_shape(shapes[k]), specs[k], mesh, rules)
            for k in specs}


def replicated(shape: Sequence[int] = ()) -> Spec:
    """The spec of a leaf replicated everywhere."""
    return (None,) * len(shape)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dimension gets
    ``Shard(d)`` if tensor dimension d names it, else ``Replicate()``.  A
    tuple of names shards one tensor dimension over those mesh dimensions,
    the first the major one (DTensor splits a dimension over mesh
    dimensions in mesh order, so the names must come in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        flat = _flat(part)
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {flat} must follow the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
               mesh) -> Dict[str, torch.Tensor]:
    """{name: DTensor}: each full tensor of ``tree`` (the same values on
    every rank, so no rank sends any) placed on ``mesh`` by its spec."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(t, mesh, placements(specs[k], mesh),
                                 src_data_rank=None)
            for k, t in tree.items()}
