"""Device meshes (the port of the JAX package's ``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised process group: one rank per device, its dimensions named as
the reference's axes.  The functions build it when called, never when
the module is imported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch.distributed as dist

from ..device import default_device


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: one pod = 16×16 = 256 ranks (data × model);
    multi-pod = 2 pods = 512 ranks with a leading 'pod' axis (used for
    hierarchical data parallelism), on the default device's type.  Needs
    a process group of 256 (or 512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks, the process group has {world}")
    return _mesh(default_device().type, shape, axes)


def make_local_mesh(dp: Optional[int] = None, tp: int = 1):
    """The (dp, tp) mesh over ("data", "model") of the initialised process
    group, on the default device's type; dp defaults to world // tp.
    Raises ``ValueError`` unless dp · tp is the world size."""
    world = dist.get_world_size()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks, the "
                         f"process group has {world}")
    return _mesh(default_device().type, (dp, tp), ("data", "model"))


def mesh_axis_size(mesh, name) -> int:
    """The size of a mesh axis, or the product of several; 1 for an axis
    the mesh lacks."""
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= mesh_axis_size(mesh, n)
        return out
    names = mesh.mesh_dim_names
    return mesh.mesh.shape[names.index(name)] if name in names else 1
