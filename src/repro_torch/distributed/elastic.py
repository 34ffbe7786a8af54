"""Elastic scaling: continue on a DIFFERENT mesh (the port of the JAX
package's ``distributed/elastic.py``).

Checkpoints store unsharded host arrays (``checkpoint/ckpt.py``), so
elastic restart is: build the new mesh, derive the placements from the
same logical rules, ``Checkpointer.restore(..., mesh=new, specs=...)``.
The data pipeline's shard-stable stream (``data/pipeline.py``)
guarantees the global batch sequence is unchanged across the re-shard,
so training is a pure continuation.  :func:`remesh` covers the in-memory
case (shrink or grow over the same ranks without going through disk),
the straggler monitor's escalation.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from .sharding import distribute, tree_shardings


def remesh(state: Mapping[str, torch.Tensor], spec_tree: Mapping,
           new_mesh, rules: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Re-place a live flat tree of DTensors onto ``new_mesh`` with the
    rules' placements there.  DTensor does not redistribute across meshes,
    so each leaf is gathered whole (``full_tensor``, a collective every
    rank joins) and distributed again."""
    full = {k: t.full_tensor() for k, t in state.items()}
    return distribute(full, tree_shardings(spec_tree, full, new_mesh, rules),
                      new_mesh)
