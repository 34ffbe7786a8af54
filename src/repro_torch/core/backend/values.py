"""Runtime value representations for the PyTorch backend.

The same layout as the JAX package's values: a variable-length result
is a static-capacity buffer plus a dynamic count, and a dictionary is
(sorted keys, vals, count) column tensors, and a groupbuilder result is
CSR (sorted keys, values sorted by key, offsets, count).  A negative
count is the poison convention: decode raises :class:`CapacityError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..errors import CapacityError


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class WVec:
    """A Weld vec[T].  `data` leading axis is the vector axis.  If `count`
    is None the vector is dense (every row valid); otherwise the first
    `count` rows are valid (front-packed) and the rest is padding."""

    data: object  # tensor or tuple of tensors (vec of structs)
    count: Optional[object] = None  # 0-dim tensor or None

    @property
    def is_dense(self) -> bool:
        return self.count is None

    def capacity(self) -> int:
        arr = self.data[0] if isinstance(self.data, tuple) else self.data
        return arr.shape[0]

    def length(self):
        return self.capacity() if self.count is None else self.count

    def to_numpy(self):
        """Host-side decode: slice off padding (on the device, so only
        the valid rows cross to the host)."""
        n = None if self.count is None else int(self.count)
        if n is not None and n < 0:
            raise CapacityError(
                "kernelized producer flagged this vector as poisoned; "
                "rerun with kernelize=False or raise the builder capacity"
            )

        def cut(a):
            return _host(a if n is None else a[:n])

        if isinstance(self.data, tuple):
            return tuple(cut(a) for a in self.data)
        return cut(self.data)


@dataclass
class WDict:
    """A Weld dict[K,V]: parallel column tensors of static capacity with
    the first `count` slots valid.  Keys/vals may be tuples of tensors
    (struct keys/values, stored column-wise)."""

    keys: object
    vals: object
    count: object

    def to_numpy(self) -> dict:
        n = int(self.count)
        if n < 0:
            raise CapacityError(
                "kernelized group-by observed keys outside [0, capacity) or "
                "more distinct keys than the capacity; rerun with "
                "kernelize=False or raise the builder capacity"
            )

        def cols(x):
            return [_host(a)[:n] for a in (x if isinstance(x, tuple) else (x,))]

        kcols, vcols = cols(self.keys), cols(self.vals)
        out = {}
        for i in range(n):
            k = tuple(c[i].item() for c in kcols)
            v = tuple(c[i].item() for c in vcols)
            out[k[0] if len(k) == 1 else k] = v[0] if len(v) == 1 else v
        return out


@dataclass
class WGroup:
    """groupbuilder result: dict[K, vec[V]] as sorted values + offsets."""

    keys: object          # (cap,) or tuple of (cap,)
    values: object        # (n,) sorted by key; or tuple
    offsets: object       # (cap+1,) group boundaries
    count: object         # number of distinct keys

    def to_numpy(self) -> dict:
        n = int(self.count)
        if n < 0:
            raise CapacityError(
                "kernelized group build observed more distinct keys than "
                "the builder capacity; rerun with kernelize=False or "
                "raise the builder capacity"
            )
        offs = _host(self.offsets)
        kcols = [_host(a) for a in
                 (self.keys if isinstance(self.keys, tuple) else (self.keys,))]
        vcols = [_host(a) for a in (self.values if isinstance(
            self.values, tuple) else (self.values,))]
        out = {}
        for i in range(n):
            k = tuple(c[i].item() for c in kcols)
            vs = [c[offs[i]: offs[i + 1]] for c in vcols]
            v = vs[0] if len(vs) == 1 else list(zip(*[x.tolist() for x in vs]))
            # values within a group keep build-row order (stable sort)
            out[k[0] if len(k) == 1 else k] = (
                v.tolist() if hasattr(v, "tolist") else v
            )
        return out


def from_numpy(value, device=None):
    """Turn a backend value whose leaves are numpy arrays — the JAX
    package's ``WVec``/``WDict``/``WGroup`` after a host transfer, or tuples of
    them — into this package's values on ``device`` (default: the
    port's default device).  Counts, negative poison included, carry
    over unchanged."""
    if device is None:
        from ...device import default_device

        device = default_device()

    def leaf(a):
        if isinstance(a, tuple):
            return tuple(leaf(x) for x in a)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def count(c):
        return None if c is None else leaf(np.asarray(c, np.int64))

    if hasattr(value, "offsets"):
        return WGroup(leaf(value.keys), leaf(value.values),
                      leaf(value.offsets), count(value.count))
    if hasattr(value, "keys") and hasattr(value, "vals"):
        return WDict(leaf(value.keys), leaf(value.vals), count(value.count))
    if hasattr(value, "data") and hasattr(value, "count"):
        return WVec(leaf(value.data), count(value.count))
    if isinstance(value, tuple):
        return tuple(from_numpy(v, device) for v in value)
    return leaf(np.asarray(value))
