"""External function registry (paper: "Weld supports calling existing C
functions for complex non-data-parallel code").

Each registered name carries two implementations: a host (pure python /
numpy) version and a torch version used by the backend.  The
``linalg.*`` names are not registered: the emitter lowers them to
``torch.matmul`` itself.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {}


def register_cudf(name: str, host_fn: Callable, torch_fn: Callable) -> None:
    if name in _REGISTRY:
        raise ValueError(f"cudf {name!r} already registered")
    _REGISTRY[name] = (host_fn, torch_fn)


def lookup_cudf_host(name: str) -> Callable:
    return _REGISTRY[name][0]


def lookup_cudf_torch(name: str) -> Callable:
    return _REGISTRY[name][1]


def has_cudf(name: str) -> bool:
    return name in _REGISTRY
