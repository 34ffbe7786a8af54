"""Dictionary probes — the gather side of the hash-join plan.

Given a dict in the backend's sorted, front-packed key layout (keys
ascending for the first ``count`` slots), find each query key's slot and
whether it is there.  Wrappers over the CUDA kernels in
``csrc/hash_probe.cu`` (the port of the TPU kernels ``dict_probe`` and
``group_probe``): ``dict_probe`` runs one binary search per query;
``group_probe`` a persistent grid whose blocks each stage the key column
(or every S-th key) and a bucket table over its range in shared memory,
so that a query searches only its bucket's keys.  The value gathers
happen outside the kernel (``vals[pos]``), so one launch serves every
output column of a fused join probe (``kernelplan.registry``).

``group_probe`` is the m:n variant: the same search also reads each
matching group's size off the CSR ``offsets``, so membership, positions
and the expansion's match counts come from one launch.

A CUDA tensor launches the kernel — or raises; a CPU tensor takes the
plain version in ``ref``.  Each wrapper counts its kernel launches in
``.launches`` and its plain-version calls in ``.plain_calls``.

Contract (shared with ``ref.dict_probe``/``ref.group_probe``): queries
and table keys are int64 in the packed key space; ``count`` (an int or a
0-dim tensor, negative when the build was poisoned) bounds the valid
keys; ``pos`` is int32 and 0 where not found, ``sizes`` int32 and 0
where not found.  ``count`` stays on the card: no call syncs the host.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import dict_probe as dict_probe_plain
from .ref import group_probe as group_probe_plain


def _prepare(table_keys, count, queries, what: str):
    for t, name in ((table_keys, "table keys"), (queries, "queries")):
        if t.device != queries.device or t.dtype != torch.int64 \
                or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous (n,) int64 "
                             f"{name} on the queries' device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    cnt = torch.as_tensor(count, device=queries.device)
    return cnt.to(torch.int64).reshape(()).contiguous()


def _outputs(n: int, dev, sizes: bool):
    outs = [torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.bool, device=dev)]
    if sizes:
        outs.append(torch.empty((n,), dtype=torch.int32, device=dev))
    return outs


def dict_probe(table_keys: torch.Tensor, count, queries: torch.Tensor):
    """(pos, found) of each query against sorted-front-packed dict keys."""
    if queries.device.type == "cpu":
        dict_probe.plain_calls += 1
        return dict_probe_plain(table_keys, count, queries)
    cnt = _prepare(table_keys, count, queries, "dict_probe")
    n, cap = queries.shape[0], table_keys.shape[0]
    pos, found = _outputs(n, queries.device, sizes=False)
    if n == 0 or cap == 0:
        return pos.zero_(), found.zero_()
    lib = _build.library()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    with torch.cuda.device(queries.device):
        rc = lib.weld_dict_probe(table_keys.data_ptr(), cap, cnt.data_ptr(),
                                 queries.data_ptr(), n, pos.data_ptr(),
                                 found.data_ptr(), stream)
    _build.check(rc, "dict_probe kernel launch")
    dict_probe.launches += 1
    return pos, found


dict_probe.launches = 0
dict_probe.plain_calls = 0


def group_probe(table_keys: torch.Tensor, offsets: torch.Tensor, count,
                queries: torch.Tensor):
    """(pos, found, sizes) per query against a groupbuilder's sorted key
    column and CSR offsets (``sizes`` is 0 on a miss)."""
    if queries.device.type == "cpu":
        group_probe.plain_calls += 1
        return group_probe_plain(table_keys, offsets, count, queries)
    cnt = _prepare(table_keys, count, queries, "group_probe")
    n, cap = queries.shape[0], table_keys.shape[0]
    if offsets.shape != (cap + 1,) or offsets.device != queries.device:
        raise ValueError(f"group_probe kernel takes (cap + 1,) offsets on the "
                         f"queries' device, got {tuple(offsets.shape)} on "
                         f"{offsets.device} for cap={cap}")
    offs = offsets.to(torch.int32).contiguous()
    pos, found, sizes = _outputs(n, queries.device, sizes=True)
    if n == 0 or cap == 0:
        return pos.zero_(), found.zero_(), sizes.zero_()
    lib = _build.library()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    with torch.cuda.device(queries.device):
        rc = lib.weld_group_probe(table_keys.data_ptr(), cap, cnt.data_ptr(),
                                  queries.data_ptr(), n, offs.data_ptr(),
                                  pos.data_ptr(), found.data_ptr(),
                                  sizes.data_ptr(), stream)
    _build.check(rc, "group_probe kernel launch")
    group_probe.launches += 1
    return pos, found, sizes


group_probe.launches = 0
group_probe.plain_calls = 0
