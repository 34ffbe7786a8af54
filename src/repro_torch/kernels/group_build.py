"""CSR group build — the groupbuilder of the m:n hash join's build side.

The build side of an m:n join stores every build row under its key.  The
layout is CSR: ``offsets`` over ascending-key compact slots plus the row
payloads sorted by slot, so a probe reads a group's fan-out as
``offsets[s + 1] - offsets[s]``.  :func:`group_build` composes

1. **hash-to-slot** (:mod:`.hash_table`): rows with equal packed keys
   share a table slot;
2. **rank compaction** (torch glue, :func:`.hash_table.compact_slots`):
   table slots become ascending-key compact ids, the layout of the
   backend's sorted dicts;
3. **slot histogram** (:func:`slot_hist`, the CUDA kernel in
   ``csrc/group_build.cu``, the port of the TPU kernel ``slot_hist``):
   rows per compact slot, then a cumulative sum into ``offsets``.

A CUDA tensor launches the kernels — or raises; a CPU tensor takes the
plain versions in ``ref``.  ``slot_hist`` counts its kernel launches in
``.launches`` and its plain-version calls in ``.plain_calls``.

Contract (shared with ``ref.group_build``): ``keys`` are int64 (packed
key space); rows equal to ``EMPTY`` park at slot ``capacity``.  Returns
``(cslots, offsets, used)``: ``cslots[i]`` in ``[0, capacity]`` is row
i's compact slot (``capacity`` = parked), ``offsets`` the
``(capacity + 1,)`` int32 CSR boundaries, ``used`` the distinct keys
inserted; ``used > capacity`` is overflow and callers poison.
"""
from __future__ import annotations

import torch

from . import _build, _count
from .hash_table import compact_slots, hash_to_slot, table_size
from .ref import slot_hist as slot_hist_plain


def slot_hist(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Rows per slot: ``out[s] = #{i: slots[i] == s}``, slots (n,) int32
    -> (num_slots,) int32; ids outside [0, num_slots) are not counted."""
    if slots.device.type == "cpu":
        _count.bump(slot_hist, "plain_calls")
        return slot_hist_plain(slots, num_slots)
    if slots.dtype != torch.int32 or slots.ndim != 1:
        raise ValueError(f"slot_hist kernel takes (n,) int32 slots, got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if not slots.is_contiguous():
        raise ValueError("slot_hist kernel takes contiguous slots")
    if num_slots < 1:
        raise ValueError(f"slot_hist needs num_slots >= 1, got {num_slots}")
    dev = slots.device
    out = torch.empty((num_slots,), dtype=torch.int32, device=dev)
    n = slots.shape[0]
    if n == 0:
        return out.zero_()
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.weld_slot_hist(slots.data_ptr(), n, num_slots,
                                out.data_ptr(), stream)
    _build.check(rc, "slot_hist kernel launch")
    _count.bump(slot_hist, "launches")
    return out


slot_hist.launches = 0
slot_hist.plain_calls = 0


def group_build(keys: torch.Tensor, capacity: int):
    """CSR group build over packed int64 keys; see the module contract."""
    cap = int(capacity)
    dev = keys.device
    slots, table, used = hash_to_slot(keys, table_size(cap))
    if keys.shape[0] == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((cap + 1,), dtype=torch.int32, device=dev), used)
    cslots = compact_slots(slots, table, cap)
    counts = slot_hist(cslots, cap + 1)[:cap]
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    return cslots, offsets, used
