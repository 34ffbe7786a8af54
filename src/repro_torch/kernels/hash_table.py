"""Open-addressing hash-to-slot — dictmerger and groupbuilder builds with
sparse keys.

Wrapper over the CUDA kernel in ``csrc/hash_table.cu`` (the port of the
TPU kernel ``hash_to_slot``).  A CUDA tensor launches the kernel — or
raises; a CPU tensor takes the plain version in ``ref``.  The wrapper
counts its kernel launches in ``.launches`` and its plain-version calls
in ``.plain_calls``.

Contract (the reference's, shared by kernel and plain version):

* ``keys`` are int64 in the packed key space (see torchgen
  ``_pack_keys``); rows equal to ``EMPTY`` are padding or masked and get
  slot ``cap_table``;
* the call returns ``(slots, table, used)``: ``slots[i]`` in
  ``[0, cap_table]`` (``cap_table`` = parked), ``table[slot]`` the key
  that owns a slot (``EMPTY`` when free), ``used`` the number of
  distinct keys inserted.  A full table parks the rows it cannot place
  and then ``used >= cap_table``; callers size ``cap_table >=
  2 * capacity``, so overflow shows as ``used > capacity``.

Slot numbers are implementation-defined: the kernel gives hash
positions, which may change from run to run, the plain version
ascending-key compact ids.  Callers rely on the contract only and
renumber through :func:`compact_slots`; :func:`check_contract` holds an
output to the contract.
"""
from __future__ import annotations

import torch

from . import _build, _count
from .ref import hash_to_slot as hash_to_slot_plain

#: "no key": reserved; rows with this key are never inserted (a real key
#: that packs onto it is caught by the build adapters, which poison).
EMPTY = int(torch.iinfo(torch.int64).min)

#: largest dict capacity the hash route serves; the table is 2 * capacity
#: rounded up to a power of two (load factor <= 0.5), so at most 2^17
#: int64 slots (1 MiB).
MAX_CAP = 65536

#: Fibonacci multiplicative hashing constant (golden-ratio reciprocal);
#: the kernel's first probe is the high log2(cap_table) bits of
#: ``uint64(key) * GOLD``.
GOLD = 0x9E3779B97F4A7C15

_INT64_MAX = torch.iinfo(torch.int64).max


def table_size(capacity: int) -> int:
    """Power-of-two open-addressing table for `capacity` distinct keys."""
    c = 16
    while c < 2 * capacity:
        c <<= 1
    return c


def compact_slots(slots: torch.Tensor, table: torch.Tensor,
                  park: int) -> torch.Tensor:
    """Renumber table slots as ascending-key compact ids: a row whose slot
    holds the r-th smallest key in the table gets ``r``; parked rows, and
    ranks at or past ``park``, get ``park``.  The same on every run,
    whatever slot numbering produced ``slots``."""
    ctab = table.shape[0]
    tsort = torch.where(table == EMPTY, torch.full_like(table, _INT64_MAX),
                        table)
    order = torch.argsort(tsort, stable=True)
    rank = torch.empty((ctab,), dtype=torch.int32, device=table.device)
    rank.scatter_(0, order, torch.arange(ctab, dtype=torch.int32,
                                         device=table.device))
    s = slots.to(torch.int64)
    cs = torch.where(s < ctab, rank[torch.clamp(s, 0, ctab - 1)].to(torch.int64),
                     torch.full_like(s, park))
    return torch.where(cs < park, cs, torch.full_like(cs, park)).to(torch.int32)


def hash_to_slot(keys: torch.Tensor, cap_table: int):
    """Assign an open-addressing slot to every key: keys (n,) int64 ->
    (slots (n,) int32, table (cap_table,) int64, used () int32)."""
    if cap_table < 2 or cap_table & (cap_table - 1):
        raise ValueError(f"hash table size must be a power of two >= 2, got "
                         f"{cap_table}")
    if keys.device.type == "cpu":
        _count.bump(hash_to_slot, "plain_calls")
        return hash_to_slot_plain(keys, cap_table)
    if keys.dtype != torch.int64 or keys.ndim != 1:
        raise ValueError(f"hash_to_slot kernel takes (n,) int64 keys, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("hash_to_slot kernel takes contiguous keys")
    dev = keys.device
    n = keys.shape[0]
    table = torch.empty((cap_table,), dtype=torch.int64, device=dev)
    used = torch.empty((), dtype=torch.int32, device=dev)
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                table.fill_(EMPTY), used.zero_())
    slots = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.weld_hash_to_slot(keys.data_ptr(), n, cap_table,
                                   slots.data_ptr(), table.data_ptr(),
                                   used.data_ptr(), stream)
    _build.check(rc, "hash_to_slot kernel launch")
    _count.bump(hash_to_slot, "launches")
    return slots, table, used


hash_to_slot.launches = 0
hash_to_slot.plain_calls = 0


def check_contract(keys: torch.Tensor, cap_table: int, slots: torch.Tensor,
                   table: torch.Tensor, used: torch.Tensor) -> None:
    """Raise ``AssertionError`` unless ``(slots, table, used)`` is a valid
    hash_to_slot result for ``keys``: every placed row's slot holds its
    key, no key owns two slots (so equal keys share one and distinct keys
    never do), every owned slot holds some row's key, ``used`` counts the
    distinct valid keys (up to ``cap_table``), EMPTY rows park, and no
    row parks while the table has room.  Whatever numbering produced the
    slots, the kernel's or the plain version's."""
    keys = keys.to(torch.int64)
    s = slots.to(torch.int64)
    n = keys.shape[0]
    assert slots.shape == (n,) and slots.dtype == torch.int32, "slots shape"
    assert table.shape == (cap_table,) and table.dtype == torch.int64, \
        "table shape"
    assert bool(((s >= 0) & (s <= cap_table)).all()), "slot out of range"
    valid = keys != EMPTY
    parked = s == cap_table
    assert bool(parked[~valid].all()), "an EMPTY row was placed"
    placed = valid & ~parked
    own = table[torch.clamp(s, 0, cap_table - 1)]
    assert bool((own[placed] == keys[placed]).all()), \
        "a row's slot holds another key"
    occupied = table[table != EMPTY]
    assert torch.unique(occupied).numel() == occupied.numel(), \
        "a key owns two slots"
    distinct = torch.unique(keys[valid])
    assert bool(torch.isin(occupied, distinct).all()), \
        "a slot holds a key no row has"
    n_distinct = distinct.numel()
    assert min(int(used), cap_table) == min(n_distinct, cap_table), \
        f"used={int(used)} but {n_distinct} distinct keys"
    assert occupied.numel() == min(n_distinct, cap_table), \
        f"{occupied.numel()} slots taken for {n_distinct} distinct keys"
    if n_distinct <= cap_table:
        assert not bool((valid & parked).any()), \
            "a row parked while the table had room"
