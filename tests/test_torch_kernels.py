"""The port's kernels on the CPU: each plain version against the JAX
package's Pallas kernel (interpret mode) and its jnp oracle, on the same
numpy inputs — ragged n, n = 0, every dtype the planner's spec takes,
K up to MAX_K.  Tolerances: integers exact; f64 rtol 1e-12 and f32
rtol 1e-5, since the summation order differs.  The join's kernels move
and count keys and sum nothing, so their plain versions must equal the
reference's jnp oracles exactly; ``hash_to_slot`` and ``group_build``
are held against ``impl="ref"`` only, since the reference's interpret
paths of those two do not run on the installed jax.  The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the wrappers'
CPU dispatch, counters, impl checks and launch shapes are held, and so
is the ``hash_to_slot`` contract checker the card's run relies on."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import filter_reduce as j_fr  # noqa: E402
from repro.kernels import hash_probe as j_hp  # noqa: E402
from repro.kernels import map_chain as j_mc  # noqa: E402
from repro.kernels import tiled_matmul as j_tm  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels import segment_reduce as j_sr  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import filter_reduce as t_fr  # noqa: E402
from repro_torch.kernels import hash_table as t_ht  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import segment_reduce as t_sr  # noqa: E402

FR_DTYPES = (np.float32, np.float64, np.int32, np.int64)   # filter_reduce_sum spec
VM_DTYPES = (np.float32, np.float64)                       # vecmerger spec
DG_DTYPES = (np.float32, np.float64, np.int32, np.int64)   # dict_group spec


def _vals(rng, shape, dtype):
    if np.issubdtype(dtype, np.integer):
        return rng.randint(-1000, 1000, shape).astype(dtype)
    return rng.randn(*shape).astype(dtype)


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 1e-5 if dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("n", [0, 1, 8 * 1024 + 3, 20_000])
@pytest.mark.parametrize("dtype", FR_DTYPES)
def test_filter_reduce_sum_plain(n, dtype):
    rng = np.random.RandomState(n)
    x = _vals(rng, (n,), dtype)
    pred = rng.rand(n) > 0.4
    got = t_ref.filter_reduce_sum(torch.from_numpy(x), torch.from_numpy(pred))
    assert got.dtype == torch.from_numpy(x).dtype and got.ndim == 0
    pallas = j_fr.filter_reduce_sum(jnp.asarray(x), jnp.asarray(pred),
                                    interpret=True)
    _close(got, pallas, dtype)
    _close(got, j_ref.filter_reduce_sum(jnp.asarray(x), jnp.asarray(pred)),
           dtype)


@pytest.mark.parametrize("a,n", [(1, 3001), (4, 9000), (5, 777), (4, 0)])
@pytest.mark.parametrize("dtype", FR_DTYPES)
def test_filter_reduce_sum_multi_plain(a, n, dtype):
    rng = np.random.RandomState(a * 100 + n)
    vals = _vals(rng, (a, n), dtype)
    pred = rng.rand(n) > 0.5
    got = t_ref.filter_reduce_sum_multi(torch.from_numpy(vals),
                                        torch.from_numpy(pred))
    pallas = j_fr.filter_reduce_sum_multi(jnp.asarray(vals),
                                          jnp.asarray(pred), interpret=True)
    _close(got, pallas, dtype)
    _close(got, j_ref.filter_reduce_sum_multi(jnp.asarray(vals),
                                              jnp.asarray(pred)), dtype)


@pytest.mark.parametrize("n,k", [(0, 8), (700, 13), (3001, 4096)])
@pytest.mark.parametrize("dtype", VM_DTYPES)
def test_segment_sum_plain(n, k, dtype):
    rng = np.random.RandomState(n + k)
    seg = rng.randint(0, k, n).astype(np.int32)
    vals = _vals(rng, (n,), dtype)
    got = t_ref.segment_sum(torch.from_numpy(seg), torch.from_numpy(vals), k)
    pallas = j_sr.segment_sum(jnp.asarray(seg), jnp.asarray(vals), k,
                              interpret=True)
    _close(got, pallas, dtype)
    _close(got, j_ref.segment_sum(jnp.asarray(seg), jnp.asarray(vals), k),
           dtype)


@pytest.mark.parametrize("n,k,d", [(0, 8, 2), (1000, 64, 2), (3001, 4096, 2),
                                   (513, 7, 3)])
@pytest.mark.parametrize("dtype", DG_DTYPES)
def test_segment_sum_vectors_plain(n, k, d, dtype):
    rng = np.random.RandomState(n + k + d)
    seg = rng.randint(0, k, n).astype(np.int32)
    vals = _vals(rng, (n, d), dtype)
    got = t_ref.segment_sum_vectors(torch.from_numpy(seg),
                                    torch.from_numpy(vals), k)
    pallas = j_sr.segment_sum_vectors(jnp.asarray(seg), jnp.asarray(vals), k,
                                      interpret=True)
    _close(got, pallas, dtype)
    _close(got, j_ref.segment_sum_vectors(jnp.asarray(seg), jnp.asarray(vals),
                                          k), dtype)


def test_segment_ids_out_of_range_are_dropped():
    seg = np.array([0, -1, 3, 5, 2], dtype=np.int32)
    vals = np.array([1.0, 10.0, 100.0, 1000.0, 7.0])
    got = t_ref.segment_sum(torch.from_numpy(seg), torch.from_numpy(vals), 4)
    want = j_ref.segment_sum(jnp.asarray(seg), jnp.asarray(vals), 4)
    _close(got, want, np.float64)


def test_cpu_tensors_take_the_plain_version_and_count_it():
    ops.reset_counts()
    x = torch.arange(10, dtype=torch.float64)
    p = x > 4
    assert float(ops.filter_reduce_sum(x, p)) == float(x[p].sum())
    ops.filter_reduce_sum_multi(torch.stack([x, x]), p)
    ops.segment_sum(torch.zeros(10, dtype=torch.int32), x, 3)
    ops.segment_sum_vectors(torch.zeros(10, dtype=torch.int32), x[:, None], 3)
    keys = torch.tensor([4, 1, 4], dtype=torch.int64)
    ops.hash_to_slot(keys, 16)
    ops.dict_probe(torch.tensor([1, 4]), 2, keys)
    ops.group_probe(torch.tensor([1, 4]), torch.tensor([0, 1, 3]), 2, keys)
    from repro_torch.kernels import group_build as t_gb

    t_gb.slot_hist(torch.tensor([0, 2, 2], dtype=torch.int32), 3)
    ops.matmul(torch.ones(3, 2, dtype=torch.float64),
               torch.ones(2, 1, dtype=torch.float64))
    ops.map_elementwise(lambda a: a * 2.0 + 1.0, [x])
    ops.filter_reduce_q6(torch.stack([x, x]), torch.tensor([1.0, 2.0]),
                         torch.tensor([5.0, 9.0]), x)
    ops.attention(torch.ones(2, 3, 8), torch.ones(1, 3, 8),
                  torch.ones(1, 3, 8), group=2)
    ops.adamw_update(torch.ones(5), torch.ones(5), torch.zeros(5),
                     torch.zeros(5), 1e-3, 1)
    assert ops.counts() == {name: (0, 1) for name in ops.WRAPPERS}
    ops.reset_counts()
    assert ops.counts() == {name: (0, 0) for name in ops.WRAPPERS}


def test_impl_must_match_the_device():
    x = torch.ones(4, dtype=torch.float64)
    p = torch.ones(4, dtype=torch.bool)
    assert float(ops.filter_reduce_sum(x, p, impl="ref")) == 4.0
    with pytest.raises(ValueError, match="cannot serve"):
        ops.filter_reduce_sum(x, p, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        ops.segment_sum(torch.zeros(4, dtype=torch.int32), x, 2,
                        impl="interpret")


def test_segment_wrapper_keeps_the_reference_size_rule():
    """A CPU tensor takes the plain version at any K, K > MAX_K included;
    the count says so.  On the card K > MAX_K runs on the kernel, a window
    of MAX_K keys a pass (tests/test_torch_cuda.py)."""
    ops.reset_counts()
    k = t_sr.MAX_K + 1
    seg = torch.tensor([0, k - 1], dtype=torch.int32)
    out = t_sr.segment_sum(seg, torch.tensor([1.0, 2.0]), k)
    assert out.shape == (k,) and float(out[k - 1]) == 2.0
    assert ops.counts()["segment_sum"] == (0, 1)
    ops.reset_counts()


@pytest.mark.parametrize("k,d,itemsize,replicas,tiles,per_sm", [
    (4096, 2, 8, 1, 25, 2), (4096, 1, 8, 1, 32, 2), (4096, 1, 4, 2, 32, 2),
    (64, 2, 8, 16, 32, 2), (4096, 4, 8, 1, 32, 1),
])
def test_segment_launch_shape(k, d, itemsize, replicas, tiles, per_sm):
    cfg = t_sr.launch_config(59_986_052, k, d, itemsize)
    assert (cfg.replicas, cfg.tiles, cfg.per_sm) == (replicas, tiles, per_sm)
    smem = t_sr.smem_bytes(k, d, itemsize, cfg.replicas, cfg.tiles)
    assert smem <= t_sr.SMEM_LIMIT
    assert per_sm * (smem + t_sr.BLOCK_RESERVED) <= t_sr.SMEM_PER_SM
    assert cfg.blocks == t_sr.SMS * per_sm
    assert t_sr.launch_config(100, k, d, itemsize).blocks == 1
    with pytest.raises(ValueError, match="accumulator"):
        t_sr.launch_config(10, 4096, 4, 16)
    with pytest.raises(ValueError, match="rows of 1 to"):
        t_sr.launch_config(10, 8, t_sr.MAX_D + 1, 8)


def test_segment_launch_holds_16_warps_an_sm_at_the_groupby_shape():
    """K = 4096, D = 2, f64 (B5): the warps an SM holds no longer shrink
    with K x D x itemsize (the first version held 3)."""
    cfg = t_sr.launch_config(59_986_052, 4096, 2, 8)
    assert cfg.warps_per_sm >= 16
    assert t_sr.WARPS % cfg.replicas == 0


@pytest.mark.parametrize("k,passes", [(1, 1), (4096, 1), (4097, 2),
                                      (20_000, 5), (50_000, 13)])
def test_segment_kernel_takes_any_k_in_windows(k, passes):
    assert t_sr.windows(k) == passes
    # each window's launch shape fits shared memory at the widest row
    for d, itemsize in ((2, 8), (t_sr.MAX_D, 8)):
        cfg = t_sr.launch_config(10, min(k, t_sr.MAX_K), d, itemsize)
        assert cfg.tiles >= t_sr.MIN_TILES and cfg.tiles % cfg.replicas == 0
        assert t_sr.smem_bytes(min(k, t_sr.MAX_K), d, itemsize, cfg.replicas,
                               cfg.tiles) <= t_sr.SMEM_LIMIT


def test_filter_reduce_grid_depends_only_on_n():
    assert t_fr.grid_blocks(1) == 1
    assert t_fr.grid_blocks(t_fr.THREADS * 4 * 3) == 3
    assert t_fr.grid_blocks(59_986_052) == t_fr.MAX_BLOCKS


def test_kernel_library_is_not_built_on_import():
    from repro_torch.kernels import map_chain as t_mc

    assert _build._lib is None
    assert not t_mc._libs
    for src in ("tiled_matmul.cu", "filter_reduce.cu"):
        assert _build.CSRC.joinpath(src).exists()
    for fn in ("weld_tiled_matmul", "weld_filter_reduce_q6"):
        assert fn in _build._C_SIGNATURES
    assert _build.CSRC.joinpath("filter_reduce.cu").exists()
    assert _build.CSRC.joinpath("segment_reduce.cu").exists()
    for src in ("hash_table.cu", "hash_probe.cu", "group_build.cu"):
        assert _build.CSRC.joinpath(src).exists()
    for fn in ("weld_hash_to_slot", "weld_dict_probe", "weld_group_probe",
               "weld_slot_hist"):
        assert fn in _build._C_SIGNATURES
        assert f'"C" int {fn}(' in "".join(
            p.read_text() for p in _build.CSRC.glob("*.cu"))


# ---------------------------------------------------------------------------
# the join's kernels: hash_to_slot, dict_probe, group_probe, slot_hist
# ---------------------------------------------------------------------------

EMPTY = t_ht.EMPTY


def _join_keys(rng, n, distinct, empty_share=0.0, spread=10**12):
    """n int64 keys drawn from `distinct` sparse values (negative ones
    included); a share of rows set to EMPTY."""
    pool = rng.randint(-spread, spread, distinct).astype(np.int64)
    keys = pool[rng.randint(0, distinct, n)] if n else pool[:0]
    keys[rng.rand(n) < empty_share] = EMPTY
    return keys


def _eq(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


HTS_CASES = [(0, 1, 16), (1, 1, 16), (500, 37, 128), (3001, 1500, 4096),
             (2000, 300, 256)]


@pytest.mark.parametrize("n,distinct,cap_table", HTS_CASES + [(900, 40, 16)])
def test_hash_to_slot_plain_matches_reference_ref(n, distinct, cap_table):
    """Plain version == the reference's oracle, EMPTY rows and a table
    smaller than the key set (parked rows) included."""
    rng = np.random.RandomState(n + distinct)
    keys = _join_keys(rng, n, distinct, empty_share=0.1)
    got = t_ref.hash_to_slot(torch.from_numpy(keys), cap_table)
    _eq(got, j_ref.hash_to_slot(jnp.asarray(keys), cap_table))
    t_ht.check_contract(torch.from_numpy(keys), cap_table, *got)


def _simulate_linear_probing(keys, cap_table):
    """Sequential linear probing from the Fibonacci hash, in row order —
    what the TPU kernel computes: slots are hash positions."""
    lg = cap_table.bit_length() - 1
    table = np.full(cap_table, EMPTY, np.int64)
    slots = np.full(keys.shape[0], cap_table, np.int32)
    used = 0
    for i, k in enumerate(keys.tolist()):
        if k == EMPTY:
            continue
        h = ((k % 2**64) * t_ht.GOLD % 2**64) >> (64 - lg)
        for _ in range(cap_table):
            if table[h] == EMPTY:
                table[h] = k
                used += 1
            if table[h] == k:
                slots[i] = h
                break
            h = (h + 1) & (cap_table - 1)
    return slots, table, np.asarray(used, np.int32)


@pytest.mark.parametrize("n,distinct,cap_table", HTS_CASES)
def test_contract_checker_accepts_hash_positions(n, distinct, cap_table):
    """The checker takes hash-position numbering (a numpy simulation of
    the kernel's linear probing), and compacting those slots gives the
    plain version's ascending-key ids bitwise — unless the table
    overflows (the last case), when which keys fit is the table's."""
    rng = np.random.RandomState(7 * n + distinct)
    keys = _join_keys(rng, n, distinct, empty_share=0.05)
    sim = [torch.from_numpy(a) for a in
           _simulate_linear_probing(keys, cap_table)]
    tk = torch.from_numpy(keys)
    t_ht.check_contract(tk, cap_table, *sim)
    plain_slots = t_ref.hash_to_slot(tk, cap_table)[0]
    if np.unique(keys[keys != EMPTY]).size <= cap_table:
        _eq([t_ht.compact_slots(sim[0], sim[1], cap_table)], [plain_slots])
    else:
        assert int(sim[2]) == cap_table


def _broken(kind):
    keys = torch.tensor([5, 9, 5, 12, EMPTY], dtype=torch.int64)
    slots, table, used = (torch.from_numpy(a) for a in
                          _simulate_linear_probing(keys.numpy(), 16))
    if kind == "shared slot":      # two distinct keys in one slot
        slots[1] = slots[0]
    elif kind == "wrong used":
        used = used + 1
    elif kind == "two slots":      # one key owns a second slot
        free = int(torch.nonzero(table == EMPTY)[0])
        table[free] = 5
        slots[2] = free
    elif kind == "stray key":      # a slot holds a key no row has
        table[int(torch.nonzero(table == EMPTY)[0])] = 77
    elif kind == "parked with room":
        slots[3] = 16
    elif kind == "empty placed":
        slots[4] = slots[0]
    return keys, slots, table, used


@pytest.mark.parametrize("kind", ["shared slot", "wrong used", "two slots",
                                  "stray key", "parked with room",
                                  "empty placed"])
def test_contract_checker_rejects_a_broken_table(kind):
    keys, slots, table, used = _broken(kind)
    with pytest.raises(AssertionError):
        t_ht.check_contract(keys, 16, slots, table, used)


def _probe_case(rng, cap, count, n):
    keys = np.sort(rng.choice(np.arange(-5000, 5000) * 7, cap,
                              replace=False)).astype(np.int64)
    queries = np.concatenate([keys[rng.randint(0, cap, n // 2)],
                              rng.randint(-40000, 40000, n - n // 2)])
    return keys, np.int64(count), queries.astype(np.int64)


PROBE_CASES = [(64, 64, 700), (365, 300, 3001), (1000, 0, 200),
               (50, -51, 300), (8, 8, 0)]


@pytest.mark.parametrize("cap,count,n", PROBE_CASES)
def test_dict_probe_plain(cap, count, n):
    """Equal to the reference's oracle and its Pallas kernel (interpret),
    a poisoned (negative) count and a stale tail past `count` included."""
    keys, cnt, q = _probe_case(np.random.RandomState(cap + n), cap, count, n)
    got = t_ref.dict_probe(torch.from_numpy(keys), torch.tensor(cnt),
                           torch.from_numpy(q))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    args = (jnp.asarray(keys), cnt, jnp.asarray(q))
    _eq(got, j_ref.dict_probe(*args))
    _eq(got, j_hp.dict_probe(*args, interpret=True))


@pytest.mark.parametrize("cap,count,n", PROBE_CASES)
def test_group_probe_plain(cap, count, n):
    rng = np.random.RandomState(cap * 3 + n)
    keys, cnt, q = _probe_case(rng, cap, count, n)
    offsets = np.concatenate([[0], np.cumsum(rng.randint(1, 6, cap))]
                             ).astype(np.int32)
    got = t_ref.group_probe(torch.from_numpy(keys), torch.from_numpy(offsets),
                            torch.tensor(cnt), torch.from_numpy(q))
    args = (jnp.asarray(keys), jnp.asarray(offsets), cnt, jnp.asarray(q))
    _eq(got, j_ref.group_probe(*args))
    _eq(got, j_hp.group_probe(*args, interpret=True))


@pytest.mark.parametrize("n,num_slots", [(0, 5), (1, 1), (5000, 4097),
                                         (3001, 65537)])
def test_slot_hist_plain(n, num_slots):
    """Counts per slot; ids outside [0, num_slots) are not counted."""
    rng = np.random.RandomState(n)
    slots = rng.randint(-2, num_slots + 2, n).astype(np.int32)
    got = t_ref.slot_hist(torch.from_numpy(slots), num_slots)
    keep = (slots >= 0) & (slots < num_slots)
    want = np.bincount(slots[keep], minlength=num_slots).astype(np.int32)
    _eq([got], [want])


@pytest.mark.parametrize("n,distinct,cap", [(0, 1, 8), (700, 50, 50),
                                            (3001, 800, 1000),
                                            (600, 90, 40)])
def test_group_build_plain_and_composite(n, distinct, cap):
    """The plain group build and the composite the wrappers run
    (hash_to_slot -> compaction -> slot_hist -> offsets) both equal the
    reference's oracle; the last case overflows (used > capacity)."""
    rng = np.random.RandomState(n + cap)
    keys = _join_keys(rng, n, distinct, empty_share=0.1)
    want = j_ref.group_build(jnp.asarray(keys), cap)
    _eq(t_ref.group_build(torch.from_numpy(keys), cap), want)
    got = ops.group_build(torch.from_numpy(keys), cap)
    if n and distinct > cap:
        # overflow: both report it; which keys fit is the hash table's
        _eq(got[2:], want[2:])
        assert int(got[2]) > cap
    else:
        _eq(got, want)


@pytest.mark.parametrize("n,distinct,cap", [(1000, 0, 16), (1, 0, 4),
                                            (900, 40, 8), (30, 7, 1)])
def test_join_builds_plain_on_all_empty_and_full_tables(n, distinct, cap):
    """The build side's plain versions against the JAX oracles where every
    row is EMPTY (distinct = 0) or the keys overflow the table: the
    hash_to_slot oracle at table_size(cap), its own minimum table 2 * cap
    rounded up (full: rows park, ``used`` past the table), the group
    build, and slot_hist against the oracle's CSR counts."""
    rng = np.random.RandomState(n + distinct + cap)
    keys = (_join_keys(rng, n, distinct) if distinct
            else np.full(n, EMPTY, np.int64))
    tk, jk = torch.from_numpy(keys), jnp.asarray(keys)
    for ctab in (t_ht.table_size(cap), max(2, 1 << (2 * cap - 1).bit_length())):
        got = t_ref.hash_to_slot(tk, ctab)
        _eq(got, j_ref.hash_to_slot(jk, ctab))
        t_ht.check_contract(tk, ctab, *got)
    want = j_ref.group_build(jk, cap)
    got = t_ref.group_build(tk, cap)
    _eq(got, want)
    counts = t_ref.slot_hist(got[0], cap + 1)[:cap]
    _eq([counts], [np.diff(np.asarray(want[1]))])
    assert int(got[2]) == np.unique(keys[keys != EMPTY]).size


# ---------------------------------------------------------------------------
# the array path's kernels: tiled_matmul, map_elementwise, filter_reduce_q6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (70, 33, 90), (300, 64, 1),
                                   (257, 130, 3), (5, 0, 4)])
@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_tiled_matmul_plain(m, k, n, dtype):
    """The plain product against the TPU kernel in interpret mode (ragged
    tiles on every side, the matvec shape n = 1) and its jnp oracle (an
    empty k too, which the interpret mode cannot slice)."""
    rng = np.random.RandomState(m + k + n)
    a = rng.randn(m, k).astype(dtype)
    b = rng.randn(k, n).astype(dtype)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(a).dtype
    if k:
        want = j_tm.tiled_matmul(jnp.asarray(a), jnp.asarray(b),
                                 interpret=True)
        _close(got, want, dtype)
    _close(got, j_ref.tiled_matmul(jnp.asarray(a), jnp.asarray(b)), dtype)


def _view(dtype, m, k, offset_bytes):
    """A contiguous (m, k) CPU view ``offset_bytes`` into a buffer that
    starts on 64 bytes."""
    e = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(m * k + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64 + offset_bytes) // e
    return buf[skip:skip + m * k].view(m, k)


@pytest.mark.parametrize("dtype,m,k,n,offset,want", [
    (torch.float64, 4_194_304 // 64, 64, 1, 0, "rows_bulk"),  # logreg
    (torch.float32, 4_194_304 // 64, 64, 1, 0, "rows_bulk"),
    (torch.float64, 65, 64, 1, 0, "rows_bulk"),  # a partial last tile
    (torch.float64, 63, 64, 1, 0, "rows_bulk"),  # no full tile
    (torch.float64, 7, 33, 1, 0, "rows_bulk"),   # k odd
    (torch.float64, 10, 128, 1, 0, "rows_bulk"),  # 1,024-byte rows
    (torch.float64, 10, 129, 1, 0, "rows_warp"),  # past a stage
    (torch.float32, 10, 256, 1, 0, "rows_bulk"),
    (torch.float32, 10, 257, 1, 0, "rows_warp"),
    (torch.float64, 10, 64, 1, 8, "rows_warp"),   # 8 bytes off 16
    (torch.float32, 10, 64, 1, 4, "rows_warp"),
    (torch.float32, 10, 64, 1, 16, "rows_bulk"),  # a view on 16 bytes
    (torch.float64, 10, 64, 2, 0, "tiles"),
    (torch.float64, 10, 64, 2, 8, "tiles"),
])
def test_tiled_matmul_plan_picks_the_launch_by_shape_and_alignment(
        dtype, m, k, n, offset, want):
    """The launch a product takes is named before it, from the operands'
    shape and alignment alone: the bulk row launch for n = 1 where A
    starts on 16 bytes and a 64-row tile of it fits a stage, the warp
    row launch for every other n = 1, the tiles for n > 1."""
    from repro_torch.kernels import tiled_matmul as t_tm

    a = _view(dtype, m, k, offset)
    b = torch.zeros((k, n), dtype=dtype)
    assert a.is_contiguous() and a.data_ptr() % 16 == offset % 16
    assert t_tm.plan(a, b) == want


def test_tiled_matmul_plan_reads_the_kernels_own_limits():
    """:data:`MAX_BULK_ROW_BYTES` is the C ring's ``kMaxBulkRowBytes`` (a
    64-row tile in one stage of the smallest ring) and ``LAUNCH_CODES`` the
    C entry's launch codes, both read from the source the library is
    built from."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import tiled_matmul as t_tm

    consts = {}
    src = (_build.CSRC / "tiled_matmul.cu").read_text()
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    assert consts["kMaxBulkRowBytes"] == t_tm.MAX_BULK_ROW_BYTES
    assert {"tiles": consts["kLaunchTiles"],
            "rows_bulk": consts["kLaunchRowsBulk"],
            "rows_warp": consts["kLaunchRowsWarp"]} == t_tm.LAUNCH_CODES


#: (jnp body, torch body) pairs: the same elementwise function written
#: once per package (a map body with no captured constants, which the
#: TPU kernel's interpret mode requires)
MAP_BODIES = {
    "exp_affine": (lambda a, b: jnp.exp(a * 2.0) + b,
                   lambda a, b: torch.exp(a * 2.0) + b),
    "blend": (lambda a, b: jnp.where(a > b, a * b, a - b),
              lambda a, b: torch.where(a > b, a * b, a - b)),
    "sqrt_ratio": (lambda a, b: jnp.sqrt(a * a + b * b) / (1.0 + a * a),
                   lambda a, b: torch.sqrt(a * a + b * b) / (1.0 + a * a)),
}


@pytest.mark.parametrize("n", [0, 1, 8 * 1024 + 3, 20_000])
@pytest.mark.parametrize("body", sorted(MAP_BODIES))
@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_map_elementwise_plain(n, body, dtype):
    jfn, tfn = MAP_BODIES[body]
    rng = np.random.RandomState(n + 7)
    a = rng.randn(n).astype(dtype)
    b = rng.randn(n).astype(dtype)
    got = ops.map_elementwise(tfn, [torch.from_numpy(a), torch.from_numpy(b)])
    want = j_mc.map_elementwise(jfn, [jnp.asarray(a), jnp.asarray(b)],
                                interpret=True)
    _close(got, want, dtype)
    _close(got, j_ref.map_elementwise(jfn, [a, b]), dtype)


def test_map_elementwise_plain_broadcasts_a_constant_body():
    x = np.arange(5, dtype=np.float64)
    got = t_ref.map_elementwise(
        lambda a: torch.tensor(3.0, dtype=torch.float64),
        [torch.from_numpy(x)])
    want = j_ref.map_elementwise(lambda a: jnp.float64(3.0), [x])
    _close(got, want, np.float64)


@pytest.mark.parametrize("k,n", [(1, 1), (3, 3001), (3, 8 * 1024 + 5),
                                 (2, 0), (8, 700)])
@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_filter_reduce_q6_plain(k, n, dtype):
    """Integer-valued columns and values: the sums are exact in both
    packages whatever the order, so they must be equal (n = 0 against
    the jnp oracle only)."""
    rng = np.random.RandomState(k * 1000 + n)
    cols = rng.randint(0, 100, (k, n)).astype(dtype)
    lo = rng.randint(0, 40, k).astype(dtype)
    hi = (lo + rng.randint(20, 70, k)).astype(dtype)
    val = rng.randint(-50, 50, n).astype(dtype)
    got = ops.filter_reduce_q6(*(torch.from_numpy(v)
                                 for v in (cols, lo, hi, val)))
    if n:  # the interpret mode cannot slice an empty column
        want = j_fr.filter_reduce_q6(
            *(jnp.asarray(v) for v in (cols, lo, hi, val)), interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(j_ref.filter_reduce_q6(cols, lo, hi, val)))


def test_array_wrappers_refuse_what_their_kernels_do_not_take():
    """The CUDA-side argument checks run before any launch; on a CPU
    machine they are reached through a tensor that claims another device
    only on the card, so here the dtype/shape checks of the Q6 and matmul
    wrappers are held on the meta device."""
    meta = torch.device("meta")
    a = torch.empty((4, 3), dtype=torch.float64, device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_fr.filter_reduce_q6(a, a[:, 0], a[:, 0], a[0])
    from repro_torch.kernels import tiled_matmul as t_tm

    with pytest.raises(ValueError, match="CUDA tensors"):
        t_tm.tiled_matmul(a, a.T)
