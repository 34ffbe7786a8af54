"""The array path's kernels on the card: the generated map chain on every
generator case (``torch_mapchain_cases.py``), ``tiled_matmul`` on ragged
shapes (f32 also on rows that start on 4 bytes and at 4096^3; both row
launches around their edges and at the logreg width), the join's
probes (``group_probe``, ``dict_probe``) at every count around the
splitter strides, the join's builds (``hash_to_slot`` held to
``hash_table.check_contract`` with its compacted slots equal to the plain
version's, ``slot_hist`` equal to its plain version, on empty, one-key,
colliding and overflowing inputs), ``filter_reduce_q6`` on exact data and the segment kernel
(``segment_sum``, ``segment_sum_vectors``) on uniform, one-key and Zipf
keys, K past MAX_K (its windows), every D and dtype, each against its plain
version on the same CUDA tensors; the LM's ``flash_attention`` against
``ref.attention`` on both of its routes (every bf16 call with D in
{64, 128} counted on the Hopper route, ``.launches_sm90``, the rest on
v1); and the training path: ``fused_adamw`` against
``ref.adamw_update`` for every p/g dtype pair, the attention's gradient
through ``FlashAttention`` against plain autograd (causal, and without
the mask at Sq below and past Skv), two ``train`` steps of a smoke
config on the card against the same on the CPU, and one
``build_train_step`` step of each other family's smoke config; the mesh path at world 1 (an
NCCL group of one rank) against the single-device path, and
``compressed_psum`` through NCCL.

These tests need a CUDA card and ``nvcc``; without one they skip (the
CPU tests hold the same arithmetic through the plain versions and the
host-compiled generated source).  Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: "bitwise" and "sqrt" cases must equal the plain version
bitwise (built with -fmad=false; PyTorch's CUDA operators round each
step as IEEE does), "libm" cases f64 rtol 1e-12 and f32 rtol 1e-5
(CUDA's and PyTorch's transcendental paths may differ in the last
bits), integers and bools exactly; products f64 rtol 1e-12 and f32 rtol
1e-5 of the largest magnitude (another summation order); the f64 tile
launch on DMMA over edge shapes, 8-byte-aligned rows and more than
65,535 x 64 columns within 1e-10 of the largest element (the limit
``chip_smoke.py`` holds it to), and bitwise equal across runs; the f32
tile launch bitwise equal across runs and each element within the
rounding bound of a k-term f32 dot product with fused multiply-adds,
gamma_k (|A| |B|), gamma_k = k u / (1 - k u), u = 2**-24, of the exact
(f64) product of the same inputs.  The probes: equal to the plain
version exactly, and so are the builds.  Attention:
the per-element limit of ``flash_attention.tolerance`` — f32 rtol 2e-4,
atol 2e-5 (the JAX package's own kernel test); bf16 2**-7 |plain| (both
sides round their f32 result to bf16: one bf16 step apart at most) plus
2**-6 R, R = sqrt(sum_j w_j**2 v_j**2) over the row's softmax weights w
(the kernel rounds p to bf16 before the PV product, the TPU kernel's
cast, which the plain version does not make: up to 2**-8 of each
weight).  With q and k at 0.5 N(0, 1) the softmax rows are nearly
uniform, so a row's values are about (its keys)**-0.5 in size; the
limit shrinks with them.  fused_adamw: m, v and an f32 p to rtol 2e-5,
atol 1e-7 (the JAX package's kernel test), a bf16 p within one bf16 step
(both round an f32 result); two launches bitwise equal.  The attention's
gradient equals plain autograd through ``ref.chunked_attention`` bitwise
(the backward recomputes with it) and autograd through ``ref.attention``
to f32 rtol 1e-4, atol 1e-5 (bf16: 2**-6 of the largest gradient).  The
smoke train steps: losses to rtol 1e-5, parameters to atol 1e-6 (the CPU
tests' limits against the JAX step).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import filter_reduce as t_fr
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import fused_adamw as t_aw
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import map_chain as t_mc
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import segment_reduce as t_sr
from repro_torch.kernels import tiled_matmul as t_tm
from torch_mapchain_cases import GEN_CASES, column, gen_lambda, plain_env

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _private_autotune_cache(tmp_path, monkeypatch):
    """Tunings made on the card by a test go to a private cache file."""
    monkeypatch.setenv("WELD_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # build every case's generated kernel up front, several at a time
    from concurrent.futures import ThreadPoolExecutor

    def build(name):
        cols, fn, _, _ = GEN_CASES[name]
        t_mc.library_for(t_mc.source_for(gen_lambda(cols, fn)))

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(build, sorted(GEN_CASES)))
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(GEN_CASES))
def test_generated_kernel_matches_the_plain_version(name, card):
    cols, fn, exact, scalars = GEN_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    n = 100_003
    data = [torch.from_numpy(np.ascontiguousarray(column(rng, dt, n, kind)))
            .to(card) for dt, kind in cols]
    env = plain_env(scalars, card)
    lam = gen_lambda(cols, fn)
    plain = t_mc.stage_plain(lam, env, card)
    want = t_ref.map_elementwise(plain, data)
    before = t_mc.map_elementwise.launches
    got = t_mc.map_elementwise(plain, data, lam=lam, env=env)
    again = t_mc.map_elementwise(plain, data, lam=lam, env=env)
    torch.cuda.synchronize()
    assert t_mc.map_elementwise.launches == before + 2
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(again.cpu().numpy().view(np.uint8),
                                  g.view(np.uint8))
    if exact == "exact" or w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w)
    elif exact in ("bitwise", "sqrt"):
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan)
        ui = np.uint64 if w.dtype == np.float64 else np.uint32
        np.testing.assert_array_equal(g[~nan].view(ui), w[~nan].view(ui))
    else:
        rtol = 1e-5 if w.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol,
                                   equal_nan=True)


def test_generated_kernel_on_an_empty_column(card):
    cols, fn, _, _ = GEN_CASES["arith_f64"]
    lam = gen_lambda(cols, fn)
    data = [torch.zeros(0, dtype=torch.float64, device=card)] * 2
    out = t_mc.map_elementwise(t_mc.stage_plain(lam, {}, card), data,
                               lam=lam)
    assert out.shape == (0,) and out.dtype == torch.float64


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (70, 33, 90), (300, 64, 1),
                                   (257, 130, 3), (1000, 17, 1),
                                   (129, 4, 200)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_tiled_matmul_matches_the_plain_version(m, k, n, dtype, card):
    gen = torch.Generator(device=card)
    gen.manual_seed(m * 7 + k * 3 + n)
    a = torch.randn((m, k), generator=gen, device=card, dtype=dtype)
    b = torch.randn((k, n), generator=gen, device=card, dtype=dtype)
    got, again = t_tm.tiled_matmul(a, b), t_tm.tiled_matmul(a, b)
    want = t_ref.tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    err = float((got - want).abs().max())
    assert err <= rtol * max(float(want.abs().max()), 1.0) * k


EDGES = (1, 7, 16, 17, 127, 128, 129, 1000)


def _held_product(got, again, want):
    """Bitwise repeatable, and within 1e-10 of the largest element of the
    plain product (f64 on DMMA sums in another order than the plain
    version's library call)."""
    assert torch.equal(got, again)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1e-10 * max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("m", EDGES)
def test_tiled_matmul_f64_edges(m, card):
    """Every (m, n, k) over the edge sizes: ragged block tiles (128), odd k
    and n (rows that start on 8 bytes: the 8-byte copy path), k not a
    multiple of the 32-deep slab."""
    gen = torch.Generator(device=card)
    gen.manual_seed(m)
    for n in EDGES:
        for k in EDGES:
            a = torch.randn((m, k), generator=gen, device=card,
                            dtype=torch.float64)
            b = torch.randn((k, n), generator=gen, device=card,
                            dtype=torch.float64)
            got, again = t_tm.tiled_matmul(a, b), t_tm.tiled_matmul(a, b)
            _held_product(got, again, t_ref.tiled_matmul(a, b))


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_tiled_matmul_on_8_byte_aligned_operands(dtype, card):
    """Contiguous views one element into their storage: even k and n, but
    the rows start on 8 bytes, so the 16-byte copies must not be taken."""
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    m, k, n = 130, 64, 258
    a = torch.randn(m * k + 1, generator=gen, device=card,
                    dtype=dtype)[1:].view(m, k)
    b = torch.randn(k * n + 1, generator=gen, device=card,
                    dtype=dtype)[1:].view(k, n)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    got, again = t_tm.tiled_matmul(a, b), t_tm.tiled_matmul(a, b)
    want = t_ref.tiled_matmul(a, b)
    if dtype == torch.float64:
        _held_product(got, again, want)
    else:
        assert torch.equal(got, again)
        assert float((got - want).abs().max()) <= \
            1e-5 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_tiled_matmul_past_the_grid_y_limit(dtype, card):
    """m = 1 and more than 65,535 x 64 columns: the tile launches index
    their tiles on a 1-D grid."""
    gen = torch.Generator(device=card)
    gen.manual_seed(9)
    n = 65_535 * 64 + 3
    a = torch.randn((1, 3), generator=gen, device=card, dtype=dtype)
    b = torch.randn((3, n), generator=gen, device=card, dtype=dtype)
    before = t_tm.tiled_matmul.launches
    got, again = t_tm.tiled_matmul(a, b), t_tm.tiled_matmul(a, b)
    assert t_tm.tiled_matmul.launches == before + 2
    want = t_ref.tiled_matmul(a, b)
    assert torch.equal(got, again)
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    assert float((got - want).abs().max()) <= \
        rtol * max(float(want.abs().max()), 1.0)


def test_tiled_matmul_f64_square_is_bitwise_repeatable(card):
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    a = torch.rand((1024, 1536), generator=gen, device=card,
                   dtype=torch.float64)
    b = torch.rand((1536, 2048), generator=gen, device=card,
                   dtype=torch.float64)
    runs = [t_tm.tiled_matmul(a, b) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    _held_product(runs[0], runs[1], t_ref.tiled_matmul(a, b))


def test_tiled_matmul_refuses_a_non_contiguous_operand(card):
    a = torch.ones((64, 32), device=card, dtype=torch.float64)
    b = torch.ones((64, 32), device=card, dtype=torch.float64)
    before = t_tm.tiled_matmul.launches
    with pytest.raises(ValueError, match="contiguous"):
        t_tm.tiled_matmul(a, b.t())
    assert t_tm.tiled_matmul.launches == before


def _held_f32(got, again, a, b):
    """Bitwise repeatable, and each element within the f32 rounding bound
    of a k-term dot product with fused multiply-adds, gamma_k (|A| |B|),
    gamma_k = k u / (1 - k u), u = 2**-24, of the exact product (the f64
    product of the same f32 inputs)."""
    assert torch.equal(got, again)
    assert got.dtype == torch.float32 and got.shape == (a.shape[0],
                                                        b.shape[1])
    k = a.shape[1]
    ku = k * 2.0 ** -24
    exact = a.double() @ b.double()
    bound = ku / (1 - ku) * (a.double().abs() @ b.double().abs())
    assert bool(((got.double() - exact).abs() <= bound).all()), \
        float(((got.double() - exact).abs() / bound.clamp_min(1e-300)).max())


@pytest.mark.parametrize("m", EDGES)
def test_tiled_matmul_f32_edges(m, card):
    """The f32 tile launch over the edge sizes: ragged 128 x 128 tiles, k
    not a multiple of the 8-deep slab, k or n not a multiple of 4 (rows
    that start on 4 bytes: the 4-byte copies), within the rounding bound
    of the exact product."""
    gen = torch.Generator(device=card)
    gen.manual_seed(m + 1)
    for n in EDGES[1:]:  # n = 1 is the row launch
        for k in EDGES:
            a = torch.randn((m, k), generator=gen, device=card)
            b = torch.randn((k, n), generator=gen, device=card)
            got, again = t_tm.tiled_matmul(a, b), t_tm.tiled_matmul(a, b)
            _held_f32(got, again, a, b)


@pytest.mark.parametrize("m,k,n", [(131, 13, 257), (255, 1001, 130),
                                   (1000, 999, 1003), (4099, 517, 4101),
                                   (2, 4096, 3)])
@pytest.mark.parametrize("offset", (0, 1, 2, 3))
def test_tiled_matmul_f32_on_ragged_and_4_byte_aligned_rows(m, k, n, offset,
                                                            card):
    """Ragged m, n, k (no multiple of 128, 16 or 4) and views 1-3 floats
    into their storage, whose rows start on 4 bytes."""
    gen = torch.Generator(device=card)
    gen.manual_seed(m + k + n + offset)
    a = torch.randn(m * k + offset, generator=gen,
                    device=card)[offset:].view(m, k)
    b = torch.randn(k * n + offset, generator=gen,
                    device=card)[offset:].view(k, n)
    got, again = t_tm.tiled_matmul(a, b), t_tm.tiled_matmul(a, b)
    _held_f32(got, again, a, b)


#: (m, k, base offset in bytes, the launch plan picks in f32, in f64): m
#: below, at and just above the 64-row bulk tile, m not a multiple of it,
#: k odd with m odd (the partial last tile's rows start anywhere), rows
#: past the 1,024 bytes a bulk stage takes a row, and a base 8 bytes off
#: 16
ROW_CASES = [
    (1, 1, 0, "rows_bulk", "rows_bulk"),
    (63, 64, 0, "rows_bulk", "rows_bulk"),
    (64, 64, 0, "rows_bulk", "rows_bulk"),
    (65, 64, 0, "rows_bulk", "rows_bulk"),
    (1000, 64, 0, "rows_bulk", "rows_bulk"),
    (4099, 33, 0, "rows_bulk", "rows_bulk"),
    (777, 127, 0, "rows_bulk", "rows_bulk"),
    (200_003, 64, 0, "rows_bulk", "rows_bulk"),
    (1001, 129, 0, "rows_bulk", "rows_warp"),
    (300, 300, 0, "rows_warp", "rows_warp"),
    (1000, 64, 8, "rows_warp", "rows_warp"),
    (4099, 33, 8, "rows_warp", "rows_warp"),
]


def _row_operands(card, dtype, m, k, offset_bytes, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    skip = offset_bytes // torch.tensor([], dtype=dtype).element_size()
    a = torch.randn(m * k + skip, generator=gen, device=card,
                    dtype=dtype)[skip:].view(m, k)
    x = torch.randn((k, 1), generator=gen, device=card, dtype=dtype)
    return a, x


@pytest.mark.parametrize("m,k,offset,f32_launch,f64_launch", ROW_CASES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_tiled_matmul_row_launches(m, k, offset, f32_launch, f64_launch,
                                   dtype, card):
    """Both row launches (n = 1) at the shapes around their edges: the
    launch ``plan`` names, bitwise equal twice, f64 within 1e-10 of the
    largest element and f32 within the rounding bound of the exact
    product."""
    a, x = _row_operands(card, dtype, m, k, offset, m + k + offset)
    want = f32_launch if dtype == torch.float32 else f64_launch
    assert t_tm.plan(a, x) == want
    before = t_tm.tiled_matmul.launches
    got, again = t_tm.tiled_matmul(a, x), t_tm.tiled_matmul(a, x)
    torch.cuda.synchronize()
    assert t_tm.tiled_matmul.launches == before + 2
    if dtype == torch.float64:
        _held_product(got, again, t_ref.tiled_matmul(a, x))
    else:
        _held_f32(got, again, a, x)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_tiled_matmul_rows_at_the_logreg_width_are_bitwise_repeatable(
        dtype, card):
    """The logreg matvec (k = 64) at a sixteenth of its 4,194,304 rows on
    the bulk launch: three runs bitwise equal, within the limit that
    ``chip_smoke.py`` holds the full shape to."""
    a, x = _row_operands(card, dtype, 262_144, 64, 0, 21)
    assert t_tm.plan(a, x) == "rows_bulk"
    runs = [t_tm.tiled_matmul(a, x) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    want = t_ref.tiled_matmul(a, x)
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    assert float((runs[0] - want).abs().max()) <= \
        rtol * max(float(want.abs().max()), 1.0)


def test_tiled_matmul_f32_square_is_bitwise_repeatable(card):
    """4096^3 in f32, three runs bitwise equal and within the rounding
    bound; the plain version (torch.matmul, full f32) within it too."""
    gen = torch.Generator(device=card)
    gen.manual_seed(13)
    a = torch.rand((4096, 4096), generator=gen, device=card)
    b = torch.rand((4096, 4096), generator=gen, device=card)
    before = t_tm.tiled_matmul.launches
    runs = [t_tm.tiled_matmul(a, b) for _ in range(3)]
    assert t_tm.tiled_matmul.launches == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    _held_f32(runs[0], runs[1], a, b)
    want = t_ref.tiled_matmul(a, b)
    _held_f32(want, want, a, b)


# -- the probes (B7 dict_probe, B9 group_probe) ------------------------------

#: counts around the splitter strides (S = 1 up to 4,096 keys, 2 to
#: 8,192, ... 16 at 65,536), a poisoned build (negative), an empty one
PROBE_COUNTS = (-3, 0, 1, 2, 15, 16, 17, 4095, 4096, 4097, 8191, 8192, 8193,
                50_000, 65_535, 65_536)


def _probe_inputs(count, dev, cap=65_536):
    """A cap-key table (sorted distinct keys, multiples of 3 below zero and
    above, then a stale unsorted tail past count), offsets with empty and
    large groups, and queries equal to, between, below and above every
    valid key, the int64 extremes and random keys."""
    rng = np.random.RandomState(count + 7)
    keys = np.sort(rng.choice(np.arange(-200_000, 200_000), cap,
                              replace=False)).astype(np.int64) * 3
    c = min(max(count, 0), cap)
    keys[c:] = rng.randint(-10**9, 10**9, cap - c)
    sizes = rng.choice([0, 1, 2, 5, 40], cap, p=[0.2, 0.4, 0.2, 0.15, 0.05])
    sizes[rng.randint(0, cap, 8)] = 5_000_000
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    valid = keys[:c]
    lo, hi = (valid[0], valid[-1]) if c else (0, 0)
    queries = np.concatenate([
        valid, valid + 1, valid - 1, [lo - 5, hi + 5, lo - 3, hi + 3],
        [np.iinfo(np.int64).min, np.iinfo(np.int64).max],
        rng.randint(-700_000, 700_000, 300_001)]).astype(np.int64)
    rng.shuffle(queries)
    count = np.asarray(count, dtype=np.int64)
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (keys, offsets, count, queries))


@pytest.mark.parametrize("count", PROBE_COUNTS)
@pytest.mark.parametrize("probe", ("group_probe", "dict_probe"))
def test_probe_kernel_equals_the_plain_version(probe, count, card):
    """Exactly the plain version's (pos, found[, sizes]), bitwise the same
    twice, launched twice, at every count around the splitter strides."""
    from repro_torch.kernels import hash_probe as t_hp

    keys, offsets, cnt, queries = _probe_inputs(count, card)
    fn = getattr(t_hp, probe)
    args = ((keys, offsets, cnt, queries) if probe == "group_probe"
            else (keys, cnt, queries))
    before = (fn.launches, fn.plain_calls)
    got, again = fn(*args), fn(*args)
    want = getattr(t_ref, probe)(*args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.plain_calls) == (before[0] + 2, before[1])
    for g, r, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, r)
        assert torch.equal(g, w)
    if 0 < count:
        assert int(got[1].sum()) >= min(count, 65_536)  # every key found


@pytest.mark.parametrize("cap,count", [(1, 1), (5, 3), (4097, 4097),
                                       (16, 16), (70_000, 70_000)])
def test_group_probe_on_small_and_odd_tables(cap, count, card):
    """Tables that are not MAX_CAP long: one key, a stale tail, one key
    past a stride, a count past 65,536 (S = 32)."""
    from repro_torch.kernels import hash_probe as t_hp

    keys, offsets, cnt, queries = _probe_inputs(count, card, cap=cap)
    got = t_hp.group_probe(keys, offsets, cnt, queries)
    again = t_hp.group_probe(keys, offsets, cnt, queries)
    want = t_ref.group_probe(keys, offsets, cnt, queries)
    for g, r, w in zip(got, again, want):
        assert torch.equal(g, r) and torch.equal(g, w)


# -- the join's builds (B6 hash_to_slot, B8 slot_hist) -----------------------

_EMPTY = np.iinfo(np.int64).min


def _first_probe(keys, cap_table):
    """The slot each key's linear probe starts at: the high log2(cap_table)
    bits of uint64(key) * GOLD."""
    lg = cap_table.bit_length() - 1
    prod = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return (prod >> np.uint64(64 - lg)).astype(np.int64)


def _colliding_keys(rng):
    """Keys whose first probes all fall on two adjacent slots of a
    1,024-slot table, each three times, shuffled: long probe chains."""
    pool = rng.randint(-10**15, 10**15, 400_000).astype(np.int64)
    pool = np.unique(pool[np.isin(_first_probe(pool, 1024), (5, 6))])
    keys = np.repeat(pool, 3)
    rng.shuffle(keys)
    return keys, 1024


#: name -> rng -> (int64 keys, cap_table)
HASH_CASES = {
    "n0": lambda rng: (np.zeros(0, np.int64), 16),
    "n1": lambda rng: (np.array([42], np.int64), 16),
    "n257": lambda rng: (rng.randint(-300, 300, 257).astype(np.int64), 1024),
    "all_empty": lambda rng: (np.full(1000, _EMPTY, np.int64), 64),
    "one_key_1m": lambda rng: (np.full(1_000_000, -7, np.int64), 16),
    "partsupp": lambda rng: (np.repeat(np.arange(1, 50_001, dtype=np.int64),
                                       4), 131_072),
    "random_2p17": lambda rng: (np.concatenate([
        rng.randint(_EMPTY + 1, np.iinfo(np.int64).max, 60_000,
                    dtype=np.int64), [_EMPTY] * 100]), 2**17),
    "first_probes_collide": _colliding_keys,
    "full_table": lambda rng: (rng.randint(0, 5_000, 20_000).astype(np.int64),
                               1024),
    "cap2": lambda rng: (np.array([9, _EMPTY, 9, -9], np.int64), 2),
    "cap2_full": lambda rng: (np.array([1, 2, 3, 2, 1, _EMPTY, 4], np.int64),
                              2),
    # one block's shared-memory table at its most rows and slots
    "n512_4096_slots": lambda rng: (rng.randint(0, 400, 512)
                                    .astype(np.int64), 4096),
    # more rows than one pass of the grid the card holds at once
    "rows_past_one_pass": lambda rng: (rng.randint(0, 100_000, 3_000_000)
                                       .astype(np.int64), 2**18),
    # the m:1 join's dimension table: yyyymmdd keys of 1993, 1,024 slots
    "dates_1993": lambda rng: (np.array(
        [int(d.strftime("%Y%m%d")) for d in
         (np.datetime64("1993-01-01") + np.arange(365)).astype(object)],
        np.int64), 1024),
}


@pytest.mark.parametrize("case", sorted(HASH_CASES) + ["view_off_16_bytes"])
def test_hash_to_slot_kernel_holds_the_contract(case, gpu):
    """Both kernels (in one block's shared memory up to 512 rows and 4,096
    slots, else behind a grid barrier) hold ``check_contract`` twice,
    launched twice;
    where the distinct keys fit, the compacted slots equal the plain
    version's bitwise in both runs.  A full table parks the rows it cannot
    place and counts ``used`` up to ``cap_table``."""
    from repro_torch.kernels import hash_table as t_ht

    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "view_off_16_bytes":  # keys start 8 bytes past 16
        keys, cap = HASH_CASES["partsupp"](rng)
        base = torch.from_numpy(np.concatenate([[0], keys])).to(gpu)
        k = base[1:]
        assert k.data_ptr() % 16 == 8
    else:
        keys, cap = HASH_CASES[case](rng)
        k = torch.from_numpy(keys).to(gpu)
    before = (t_ht.hash_to_slot.launches, t_ht.hash_to_slot.plain_calls)
    got, again = t_ht.hash_to_slot(k, cap), t_ht.hash_to_slot(k, cap)
    want = t_ref.hash_to_slot(k, cap)
    torch.cuda.synchronize()
    n = k.shape[0]
    assert (t_ht.hash_to_slot.launches, t_ht.hash_to_slot.plain_calls) == (
        before[0] + (2 if n else 0), before[1])
    distinct = torch.unique(k[k != _EMPTY]).numel()
    for out in (got, again):
        t_ht.check_contract(k, cap, *out)
        if distinct <= cap:
            assert int(out[2]) == distinct
            assert torch.equal(t_ht.compact_slots(out[0], out[1], cap),
                               want[0])
        else:
            assert int(out[2]) == cap
            assert int((out[0] == cap).sum()) > 0


#: name -> rng -> (int32 slot ids, num_slots)
HIST_CASES = {
    "n0": lambda rng: (np.zeros(0, np.int32), 5),
    "n1": lambda rng: (np.array([3], np.int32), 5),
    "n257": lambda rng: (rng.randint(0, 40, 257).astype(np.int32), 41),
    "outside_the_range": lambda rng: (
        rng.randint(-70_000, 70_000, 300_001).astype(np.int32), 65_537),
    "one_id_1m": lambda rng: (np.full(1_000_000, 11, np.int32), 65_537),
    "partsupp": lambda rng: (np.repeat(np.arange(50_000, dtype=np.int32), 4),
                             50_001),
    "random_65537": lambda rng: (rng.randint(0, 65_537, 1_000_003)
                                 .astype(np.int32), 65_537),
    "one_slot": lambda rng: (rng.randint(-1, 2, 10_000).astype(np.int32), 1),
    "rows_past_one_pass": lambda rng: (rng.randint(0, 65_537, 5_000_000)
                                       .astype(np.int32), 65_537),
}


@pytest.mark.parametrize("case", sorted(HIST_CASES) + ["view_off_16_bytes"])
def test_slot_hist_kernel_equals_the_plain_version(case, gpu):
    """Equal to the plain version bitwise, twice, on one block and on a
    cooperative grid (also past one pass of the rows it reads first); ids
    below 0 and at or past ``num_slots`` are not counted."""
    from repro_torch.kernels import group_build as t_gb

    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "view_off_16_bytes":  # ids start 4 bytes past 16
        slots, num = HIST_CASES["outside_the_range"](rng)
        s = torch.from_numpy(np.concatenate([[0], slots]).astype(np.int32)
                             ).to(gpu)[1:]
        assert s.data_ptr() % 16 == 4
    else:
        slots, num = HIST_CASES[case](rng)
        s = torch.from_numpy(slots).to(gpu)
    before = (t_gb.slot_hist.launches, t_gb.slot_hist.plain_calls)
    got, again = t_gb.slot_hist(s, num), t_gb.slot_hist(s, num)
    want = t_ref.slot_hist(s, num)
    torch.cuda.synchronize()
    assert (t_gb.slot_hist.launches, t_gb.slot_hist.plain_calls) == (
        before[0] + (2 if s.shape[0] else 0), before[1])
    assert got.dtype == torch.int32 and got.shape == (num,)
    assert torch.equal(got, again) and torch.equal(got, want)


@pytest.mark.parametrize("case", ["partsupp", "full_table"])
def test_group_build_on_the_card_equals_the_plain_version(case, gpu):
    """The composite (hash_to_slot, compaction, slot_hist, offsets) on the
    card against ``ref.group_build``; the overflowing build (20,000 rows of
    up to 5,000 keys at capacity 400) reports its overflow, ``used >
    capacity``, as the plain version does."""
    from repro_torch.kernels import group_build as t_gb

    rng = np.random.RandomState(5)
    keys, _ = HASH_CASES[case](rng)
    cap = 50_000 if case == "partsupp" else 400
    k = torch.from_numpy(keys).to(gpu)
    got, want = t_gb.group_build(k, cap), t_ref.group_build(k, cap)
    if case == "partsupp":
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    else:
        assert int(got[2]) > cap and int(want[2]) > cap


@pytest.mark.parametrize("k,d,n", [(4096, 1, 300_000), (4097, 1, 20_000),
                                   (20_000, 1, 20_000), (50_000, 2, 100_003)])
@pytest.mark.parametrize("dtype", (torch.float64, torch.int64))
def test_segment_sum_takes_any_k_in_windows(k, d, n, dtype, gpu):
    """K past MAX_K runs on the kernel, a window of MAX_K keys a pass: the
    same sums as the plain version (f64 rtol 1e-12 of the largest sum,
    integers exactly), bitwise the same twice, and no plain call."""
    from repro_torch.kernels import segment_reduce as t_sr

    gen = torch.Generator(device=gpu)
    gen.manual_seed(k + n)
    seg = torch.randint(-1, k + 1, (n,), generator=gen, device=gpu,
                        dtype=torch.int32)  # ids outside [0, K) drop
    vals = torch.randint(-1000, 1000, (n, d), generator=gen, device=gpu)
    vals = vals.to(dtype) / (8 if dtype.is_floating_point else 1)
    before = t_sr.segment_sum_vectors.plain_calls
    got = t_sr.segment_sum_vectors(seg, vals, k)
    again = t_sr.segment_sum_vectors(seg, vals, k)
    want = t_ref.segment_sum_vectors(seg.cpu(), vals.cpu(), k)
    assert t_sr.segment_sum_vectors.plain_calls == before
    assert torch.equal(got, again), "two runs differ bitwise"
    got = got.cpu()
    if dtype.is_floating_point:
        tol = 1e-12 * max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= tol
    else:
        assert torch.equal(got, want)
    col = t_sr.segment_sum(seg, vals[:, 0].contiguous(), k).cpu()
    if dtype.is_floating_point:
        assert float((col - want[:, 0]).abs().max()) <= tol
    else:
        assert torch.equal(col, want[:, 0])


#: the segment kernel's cases: (keys, K, n).  4095 keys split unevenly
#: over a replica's 16 owners; 9,000 keys take three windows; 31 rows are
#: fewer than a tile; 3 * 800 + 17 rows end in a ragged chunk
SEGMENT_CASES = [
    ("uniform", 4096, 1_000_003), ("one_key", 4096, 300_001),
    ("zipf", 4096, 1_000_003), ("uniform", 1, 70_001),
    ("uniform", 4095, 100_000), ("uniform", 3, 5_000),
    ("uniform", 9_000, 200_003), ("out_of_range", 4096, 100_003),
    ("uniform", 100, 31), ("uniform", 4096, 3 * 800 + 17),
]


def _segment_ids(keys, k, n, gen, dev):
    if keys == "one_key":
        return torch.full((n,), k // 2, dtype=torch.int32, device=dev)
    if keys == "zipf":  # Zipf s = 1.1 over the K keys
        w = 1.0 / torch.arange(1, k + 1, device=dev,
                               dtype=torch.float64) ** 1.1
        return torch.multinomial(w, n, replacement=True,
                                 generator=gen).to(torch.int32)
    lo, hi = (-3, k + 3) if keys == "out_of_range" else (0, k)
    return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                         dtype=torch.int32)


def _held_to_plain(got, again, want, dtype):
    """Bitwise the same twice; integers exact, floats within f64 rtol
    1e-10 / f32 1e-5 of the largest |plain| (chip_smoke's _tolerance:
    the kernel sums in another order than the plain version)."""
    assert torch.equal(got, again), "two runs differ bitwise"
    got, want = got.cpu(), want.cpu()
    if not dtype.is_floating_point:
        assert torch.equal(got, want)
        return
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    tol = rtol * max(float(want.abs().max()), 1.0)
    assert float((got.double() - want.double()).abs().max()) <= tol


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.int32, torch.int64))
@pytest.mark.parametrize("keys,k,n", SEGMENT_CASES)
def test_segment_kernel_matches_the_plain_version(keys, k, n, dtype, d, gpu):
    """B5 (segment_sum_vectors) and, at D = 1, B4 (segment_sum) against
    their plain versions on the same CUDA tensors: uniform, one-key and
    Zipf keys, K of 1, uneven over the owners and past one window, ids
    out of range, ragged n; no plain call.  Values are multiples of 1/8
    below 125 in size, so every float sum here is exact in any order."""
    from repro_torch.kernels import segment_reduce as t_sr

    gen = torch.Generator(device=gpu)
    gen.manual_seed(k * 7 + n + d)
    seg = _segment_ids(keys, k, n, gen, gpu)
    vals = torch.randint(-1000, 1000, (n, d), generator=gen, device=gpu)
    vals = vals.to(dtype) / 8 if dtype.is_floating_point else vals.to(dtype)
    before = (t_sr.segment_sum_vectors.plain_calls,
              t_sr.segment_sum.plain_calls)
    got = t_sr.segment_sum_vectors(seg, vals, k)
    again = t_sr.segment_sum_vectors(seg, vals, k)
    _held_to_plain(got, again, t_ref.segment_sum_vectors(seg, vals, k),
                   dtype)
    if d == 1:
        col = vals[:, 0].contiguous()
        _held_to_plain(t_sr.segment_sum(seg, col, k),
                       t_sr.segment_sum(seg, col, k),
                       t_ref.segment_sum(seg, col, k), dtype)
    assert (t_sr.segment_sum_vectors.plain_calls,
            t_sr.segment_sum.plain_calls) == before


@pytest.mark.parametrize("keys", ["uniform", "one_key", "zipf"])
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_segment_kernel_on_continuous_values(keys, dtype, gpu):
    """Values in [0, 1): sums that round, held within the tolerance."""
    from repro_torch.kernels import segment_reduce as t_sr

    k, n = 4096, 200_003 if keys != "one_key" else 20_003
    gen = torch.Generator(device=gpu)
    gen.manual_seed(n)
    seg = _segment_ids(keys, k, n, gen, gpu)
    vals = torch.rand((n, 2), generator=gen, device=gpu, dtype=dtype)
    _held_to_plain(t_sr.segment_sum_vectors(seg, vals, k),
                   t_sr.segment_sum_vectors(seg, vals, k),
                   t_ref.segment_sum_vectors(seg, vals, k), dtype)


@pytest.mark.parametrize("k,n", [(1, 1), (3, 3001), (3, 1_000_003), (8, 777)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_filter_reduce_q6_matches_the_plain_version(k, n, dtype, card):
    """Integer-valued data: every partial sum is exact, so the kernel's
    fixed-order sum must equal the plain version's."""
    rng = np.random.RandomState(k + n)
    cols = torch.from_numpy(rng.randint(0, 100, (k, n))).to(card, dtype)
    lo = torch.from_numpy(rng.randint(0, 40, k)).to(card, dtype)
    hi = lo + torch.from_numpy(rng.randint(20, 70, k)).to(card, dtype)
    val = torch.from_numpy(rng.randint(-50, 50, n)).to(card, dtype)
    got = t_fr.filter_reduce_q6(cols, lo, hi, val)
    want = t_ref.filter_reduce_q6(cols, lo, hi, val)
    assert float(got) == float(want)


# -- flash_attention ---------------------------------------------------------


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(dev, dtype, b, h, group, sq, skv, d, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(heads, s, mul):
        x = torch.randn((b, heads, s, d), generator=gen, device=dev)
        return (x * mul).to(dtype)

    return (draw(h, sq, 0.5), draw(h // group, skv, 0.5),
            draw(h // group, skv, 1.0))


def _hold_attention(q, k, v, causal, group):
    t_fa.flash_attention.launches = 0
    t_fa.flash_attention.launches_sm90 = 0
    got = t_fa.flash_attention(q, k, v, causal=causal, group=group)
    again = t_fa.flash_attention(q, k, v, causal=causal, group=group)
    want = t_ref.attention(q, k, v, causal=causal, group=group)
    torch.cuda.synchronize()
    assert t_fa.flash_attention.launches == 2
    sm90 = t_fa.route(q.dtype, q.shape[-1]) == "sm90"
    assert t_fa.flash_attention.launches_sm90 == (2 if sm90 else 0)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, again), "two runs differ bitwise"
    limit = t_fa.tolerance(q, k, v, want, causal=causal, group=group)
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("group", (1, 3, 4))
@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_flash_attention_matches_the_plain_version(dtype, d, group, causal,
                                                   gpu):
    q, k, v = _qkv(gpu, dtype, 2, 2 * group, group, 256, 256, d,
                   seed=d + group * 10 + int(causal))
    _hold_attention(q, k, v, causal, group)


@pytest.mark.parametrize("sq,skv,d,group,causal", [
    (333, 333, 128, 3, True),    # ragged: neither tile width divides S
    (77, 300, 64, 4, True),      # Sq < Skv: q are the last 77 positions
    (77, 300, 64, 4, False),
    (1, 517, 128, 3, True),      # one query row against a long kv
    (100, 100, 8, 1, True),      # the smallest head dimension
    (100, 130, 72, 2, True),     # a head dimension between the buckets
    (65, 129, 256, 2, True),     # the largest head dimension
])
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_flash_attention_ragged_shapes(dtype, sq, skv, d, group, causal, gpu):
    q, k, v = _qkv(gpu, dtype, 2, 2 * group, group, sq, skv, d,
                   seed=sq + skv + d)
    _hold_attention(q, k, v, causal, group)


def test_flash_attention_f32_at_the_prefill_shape(gpu):
    """f32 at one sequence of the serving prefill (H = 24/8, S = 2,048,
    D = 128, causal): the v1 route, bitwise equal twice, every element
    within F32_ATOL + F32_RTOL |plain|."""
    q, k, v = _qkv(gpu, torch.float32, 1, 24, 3, 2048, 2048, 128, seed=41)
    assert t_fa.route(q.dtype, 128) == "v1"
    _hold_attention(q, k, v, True, 3)


def test_flash_attention_reads_strided_views(gpu):
    """The layer hands over (B, T, H, D) activations as (B, H, T, D) views
    and a 3-D (H, S, D) call is the batched one without B."""
    gen = torch.Generator(device=gpu)
    gen.manual_seed(5)
    x = torch.randn((2, 200, 12, 64), generator=gen, device=gpu)
    x = x.to(torch.bfloat16)
    kv = torch.randn((2, 200, 4, 64), generator=gen, device=gpu)
    kv = kv.to(torch.bfloat16)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    got = t_fa.flash_attention(q, k, k, group=3)
    want = t_fa.flash_attention(q.contiguous(), k.contiguous(),
                                k.contiguous(), group=3)
    assert torch.equal(got, want)
    one = t_fa.flash_attention(q[1].contiguous(), k[1].contiguous(),
                               k[1].contiguous(), group=3)
    assert one.shape == (12, 200, 64) and torch.equal(one, want[1])


@pytest.mark.parametrize("sq,skv,d,group,causal", [
    (333, 333, 128, 3, True),    # neither length a multiple of 128
    (333, 333, 64, 4, False),
    (77, 300, 128, 3, True),     # Sq < Skv, one q tile
    (77, 300, 64, 1, False),
    (129, 257, 128, 4, True),    # one row past a tile on both sides
    (1, 517, 64, 3, True),       # one query row against a long kv
    (640, 2000, 128, 3, True),   # several q tiles, a ragged kv end
])
def test_flash_attention_sm90_on_ragged_shapes(sq, skv, d, group, causal,
                                               gpu):
    """The Hopper route (bf16, D in {64, 128}) where TMA zero-fills the
    rows past Sq or Skv and the store masks rows past Sq."""
    q, k, v = _qkv(gpu, torch.bfloat16, 2, 2 * group, group, sq, skv, d,
                   seed=sq * 7 + skv + d)
    assert t_fa.route(q.dtype, d) == "sm90"
    _hold_attention(q, k, v, causal, group)


def test_flash_attention_sm90_reads_the_train_micro_batch_as_views(gpu):
    """B = 2, the train micro-batch of the Llama 3.2 3B config (24/8 heads,
    D = 128, S = 2048): the layer's (B, T, H, D) activations go in as
    (B, H, T, D) views, read through the tensor maps' strides; the result
    equals the contiguous call's bitwise."""
    gen = torch.Generator(device=gpu)
    gen.manual_seed(17)

    def draw(heads, mul):
        x = torch.randn((2, 2048, heads, 128), generator=gen, device=gpu)
        return (x * mul).to(torch.bfloat16).transpose(1, 2)

    q, k, v = draw(24, 0.5), draw(8, 0.5), draw(8, 1.0)
    _hold_attention(q, k, v, True, 3)
    got = t_fa.flash_attention(q, k, v, group=3)
    want = t_fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), group=3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sq,skv,d,h,group", [
    (300, 129, 64, 8, 4),        # Sq > Skv, Skv one row past a tile
    (200, 37, 128, 6, 3),        # Skv under one tile
    (1500, 1500, 64, 4, 1),      # the Whisper encoder's length: 11 full
                                 # kv tiles of 128 and one of 92
    (448, 1500, 64, 4, 1),       # Whisper's cross-attention, Sq < Skv
    (2048, 1600, 128, 16, 8),    # the vision model's cross-attention
])
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_flash_attention_without_the_mask_takes_any_sq(dtype, sq, skv, d, h,
                                                       group, gpu):
    """Non-causal calls with Sq past Skv (a cross-attention's text longer
    than the sequence it attends to), on both routes: every q tile walks
    every kv tile, the partial last one masked by kj < skv."""
    q, k, v = _qkv(gpu, dtype, 2, h, group, sq, skv, d, seed=sq + 3 * skv)
    _hold_attention(q, k, v, False, group)


@pytest.mark.parametrize("entry", ("weld_flash_attention",
                                   "weld_flash_attention_sm90"))
def test_flash_attention_c_entries_refuse_causal_sq_past_skv(entry, gpu):
    """The C entries check the contract themselves: causal Sq > Skv is
    refused (cudaErrorInvalidValue) before any launch, the same call
    without the mask is taken."""
    import ctypes

    from repro_torch.kernels import _build

    q = torch.zeros((1, 2, 9, 64), dtype=torch.bfloat16, device=gpu)
    k = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device=gpu)
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *t_fa._strides(q), *t_fa._strides(k), *t_fa._strides(k),
        *t_fa._strides(out))
    lib = _build.library()
    stream = torch.cuda.current_stream(gpu).cuda_stream
    head = (0,) if entry == "weld_flash_attention" else ()
    for causal, want in ((1, 1), (0, 0)):   # 1: cudaErrorInvalidValue
        rc = getattr(lib, entry)(
            *head, q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(),
            strides, 1, 2, 1, 9, 8, 64, causal, 0.125, stream)
        assert rc == want, (causal, rc)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,d,sq,skv,what", [
    (torch.float16, 64, 8, 8, TypeError),
    (torch.float64, 64, 8, 8, TypeError),
    (torch.bfloat16, 12, 8, 8, ValueError),
    (torch.bfloat16, 264, 8, 8, ValueError),
    (torch.float32, 64, 9, 8, ValueError),
    (torch.bfloat16, 64, 9, 8, ValueError),   # causal Sq > Skv, sm90 route
])
def test_flash_attention_refuses_what_it_does_not_take(dtype, d, sq, skv,
                                                       what, gpu):
    q = torch.zeros((1, 2, sq, d), dtype=dtype, device=gpu)
    k = torch.zeros((1, 2, skv, d), dtype=dtype, device=gpu)
    t_fa.flash_attention.launches = 0
    t_fa.flash_attention.launches_sm90 = 0
    with pytest.raises(what):
        t_fa.flash_attention(q, k, k)
    assert t_fa.flash_attention.launches == 0
    assert t_fa.flash_attention.launches_sm90 == 0


# -- fused_adamw -------------------------------------------------------------


def _adam_state(dev, n, p_dtype, g_dtype, seed, offset=0):
    """p, g, m, v on the card; ``offset`` elements into larger buffers (an
    address off 16 bytes takes the kernel's scalar path)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(mul, dtype, positive=False):
        x = torch.randn((n + offset,), generator=gen, device=dev) * mul
        return (x.abs() if positive else x).to(dtype)[offset:]

    return (draw(1.0, p_dtype), draw(0.1, g_dtype),
            draw(0.01, torch.float32), draw(0.001, torch.float32, True))


def _hold_adamw(p, g, m, v, lr, t):
    want = t_ref.adamw_update(p, g, m, v, lr, t)
    runs = []
    for _ in range(2):
        pp, mm, vv = p.clone(), m.clone(), v.clone()
        ptrs = [x.data_ptr() for x in (pp, mm, vv)]
        out = t_aw.adamw_update(pp, g, mm, vv, lr, t)
        assert all(a is b for a, b in zip(out, (pp, mm, vv)))
        assert [x.data_ptr() for x in out] == ptrs
        runs.append(out)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b), "two launches differ bitwise"
    got = runs[0]
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-7)
    if p.dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=1e-7)
    else:
        diff = (got[0].float() - want[0].float()).abs()
        assert bool((diff <= want[0].float().abs() * 2.0 ** -7).all())


@pytest.mark.parametrize("t", (1, 5, 1000))
@pytest.mark.parametrize("n", (1, 7, 16_384 * 3 + 7, 1_000_003))
@pytest.mark.parametrize("g_dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("p_dtype", (torch.bfloat16, torch.float32))
def test_fused_adamw_matches_the_plain_version(p_dtype, g_dtype, n, t, gpu):
    before = t_aw.adamw_update.launches
    _hold_adamw(*_adam_state(gpu, n, p_dtype, g_dtype, seed=n + t), 3e-4, t)
    assert t_aw.adamw_update.launches == before + 2


@pytest.mark.parametrize("offset", (1, 3))
def test_fused_adamw_on_unaligned_views(offset, gpu):
    p, g, m, v = _adam_state(gpu, 100_001, torch.bfloat16, torch.float32,
                             seed=offset, offset=offset)
    assert p.data_ptr() % 16
    _hold_adamw(p, g, m, v, 1e-3, 3)


@pytest.mark.parametrize("what", ["p_f16", "m_bf16", "sizes", "strided",
                                  "device"])
def test_fused_adamw_refuses_what_it_does_not_take(what, gpu):
    p, g, m, v = _adam_state(gpu, 64, torch.float32, torch.float32, seed=1)
    if what == "p_f16":
        p, err = p.half(), TypeError
    elif what == "m_bf16":
        m, err = m.bfloat16(), TypeError
    elif what == "sizes":
        g, err = g[:63], ValueError
    elif what == "strided":
        p, err = torch.zeros((128,), device=gpu)[::2], ValueError
    else:
        g, err = g.cpu(), ValueError
    before = t_aw.adamw_update.launches
    with pytest.raises(err):
        t_aw.adamw_update(p, g, m, v, 1e-3, 1)
    assert t_aw.adamw_update.launches == before


# -- the attention's gradient ------------------------------------------------


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_attention_gradient_matches_plain_autograd(dtype, gpu):
    b, h, group, s, d = 2, 6, 3, 200, 64
    q, k, v = _qkv(gpu, dtype, b, h, group, s, s, d, seed=31)
    gen = torch.Generator(device=gpu)
    gen.manual_seed(32)
    w = torch.randn((b, h, s, d), generator=gen, device=gpu).to(dtype)

    def grads(fn):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*ins).float() * w.float()).sum().backward()
        return [x.grad for x in ins]

    t_ops.reset_counts()
    got = grads(lambda *x: t_ops.attention(*x, group=group, chunk=64))
    torch.cuda.synchronize()
    assert t_ops.counts()["flash_attention"] == (1, 0)
    assert t_fa.flash_attention.backward_calls == 1
    same = grads(lambda *x: t_ref.chunked_attention(*x, group=group,
                                                    chunk=64))
    dense = grads(lambda *x: t_ref.attention(*x, group=group))
    for a, b_, c in zip(got, same, dense):
        assert a.dtype == dtype
        assert torch.equal(a, b_)
        if dtype == torch.float32:
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        else:
            scale = float(c.float().abs().max())
            assert float((a.float() - c.float()).abs().max()) \
                <= 2.0 ** -6 * scale


def test_train_steps_on_the_card_match_the_cpu(gpu):
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import build_model

    cfg = get_config("llama3.2-3b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    kw = dict(steps=2, global_batch=4, seq_len=64, accum=2, verbose=False,
              params=params, peak_lr=3e-3)
    repro_torch.set_default_device("cpu")
    try:
        on_cpu = train(cfg, **kw)
    finally:
        repro_torch.set_default_device("cuda")
    t_ops.reset_counts()
    on_card = train(cfg, **kw)
    torch.cuda.synchronize()
    counts = t_ops.counts()
    assert counts["fused_adamw"] == (2 * len(params), 0)
    assert counts["flash_attention"] == (2 * 2 * cfg.n_layers, 0)
    assert t_fa.flash_attention.backward_calls == 2 * 2 * cfg.n_layers
    np.testing.assert_allclose(on_card["losses"], on_cpu["losses"],
                               rtol=1e-5)
    for name, p in on_cpu["params"].items():
        torch.testing.assert_close(on_card["params"][name].cpu(), p,
                                   rtol=0, atol=1e-6)


@pytest.fixture()
def nccl_world_one(gpu, tmp_path):
    """Starts an NCCL process group of one rank over a ``file://`` store
    when called; destroys it after the test."""
    import torch.distributed as dist

    def start():
        dist.init_process_group("nccl",
                                init_method=f"file://{tmp_path}/store",
                                rank=0, world_size=1)
        return dist.group.WORLD

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_train_on_the_world_one_mesh_matches_one_device(nccl_world_one):
    """The mesh path at world 1 (DTensor parameters, ZeRO-1 moments,
    flash_attention on local heads, fused_adamw on local shards) against
    the single-device path on the card: a 2-layer f32 config, 2 steps,
    losses and gnorms to rtol 2e-4, atol 2e-5 and parameters to atol
    1e-5 (the CPU mesh tests' limits)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as t_train
    from repro_torch.models import build_model

    cfg = get_config("llama3.2-3b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    kw = dict(steps=2, global_batch=4, seq_len=64, accum=2, verbose=False,
              params=params, peak_lr=3e-3)
    single = t_train.train(cfg, **kw)
    nccl_world_one()
    t_ops.reset_counts()
    mesh = t_train.train(cfg, dp=1, tp=1, **kw)
    torch.cuda.synchronize()
    counts = t_ops.counts()
    assert counts["fused_adamw"] == (2 * len(params), 0)
    assert counts["flash_attention"] == (2 * 2 * cfg.n_layers, 0)
    np.testing.assert_allclose(mesh["losses"], single["losses"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(mesh["gnorms"], single["gnorms"], rtol=2e-4,
                               atol=2e-5)
    for k, p in single["params"].items():
        torch.testing.assert_close(mesh["params"][k].full_tensor(), p,
                                   rtol=0, atol=1e-5)


def test_compressed_psum_through_nccl(nccl_world_one, gpu):
    """At world 1 the mean is the rank's own dequantized payload and the
    error its residual, bitwise, on the card."""
    from repro_torch.optim.compress import (compressed_psum,
                                            dequantize_int8, quantize_int8)

    gen = torch.Generator(device=gpu)
    gen.manual_seed(5)
    g = torch.randn((4097,), generator=gen, device=gpu)
    err = torch.randn((4097,), generator=gen, device=gpu) * 1e-3
    mean, new_err = compressed_psum(g, err, nccl_world_one())
    q, scale = quantize_int8(g + err)
    sent = dequantize_int8(q, scale)
    assert mean.device.type == "cuda"
    assert torch.equal(mean, sent) and torch.equal(new_err, g + err - sent)


@pytest.mark.parametrize("sq,skv", [(96, 200), (300, 128)])
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_attention_gradient_without_the_mask_at_sq_unlike_skv(dtype, sq,
                                                              skv, gpu):
    """The cross-attentions' case under autograd: non-causal, Sq below and
    past Skv, the kernel's forward and the plain version's backward."""
    b, h, group, d = 2, 4, 2, 64
    q, k, v = _qkv(gpu, dtype, b, h, group, sq, skv, d, seed=sq + skv)
    gen = torch.Generator(device=gpu)
    gen.manual_seed(33)
    w = torch.randn((b, h, sq, d), generator=gen, device=gpu).to(dtype)

    def grads(fn):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*ins).float() * w.float()).sum().backward()
        return [x.grad for x in ins]

    t_ops.reset_counts()
    got = grads(lambda *x: t_ops.attention(*x, causal=False, group=group,
                                           chunk=64))
    torch.cuda.synchronize()
    assert t_ops.counts()["flash_attention"] == (1, 0)
    assert t_fa.flash_attention.backward_calls == 1
    assert t_fa.flash_attention.launches_sm90 == (dtype == torch.bfloat16)
    same = grads(lambda *x: t_ref.chunked_attention(
        *x, causal=False, group=group, chunk=64))
    dense = grads(lambda *x: t_ref.attention(*x, causal=False, group=group))
    for a, b_, c in zip(got, same, dense):
        assert a.dtype == dtype
        assert torch.equal(a, b_)
        if dtype == torch.float32:
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        else:
            scale = float(c.float().abs().max())
            assert float((a.float() - c.float()).abs().max()) \
                <= 2.0 ** -6 * scale


@pytest.mark.parametrize("arch", ("deepseek-moe-16b", "dbrx-132b",
                                  "zamba2-1.2b", "xlstm-350m",
                                  "whisper-large-v3",
                                  "llama-3.2-vision-90b"))
def test_family_train_step_on_the_card_matches_the_cpu(arch, gpu):
    """Two ``build_train_step`` steps of each family's smoke config in f32,
    remat on, from one set of weights and two batches (the vision gates
    set away from the reference's 0), warmup 1: the first step at lr 0, so
    that both devices start the second, at the peak lr, from the same
    parameters.  The losses to rtol 1e-5, the gnorms and m to 1e-4 (v, the
    gradients squared, to 2e-4) of the largest |value|, and the parameters
    within ``optim.adamw.second_step_limit`` of that gradient error, the
    limits of ``chip_smoke.py``'s f32 copies; flash_attention's launches
    and backward calls the remat structure's
    (``kernels.launch_counts.attention_calls``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.launch_counts import attention_calls
    from repro_torch.kernels.ref import adamw_scalars
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import second_step_limit

    grad_rel = 1e-4
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    model = build_model(cfg)
    weights = model.init(torch.Generator().manual_seed(5))
    for name in weights:
        if name.endswith(".gate"):
            weights[name].fill_(0.5)
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(2):
        batch = {k: rng.randint(0, cfg.vocab, (2, 32)).astype(np.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            batch["frames"] = rng.randn(2, cfg.n_frames,
                                        cfg.d_model).astype(np.float32)
        if cfg.family == "vlm":
            batch["images"] = rng.randn(2, cfg.n_image_tokens,
                                        cfg.d_vision).astype(np.float32)
        batches.append(batch)
    step = build_train_step(model, warmup=1)

    def run(dev):
        params = {k: v.to(dev, copy=True) for k, v in weights.items()}
        opt = adamw_init(params)
        metrics = []
        for batch in batches:
            params, opt, m = step(params, opt, {
                k: torch.from_numpy(x).to(dev) for k, x in batch.items()})
            metrics.append({k: float(x) for k, x in m.items()})
        return params, opt, metrics

    p_cpu, o_cpu, m_cpu = run(torch.device("cpu"))
    t_ops.reset_counts()
    p_card, o_card, m_card = run(gpu)
    torch.cuda.synchronize()
    counts = t_ops.counts()
    fwd, bwd = attention_calls(cfg, training=True)
    assert counts["fused_adamw"] == (2 * len(weights), 0)
    assert counts["flash_attention"] == (2 * fwd, 0)
    assert t_fa.flash_attention.backward_calls == 2 * bwd
    lrs = [m["lr"] for m in m_cpu]
    assert lrs == [m["lr"] for m in m_card] and lrs[0] == 0 < lrs[1]
    for key, rtol in (("loss", 1e-5), ("gnorm", grad_rel)):
        np.testing.assert_allclose([m[key] for m in m_card],
                                   [m[key] for m in m_cpu], rtol=rtol)
    lr, _, _, _, c2 = adamw_scalars(lrs[1], 2, 0.9, 0.999)
    for name, p in p_cpu.items():
        for mom, rel in (("m", grad_rel), ("v", 2 * grad_rel)):
            want = o_cpu[mom][name]
            err = float((o_card[mom][name].cpu() - want).abs().max())
            assert err <= rel * float(want.abs().max()), (name, mom)
        limit = second_step_limit(p, o_cpu["v"][name], lr, c2, grad_rel)
        diff = (p_card[name].cpu() - p).abs()
        assert bool((diff <= limit).all()), (
            name, float((diff / limit).max()))
    assert any(not torch.equal(p_card[k].cpu(), w) for k, w in
               weights.items()), "the second step moved no parameter"


# ---------------------------------------------------------------------------
# the evaluate pipeline's records on the card: the measured replay, and
# the kernel-failure rung's quarantine key
# ---------------------------------------------------------------------------


@pytest.fixture()
def private_state(tmp_path, monkeypatch):
    """A private cost ledger and kernel health file, cold caches."""
    from repro_torch.core import faults, runtime
    from repro_torch.core.kernelplan import quarantine

    monkeypatch.setenv("WELD_COST_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("WELD_KERNEL_HEALTH",
                       str(tmp_path / "kernel_health.json"))
    quarantine.clear(disk=False)
    runtime.clear_cache()
    yield tmp_path
    faults.clear()
    quarantine.clear(disk=False)
    runtime.clear_cache()


def test_traced_join_records_each_routed_kernel(gpu, private_state):
    """A traced m:1 join on the card writes one ledger record per routed
    kernel, naming the impl and the card; each ``measured_ns`` (the card's
    time inside the call's kernel entries) is at most the CUDA-event
    time of the whole call (``event_ns``), which is at most its host span
    between synchronizes (``host_ns``)."""
    from repro_torch import obs
    from repro_torch.frames import weldrel

    rng = np.random.RandomState(5)
    left = weldrel.Table({"k": rng.randint(0, 512, 1 << 20)
                          .astype(np.int64), "p": rng.rand(1 << 20)})
    right = weldrel.Table({"k": np.arange(365, dtype=np.int64),
                           "v": rng.rand(365)})
    obs.enable()
    pos = obs.mark()
    try:
        st: dict = {}
        weldrel.Query(left).join(right, on="k", kernelize="always",
                                 collect_stats=st)
        spans = [sp for sp in obs.spans_since(pos)
                 if sp.name.startswith("kernel.")]
    finally:
        obs.disable()
        obs.clear()
    recs = obs.ledger.read(str(private_state / "ledger.jsonl"))
    assert [r["kernel"] for r in recs] == ["dict_hash_build", "hash_probe"]
    assert [sp.name for sp in spans] == ["kernel.dict_hash_build",
                                         "kernel.hash_probe"]
    for r, sp in zip(recs, spans):
        assert r["measured_ns"] == sp.tags["measured_ns"]
        assert 0 < r["measured_ns"] <= sp.tags["event_ns"] <= r["host_ns"]
        assert r["predicted_ns"] > 0
        assert r["impl"] == "cuda"
        assert r["device"] == torch.cuda.get_device_name()


def _card_filter_sum(mode, n=1 << 26):
    """A filtered sum on the card (the filter_reduce_sum route), and
    numpy's."""
    from repro_torch.frames import weldrel

    rng = np.random.RandomState(12)
    x = rng.rand(n)
    t = weldrel.Table({"x": x})
    st: dict = {}
    got = weldrel.Query(t).filter(t.col("x") < 0.5).agg(
        {"s": (t.col("x"), "+")}, kernelize=mode, collect_stats=st)
    return got, float(x[x < 0.5].sum()), st


def test_cpu_records_never_price_the_card(gpu, private_state):
    """Ledger lines of the plain versions on the CPU, and lines naming no
    impl, however slow, leave the card's gate on its roofline."""
    from repro_torch.core import obs
    from repro_torch.core.kernelplan import calibrate

    for impl, device in (("ref", "cpu"), (None, None)):
        for _ in range(3):
            obs.ledger.record("filter_reduce_sum", "float64", 1 << 26, None,
                              int(5e9), impl=impl, device=device)
    calibrate.invalidate()
    got, want, st = _card_filter_sum("auto")
    (cost,) = st["kernelplan"]["costs"]
    assert cost["source"] == "roofline" and cost["routed"]
    assert got["s"] == pytest.approx(want, rel=1e-9)
    calibrate.invalidate()


def test_calibrated_gate_on_the_card_keeps_a_faster_kernel(
        gpu, private_state, monkeypatch):
    """One traced run on the card calibrates the gate from the card's
    time inside the kernel entries: at 2^26 rows the filtered sum's
    kernel beats the generic lowering's roofline, and stays routed."""
    from repro_torch.core import obs, runtime
    from repro_torch.core.kernelplan import calibrate

    monkeypatch.setenv(calibrate.ENV_MIN_SAMPLES, "1")
    obs.enable()
    try:
        _card_filter_sum("always")
    finally:
        obs.disable()
        obs.clear()
    calibrate.invalidate()
    runtime.clear_cache()
    got, want, st = _card_filter_sum("auto")
    (cost,) = st["kernelplan"]["costs"]
    assert cost["source"] == "measured" and cost["routed"], cost
    assert got["s"] == pytest.approx(want, rel=1e-9)
    calibrate.invalidate()


def _card_groupby(kernelize="always"):
    """A group-by on the card routed to ``dict_group_sum`` (the route
    whose kernel is ``segment_sum_vectors``), and numpy's sums."""
    from repro_torch.frames import welddf

    rng = np.random.RandomState(9)
    keys = rng.randint(0, 4096, 1 << 20).astype(np.int64)
    vals = rng.rand(1 << 20)
    want = np.bincount(keys, weights=vals, minlength=4096)

    def run(mode=kernelize):
        df = welddf.DataFrame({"k": keys, "v": vals})
        st: dict = {}
        out = df.groupby_sum("k", "v", capacity=4096, kernelize=mode,
                             collect_stats=st)
        return out, st

    return run, keys, want


def test_kernel_raise_on_the_card_quarantines_under_its_name(
        gpu, private_state):
    """``kernel.dict_group_sum:raise`` on card tensors raises
    ``KernelCompileError`` (the generic lowering does not stand in for
    the kernel on a card) after writing one health-file key, which names
    the card; the next "always" compile raises ``KernelQuarantinedError``
    at the gate with no launch; after ``quarantine.clear()`` the kernel
    launches again and gives numpy's sums."""
    import json

    from repro_torch.core import errors, faults
    from repro_torch.core.kernelplan import quarantine

    run, keys, want = _card_groupby()
    faults.inject("kernel.dict_group_sum", "raise", times=1)
    t_ops.reset_counts()
    with pytest.raises(errors.KernelCompileError) as ei:
        run()
    assert not isinstance(ei.value, errors.KernelQuarantinedError)
    table = json.loads((private_state / "kernel_health.json").read_text())
    (key,) = table
    assert list(quarantine.entries()) == [key] and key in str(ei.value)
    assert key.startswith("dict_group_sum|")
    assert key.endswith("|" + torch.cuda.get_device_name())
    assert t_ops.counts()["segment_sum_vectors"] == (0, 0)
    with pytest.raises(errors.KernelQuarantinedError):
        run()
    assert all(c == (0, 0) for c in t_ops.counts().values())
    quarantine.clear()
    out, st = run()
    assert t_ops.counts()["segment_sum_vectors"][0] >= 1
    assert "recovery.attempts" not in st
    assert sorted(out) == np.flatnonzero(
        np.bincount(keys, minlength=4096)).tolist()
    np.testing.assert_allclose([out[k] for k in sorted(out)],
                               want[sorted(out)], rtol=1e-12)


def test_a_quarantined_route_on_the_card_warns_under_auto(
        gpu, private_state):
    """Under "auto" the gate keeps the generic lowering for a quarantined
    route on the card, and says so with a ``RuntimeWarning``."""
    import warnings

    from repro_torch.core import errors, faults

    run, _, _ = _card_groupby()
    faults.inject("kernel.dict_group_sum", "raise", times=1)
    with pytest.raises(errors.KernelCompileError):
        run()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, st = run("auto")
    assert any("quarantined" in str(x.message) for x in w)
    assert any(c.get("why") == "quarantined"
               for c in st["kernelplan"]["costs"])


def _misaligned_launch(args, params, fns, impl):
    """The segment kernel's C entry given segment ids 4 bytes off its
    16-byte condition: the entry refuses them (``_build.check``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_reduce as sr

    n, k = 1 << 12, 64
    seg = torch.zeros(n + 4, dtype=torch.int32, device="cuda")[1:n + 1]
    vals = torch.zeros((n, 1), dtype=torch.float64, device="cuda")
    cfg = sr.launch_config(n, k, 1, 8)
    partials = torch.empty((cfg.blocks, k, 1), dtype=torch.float64,
                           device="cuda")
    out = torch.empty((k, 1), dtype=torch.float64, device="cuda")
    rc = _build.library().weld_segment_sum(
        sr.DTYPE_CODES[torch.float64], seg.data_ptr(), vals.data_ptr(), n, k,
        k, 1, cfg.replicas, cfg.tiles, cfg.blocks, partials.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "segment_sum kernel launch")


def _oom_launch(args, params, fns, impl):
    """An allocation of 1 TiB on an 80 GB card."""
    torch.empty(1 << 40, dtype=torch.uint8, device="cuda")


@pytest.mark.parametrize("what", ["misaligned", "oom"])
def test_a_kernel_own_failure_on_the_card_raises_as_it_is(
        gpu, private_state, monkeypatch, what):
    """A C entry refusing a pointer and an out-of-memory error on the
    card are the launch's own failures, not a kernel fault: each raises
    as it is and writes no health-file key."""
    import dataclasses

    from repro_torch.core.kernelplan import quarantine, registry

    launch = {"misaligned": _misaligned_launch, "oom": _oom_launch}[what]
    monkeypatch.setitem(registry._REGISTRY, "dict_group_sum",
                        dataclasses.replace(registry.get("dict_group_sum"),
                                            execute=launch))
    run, _, _ = _card_groupby()
    want = {"misaligned": RuntimeError, "oom": torch.OutOfMemoryError}[what]
    with pytest.raises(want) as ei:
        run()
    if what == "misaligned":
        assert "misaligned" in str(ei.value)
    assert quarantine.entries() == {}
    assert not (private_state / "kernel_health.json").exists()


# ---------------------------------------------------------------------------
# the autotuner on the card: every grid cap a tune space holds, the tuner's
# cache, a tuned plan's repeatability, the server, and a refusal while
# tuning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", t_fr.GRID_CAPS)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_filter_reduce_every_grid_cap_matches_the_plain_version(cap, dtype,
                                                                gpu):
    """B1 and B2 at each candidate cap of their tune space, within the
    route's tolerance of the plain version (``_held_to_plain``) and
    bitwise the same twice."""
    gen = torch.Generator(device=gpu)
    gen.manual_seed(cap)
    n = 3_000_017
    x = torch.rand((3, n), generator=gen, device=gpu, dtype=dtype)
    p = torch.rand(n, generator=gen, device=gpu) < 0.5
    _held_to_plain(t_fr.filter_reduce_sum(x[0], p, max_blocks=cap),
                   t_fr.filter_reduce_sum(x[0], p, max_blocks=cap),
                   t_ref.filter_reduce_sum(x[0], p), dtype)
    _held_to_plain(t_fr.filter_reduce_sum_multi(x, p, max_blocks=cap),
                   t_fr.filter_reduce_sum_multi(x, p, max_blocks=cap),
                   t_ref.filter_reduce_sum_multi(x, p), dtype)


@pytest.mark.parametrize("cap", t_sr.GRID_CAPS)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_segment_every_grid_cap_matches_the_plain_version(cap, dtype, gpu):
    """B4 and B5 at each candidate cap, on continuous values at the
    group-by's 4,096 keys, within the route's tolerance."""
    k, n = 4096, 1_000_003
    gen = torch.Generator(device=gpu)
    gen.manual_seed(cap + 1)
    seg = _segment_ids("uniform", k, n, gen, gpu)
    vals = torch.rand((n, 2), generator=gen, device=gpu, dtype=dtype)
    _held_to_plain(t_sr.segment_sum_vectors(seg, vals, k, max_blocks=cap),
                   t_sr.segment_sum_vectors(seg, vals, k, max_blocks=cap),
                   t_ref.segment_sum_vectors(seg, vals, k), dtype)
    col = vals[:, 0].contiguous()
    _held_to_plain(t_sr.segment_sum(seg, col, k, max_blocks=cap),
                   t_sr.segment_sum(seg, col, k, max_blocks=cap),
                   t_ref.segment_sum(seg, col, k), dtype)


def test_map_chain_every_grid_cap_is_bitwise_the_same(card):
    """B3 is elementwise: every candidate cap gives the same bits."""
    cols, fn, _, _ = GEN_CASES["arith_f64"]
    lam = gen_lambda(cols, fn)
    rng = np.random.RandomState(3)
    data = [torch.from_numpy(column(rng, dt, 3_000_017, kind)).to(card)
            for dt, kind in cols]
    plain = t_mc.stage_plain(lam, {}, card)
    outs = [t_mc.map_elementwise(plain, data, lam=lam, max_blocks=cap)
            for cap in t_mc.GRID_CAPS]
    for cap, o in zip(t_mc.GRID_CAPS, outs):
        assert torch.equal(o.view(torch.int64), outs[-1].view(torch.int64)), cap


@pytest.mark.parametrize("name", ["filter_reduce_sum", "vecmerger_segment_sum",
                                  "dict_group_sum", "map_elementwise"])
def test_tuning_on_the_card_times_every_candidate_then_hits_the_cache(
        name, gpu, monkeypatch):
    from repro_torch.core.kernelplan import autotune, registry

    autotune.clear_cache(disk=False)
    spec = registry.get(name)
    meta = {"n": 1 << 20, "k": 4096, "dtype": np.float64}
    timed = []
    real = autotune._time_candidate
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda go: timed.append(1) or real(go))
    params, cached = autotune.tune(spec, meta, impl=None)
    assert not cached and params["max_blocks"] in spec.tune_space["max_blocks"]
    assert len(timed) == len(spec.tune_space["max_blocks"])
    ent = autotune.entry(name, np.float64, 1 << 20, None, k=4096)
    assert ent["us"] > 0 and ent["us"] <= ent["default_us"]
    (key,) = autotune._load()
    assert key.endswith("|cuda|" + torch.cuda.get_device_name())
    timed.clear()
    again, cached = autotune.tune(spec, meta, impl=None)
    assert cached and again == params and not timed
    autotune.clear_cache(disk=False)


def test_a_tuned_plan_is_bitwise_repeatable(gpu, private_state):
    """The group-by under "always" tunes its grid cap at first encounter;
    the next run (a compile-cache hit) and a recompile (a tuning-cache
    hit) give the same bits."""
    from repro_torch.core import runtime
    from repro_torch.core.kernelplan import autotune

    autotune.clear_cache(disk=False)
    run, _, want = _card_groupby()
    first, st = run()
    (ev,) = st["kernelplan"]["autotune"]
    assert ev["kernel"] == "dict_group_sum" and not ev["cached"]
    second, st2 = run()
    assert st2["cache.hit"]
    runtime.clear_cache()
    third, st3 = run()
    assert st3["kernelplan"]["autotune"][0]["cached"]
    assert st3["kernelplan"]["autotune"][0]["params"] == ev["params"]
    for got in (second, third):
        assert list(got) == list(first)
        assert np.array_equal(np.array(list(got.values())).view(np.int64),
                              np.array(list(first.values())).view(np.int64))
    np.testing.assert_allclose([first[k] for k in sorted(first)],
                               want[sorted(first)], rtol=1e-9)
    autotune.clear_cache(disk=False)


def test_query_server_on_four_workers_is_bitwise_the_serial_run(
        gpu, private_state):
    from repro_torch.core import runtime
    from repro_torch.core.serve import QueryServer
    from repro_torch.frames import weldrel

    rng = np.random.RandomState(5)
    n, k = 1 << 20, 1000
    probe = {"k": rng.randint(0, 2 * k, n).astype(np.int64),
             "x": rng.rand(n)}
    build = {"k": np.arange(k, dtype=np.int64), "w": rng.rand(k)}
    dup = {"k": np.repeat(np.arange(k // 2, dtype=np.int64), 3),
           "w": rng.rand(3 * (k // 2))}

    def m1():
        return weldrel.Query(weldrel.Table(probe)).stage().join(
            weldrel.Table(build), on="k", validate="m:1")

    def mn():
        return weldrel.Query(weldrel.Table(probe)).stage().join(
            weldrel.Table(dup), on="k")

    def agg():
        t = weldrel.Table(probe)
        return weldrel.Query(t).filter(t.col("x") < 0.5).stage().agg(
            {"s": (t.col("x"), "+")})

    def group():
        t = weldrel.Table(probe)
        return weldrel.Query(t).stage().group_agg(
            [t.col("k")], {"s": (t.col("x"), "+")}, capacity=2 * k)

    makers = [m1, mn, agg, group]

    def flat(v):
        if isinstance(v, weldrel.Table):
            return [np.asarray(weldrel._host(c)).tobytes()
                    for _, c in sorted(v.cols.items())]
        return repr(v)

    with QueryServer(workers=1, kernelize="always") as one:
        serial = [flat(one.run(m())) for m in makers]
    runtime.clear_cache()
    t_ops.reset_counts()
    with QueryServer(workers=4, kernelize="always") as srv:
        outs = srv.map([makers[i % 4]() for i in range(16)])
        st = srv.stats()
    assert st["cache.misses"] == 4 and st["serve.completed"] == 16
    assert all(p == 0 for _, p in t_ops.counts().values())
    for i, got in enumerate(outs):
        assert flat(got) == serial[i % 4], i


def test_a_c_entry_refusal_while_tuning_raises_and_records_nothing(
        gpu, monkeypatch):
    """A candidate whose launch the C entry refuses is a fault to see,
    not a point to drop: ``tune`` raises and caches nothing."""
    import dataclasses

    from repro_torch.core.kernelplan import autotune, registry

    autotune.clear_cache(disk=False)
    spec = dataclasses.replace(
        registry.get("dict_group_sum"),
        make_bench=lambda meta, params, impl: (
            lambda: _misaligned_launch(None, params, None, impl)))
    with pytest.raises(RuntimeError, match="misaligned"):
        autotune.tune(spec, {"n": 1 << 16, "k": 64, "dtype": np.float64},
                      impl="cuda")
    assert autotune._load() == {}

