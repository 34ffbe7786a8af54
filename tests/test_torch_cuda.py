"""The array path's kernels on the card: the generated map chain on every
generator case (``torch_mapchain_cases.py``), ``tiled_matmul`` on ragged
shapes and ``filter_reduce_q6`` on exact data, each against its plain
version on the same CUDA tensors; the LM's ``flash_attention`` against
``ref.attention``; and the training path: ``fused_adamw`` against
``ref.adamw_update`` for every p/g dtype pair, the attention's gradient
through ``FlashAttention`` against plain autograd, and two ``train``
steps of a smoke config on the card against the same on the CPU.

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
``chip_smoke.py`` holds it to), and bitwise equal across runs.  Attention:
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
from repro_torch.kernels import tiled_matmul as t_tm
from torch_mapchain_cases import GEN_CASES, column, gen_lambda, plain_env

pytestmark = pytest.mark.cuda


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
    got = t_fa.flash_attention(q, k, v, causal=causal, group=group)
    again = t_fa.flash_attention(q, k, v, causal=causal, group=group)
    want = t_ref.attention(q, k, v, causal=causal, group=group)
    torch.cuda.synchronize()
    assert t_fa.flash_attention.launches == 2
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


@pytest.mark.parametrize("dtype,d,sq,skv,what", [
    (torch.float16, 64, 8, 8, TypeError),
    (torch.float64, 64, 8, 8, TypeError),
    (torch.bfloat16, 12, 8, 8, ValueError),
    (torch.bfloat16, 264, 8, 8, ValueError),
    (torch.float32, 64, 9, 8, ValueError),
])
def test_flash_attention_refuses_what_it_does_not_take(dtype, d, sq, skv,
                                                       what, gpu):
    q = torch.zeros((1, 2, sq, d), dtype=dtype, device=gpu)
    k = torch.zeros((1, 2, skv, d), dtype=dtype, device=gpu)
    t_fa.flash_attention.launches = 0
    with pytest.raises(what):
        t_fa.flash_attention(q, k, k)
    assert t_fa.flash_attention.launches == 0


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
