"""The array path's kernels on the card: the generated map chain on every
generator case (``torch_mapchain_cases.py``), ``tiled_matmul`` on ragged
shapes and ``filter_reduce_q6`` on exact data, each against its plain
version on the same CUDA tensors.

These tests need a CUDA card and ``nvcc``; without one they skip (the
CPU tests hold the same arithmetic through the plain versions and the
host-compiled generated source).  Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: "bitwise" and "sqrt" cases must equal the plain version
bitwise (built with -fmad=false; PyTorch's CUDA operators round each
step as IEEE does), "libm" cases f64 rtol 1e-12 and f32 rtol 1e-5
(CUDA's and PyTorch's transcendental paths may differ in the last
bits), integers and bools exactly; products f64 rtol 1e-12 and f32 rtol
1e-5 of the largest magnitude (another summation order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import filter_reduce as t_fr
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
