"""The port's kernels on the CPU: each plain version against the JAX
package's Pallas kernel (interpret mode) and its jnp oracle, on the same
numpy inputs — ragged n, n = 0, every dtype the planner's spec takes,
K up to MAX_K.  Tolerances: integers exact; f64 rtol 1e-12 and f32
rtol 1e-5, since the summation order differs.  The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the wrappers'
CPU dispatch, counters, impl checks and launch shapes are held."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import filter_reduce as j_fr  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels import segment_reduce as j_sr  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import filter_reduce as t_fr  # noqa: E402
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
    """K > MAX_K takes the plain version (the reference's own dispatch),
    whatever the device; the count says so."""
    ops.reset_counts()
    k = t_sr.MAX_K + 1
    seg = torch.tensor([0, k - 1], dtype=torch.int32)
    out = t_sr.segment_sum(seg, torch.tensor([1.0, 2.0]), k)
    assert out.shape == (k,) and float(out[k - 1]) == 2.0
    assert ops.counts()["segment_sum"] == (0, 1)
    ops.reset_counts()


@pytest.mark.parametrize("k,d,itemsize,warps", [
    (4096, 2, 8, 3), (4096, 1, 8, 7), (4096, 1, 4, 8), (64, 2, 8, 8),
])
def test_segment_launch_shape(k, d, itemsize, warps):
    w, blocks = t_sr.launch_config(59_986_052, k, d, itemsize)
    assert w == warps
    assert w * k * d * itemsize <= t_sr.SMEM_LIMIT
    assert blocks == t_sr.MAX_BLOCKS
    assert t_sr.launch_config(100, k, d, itemsize)[1] == 1
    with pytest.raises(ValueError, match="accumulator"):
        t_sr.launch_config(10, 4096, 4, 16)
    with pytest.raises(ValueError, match="rows of 1 to"):
        t_sr.launch_config(10, 8, t_sr.MAX_D + 1, 8)


def test_filter_reduce_grid_depends_only_on_n():
    assert t_fr.grid_blocks(1) == 1
    assert t_fr.grid_blocks(t_fr.THREADS * 4 * 3) == 3
    assert t_fr.grid_blocks(59_986_052) == t_fr.MAX_BLOCKS


def test_kernel_library_is_not_built_on_import():
    assert _build._lib is None
    assert _build.CSRC.joinpath("filter_reduce.cu").exists()
    assert _build.CSRC.joinpath("segment_reduce.cu").exists()
