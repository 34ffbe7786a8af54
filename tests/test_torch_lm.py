"""The port's dense LM serving path against the JAX package, on the CPU.

* The plain attention versions (``ref.attention`` and, through
  ``ops.attention`` on CPU tensors, ``ref.chunked_attention``) against the
  JAX package's Pallas ``flash_attention`` run in interpret mode, over the
  sweep of ``test_kernels.py`` plus a ragged ``Sq < Skv`` case and
  three non-causal ones (``Sq > Skv``, ragged Skv, GQA): f32 to
  rtol 2e-4, atol 2e-5 (the JAX package's own kernel test).  Two bf16
  cases hold the port's chunked version to the reference's chunked
  version (the same cast points: rtol 2**-7, one bf16 step, atol 1e-6)
  and the interpret-mode kernel to the port's ``ref.attention`` within
  the card's per-element limit ``flash_attention.tolerance`` (2**-7
  |plain| + 2**-6 R: the kernel rounds p to bf16 before the PV product,
  the plain versions do not).  That limit rejects the card check's
  planted faults (an off-by-one causal mask, interleaved kv heads), also
  on the later rows, where its size follows values of about S**-0.5.
* Each of the four dense smoke configs with the reference's parameters
  carried across by ``params_from_jax`` (biases and norm scales drawn at
  random too, so that they count): prefill logits, the KV cache, a run
  of ``decode_step``s and ``loss_fn``, in f32, to rtol 1e-5 and atol 1e-5
  (the two backends sum in other orders: about 2e-6 seen).
* Decode against prefill, teacher-forced, in the port (rtol and atol
  1e-4 in f32; the JAX package's own test allows 2e-3).
* ``serve``'s greedy tokens equal the JAX ``serve``'s for the same seed
  and weights, and its logits agree to rtol and atol 1e-5.
* ``serve`` with no device chosen refuses to run on the CPU.

Inputs come from numpy seeds.  JAX inputs carry explicit dtypes, since
another test module in the process may have switched x64 on.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as r_get_config
from repro.kernels import flash_attention as r_fa
from repro.kernels import ref as r_ref
from repro.launch import serve as r_serve
from repro.models import build_model as r_build_model
from repro_torch import DeviceUnavailableError
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

ARCHS = ("llama3.2-3b", "qwen2-7b", "starcoder2-15b", "nemotron-4-15b")
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


# -- attention ---------------------------------------------------------------


SWEEP = [
    (2, 64, 64, 32, 1, True),
    (4, 128, 128, 64, 2, True),
    (2, 64, 256, 32, 1, True),    # q shorter than kv
    (2, 100, 100, 32, 1, False),  # non-causal + padding path
    (8, 96, 96, 16, 4, True),     # GQA group=4
    (6, 37, 101, 24, 3, True),    # ragged Sq < Skv, group 3
    (4, 100, 37, 32, 2, False),   # non-causal Sq > Skv, Skv ragged, GQA 2
    (8, 130, 70, 16, 4, False),   # non-causal Sq > Skv, GQA 4
    (2, 50, 130, 32, 1, False),   # non-causal Sq < Skv, Skv ragged
]


def _attn_inputs(seed, h, sq, skv, d, group):
    rng = np.random.RandomState(seed)
    q = (rng.randn(h, sq, d) * 0.3).astype(np.float32)
    k = (rng.randn(h // group, skv, d) * 0.3).astype(np.float32)
    v = rng.randn(h // group, skv, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("h,sq,skv,d,group,causal", SWEEP)
def test_plain_attention_matches_the_jax_kernel(h, sq, skv, d, group,
                                                causal):
    q, k, v = _attn_inputs(h * sq + d, h, sq, skv, d, group)
    want = np.asarray(r_fa.flash_attention(
        jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32),
        jnp.asarray(v, jnp.float32), causal=causal, group=group, bq=32,
        bk=32, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    dense = ref.attention(tq, tk, tv, causal=causal, group=group)
    ops.reset_counts()
    chunked = ops.attention(tq, tk, tv, causal=causal, group=group,
                            chunk=32)
    assert ops.counts()["flash_attention"] == (0, 1)
    np.testing.assert_allclose(dense.numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=2e-4, atol=2e-5)


def test_plain_attention_batched_equals_per_sequence():
    """The (B, H, S, D) entry is the 3-D one for each sequence."""
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(3, 4, 20, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 2, 33, 16).astype(np.float32))
    out = ops.attention(q, k, k, group=2, chunk=8)
    for b in range(3):
        one = ops.attention(q[b], k[b], k[b], group=2, chunk=8)
        np.testing.assert_allclose(out[b].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-7)


def _bf16(*xs):
    return [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
            for x in xs]


@pytest.mark.parametrize("h,sq,skv,d,group", [
    (4, 50, 70, 32, 2),
    (4, 256, 256, 64, 2),  # near-uniform late rows: values about 256**-0.5
])
def test_plain_attention_in_bf16(h, sq, skv, d, group):
    q, k, v = _attn_inputs(11 + sq, h, sq, skv, d, group)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want_chunked = np.asarray(r_ref.chunked_attention(
        jq, jk, jv, causal=True, group=group, chunk=32), np.float32)
    want_kernel = np.asarray(r_fa.flash_attention(
        jq, jk, jv, causal=True, group=group, bq=32, bk=32,
        interpret=True), np.float32)
    tq, tk, tv = _bf16(jq, jk, jv)
    got = ops.attention(tq, tk, tv, causal=True, group=group, chunk=32)
    assert got.dtype == torch.bfloat16
    # the same cast points: one bf16 step of the value apart at most
    np.testing.assert_allclose(got.float().numpy(), want_chunked,
                               rtol=2.0 ** -7, atol=1e-6)
    # the kernel rounds p to bf16 as well: the card test's limit
    plain = ref.attention(tq, tk, tv, causal=True, group=group)
    limit = t_fa.tolerance(tq, tk, tv, plain, causal=True, group=group)
    err = np.abs(want_kernel - plain.float().numpy())
    assert (err <= limit.numpy()).all(), float((err / limit.numpy()).max())


def test_plain_attention_in_bf16_without_the_mask_past_skv():
    """bf16, non-causal, Sq > Skv (a cross-attention's text longer than
    the image): the port's chunked version to the reference's, and the
    interpret-mode kernel within the card's limit, as above."""
    h, sq, skv, d, group = 8, 96, 40, 64, 4
    q, k, v = _attn_inputs(23, h, sq, skv, d, group)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want_chunked = np.asarray(r_ref.chunked_attention(
        jq, jk, jv, causal=False, group=group, chunk=32), np.float32)
    want_kernel = np.asarray(r_fa.flash_attention(
        jq, jk, jv, causal=False, group=group, bq=32, bk=32,
        interpret=True), np.float32)
    tq, tk, tv = _bf16(jq, jk, jv)
    got = ops.attention(tq, tk, tv, causal=False, group=group, chunk=32)
    np.testing.assert_allclose(got.float().numpy(), want_chunked,
                               rtol=2.0 ** -7, atol=1e-6)
    plain = ref.attention(tq, tk, tv, causal=False, group=group)
    limit = t_fa.tolerance(tq, tk, tv, plain, causal=False, group=group)
    err = np.abs(want_kernel - plain.float().numpy())
    assert (err <= limit.numpy()).all(), float((err / limit.numpy()).max())


def _attention_with(q, k, v, group, *, mask_shift=0, kv_head=None):
    """ref.attention in bf16 with a planted fault: the causal mask let
    ``mask_shift`` positions further, or q head h reading kv head
    ``kv_head(h)``."""
    h, sq, d = q.shape
    skv = k.shape[1]
    heads = [kv_head(i) if kv_head else i // group for i in range(h)]
    kk, vv = k[heads].float(), v[heads].float()
    s = torch.einsum("hqd,hkd->hqk", q.float(), kk) * d ** -0.5
    qi = torch.arange(sq)[:, None] + (skv - sq) + mask_shift
    s = torch.where(torch.arange(skv)[None, :] <= qi, s,
                    torch.tensor(-1e30))
    return torch.einsum("hqk,hkd->hqd", torch.softmax(s, -1), vv).to(q.dtype)


@pytest.mark.parametrize("fault", ["causal_off_by_one", "kv_head_interleaved"])
def test_bf16_limit_rejects_planted_faults(fault):
    """The card's bf16 limit passes the sound answer and rejects each
    planted fault of the card's fault check, also on the later half of
    the rows, where near-uniform rows have values of about S**-0.5."""
    h, s, d, group = 6, 512, 64, 3
    tq, tk, tv = _bf16(*_attn_inputs(5, h, s, s, d, group))
    plain = ref.attention(tq, tk, tv, causal=True, group=group)
    limit = t_fa.tolerance(tq, tk, tv, plain, causal=True, group=group)
    sound = _attention_with(tq, tk, tv, group)
    if fault == "causal_off_by_one":
        bad = _attention_with(tq, tk, tv, group, mask_shift=1)
    else:
        bad = _attention_with(tq, tk, tv, group,
                              kv_head=lambda i: i % (h // group))
    for got, rejected in ((sound, False), (bad, True)):
        share = (got.float() - plain.float()).abs() / limit
        assert bool((share > 1).any()) is rejected
        assert bool((share[:, s // 2:] > 1).any()) is rejected


# -- which kernel a CUDA call takes, checked before any launch ---------------


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 8, "v1"), (torch.bfloat16, 72, "v1"),
    (torch.bfloat16, 256, "v1"), (torch.float32, 64, "v1"),
    (torch.float32, 128, "v1"),
])
def test_kernel_route_is_chosen_by_dtype_and_head_dimension(dtype, d, want):
    """bf16 with D in {64, 128} goes to the Hopper kernel, the rest to
    v1, batched or not, whatever the sequence lengths."""
    assert t_fa.route(dtype, d) == want
    for sq, skv in ((1, 1), (77, 300), (333, 333)):
        q = torch.zeros((2, 6, sq, d), dtype=dtype)
        k = torch.zeros((2, 2, skv, d), dtype=dtype)
        assert t_fa.plan(q, k, k, group=3) == want
        assert t_fa.plan(q[0], k[0], k[0], group=3) == want


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "flash_sm90"), (torch.bfloat16, 128, "flash_sm90"),
    (torch.bfloat16, 72, "flash_bf16"), (torch.float32, 64, "flash_f32"),
    (torch.float32, 128, "flash_f32"), (torch.float32, 256, "flash_f32"),
])
def test_kernel_names_the_cuda_function_its_route_runs(dtype, d, want):
    """:func:`kernel` names a ``__global__`` function of its route's
    source."""
    import re

    from repro_torch.kernels import _build

    assert t_fa.kernel(dtype, d) == want
    name, source = t_fa.KERNELS[t_fa.route(dtype, d), dtype]
    src = (_build.CSRC / source).read_text()
    assert re.search(rf"__global__ void (__launch_bounds__\([^)]*\)\s*)?"
                     rf"{name}\(", src)


@pytest.mark.parametrize("what,q,k,v,group,err", [
    ("f16", (1, 2, 8, 64, "f16"), (1, 2, 8, 64, "f16"), None, 1, TypeError),
    ("f64", (1, 2, 8, 64, "f64"), (1, 2, 8, 64, "f64"), None, 1, TypeError),
    ("mixed dtypes", (1, 2, 8, 64, "bf16"), (1, 2, 8, 64, "f32"), None, 1,
     TypeError),
    ("D not a multiple of 8", (1, 2, 8, 12, "bf16"), (1, 2, 8, 12, "bf16"),
     None, 1, ValueError),
    ("D past 256", (1, 2, 8, 264, "bf16"), (1, 2, 8, 264, "bf16"), None, 1,
     ValueError),
    ("Sq > Skv", (1, 2, 9, 64, "bf16"), (1, 2, 8, 64, "bf16"), None, 1,
     ValueError),
    ("heads not group x kv heads", (1, 6, 8, 64, "bf16"),
     (1, 2, 8, 64, "bf16"), None, 2, ValueError),
    ("v shaped unlike k", (1, 2, 8, 64, "bf16"), (1, 2, 8, 64, "bf16"),
     (1, 2, 9, 64, "bf16"), 1, ValueError),
    ("2-D", (8, 64, "bf16"), (8, 64, "bf16"), None, 1, ValueError),
])
def test_kernel_plan_refuses_what_no_kernel_takes(what, q, k, v, group, err):
    """What the kernels do not take raises before a launch, on either
    route; a CPU call never reaches the check."""
    dtypes = {"bf16": torch.bfloat16, "f16": torch.float16,
              "f32": torch.float32, "f64": torch.float64}

    def make(spec):
        return torch.zeros(spec[:-1], dtype=dtypes[spec[-1]])

    qt, kt = make(q), make(k)
    vt = kt if v is None else make(v)
    with pytest.raises(err):
        t_fa.plan(qt, kt, vt, group=group, causal=True)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 64, "v1"), (torch.bfloat16, 72, "v1"),
])
def test_kernel_plan_takes_sq_past_skv_without_the_mask(dtype, d, want):
    """Sq > Skv is refused under the causal mask only: without it (a
    cross-attention) both routes take any Sq and Skv; an empty side is
    refused either way."""
    q = torch.zeros((2, 16, 2048, d), dtype=dtype)
    k = torch.zeros((2, 2, 1600, d), dtype=dtype)
    assert t_fa.plan(q, k, k, group=8, causal=False) == want
    with pytest.raises(ValueError, match="causal"):
        t_fa.plan(q, k, k, group=8, causal=True)
    with pytest.raises(ValueError):
        t_fa.plan(q, k[:, :, :0], k[:, :, :0], group=8, causal=False)


def test_cpu_calls_count_no_launch_on_either_route():
    """A CPU tensor takes the plain version: counted in ``.plain_calls``,
    never in ``.launches`` or ``.launches_sm90``, which
    ``ops.reset_counts`` zeroes with the rest."""
    t_fa.flash_attention.launches_sm90 = 5
    ops.reset_counts()
    q, k, v = _bf16(*_attn_inputs(2, 4, 16, 16, 64, 2))
    t_fa.flash_attention(q, k, v, group=2)
    assert (t_fa.flash_attention.launches, t_fa.flash_attention.launches_sm90,
            t_fa.flash_attention.plain_calls) == (0, 0, 1)


# -- the dense LM against the reference --------------------------------------


def _reference(arch, seed):
    """The reference's smoke model and a parameter tree with every leaf
    random (biases and norm scales included), as jnp and as numpy."""
    cfg = r_get_config(arch, smoke=True)
    model = r_build_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("scale", "'bq'", "'bk'", "'bv'", "bias")):
            base = 1.0 if "scale" in name else 0.0
            return (base + 0.1 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, a.dtype), tree)
    return cfg, model, tree, jtree


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_lm_matches_the_reference(arch):
    r_cfg, r_model, tree, jtree = _reference(arch, seed=3)
    cfg = get_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(r_cfg)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        r_get_config(arch))
    model = build_model(cfg)
    params = params_from_jax(cfg, tree)
    assert model.param_count(params) == r_model.param_count(jtree)
    rng = np.random.RandomState(4)
    b, t, steps = 2, 24, 4
    toks = rng.randint(0, cfg.vocab, (b, t + steps)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (b, t)).astype(np.int32)

    r_logits, r_cache = jax.jit(r_model.prefill)(
        jtree, {"tokens": jnp.asarray(toks[:, :t], jnp.int32)})
    r_cache = r_serve._pad_cache_to(r_cache, r_model.cache_init(b, t + steps))
    r_dec = jax.jit(r_model.decode_step)
    r_loss = jax.jit(r_model.loss_fn)(
        jtree, {"tokens": jnp.asarray(toks[:, :t], jnp.int32),
                "labels": jnp.asarray(labels, jnp.int32)})

    with torch.inference_mode():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks[:, :t])})
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   **F32)
        for name in ("k", "v"):
            assert cache["dense"][name].shape == (cfg.n_layers, b, t,
                                                  cfg.n_kv_heads,
                                                  cfg.head_dim)
            np.testing.assert_allclose(cache["dense"][name].numpy(),
                                       np.asarray(r_cache["dense"][name])
                                       [:, :, :t], **F32)
        cache = t_serve._pad_cache_to(cache, model.cache_spec(b, t + steps))
        for s in range(steps):
            tok = toks[:, t + s:t + s + 1]
            r_out, r_cache = r_dec(jtree, r_cache, jnp.asarray(tok, jnp.int32),
                                   jnp.int32(t + s))
            out, cache = model.decode_step(params, cache,
                                           torch.from_numpy(tok), t + s)
            np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **F32)
        np.testing.assert_allclose(cache["dense"]["k"].numpy(),
                                   np.asarray(r_cache["dense"]["k"]), **F32)
        loss = model.loss_fn(params, {"tokens": torch.from_numpy(toks[:, :t]),
                                      "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss), float(r_loss), **F32)


def test_decode_matches_prefill():
    """Step-by-step decode reproduces the teacher-forced prefill logits."""
    cfg = get_config("llama3.2-3b", smoke=True)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(2)
    params = model.init(gen)
    toks = torch.from_numpy(
        np.random.RandomState(2).randint(0, cfg.vocab, (1, 8)).astype(
            np.int32))
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": toks})
        cache = model.cache_init(1, 8)
        for t in range(8):
            step, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 0].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_the_reference(arch):
    seed, batch, prompt, gen_len = 5, 2, 12, 6
    want = r_serve.serve(arch, smoke=True, batch=batch, prompt_len=prompt,
                         gen_len=gen_len, seed=seed, verbose=False)
    cfg = get_config(arch, smoke=True)
    r_model = r_build_model(r_get_config(arch, smoke=True))
    tree = jax.tree_util.tree_map(np.asarray,
                                  r_model.init(jax.random.PRNGKey(seed)))
    got = t_serve.serve(arch, smoke=True, batch=batch, prompt_len=prompt,
                        gen_len=gen_len, seed=seed, verbose=False,
                        params=params_from_jax(cfg, tree))
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["logits"].shape == (batch, gen_len, cfg.vocab)
    # the reference returns no logits: its first step's come from prefill
    r_logits, _ = r_model.prefill(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, a.dtype), tree),
        {"tokens": jnp.asarray(np.random.RandomState(seed).randint(
            0, cfg.vocab, (batch, prompt)), jnp.int32)})
    np.testing.assert_allclose(got["logits"][:, 0].numpy(),
                               np.asarray(r_logits)[:, -1], **F32)


def test_serve_draws_its_own_weights_repeatably():
    a = t_serve.serve("nemotron-4-15b", batch=2, prompt_len=8, gen_len=4,
                      seed=9, verbose=False)
    b = t_serve.serve("nemotron-4-15b", batch=2, prompt_len=8, gen_len=4,
                      seed=9, verbose=False)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])


def test_serve_without_a_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device to serve on")
    repro_torch.set_default_device("cuda")
    try:
        with pytest.raises(DeviceUnavailableError):
            t_serve.serve("llama3.2-3b", batch=1, prompt_len=4, gen_len=2,
                          verbose=False)
    finally:
        repro_torch.set_default_device("cpu")


def test_model_rebinds_a_replaced_parameter():
    """An entry point binds its params dict once; replacing an entry of
    that dict, or updating one in place, is seen by the next call."""
    cfg = get_config("llama3.2-3b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(6))
    other = model.init(torch.Generator().manual_seed(7))
    toks = {"tokens": torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab, (1, 6)).astype(np.int32))}
    name = "dense_layers.0.mlp.wo"
    with torch.inference_mode():
        before, _ = model.prefill(params, toks)
        params[name] = other[name]
        replaced, _ = model.prefill(params, toks)
        want, _ = model.prefill(dict(params), toks)
        params[name].mul_(2.0)
        doubled, _ = model.prefill(params, toks)
        want_doubled, _ = model.prefill(dict(params), toks)
    assert not torch.equal(before, replaced)
    assert torch.equal(replaced, want)
    assert not torch.equal(replaced, doubled)
    assert torch.equal(doubled, want_doubled)


def test_params_from_jax_checks_the_tree():
    _, _, tree, _ = _reference("llama3.2-3b", seed=1)
    cfg = get_config("llama3.2-3b", smoke=True)
    params = params_from_jax(cfg, tree)
    assert params["dense_layers.1.attn.wq"].shape == (cfg.d_model,
                                                      cfg.n_heads,
                                                      cfg.head_dim)
    np.testing.assert_array_equal(params["dense_layers.1.mlp.wo"].numpy(),
                                  tree["dense_layers"]["mlp"]["wo"][1])
    broken = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(cfg, broken)
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_jax(dataclasses.replace(cfg, n_layers=3), tree)
