"""The port's single-device LM training path against the JAX package, on
the CPU.

* ``ref.adamw_update`` (the plain version of the fused-AdamW kernel)
  against the reference's ``ref.adamw_update`` and its Pallas kernel in
  interpret mode over the JAX test's sizes, one step at t = 5 and three
  consecutive steps: rtol 2e-5, atol 1e-7 (the JAX package's own kernel
  test); the CPU wrapper updates in place and returns the plain result.
* ``adamw_update_tree`` on bf16 and f32 leaves against the reference's
  ``impl="jax"`` tree update: f32 leaves and every moment to rtol 2e-5,
  atol 1e-7; bf16 parameters at most one bf16 step (2**-7 of the value)
  apart, since both round the same f32 result to bf16.
* ``clip_by_global_norm`` (rtol 1e-6: another summation order of the
  norm) and ``cosine_warmup`` (rtol 1e-6: f32 cos) against the
  reference's.
* ``Model.loss_and_grad`` against ``jax.value_and_grad(model.loss_fn)``
  for the four dense smoke configs, with and without remat, weights
  carried by ``params_from_jax`` and gradients named the same way: f32
  to rtol and atol 1e-5 (the serving tests' tolerance; about 2e-6 seen).
* The ``ops.attention`` gradient (the plain version on CPU tensors)
  against autograd through ``ref.attention`` (rtol and atol 1e-5) and
  against ``jax.grad`` of the reference's ``kops.attention(impl="ref")``
  (rtol 1e-4, atol 1e-5: f32 einsums summed in other orders).
* Five steps of the port's ``build_train_step`` (accum 1 and 2,
  ``warmup=1``, so that four steps update) against a single-device JAX
  step made of the reference's own pieces — ``jax.value_and_grad``, its
  f32 micro-batch sums, ``clip_by_global_norm``, ``cosine_warmup`` and
  ``adamw_update_tree`` with ``impl="jax"`` and ``impl="pallas"``
  (interpret) — from the same weights, state (``state_from_jax``) and
  batches: losses and gnorms to rtol 1e-5, parameters to atol 1e-6
  (6e-8 seen), moments to 1e-4 of each leaf's largest value.  (The
  reference's own ``train`` builds a mesh and fails here, ROADMAP C2.)
* The properties of ``test_train_loop.py`` on the port's ``train``: the
  loss decreases, accum 4 equals accum 1 (rtol 1e-4), preempt and resume
  are bitwise equal, checkpoint corruption is detected, async saves and
  gc work (bf16 leaves keep their bits), the pipeline is shard-stable,
  round-trips its state and yields the reference's tokens,
  ``preprocess_weld`` works, ``adamw_update_weld`` matches, and the
  straggler monitor fires.
* ``train`` with no device chosen refuses the CPU; a mesh of more than
  one rank without a process group raises, naming torchrun.

Inputs come from numpy seeds; JAX inputs carry explicit dtypes (another
test module in the process may have switched x64 on).
"""
from __future__ import annotations

import glob
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as r_get_config
from repro.data import TokenPipeline as RPipeline
from repro.kernels import fused_adamw as r_fa
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.models import build_model as r_build_model
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update_tree as r_adamw_update_tree
from repro.optim import clip_by_global_norm as r_clip
from repro.optim.adamw import adamw_update_weld as r_adamw_weld
from repro.optim.schedule import cosine_warmup as r_cosine
from repro_torch import DeviceUnavailableError
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed.straggler import StepMonitor
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim import (adamw_init, adamw_update_tree,
                               clip_by_global_norm, cosine_warmup)
from repro_torch.optim.adamw import adamw_update_weld

ARCHS = ("llama3.2-3b", "qwen2-7b", "starcoder2-15b", "nemotron-4-15b")
ADAM = dict(rtol=2e-5, atol=1e-7)
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    # the smoke models' tensors are tiny: one intra-op thread runs their
    # steps an order of magnitude faster than a pool on a busy host
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _j32(a) -> jnp.ndarray:
    return jnp.asarray(np.asarray(a, np.float32), jnp.float32)


# -- the fused-AdamW kernel's plain version -----------------------------------


def _adam_inputs(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32),
            (rng.randn(n) * 0.1).astype(np.float32),
            (rng.randn(n) * 0.01).astype(np.float32),
            (np.abs(rng.randn(n)) * 0.001).astype(np.float32))


@pytest.mark.parametrize("n", [10, 16 * 1024, 16 * 1024 + 7, 50_000])
def test_plain_adamw_matches_the_reference(n):
    p, g, m, v = _adam_inputs(n, n)
    got = ref.adamw_update(*map(torch.from_numpy, (p, g, m, v)), 3e-4, 5.0)
    want = r_ref.adamw_update(*map(_j32, (p, g, m, v)), 3e-4, 5.0)
    kern = r_fa.adamw_update(*map(_j32, (p, g, m, v)), 3e-4, 5.0,
                             interpret=True)
    for a, b, c in zip(got, want, kern):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), np.asarray(b), **ADAM)
        np.testing.assert_allclose(_np(a), np.asarray(c), **ADAM)
    # the CPU wrapper writes the plain result into its arguments
    tp, tg, tm, tv = (torch.from_numpy(x.copy()) for x in (p, g, m, v))
    ptr = tp.data_ptr()
    ops.reset_counts()
    out = ops.adamw_update(tp, tg, tm, tv, 3e-4, 5.0)
    assert ops.counts()["fused_adamw"] == (0, 1)
    assert out[0] is tp and tp.data_ptr() == ptr
    for a, b in zip((tp, tm, tv), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, 16 * 1024 + 7])
def test_plain_adamw_steps_track_the_reference(n):
    """Three consecutive steps from zero moments, the gradient growing."""
    p, g0, _, _ = _adam_inputs(n, 7)
    tp = torch.from_numpy(p.copy())
    tm, tv = torch.zeros(n), torch.zeros(n)
    jp, jm, jv = _j32(p), _j32(np.zeros(n)), _j32(np.zeros(n))
    kp, km, kv = jp, jm, jv
    for t in range(1, 4):
        g = g0 * t
        ops.adamw_update(tp, torch.from_numpy(g), tm, tv, 1e-3, t)
        jp, jm, jv = r_ref.adamw_update(jp, _j32(g), jm, jv, 1e-3, float(t))
        kp, km, kv = r_fa.adamw_update(kp, _j32(g), km, kv, 1e-3, float(t),
                                       interpret=True)
    for a, b, c in ((tp, jp, kp), (tm, jm, km), (tv, jv, kv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **ADAM)
        np.testing.assert_allclose(_np(a), np.asarray(c), **ADAM)


def _one_bf16_step(got, want):
    """|got - want| within one bf16 step of want (2**-7 of its size)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7, atol=1e-30)


@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
def test_adamw_update_tree_matches_the_reference(g_dtype):
    rng = np.random.RandomState(11)
    shapes = {"a": (64, 8), "b": (33,), "c": (5, 7, 3)}
    dtypes = {"a": "bfloat16", "b": "float32", "c": "bfloat16"}
    p_np = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    g_np = {k: (rng.randn(*s) * 0.05).astype(np.float32)
            for k, s in shapes.items()}
    jparams = {k: jnp.asarray(p_np[k], dtypes[k]) for k in shapes}
    jgrads = {k: jnp.asarray(g_np[k], g_dtype) for k in shapes}
    tparams = {k: torch.from_numpy(np.array(jparams[k], np.float32))
               .to(getattr(torch, dtypes[k])) for k in shapes}
    tgrads = {k: torch.from_numpy(np.array(jgrads[k], np.float32))
              .to(getattr(torch, g_dtype)) for k in shapes}
    jopt, topt = r_adamw_init(jparams), adamw_init(tparams)
    for _ in range(3):
        jparams, jopt = r_adamw_update_tree(jparams, jgrads, jopt, 1e-3,
                                            impl="jax")
        tparams, topt = adamw_update_tree(tparams, tgrads, topt, 1e-3)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    for k in shapes:
        assert tparams[k].dtype == getattr(torch, dtypes[k])
        if dtypes[k] == "bfloat16":
            _one_bf16_step(tparams[k], jparams[k])
        else:
            np.testing.assert_allclose(_np(tparams[k]),
                                       np.asarray(jparams[k]), **ADAM)
        for mom in ("m", "v"):
            np.testing.assert_allclose(_np(topt[mom][k]),
                                       np.asarray(jopt[mom][k]), **ADAM)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    rng = np.random.RandomState(3)
    g_np = {"w": rng.randn(40, 3).astype(np.float32),
            "b": rng.randn(17).astype(np.float32)}
    jg = {"w": _j32(g_np["w"]), "b": jnp.asarray(g_np["b"], jnp.bfloat16)}
    tg = {"w": torch.from_numpy(g_np["w"].copy()),
          "b": torch.from_numpy(g_np["b"]).to(torch.bfloat16)}
    want, jn = r_clip(jg, max_norm)
    got, tn = clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(_np(got["w"]), np.asarray(want["w"]),
                               rtol=1e-6)
    assert got["b"].dtype == torch.bfloat16
    _one_bf16_step(got["b"], want["b"])


@pytest.mark.parametrize("warmup,total", [(1, 1000), (50, 1000), (10, 12)])
def test_cosine_warmup_matches_the_reference(warmup, total):
    for step in (0, 1, 5, warmup - 1, warmup, warmup + 3, total - 1, total,
                 total + 40):
        got = cosine_warmup(step, peak_lr=3e-4, warmup=warmup, total=total)
        want = r_cosine(jnp.int32(step), peak_lr=3e-4, warmup=warmup,
                        total=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)


# -- gradients through the model ---------------------------------------------


def _reference(arch, seed, remat=False):
    import dataclasses

    r_cfg = dataclasses.replace(r_get_config(arch, smoke=True), remat=remat)
    r_model = r_build_model(r_cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  r_model.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):  # norm scales and biases random too
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("scale", "'bq'", "'bk'", "'bv'", "bias")):
            base = 1.0 if "scale" in name else 0.0
            return (base + 0.1 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    return cfg, r_model, tree


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_the_reference(arch, remat):
    cfg, r_model, tree = _reference(arch, seed=5, remat=remat)
    rng = np.random.RandomState(6)
    toks = rng.randint(0, cfg.vocab, (2, 20)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (2, 20)).astype(np.int32)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, a.dtype), tree)
    r_loss, r_grads = jax.jit(jax.value_and_grad(r_model.loss_fn))(
        jtree, {"tokens": jnp.asarray(toks, jnp.int32),
                "labels": jnp.asarray(labels, jnp.int32)})
    model = build_model(cfg)
    params = params_from_jax(cfg, tree)
    loss, grads = model.loss_and_grad(
        params, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)})
    assert not any(p.requires_grad for p in params.values())
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(r_loss), **F32)
    want = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, r_grads))
    assert list(grads) == list(params)
    for name, g in grads.items():
        assert g.dtype == params[name].dtype
        np.testing.assert_allclose(_np(g), _np(want[name]), **F32,
                                   err_msg=name)


def test_loss_and_grad_leave_the_bound_params():
    """A gradient call runs on its own tensors: the params bound by an
    earlier entry point stay bound, and loss_fn agrees with it."""
    cfg = get_config("llama3.2-3b", smoke=True)
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(1))
    b = model.init(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=gen,
                                     dtype=torch.int32)}
    batch["labels"] = batch["tokens"]
    with torch.no_grad():
        la = model.loss_fn(a, batch)
    lb, _ = model.loss_and_grad(b, batch)
    with torch.no_grad():
        assert torch.equal(model.impl.embed.table, a["embed.table"])
        assert float(model.loss_fn(b, batch)) == float(lb)
        assert float(model.loss_fn(a, batch)) == float(la)


def _attn_case(seed, b, h, hk, sq, skv, d):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, h, sq, d) * 0.4).astype(np.float32),
            (rng.randn(b, hk, skv, d) * 0.4).astype(np.float32),
            rng.randn(b, hk, skv, d).astype(np.float32),
            rng.randn(b, h, sq, d).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hk,sq,skv,d", [
    (2, 4, 2, 24, 24, 16), (1, 6, 2, 13, 40, 8)])
def test_attention_gradient_matches_the_reference(b, h, hk, sq, skv, d,
                                                  causal):
    q, k, v, w = _attn_case(b * sq + skv, b, h, hk, sq, skv, d)
    group = h // hk

    def grads(fn):
        ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*ins) * torch.from_numpy(w)).sum().backward()
        return [t.grad.numpy() for t in ins]

    ops.reset_counts()
    got = grads(lambda *x: ops.attention(*x, causal=causal, group=group,
                                         chunk=16))
    assert ops.counts()["flash_attention"] == (0, 1)
    dense = grads(lambda *x: ref.attention(*x, causal=causal, group=group))

    def r_loss(qq, kk, vv):
        out = jax.vmap(lambda a, bb, c: r_ops.attention(
            a, bb, c, causal=causal, group=group, chunk=16, impl="ref"))(
                qq, kk, vv)
        return jnp.sum(out * _j32(w))

    want = jax.grad(r_loss, argnums=(0, 1, 2))(*map(_j32, (q, k, v)))
    for a, bb, c in zip(got, dense, want):
        np.testing.assert_allclose(a, bb, **F32)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-4, atol=1e-5)


# -- the train step against a single-device JAX step --------------------------


def _jax_step(model, accum, impl, warmup=1, peak_lr=3e-4, total=1000,
              max_norm=1.0):
    """The reference's train step on one device, from its own pieces."""

    def step(params, opt, batch):
        if accum > 1:
            mb = batch["tokens"].shape[0] // accum
            gacc = jax.tree_util.tree_map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params)
            lacc = 0.0
            for i in range(accum):
                part = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                loss, g = jax.value_and_grad(model.loss_fn)(params, part)
                gacc = jax.tree_util.tree_map(
                    lambda a, x: a + x.astype(jnp.float32), gacc, g)
                lacc = lacc + loss
            grads = jax.tree_util.tree_map(lambda g: g / accum, gacc)
            loss = lacc / accum
        else:
            loss, grads = jax.value_and_grad(model.loss_fn)(params, batch)
        grads, gnorm = r_clip(grads, max_norm)
        lr = r_cosine(opt["step"], peak_lr=peak_lr, warmup=warmup,
                      total=total)
        params, opt = r_adamw_update_tree(params, grads, opt, lr, impl=impl)
        return params, opt, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return jax.jit(step)


@pytest.mark.parametrize("impl", ["jax", "pallas"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_the_reference(accum, impl):
    cfg, r_model, tree = _reference("llama3.2-3b", seed=0)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, a.dtype), tree)
    jopt = r_adamw_init(jparams)
    params = params_from_jax(cfg, tree)
    opt = state_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jopt))
    jstep = _jax_step(r_model, accum, impl)
    step = t_train.build_train_step(build_model(cfg), accum=accum, warmup=1)
    rpipe = RPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3)
    for _ in range(5):
        rb, tb = rpipe.next_batch(), pipe.next_batch()
        jparams, jopt, jm = jstep(jparams, jopt, {
            k: jnp.asarray(x, jnp.int32) for k, x in rb.items()})
        params, opt, m = step(params, opt,
                              {k: torch.from_numpy(x) for k, x in tb.items()})
        for key in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5)
    want = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams))
    wopt = state_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jopt))
    assert int(opt["step"]) == int(wopt["step"]) == 5
    for name in want:
        np.testing.assert_allclose(_np(params[name]), _np(want[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
        for mom in ("m", "v"):
            scale = float(wopt[mom][name].abs().max())
            np.testing.assert_allclose(_np(opt[mom][name]),
                                       _np(wopt[mom][name]), rtol=0,
                                       atol=1e-4 * scale, err_msg=name)


# -- the properties of test_train_loop.py on the port's train -----------------


def test_loss_decreases():
    out = t_train.train("llama3.2-3b", smoke=True, steps=60, global_batch=8,
                        seq_len=32, peak_lr=3e-3, verbose=False)
    first = np.mean(out["losses"][:10])
    last = np.mean(out["losses"][-10:])
    assert last < first - 0.05, (first, last)
    assert len(out["gnorms"]) == len(out["step_s"]) == 60


def test_grad_accumulation_matches_large_batch():
    o1 = t_train.train("llama3.2-3b", smoke=True, steps=5, global_batch=8,
                       seq_len=16, accum=1, verbose=False)
    o2 = t_train.train("llama3.2-3b", smoke=True, steps=5, global_batch=8,
                       seq_len=16, accum=4, verbose=False)
    np.testing.assert_allclose(o1["losses"], o2["losses"], rtol=1e-4)


def test_preempt_resume_bitwise(tmp_path):
    """Stop at step 10, resume, final params equal the uninterrupted
    run's bitwise (bf16 parameters, f32 moments)."""
    import dataclasses

    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              param_dtype="bfloat16")
    kw = dict(steps=20, global_batch=4, seq_len=16, verbose=False)
    full = t_train.train(cfg, ckpt_dir=str(tmp_path / "a"), ckpt_every=100,
                         **kw)
    d2 = str(tmp_path / "b")
    t_train.train(cfg, **dict(kw, steps=10), ckpt_dir=d2, ckpt_every=10)
    resumed = t_train.train(cfg, ckpt_dir=d2, ckpt_every=10, resume=True,
                            **kw)
    assert resumed["losses"] == full["losses"][10:]
    for name, p in full["params"].items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, resumed["params"][name]), name
    for mom in ("m", "v"):
        for name, x in full["opt"][mom].items():
            assert torch.equal(x, resumed["opt"][mom][name]), name
    assert int(resumed["opt"]["step"]) == 20


def test_train_works_on_a_copy_of_given_params():
    cfg = get_config("llama3.2-3b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(4))
    before = {k: v.clone() for k, v in params.items()}
    a = t_train.train(cfg, steps=3, global_batch=2, seq_len=8,
                      verbose=False, params=params)
    b = t_train.train(cfg, steps=3, global_batch=2, seq_len=8,
                      verbose=False, params=params)
    assert all(torch.equal(before[k], params[k]) for k in params)
    assert a["losses"] == b["losses"]
    assert not all(torch.equal(a["params"][k], params[k]) for k in params)


def test_checkpoint_integrity_detection(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"w": torch.arange(10, dtype=torch.float32)}
    ck.save(1, state, blocking=True)
    f = glob.glob(str(tmp_path / "step_1" / "*.npy"))[0]
    arr_bad = np.load(f).copy()
    arr_bad[0] += 1
    np.save(f, arr_bad)
    with pytest.raises(IOError):
        ck.restore(1, state)


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.full((4,), float(s)),
                    "nest": {"b": torch.full((3,), s + 0.5,
                                             dtype=torch.bfloat16)}})
    ck.wait()
    assert ck.list_steps() == [3, 4] and ck.latest_step() == 4
    got, extra = ck.restore(4, {"w": torch.zeros(4),
                                "nest": {"b": torch.zeros(
                                    3, dtype=torch.bfloat16)}})
    assert extra["step"] == 4
    np.testing.assert_array_equal(got["w"].numpy(), np.full(4, 4.0))
    assert got["nest"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["nest"]["b"],
                       torch.full((3,), 4.5, dtype=torch.bfloat16))


def test_checkpoint_keeps_bf16_bits(tmp_path):
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, {"x": x, "step": torch.tensor(7, dtype=torch.int32)},
            extra={"pipeline": {"step": 3, "seed": 1}}, blocking=True)
    got, extra = ck.restore(7, {"x": torch.empty(1000, dtype=torch.bfloat16,
                                                 device="meta"),
                                "step": torch.zeros((), dtype=torch.int32)})
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    assert int(got["step"]) == 7 and extra["pipeline"] == {"step": 3,
                                                           "seed": 1}


def test_pipeline_shard_stability():
    full = TokenPipeline(vocab=97, seq_len=16, global_batch=8)
    b_full = full.next_batch()
    shards = [TokenPipeline(vocab=97, seq_len=16, global_batch=8, shard=k,
                            num_shards=4).next_batch() for k in range(4)]
    merged = np.concatenate([s["tokens"] for s in shards], axis=0)
    np.testing.assert_array_equal(merged, b_full["tokens"])


def test_pipeline_state_roundtrip():
    p = TokenPipeline(vocab=97, seq_len=8, global_batch=2)
    p.next_batch()
    p.next_batch()
    st = p.state()
    b3 = p.next_batch()
    q = TokenPipeline(vocab=97, seq_len=8, global_batch=2)
    q.restore(st)
    np.testing.assert_array_equal(q.next_batch()["tokens"], b3["tokens"])


@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (5, 1, 2),
                                                   (9, 3, 4)])
def test_pipeline_yields_the_reference_tokens(seed, shard, num_shards):
    kw = dict(vocab=128_256, seq_len=33, global_batch=8, seed=seed,
              shard=shard, num_shards=num_shards)
    mine, theirs = TokenPipeline(**kw), RPipeline(**kw)
    for _ in range(3):
        a, b = mine.next_batch(), theirs.next_batch()
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])


def test_pipeline_weld_preprocess():
    p = TokenPipeline(vocab=50, seq_len=8, global_batch=2)
    raw = np.array([[1, 0, 3], [0, 5, 6]], dtype=np.int64)
    toks, mask = p.preprocess_weld(raw, pad_id=0)
    np.testing.assert_array_equal(toks, raw)
    np.testing.assert_array_equal(mask, np.array([[1, 0, 1], [0, 1, 1]]))


def test_adamw_weld_matches_the_reference():
    rng = np.random.RandomState(0)
    n = 512
    p, g = rng.randn(n), rng.randn(n) * 0.1
    m, v = rng.randn(n) * 0.01, np.abs(rng.randn(n)) * 0.001
    got = adamw_update_weld(p, g, m, v, 1e-3, 2.0)
    want = r_adamw_weld(p, g, m, v, 1e-3, 2.0)
    c1, c2 = 1 - 0.9 ** 2.0, 1 - 0.999 ** 2.0
    m_new = 0.9 * m + 0.1 * g
    v_new = 0.999 * v + 0.001 * g * g
    p_new = p - 1e-3 * ((m_new / c1) / (np.sqrt(v_new / c2) + 1e-8)
                        + 0.01 * p)
    for a, b, c in zip(got, want, (p_new, m_new, v_new)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(a), c, rtol=1e-12)


def test_straggler_monitor_flags_outliers():
    mon = StepMonitor(threshold=2.0, patience=2)
    for i in range(12):
        mon.start()
        time.sleep(0.012 if i in (8, 9) else 0.002)
        mon.stop()
    assert len(mon.events) >= 2
    assert mon.escalations >= 1
    s = mon.summary()
    assert s["steps"] == 12 and s["stragglers"] >= 2


def test_train_without_a_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device to train on")
    repro_torch.set_default_device("cuda")
    try:
        with pytest.raises(DeviceUnavailableError):
            t_train.train("llama3.2-3b", steps=1, global_batch=2, seq_len=4,
                          verbose=False)
    finally:
        repro_torch.set_default_device("cpu")


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_training_on_a_mesh_waits_for_the_distributed_slice(dp, tp):
    """A mesh of more than one rank needs a process group: without one
    ``train`` raises, naming torchrun (``test_torch_distributed_train.py``
    trains on gloo meshes)."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        t_train.train("llama3.2-3b", steps=1, dp=dp, tp=tp, verbose=False)


def test_main_trains_on_the_cpu_when_asked(capsys):
    try:
        t_train.main(["--steps", "2", "--batch", "2", "--seq", "8",
                      "--device", "cpu"])
    finally:
        repro_torch.set_default_device("cpu")
    assert "[train] step     1" in capsys.readouterr().out
