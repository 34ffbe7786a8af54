"""Training on the port's other LM families against the JAX package, on
the CPU: MoE (deepseek-moe-16b, dbrx-132b), the Mamba2 hybrid
(zamba2-1.2b), xLSTM (xlstm-350m), encoder-decoder (whisper-large-v3)
and vision (llama-3.2-vision-90b), on their smoke configs in f32.

* ``Model.loss_and_grad`` against ``jax.value_and_grad(model.loss_fn)``
  for each family with ``remat`` off and on (the reference's checkpoints
  on its side too): the loss to rtol 1e-5, and every gradient, named as
  the parameters and in its parameter's dtype, within 1e-5 of its leaf's
  largest |value| (the backends sum in other orders), the hybrid's within
  2e-5: its f32 gradients lie up to about 1e-5 of a leaf's largest
  |value| from the same code evaluated in f64, on either side (the
  Mamba2 scalars' sums cancel to a tenth of their terms), so the two
  packages part by up to twice that.  Weights come from
  ``params_from_jax`` of the reference's init with the leaves it draws as
  constants drawn at random (norm scales, biases, the SSM's ``A_log``,
  ``dt_bias`` and ``D``, and the vision model's ``gate``s: at the
  reference's 0 every cross-attention weight's gradient is exactly 0, and
  the case asserts that they are not).
* MoE at a capacity factor that drops slots (asserted): a dropped slot
  adds nothing to the gradient, as the reference's zero gate.
* xLSTM cut to fewer layers than ``slstm_every``: the sLSTM parameter set
  the model draws and never runs gets zero gradients, as in JAX.
* Five steps of ``build_train_step`` (accum 2 for deepseek and Whisper)
  against the single-device JAX step of ``test_torch_train``: loss,
  gnorm and lr to rtol 1e-5, parameters to atol 1e-6, moments to 1e-4
  of each leaf's largest |value|; for MoE the routing ids of every layer
  and micro-batch equal the reference's at every step (read from its
  jitted step by a ``jax.debug.callback``), so that a flip is reported
  as a flip.
* ``train()`` on the CPU for the token-only families, and its
  ``ValueError`` for the families whose loss needs ``frames`` or
  ``images``.
* flash_attention's launches and backward calls of one ``loss_and_grad``
  per family and remat setting, counted with the card's dispatch
  standing in on the CPU, against
  ``kernels.launch_counts.attention_calls`` (the formula
  ``chip_smoke.py`` asserts on the card).

Inputs come from numpy seeds; JAX inputs carry explicit dtypes, and
JAX's x64 mode is off while the module runs (restored after it).
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
from repro.data import TokenPipeline as RPipeline
from repro.models import build_model as r_build_model
from repro.optim import adamw_init as r_adamw_init
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.kernels import _count
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.launch_counts import attention_calls
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import params_from_jax, state_from_jax
from test_torch_train import _jax_step

ARCHS = ("deepseek-moe-16b", "dbrx-132b", "zamba2-1.2b", "xlstm-350m",
         "whisper-large-v3", "llama-3.2-vision-90b")
MOE = ("deepseek-moe-16b", "dbrx-132b")
#: of the largest |value| of what is compared
REL = 1e-5
#: the gradients' limit by family, where it is not REL (see the docstring)
GRAD_REL = {"hybrid": 2e-5}
#: tokens a sequence: a multiple of the smoke SSM chunk (16)
SEQ = 32

#: leaves the reference draws as constants, drawn at random here
_PERTURBED = ("scale", "'bq'", "'bk'", "'bv'", "bias", "'gate'", "A_log",
              "'D'")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    # the reference's f32 models in f32: another module in the process may
    # have switched JAX's x64 mode on, under which ``jnp.ones`` and the
    # like default to f64 (the reference's mLSTM would then run its
    # normaliser column, and all the state it touches, in f64)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


def _held(got, want, what: str, rel: float = REL) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * max(scale, 1e-30), (
        f"{what}: max |port - reference| {err}, {err / max(scale, 1e-30)} "
        f"of the largest |value| {scale}")


def _reference(arch, seed, **over):
    """The port's config and the reference's model and perturbed weights
    (numpy and jnp), both configs replaced by ``over``."""
    r_cfg = dataclasses.replace(r_get_config(arch, smoke=True), **over)
    r_model = r_build_model(r_cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  r_model.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in _PERTURBED):
            return (leaf + 0.3 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, a.dtype), tree)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    return cfg, r_model, tree, jtree


def _extra(cfg, rng, b):
    """The batch keys beyond tokens and labels that the family's loss
    reads, as numpy f32."""
    if cfg.family == "encdec":
        return {"frames": rng.randn(b, cfg.n_frames,
                                    cfg.d_model).astype(np.float32)}
    if cfg.family == "vlm":
        return {"images": rng.randn(b, cfg.n_image_tokens,
                                    cfg.d_vision).astype(np.float32)}
    return {}


def _batch(cfg, seed, b=2, t=SEQ):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab, (b, t)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab, (b, t)).astype(np.int32)}
    out.update(_extra(cfg, rng, b))
    return out


def _jnp(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int32
                           else jnp.float32) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_held(cfg, grads, params, r_grads, what):
    want = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, r_grads))
    assert list(grads) == list(params)
    for name, g in grads.items():
        assert g.dtype == params[name].dtype, name
        _held(g.numpy(), want[name].numpy(), f"{what} grad {name}",
              GRAD_REL.get(cfg.family, REL))
    return want


def _loss_and_grads(arch, seed, **over):
    cfg, r_model, tree, jtree = _reference(arch, seed, **over)
    batch = _batch(cfg, seed + 1)
    r_loss, r_grads = jax.jit(jax.value_and_grad(r_model.loss_fn))(
        jtree, _jnp(batch))
    params = params_from_jax(cfg, tree)
    loss, grads = build_model(cfg).loss_and_grad(params, _torch(batch))
    assert not loss.requires_grad
    assert not any(p.requires_grad for p in params.values())
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    return cfg, params, grads, r_grads


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_the_reference(arch, remat):
    cfg, params, grads, r_grads = _loss_and_grads(arch, 5, remat=remat)
    _grads_held(cfg, grads, params, r_grads, f"{arch} remat={remat}")
    if cfg.family == "vlm":   # the gates away from 0: the cross path counts
        for name, g in grads.items():
            if name.startswith("cross_layers.") and ".attn.w" in name:
                assert float(g.abs().max()) > 0, name


@pytest.mark.parametrize("arch", MOE)
def test_moe_gradient_with_dropped_slots(monkeypatch, arch):
    dropped = []
    route = t_moe.Moe.route

    def counting(mod, xt, ids=None):
        r = route(mod, xt, ids=ids)
        dropped.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(t_moe.Moe, "route", counting)
    cfg, params, grads, r_grads = _loss_and_grads(arch, 7,
                                                  capacity_factor=0.25)
    assert sum(dropped) > 0, "no slot dropped: the case tests nothing"
    _grads_held(cfg, grads, params, r_grads, f"{arch} dropping slots")


def test_xlstm_without_an_slstm_gives_its_parameters_zero_gradients():
    """Two layers, fewer than ``slstm_every``: no sLSTM runs, and the one
    sLSTM parameter set both packages draw gets exact zeros."""
    cfg, params, grads, r_grads = _loss_and_grads("xlstm-350m", 3,
                                                  n_layers=2)
    assert not build_model(cfg).impl.slstm_idx
    want = _grads_held(cfg, grads, params, r_grads, "xlstm n_layers=2")
    unused = [k for k in grads if k.startswith("slstm_layers.")]
    assert unused
    for name in unused:
        assert not grads[name].any() and not want[name].any(), name
    assert any(grads[k].any() for k in grads if k not in unused)


# -- train steps against the single-device JAX step ---------------------------


def _routing_recorders(monkeypatch):
    """(reference ids, port ids): every MoE layer's top-k expert ids, in
    the order the layers and micro-batches run — the reference's from its
    jitted step through a ``jax.debug.callback`` on ``jax.lax.top_k``."""
    ref_ids, port_ids = [], []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        vals, ids = top_k(x, k)
        jax.debug.callback(lambda a: ref_ids.append(np.asarray(a)), ids,
                           ordered=True)
        return vals, ids

    route = t_moe.Moe.route

    def recording_route(mod, xt, ids=None):
        r = route(mod, xt, ids=ids)
        port_ids.append(r.ids.numpy().copy())
        return r

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    monkeypatch.setattr(t_moe.Moe, "route", recording_route)
    return ref_ids, port_ids


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference(monkeypatch, arch):
    accum = 2 if arch in ("deepseek-moe-16b", "whisper-large-v3") else 1
    cfg, r_model, tree, jparams = _reference(arch, seed=0)
    jopt = r_adamw_init(jparams)
    params = params_from_jax(cfg, tree)
    opt = state_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jopt))
    moe = cfg.family == "moe"
    if moe:
        ref_ids, port_ids = _routing_recorders(monkeypatch)
    jstep = _jax_step(r_model, accum, "jax")
    step = t_train.build_train_step(build_model(cfg), accum=accum, warmup=1)
    kw = dict(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3)
    rpipe, pipe = RPipeline(**kw), TokenPipeline(**kw)
    rng = np.random.RandomState(4)
    for s in range(5):
        rb, tb = rpipe.next_batch(), pipe.next_batch()
        extra = _extra(cfg, rng, 4)
        jparams, jopt, jm = jstep(jparams, jopt, _jnp(dict(rb, **extra)))
        params, opt, m = step(params, opt, _torch(dict(tb, **extra)))
        if moe:
            jax.effects_barrier()
            assert len(ref_ids) == len(port_ids) > 0
            for i, (a, b) in enumerate(zip(port_ids, ref_ids)):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{arch} step {s}: the routing of MoE "
                    f"call {i} flipped")
            ref_ids.clear()
            port_ids.clear()
        for key in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} step {s}")
    want = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams))
    wopt = state_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jopt))
    assert int(opt["step"]) == int(wopt["step"]) == 5
    for name in want:
        np.testing.assert_allclose(params[name].numpy(),
                                   want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        for mom in ("m", "v"):
            scale = float(wopt[mom][name].abs().max())
            np.testing.assert_allclose(opt[mom][name].numpy(),
                                       wopt[mom][name].numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=name)


# -- train() ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b",
                                  "zamba2-1.2b", "xlstm-350m"])
def test_train_runs_the_token_families(arch):
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    out = t_train.train(cfg, steps=3, global_batch=2, seq_len=16,
                        verbose=False, params=params)
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"] + out["gnorms"]))
    assert any(not torch.equal(out["params"][k], params[k]) for k in params)


@pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                      ("llama-3.2-vision-90b", "images")])
def test_train_refuses_a_family_whose_loss_needs_more_than_tokens(arch,
                                                                  key):
    with pytest.raises(ValueError, match=f"'{key}'"):
        t_train.train(arch, steps=1, global_batch=2, seq_len=16,
                      verbose=False)


# -- flash_attention's launches under training --------------------------------


def _card_dispatch(monkeypatch):
    """The wrapper's CUDA dispatch on CPU tensors: a forward that needs a
    gradient goes through ``FlashAttention`` (its backward counted), any
    other through ``_launch`` — here the plain attention, counted as a
    launch."""
    def launch(q, k, v, causal, group, scale):
        _count.bump(fa.flash_attention, "launches")
        return ref.attention(q, k, v, causal=causal, group=group,
                             scale=scale)

    def on_card(q, k, v, *, causal=True, group=1, scale=None, chunk=1024):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return fa.FlashAttention.apply(q, k, v, causal, group, scale,
                                           chunk)
        return launch(q, k, v, causal, group, scale)

    on_card.launches = on_card.backward_calls = 0
    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(fa, "flash_attention", on_card)
    return on_card


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ("llama3.2-3b",) + ARCHS)
def test_attention_launches_of_a_training_step(monkeypatch, arch, remat):
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    ops.reset_counts()
    counted = _card_dispatch(monkeypatch)
    loss, _ = model.loss_and_grad(params, _torch(_batch(cfg, 2)))
    assert np.isfinite(float(loss))
    want = attention_calls(cfg, training=True)
    assert (counted.launches, counted.backward_calls) == want
    # one prefill: the structure's calls, no backward
    counted.launches = counted.backward_calls = 0
    with torch.no_grad():
        model.prefill(params, _torch(_batch(cfg, 2)))
    assert (counted.launches, counted.backward_calls) == (
        attention_calls(cfg)[0], 0)
    monkeypatch.undo()
    # and on the CPU itself: one plain call per forward, no launch
    ops.reset_counts()
    model.loss_and_grad(params, _torch(_batch(cfg, 2)))
    assert ops.counts()["flash_attention"] == (0, want[0])
