"""The port's other LM families against the JAX package, on the CPU: MoE
(deepseek-moe-16b, dbrx-132b), the Mamba2 hybrid (zamba2-1.2b), xLSTM
(xlstm-350m), encoder-decoder (whisper-large-v3), vision
(llama-3.2-vision-90b) and the dense weld-bench config.

* Each smoke config with the reference's parameters carried across by
  ``params_from_jax`` (norm scales, biases, the SSM's A_log, dt_bias and
  D, the vision model's gates drawn at random too, so that they count):
  prefill logits, every cache leaf, 4 teacher-forced ``decode_step``s
  and ``loss_fn``, in f32, each within 1e-5 of its largest |value| (the
  backends sum in other orders; about 3e-6 of it seen).
* MoE: the chosen expert ids, the slots' order and the kept-slot mask
  equal the reference's exactly, at the config's capacity factor and at
  one small enough that most experts drop slots; the layer's output and
  load-balance loss agree to 1e-5; two runs are bitwise equal.
* ``serve``'s greedy tokens equal the JAX ``serve``'s for the same seed
  and weights (frames and images drawn in the reference's order).
* Decode against prefill, teacher-forced, within the port.
* ``list_configs`` equals the reference's; ``param_specs`` names every
  parameter with the reference's axes (less the stack axes);
  ``active_param_count`` equals the reference's; ``train`` refuses the
  families it does not train.

Inputs come from numpy seeds; JAX inputs carry explicit dtypes.
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
from repro.configs import list_configs as r_list_configs
from repro.launch import serve as r_serve
from repro.models import build_model as r_build_model
from repro.models import moe as r_moe
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import params_from_jax

FAMILIES = ("deepseek-moe-16b", "dbrx-132b", "zamba2-1.2b", "xlstm-350m",
            "whisper-large-v3", "llama-3.2-vision-90b", "weld-bench")
MOE = ("deepseek-moe-16b", "dbrx-132b")
UNTRAINED = ("deepseek-moe-16b", "dbrx-132b", "zamba2-1.2b", "xlstm-350m",
             "whisper-large-v3", "llama-3.2-vision-90b")
#: of the largest |value| of what is compared
REL = 1e-5
#: a prompt length that is a multiple of the smoke SSM chunk (16)
PROMPT = 32

#: leaves drawn at random on top of the reference's init (constants there)
_PERTURBED = ("scale", "'bq'", "'bk'", "'bv'", "bias", "'gate'", "A_log",
              "'D'")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


def _held(got, want, what: str) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= REL * max(scale, 1e-30), (
        f"{what}: max |port - reference| {err}, {err / max(scale, 1e-30)} "
        f"of the largest |value| {scale}")


def _reference(arch, seed, cfg=None):
    """The reference's smoke model and its parameters with the constant
    leaves drawn at random, as numpy and as jnp."""
    cfg = cfg or r_get_config(arch, smoke=True)
    model = r_build_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in _PERTURBED):
            return (leaf + 0.3 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, a.dtype), tree)
    return cfg, model, tree, jtree


def _batches(cfg, rng, b, t, steps):
    """Tokens (b, t + steps), labels, and the reference's and the port's
    prefill batches (with frames or images where the family takes them)."""
    toks = rng.randint(0, cfg.vocab, (b, t + steps)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (b, t)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.randn(b, cfg.n_frames,
                                    cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        extra["images"] = rng.randn(b, cfg.n_image_tokens,
                                    cfg.d_vision).astype(np.float32)
    r_batch = {"tokens": jnp.asarray(toks[:, :t], jnp.int32)}
    t_batch = {"tokens": torch.from_numpy(toks[:, :t])}
    for k, v in extra.items():
        r_batch[k] = jnp.asarray(v, jnp.float32)
        t_batch[k] = torch.from_numpy(v)
    return toks, labels, r_batch, t_batch


def _leaves(cache, r_cache):
    """(path, port leaf, reference leaf) of every cache leaf."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(r_cache):
        node = cache
        for key in path:
            node = node[key.key]
        yield jax.tree_util.keystr(path), node, leaf


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_the_reference(arch):
    r_cfg, r_model, tree, jtree = _reference(arch, seed=3)
    cfg = get_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(r_cfg)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        r_get_config(arch))
    model = build_model(cfg)
    params = params_from_jax(cfg, tree)
    assert model.param_count(params) == r_model.param_count(jtree)
    rng = np.random.RandomState(4)
    b, t, steps = 2, PROMPT, 4
    toks, labels, r_batch, t_batch = _batches(cfg, rng, b, t, steps)

    r_logits, r_cache = jax.jit(r_model.prefill)(jtree, r_batch)
    r_cache = r_serve._pad_cache_to(r_cache, r_model.cache_init(b, t + steps))
    r_dec = jax.jit(r_model.decode_step)
    r_loss = jax.jit(r_model.loss_fn)(
        jtree, dict(r_batch, labels=jnp.asarray(labels, jnp.int32)))

    with torch.inference_mode():
        logits, cache = model.prefill(params, t_batch)
        _held(logits, r_logits, f"{arch} prefill logits")
        cache = t_serve._pad_cache_to(cache, model.cache_spec(b, t + steps))
        for path, got, want in _leaves(cache, r_cache):
            assert got.dtype == {np.dtype("float32"): torch.float32}[
                want.dtype], path
            _held(got, want, f"{arch} prefill cache {path}")
        for s in range(steps):
            tok = toks[:, t + s:t + s + 1]
            r_out, r_cache = r_dec(jtree, r_cache,
                                   jnp.asarray(tok, jnp.int32),
                                   jnp.int32(t + s))
            out, cache = model.decode_step(params, cache,
                                           torch.from_numpy(tok), t + s)
            _held(out, r_out, f"{arch} decode step {s}")
        for path, got, want in _leaves(cache, r_cache):
            _held(got, want, f"{arch} cache after decode {path}")
        loss = model.loss_fn(params, dict(t_batch,
                                          labels=torch.from_numpy(labels)))
    _held(float(loss), float(r_loss), f"{arch} loss")


# -- MoE routing --------------------------------------------------------------


def _reference_routing(monkeypatch, params, x, cfg):
    """The reference's moe_apply on ``x`` (not jitted), with its top-k
    ids, slot order and kept-slot mask taken from its own intermediates."""
    seen = {}
    top_k, argsort, searchsorted = jax.lax.top_k, jnp.argsort, \
        jnp.searchsorted

    def rec(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen.setdefault(name, out)
            return out
        return wrapped

    monkeypatch.setattr(jax.lax, "top_k", rec("top_k", top_k))
    monkeypatch.setattr(jnp, "argsort", rec("argsort", argsort))
    monkeypatch.setattr(jnp, "searchsorted", rec("searchsorted",
                                                 searchsorted))
    out, aux = r_moe.moe_apply(params, x, cfg)
    monkeypatch.undo()
    ids = np.asarray(seen["top_k"][1])
    order = np.asarray(seen["argsort"])
    seg_starts = np.asarray(seen["searchsorted"])
    n_tok = ids.shape[0]
    cap = max(int(cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts
                  + 0.5), 4)
    sorted_ids = ids.reshape(-1)[order]
    keep = np.arange(ids.size) - seg_starts[sorted_ids] < cap
    return np.asarray(out), float(aux), ids, order, keep


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_equals_the_reference(monkeypatch, arch,
                                          capacity_factor):
    r_cfg = r_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    if capacity_factor is not None:
        r_cfg = dataclasses.replace(r_cfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    _, _, tree, jtree = _reference(arch, seed=5, cfg=r_cfg)
    params = params_from_jax(cfg, tree)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda a: a[0], jtree["moe_layers"]["mlp"])
    want, want_aux, ids, order, keep = _reference_routing(
        monkeypatch, layer, jnp.asarray(x, jnp.float32), r_cfg)
    if capacity_factor is not None:
        assert not keep.all(), "no slot dropped: the case tests nothing"

    model = build_model(cfg)
    moe = model._bind(params).moe_layers[0].mlp
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        r = moe.route(xt.reshape(-1, cfg.d_model))
        out, aux = moe(xt)
        again, _ = moe(xt)
    assert r.cap == t_moe.capacity(cfg, 32)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    _held(out, want, f"{arch} MoE output")
    _held(float(aux), want_aux, f"{arch} MoE aux loss")
    assert torch.equal(out, again)


def test_moe_route_takes_given_ids():
    """``route(xt, ids)`` routes to the given experts, gated by the
    router's renormalised probabilities there: the top-k ids give the
    free routing back bitwise; other ids move the slots."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    model = build_model(cfg)
    moe = model._bind(model.init(torch.Generator().manual_seed(4))) \
        .moe_layers[0].mlp
    xt = torch.from_numpy(np.random.RandomState(4).randn(
        20, cfg.d_model).astype(np.float32))
    free = moe.route(xt)
    same = moe.route(xt, ids=free.ids)
    for a, b in zip(free, same):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    other = torch.roll(free.ids, 1, dims=0)
    moved = moe.route(xt, ids=other)
    probs = torch.softmax(xt @ moe.router, dim=-1).gather(1, other)
    np.testing.assert_allclose(moved.gates.numpy(),
                               (probs / probs.sum(-1, keepdim=True)).numpy(),
                               rtol=1e-6)
    assert torch.equal(moved.ids, other)


def test_moe_capacity_is_the_reference_arithmetic():
    cfg = get_config("deepseek-moe-16b")
    # 1.25 * 1024 * 6 / 64 = 120.0; rounded half up, floored at 4
    assert t_moe.capacity(cfg, 1024) == 120
    assert t_moe.capacity(cfg, 2) == 4
    assert t_moe.capacity(dataclasses.replace(cfg, capacity_factor=1.0),
                          1000) == int(1000 * 6 / 64 + 0.5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_is_bitwise_repeatable(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(8))
    toks = {"tokens": torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (2, 24)).astype(np.int32))}
    with torch.inference_mode():
        a, ca = model.prefill(params, toks)
        b, cb = model.prefill(params, toks)
    assert torch.equal(a, b)
    assert all(torch.equal(ca[k][n], cb[k][n]) for k in ca for n in ca[k])


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("arch", UNTRAINED)
def test_serve_tokens_equal_the_reference(arch):
    seed, batch, prompt, gen_len = 5, 2, 16, 6
    want = r_serve.serve(arch, smoke=True, batch=batch, prompt_len=prompt,
                         gen_len=gen_len, seed=seed, verbose=False)
    cfg = get_config(arch, smoke=True)
    r_model = r_build_model(r_get_config(arch, smoke=True))
    tree = jax.tree_util.tree_map(np.asarray,
                                  r_model.init(jax.random.PRNGKey(seed)))
    got = t_serve.serve(arch, smoke=True, batch=batch, prompt_len=prompt,
                        gen_len=gen_len, seed=seed, verbose=False,
                        params=params_from_jax(cfg, tree))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["logits"].shape == (batch, gen_len, cfg.vocab)
    assert bool(torch.isfinite(got["logits"]).all())


@pytest.mark.parametrize("arch", UNTRAINED)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode after a prefill of half the prompt
    reproduces the prefill of the whole prompt (f32: 1e-4 of the largest
    |logit|; the chunked scans and the recurrences sum in other orders).
    MoE at a capacity factor of E / k, where no slot can drop: a prefill
    drops the slots past an expert's capacity over the whole batch, which
    a decode of one token a row never reaches (the reference's
    semantics, held in ``test_moe_routing_equals_the_reference``)."""
    cfg = get_config(arch, smoke=True)
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    if cfg.family == "vlm":   # the reference draws the gates at 0
        for name in params:
            if name.endswith(".gate"):
                params[name].fill_(0.5)
    rng = np.random.RandomState(2)
    t, half = PROMPT, PROMPT // 2
    toks, _, _, batch = _batches(cfg, rng, 2, t, 0)
    with torch.inference_mode():
        full, _ = model.prefill(params, batch)
        _, cache = model.prefill(params, dict(
            batch, tokens=batch["tokens"][:, :half]))
        cache = t_serve._pad_cache_to(cache, model.cache_spec(2, t))
        for i in range(half, t):
            step, cache = model.decode_step(
                params, cache, batch["tokens"][:, i:i + 1], i)
    scale = float(full.abs().max())
    assert float((step - full).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-large-v3"])
def test_decode_drift_reads_zero_in_f32(arch):
    """``launch.decode_drift`` (decode against prefill, and a prefix's
    prefill against the same position inside the whole prompt's) reads
    next to nothing in f32 on the smoke configs."""
    from repro_torch.launch import decode_drift

    cfg = get_config(arch, smoke=True)
    dec, pre = decode_drift.drift(cfg, PROMPT, PROMPT // 2, seed=3,
                                  dev=torch.device("cpu"))
    assert dec <= 1e-5 and pre <= 1e-5, (dec, pre)


def test_pad_cache_walks_any_tree():
    """Each leaf is padded on its one differing axis; a leaf shaped as its
    spec passes through as it is."""
    from repro_torch.models.layers import TensorSpec

    state = torch.ones((2, 3))
    cache = {"a": {"k": torch.ones((1, 2, 4, 3)), "state": state},
             "b": torch.ones((2, 5))}
    spec = {"a": {"k": TensorSpec((1, 2, 6, 3), torch.float32),
                  "state": TensorSpec((2, 3), torch.float32)},
            "b": TensorSpec((2, 5), torch.float32)}
    out = t_serve._pad_cache_to(cache, spec)
    assert out["a"]["state"] is state and out["b"] is cache["b"]
    assert out["a"]["k"].shape == (1, 2, 6, 3)
    assert float(out["a"]["k"][:, :, 4:].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="more than one axis"):
        t_serve._pad_cache_to({"x": torch.ones((2, 2))},
                              {"x": TensorSpec((3, 3), torch.float32)})


# -- registry, specs, counts --------------------------------------------------


def test_the_port_registers_every_reference_config():
    assert list_configs() == r_list_configs()


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_specs_cover_params(arch):
    """Every parameter has logical axes of its rank: the reference's at
    its tree path, less the stack axes the port takes apart."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    specs = model.param_specs()
    params = dict(model.impl.named_parameters())
    assert set(specs) == set(params)
    r_model = r_build_model(r_get_config(arch, smoke=True))
    r_specs = r_model.param_specs()
    for name, p in params.items():
        assert len(specs[name]) == p.dim(), (name, specs[name], p.shape)
        parts = [s for s in name.split(".") if not s.isdigit()]
        node = r_specs
        for part in parts:
            node = node[part]
        stacked = len(name.split(".")) - len(parts)
        assert tuple(node) == (None,) * stacked + tuple(specs[name]), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_active_param_count_equals_the_reference(arch):
    for smoke in (True, False):
        model = build_model(get_config(arch, smoke=smoke))
        r_model = r_build_model(r_get_config(arch, smoke=smoke))
        assert model.param_count() == r_model.param_count()
        assert model.active_param_count() == r_model.active_param_count()


@pytest.mark.parametrize("arch", UNTRAINED)
def test_train_refuses_the_untrained_families(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_train.train(arch, steps=1, global_batch=2, seq_len=16,
                      verbose=False)
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    with pytest.raises(NotImplementedError, match="training on the new"):
        model.loss_and_grad(model.init(torch.Generator().manual_seed(0)),
                            {})


def test_params_from_jax_takes_a_doubly_stacked_tree():
    """The vision model's ``self_layers`` are stacked (n_super,
    self_per_super, ...): each block gets its own slice; a stack of the
    wrong depth is refused."""
    arch = "llama-3.2-vision-90b"
    _, _, tree, _ = _reference(arch, seed=1)
    cfg = get_config(arch, smoke=True)
    params = params_from_jax(cfg, tree)
    np.testing.assert_array_equal(
        params["self_layers.1.0.mlp.wo"].numpy(),
        tree["self_layers"]["mlp"]["wo"][1, 0])
    assert params["cross_layers.1.gate"].dtype == torch.float32
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_jax(dataclasses.replace(cfg, n_layers=6), tree)
