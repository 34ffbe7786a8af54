"""Dense decoder-only LM (the starcoder2 / nemotron / llama / qwen
families) with GQA + RoPE, which also serves the MoE LMs (deepseek-moe,
dbrx: ``family == "moe"``, the first ``first_k_dense`` layers dense, the
rest MoE), and the entry points of serving: prefill, decode_step and the
cache; ``loss_fn`` runs the forward pass — the port of the JAX package's
``models/transformer.py``.  Also hosts what every family shares
(:class:`LMBase`: parameter drawing, specs, the cache tree).

The reference scans a layer-stacked parameter tree; here each layer is a
``Block`` of its own in ``dense_layers`` (and ``moe_layers``) and the
scan is a Python loop.
Training differentiates ``loss_fn`` (``forward``); with
``cfg.remat`` each layer of it runs under ``torch.utils.checkpoint``
(non-reentrant), which keeps only the layer's input and recomputes the
rest in the backward pass — the reference's ``jax.checkpoint`` of each
layer body.  Parameter names follow
the reference's tree paths with the layer index put in:
``dense_layers.<i>.attn.wq`` is layer i of ``dense_layers/attn/wq``.  The
KV cache keeps the reference's layout, ``{"dense": {"k", "v"}}`` (and
``"moe"``), each (L, B, S, Hkv, hd).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .moe import Moe


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits (B, T, V) f32; labels (B, T)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - ll)


def stacked_spec(spec: L.TensorSpec, n: int) -> L.TensorSpec:
    """``spec`` with a leading stack axis of ``n``."""
    return L.TensorSpec((n,) + tuple(spec.shape), spec.dtype)


def zeros_of(tree, device=None):
    """Zero tensors for a (nested) dict of ``TensorSpec``s."""
    if isinstance(tree, Mapping):
        return {k: zeros_of(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


class LMBase(nn.Module):
    """What every family's model shares: parameters drawn module by module
    (each :class:`layers.Initialised` draws its own), their logical axes,
    the token embedding, and zero caches from ``cache_spec``."""

    def init(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh parameters, drawn from ``gen`` on its device with the
        reference's distributions (not its bits), in parameter order."""
        out = {}
        for mod_name, mod in self.named_modules():
            if not isinstance(mod, L.Initialised):
                continue
            for name, p in mod.named_parameters(recurse=False):
                full = f"{mod_name}.{name}" if mod_name else name
                out[full] = mod.draw(name, tuple(p.shape), p.dtype, gen)
        return out

    def param_specs(self) -> Dict[str, Tuple]:
        """Logical axes of every parameter, by name."""
        out = {}
        for mod_name, mod in self.named_modules():
            if isinstance(mod, L.Initialised):
                for name, _ in mod.named_parameters(recurse=False):
                    full = f"{mod_name}.{name}" if mod_name else name
                    out[full] = mod.SPECS[name]
        return out

    def _embed(self, tokens):
        return self.embed.embed(tokens).to(self.cfg.act_dtype)

    def cache_init(self, batch: int, max_seq: int, device=None):
        return zeros_of(self.cache_spec(batch, max_seq), device)


class Block(nn.Module):
    """One pre-norm decoder layer: attention and an MLP (or, with ``moe``,
    a mixture of experts), each residual."""

    def __init__(self, cfg, moe: bool = False):
        super().__init__()
        self.rope = cfg.rope_theta > 0
        self.attn_norm = L.Norm(cfg)
        self.attn = L.Attention(cfg)
        self.mlp_norm = L.Norm(cfg)
        self.mlp = Moe(cfg) if moe else L.Mlp(cfg)
        self.moe = moe

    def _ffn(self, z):
        """(out, aux): the MoE's load-balance loss, 0.0 for an MLP."""
        return self.mlp(z) if self.moe else (self.mlp(z), 0.0)

    def apply(self, x):
        """(out, (k, v), aux) of the whole sequence."""
        h, kv = self.attn.prefill(self.attn_norm(x), causal=True,
                                  rope=self.rope)
        x = x + h
        h2, aux = self._ffn(self.mlp_norm(x))
        return x + h2, kv, aux

    def prefill(self, x):
        out, kv, _ = self.apply(x)
        return out, kv

    def decode(self, x, cache_k, cache_v, pos: int):
        x = x + self.attn.decode(self.attn_norm(x), cache_k, cache_v, pos,
                                 rope=self.rope)
        return x + self._ffn(self.mlp_norm(x))[0]


class DenseLM(LMBase):
    """The dense family, and the MoE family (``family == "moe"``): the
    first ``first_k_dense`` layers dense (``dense_layers``), the rest MoE
    (``moe_layers``)."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"DenseLM serves the dense and MoE families, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self.is_moe = cfg.family == "moe"
        self.n_dense = cfg.first_k_dense if self.is_moe else cfg.n_layers
        self.n_moe = cfg.n_layers - self.n_dense
        self.embed = L.Embedding(cfg)
        self.final_norm = L.Norm(cfg)
        if self.n_dense:
            self.dense_layers = nn.ModuleList(Block(cfg)
                                              for _ in range(self.n_dense))
        if self.n_moe:
            self.moe_layers = nn.ModuleList(Block(cfg, moe=True)
                                            for _ in range(self.n_moe))

    def _stacks(self):
        """(cache key, blocks) in the order the layers run."""
        out = []
        if self.n_dense:
            out.append(("dense", self.dense_layers))
        if self.n_moe:
            out.append(("moe", self.moe_layers))
        return out

    # -- entry points -----------------------------------------------------------

    def loss_fn(self, batch) -> torch.Tensor:
        """Mean next-token cross-entropy; for MoE plus 0.01 times the
        layers' load-balance losses over n_layers, as the reference's."""
        x = self._embed(batch["tokens"])
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = 0.0
        for _, blocks in self._stacks():
            for blk in blocks:
                if remat:   # keeps (out, aux), drops the layer's k and v
                    x, a = checkpoint(
                        lambda h, blk=blk: blk.apply(h)[::2], x,
                        use_reentrant=False)
                else:
                    x, _, a = blk.apply(x)
                aux = aux + a
        logits = self.embed.unembed(self.final_norm(x))
        loss = xent_loss(logits, batch["labels"])
        if self.is_moe:
            loss = loss + 0.01 * aux / self.cfg.n_layers
        return loss

    def forward(self, batch, wrt: Sequence[torch.Tensor]):
        """(loss, grads): the training loss and its gradient with respect
        to ``wrt``, taken while they are bound (so that a checkpointed
        layer's recompute reads them too)."""
        loss = self.loss_fn(batch)
        return loss, torch.autograd.grad(loss, wrt)

    def prefill(self, batch):
        """Logits of the last position (B, 1, V) f32 and the prompt's cache
        (each (L, B, T, Hkv, hd) in the activation dtype)."""
        act = self.cfg.act_dtype
        x = self._embed(batch["tokens"])
        cache = {}
        for key, blocks in self._stacks():
            ks, vs = [], []
            for blk in blocks:
                x, (k, v) = blk.prefill(x)
                ks.append(k.to(act))
                vs.append(v.to(act))
            cache[key] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        x = self.final_norm(x)
        logits = self.embed.unembed(x[:, -1:, :])
        return logits, cache

    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) current token; pos: its position.  Writes the
        token's k and v into ``cache`` in place (the reference returns a
        new cache; the port saves the copy) and returns (logits, cache)."""
        x = self._embed(tokens)
        for key, blocks in self._stacks():
            ck, cv = cache[key]["k"], cache[key]["v"]
            for i, blk in enumerate(blocks):
                x = blk.decode(x, ck[i], cv[i], pos)
        logits = self.embed.unembed(self.final_norm(x))
        return logits, cache

    # -- cache ------------------------------------------------------------------

    def cache_spec(self, batch: int, max_seq: int):
        """Each layer's ``layers.attention_cache_spec``, stacked."""
        cfg = self.cfg
        one = L.attention_cache_spec(cfg, batch, max_seq, cfg.act_dtype)
        return {key: {n: stacked_spec(s, len(blocks)) for n, s in one.items()}
                for key, blocks in self._stacks()}

    def cache_axes(self):
        """Logical axes of the cache leaves: (layers, batch, seq, kv_heads,
        head_dim)."""
        spec = (None, "batch", None, L.KV_HEADS, L.HEAD_DIM)
        return {key: {"k": spec, "v": spec} for key, _ in self._stacks()}
