"""Dense decoder-only LM (the starcoder2 / nemotron / llama / qwen
families) with GQA + RoPE, and the entry points of serving: prefill,
decode_step and the cache; ``loss_fn`` runs the forward pass — the port
of the JAX package's ``models/transformer.py``.

The reference scans a layer-stacked parameter tree; here each layer is a
``Block`` of its own in ``dense_layers`` and the scan is a Python loop.
Training differentiates ``loss_fn`` (``forward``); with
``cfg.remat`` each layer of it runs under ``torch.utils.checkpoint``
(non-reentrant), which keeps only the layer's input and recomputes the
rest in the backward pass — the reference's ``jax.checkpoint`` of each
layer body.  Parameter names follow
the reference's tree paths with the layer index put in:
``dense_layers.<i>.attn.wq`` is layer i of ``dense_layers/attn/wq``.  The
KV cache keeps the reference's layout, ``{"dense": {"k", "v"}}``, each
(L, B, S, Hkv, hd).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits (B, T, V) f32; labels (B, T)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - ll)


class Block(nn.Module):
    """One pre-norm decoder layer: attention and an MLP, each residual."""

    def __init__(self, cfg):
        super().__init__()
        self.rope = cfg.rope_theta > 0
        self.attn_norm = L.Norm(cfg)
        self.attn = L.Attention(cfg)
        self.mlp_norm = L.Norm(cfg)
        self.mlp = L.Mlp(cfg)

    def prefill(self, x):
        h, kv = self.attn.prefill(self.attn_norm(x), causal=True,
                                  rope=self.rope)
        x = x + h
        return x + self.mlp(self.mlp_norm(x)), kv

    def decode(self, x, cache_k, cache_v, pos: int):
        x = x + self.attn.decode(self.attn_norm(x), cache_k, cache_v, pos,
                                 rope=self.rope)
        return x + self.mlp(self.mlp_norm(x))


class DenseLM(nn.Module):
    """The dense family.  (The reference's class also serves MoE LMs; that
    family waits for its own slice.)"""

    def __init__(self, cfg):
        super().__init__()
        if cfg.family == "moe":
            raise NotImplementedError(
                "the MoE family is not ported yet (ROADMAP, queue A item 9: "
                "the LM stack's other families)")
        if cfg.family != "dense":
            raise ValueError(f"DenseLM serves the dense family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.embed = L.Embedding(cfg)
        self.final_norm = L.Norm(cfg)
        self.dense_layers = nn.ModuleList(Block(cfg)
                                          for _ in range(cfg.n_layers))

    # -- params ---------------------------------------------------------------

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
                    out[f"{mod_name}.{name}"] = mod.SPECS[name]
        return out

    # -- entry points -----------------------------------------------------------

    def _embed(self, tokens):
        return self.embed.embed(tokens).to(self.cfg.act_dtype)

    def loss_fn(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.dense_layers:
            if remat:
                x = checkpoint(lambda h, blk=blk: blk.prefill(h)[0], x,
                               use_reentrant=False)
            else:
                x, _ = blk.prefill(x)
        logits = self.embed.unembed(self.final_norm(x))
        return xent_loss(logits, batch["labels"])

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
        ks, vs = [], []
        for blk in self.dense_layers:
            x, (k, v) = blk.prefill(x)
            ks.append(k.to(act))
            vs.append(v.to(act))
        x = self.final_norm(x)
        logits = self.embed.unembed(x[:, -1:, :])
        return logits, {"dense": {"k": torch.stack(ks),
                                  "v": torch.stack(vs)}}

    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) current token; pos: its position.  Writes the
        token's k and v into ``cache`` in place (the reference returns a
        new cache; the port saves the copy) and returns (logits, cache)."""
        x = self._embed(tokens)
        ck, cv = cache["dense"]["k"], cache["dense"]["v"]
        for i, blk in enumerate(self.dense_layers):
            x = blk.decode(x, ck[i], cv[i], pos)
        logits = self.embed.unembed(self.final_norm(x))
        return logits, cache

    # -- cache ------------------------------------------------------------------

    def cache_spec(self, batch: int, max_seq: int):
        """Each layer's ``layers.attention_cache_spec``, stacked."""
        cfg = self.cfg
        one = L.attention_cache_spec(cfg, batch, max_seq, cfg.act_dtype)
        return {"dense": {n: L.TensorSpec((cfg.n_layers,) + s.shape, s.dtype)
                          for n, s in one.items()}}

    def cache_init(self, batch: int, max_seq: int, device=None):
        return {fam: {n: torch.zeros(s.shape, dtype=s.dtype, device=device)
                      for n, s in leaves.items()}
                for fam, leaves in self.cache_spec(batch, max_seq).items()}

    def cache_axes(self):
        """Logical axes of the cache leaves: (layers, batch, seq, kv_heads,
        head_dim)."""
        spec = (None, "batch", None, L.KV_HEADS, L.HEAD_DIM)
        return {"dense": {"k": spec, "v": spec}}
