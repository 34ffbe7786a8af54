"""Llama-3.2-Vision-style VLM backbone — the port of the JAX package's
``models/vlm.py``: a dense GQA decoder with a gated cross-attention
layer to the image's patch embeddings at every ``cross_attn_every``-th
place.

The vision tower is a stub, as the reference's: the batch carries patch
embeddings ``images`` (B, n_image_tokens, d_vision), projected to d_model
by ``img_proj``.  The layers form ``n_super = n_layers //
cross_attn_every`` super-blocks, each ``cross_attn_every - 1`` dense
blocks (``self_layers.<s>.<j>.*``, the reference's tree stacked twice)
and one cross block (``cross_layers.<s>.*``) whose output is scaled by
``tanh(gate)``.  The cross-attention is non-causal with Sq the text and
Skv the image tokens — a prompt longer than the image (Sq > Skv) is
allowed — through ``ops.attention``, the flash-attention kernel on a
CUDA tensor.  Cache: ``{"self": {"k", "v"}}`` (n_super,
cross_attn_every - 1, B, S, Hkv, hd) and ``{"cross": {"k", "v"}}``
(n_super, B, n_image_tokens, Hkv, hd).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .transformer import Block, LMBase, xent_loss


class CrossBlock(L.Initialised):
    SPECS = {"gate": (None,)}
    INIT = {"gate": "zeros"}   # gated cross-attention (llama 3.2)

    def __init__(self, cfg):
        super().__init__()
        self.norm = L.Norm(cfg, "rmsnorm")
        self.attn = L.Attention(cfg)
        self.mlp_norm = L.Norm(cfg, "rmsnorm")
        self.mlp = L.Mlp(cfg)
        self.gate = L._param((1,), torch.float32)

    def apply(self, x, img):
        """(out, (k, v) of the image)."""
        kv = self.attn.cross_kv(img)
        c, _ = self.attn.prefill(self.norm(x), causal=False, rope=False,
                                 kv=kv)
        x = x + torch.tanh(self.gate).to(x.dtype) * c
        return x + self.mlp(self.mlp_norm(x)), kv

    def decode(self, x, cross_k, cross_v, pos: int):
        c = self.attn.decode(self.norm(x), cross_k, cross_v, pos, rope=False,
                             cross=True)
        x = x + torch.tanh(self.gate).to(x.dtype) * c
        return x + self.mlp(self.mlp_norm(x))


class VisionLM(LMBase, L.Initialised):
    SPECS = {"img_proj": (None, L.EMBED)}

    def __init__(self, cfg):
        super().__init__()
        k = cfg.cross_attn_every
        assert k > 1
        assert cfg.n_layers % k == 0, "n_layers must divide into super-blocks"
        self.cfg = cfg
        self.n_super = cfg.n_layers // k
        self.self_per_super = k - 1
        self.embed = L.Embedding(cfg)
        self.img_proj = L._param((cfg.d_vision, cfg.d_model), cfg.p_dtype)
        self.self_layers = nn.ModuleList(
            nn.ModuleList(Block(cfg) for _ in range(self.self_per_super))
            for _ in range(self.n_super))
        self.cross_layers = nn.ModuleList(CrossBlock(cfg)
                                          for _ in range(self.n_super))
        self.final_norm = L.Norm(cfg, "rmsnorm")

    def _img_tokens(self, images):
        act = self.cfg.act_dtype
        return torch.matmul(images.to(act), self.img_proj.to(act))

    def _forward(self, batch):
        """(x, self (k, v) by super-block and layer, cross (k, v))."""
        x = self._embed(batch["tokens"])
        img = self._img_tokens(batch["images"])
        selfs, crosses = [], []
        for blocks, cross in zip(self.self_layers, self.cross_layers):
            kvs = []
            for blk in blocks:
                x, kv = blk.prefill(x)
                kvs.append(kv)
            x, ckv = cross.apply(x, img)
            selfs.append(kvs)
            crosses.append(ckv)
        return self.final_norm(x), selfs, crosses

    def loss_fn(self, batch) -> torch.Tensor:
        x, _, _ = self._forward(batch)
        return xent_loss(self.embed.unembed(x), batch["labels"])

    def prefill(self, batch):
        act = self.cfg.act_dtype
        x, selfs, crosses = self._forward(batch)
        logits = self.embed.unembed(x[:, -1:, :])
        cache = {
            "self": {n: torch.stack([torch.stack([kv[i].to(act)
                                                  for kv in kvs])
                                     for kvs in selfs])
                     for i, n in enumerate(("k", "v"))},
            "cross": {n: torch.stack([kv[i].to(act) for kv in crosses])
                      for i, n in enumerate(("k", "v"))},
        }
        return logits, cache

    def decode_step(self, cache, tokens, pos: int):
        """Writes the token's self k and v into ``cache`` in place and
        returns (logits, cache)."""
        x = self._embed(tokens)
        sk, sv = cache["self"]["k"], cache["self"]["v"]
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        for s, (blocks, cross) in enumerate(zip(self.self_layers,
                                                self.cross_layers)):
            for j, blk in enumerate(blocks):
                x = blk.decode(x, sk[s, j], sv[s, j], pos)
            x = cross.decode(x, ck[s], cv[s], pos)
        return self.embed.unembed(self.final_norm(x)), cache

    def cache_spec(self, batch: int, max_seq: int):
        cfg = self.cfg
        dt = cfg.act_dtype
        self_shp = (self.n_super, self.self_per_super, batch, max_seq,
                    cfg.n_kv_heads, cfg.head_dim)
        cross_shp = (self.n_super, batch, cfg.n_image_tokens,
                     cfg.n_kv_heads, cfg.head_dim)
        return {"self": {"k": L.TensorSpec(self_shp, dt),
                         "v": L.TensorSpec(self_shp, dt)},
                "cross": {"k": L.TensorSpec(cross_shp, dt),
                          "v": L.TensorSpec(cross_shp, dt)}}

    def cache_axes(self):
        s = (None, None, "batch", None, L.KV_HEADS, L.HEAD_DIM)
        c = (None, "batch", None, L.KV_HEADS, L.HEAD_DIM)
        return {"self": {"k": s, "v": s}, "cross": {"k": c, "v": c}}
