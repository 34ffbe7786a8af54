"""Whisper-style encoder-decoder backbone — the port of the JAX package's
``models/encdec.py``.

The audio frontend is a stub, as the reference's: the batch carries
frame embeddings ``frames`` (B, n_frames, d_model).  The encoder is a
non-causal transformer over them with sinusoid positions; the decoder
has learned positions ``pos``, causal self-attention and
cross-attention to the encoder's output, LayerNorms and GeLU throughout.
Every prefill attention — the encoder's (Sq = Skv = n_frames), the
decoder's causal self-attention and its cross-attention (Sq the text,
Skv the frames, either longer) — runs through ``ops.attention``, the
flash-attention kernel on a CUDA tensor.  Decode keeps the reference's
cache, ``{"self_k", "self_v", "cross_k", "cross_v"}``, each (L, B, S,
Hkv, hd): the self entries written in place at ``pos``, the cross ones
(the encoder's k and v from the prefill) read as they are.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .transformer import LMBase, xent_loss


def sinusoid(t: int, d: int, device=None) -> torch.Tensor:
    """(t, d) f32: sin of pos / 10000**(2i/d) in the first half, cos in
    the second."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.attn_norm = L.Norm(cfg, "layernorm")
        self.attn = L.Attention(cfg)
        self.mlp_norm = L.Norm(cfg, "layernorm")
        self.mlp = L.Mlp(cfg)

    def forward(self, x):
        a, _ = self.attn.prefill(self.attn_norm(x), causal=False, rope=False)
        x = x + a
        return x + self.mlp(self.mlp_norm(x))


class DecBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.self_norm = L.Norm(cfg, "layernorm")
        self.self_attn = L.Attention(cfg)
        self.cross_norm = L.Norm(cfg, "layernorm")
        self.cross_attn = L.Attention(cfg)
        self.mlp_norm = L.Norm(cfg, "layernorm")
        self.mlp = L.Mlp(cfg)

    def apply(self, x, enc):
        """(out, self (k, v), cross (k, v)) of the whole sequence."""
        a, self_kv = self.self_attn.prefill(self.self_norm(x), causal=True,
                                            rope=False)
        x = x + a
        cross_kv = self.cross_attn.cross_kv(enc)
        c, _ = self.cross_attn.prefill(self.cross_norm(x), causal=False,
                                       rope=False, kv=cross_kv)
        x = x + c
        return x + self.mlp(self.mlp_norm(x)), self_kv, cross_kv

    def decode(self, x, self_k, self_v, cross_k, cross_v, pos: int):
        x = x + self.self_attn.decode(self.self_norm(x), self_k, self_v, pos,
                                      rope=False)
        x = x + self.cross_attn.decode(self.cross_norm(x), cross_k, cross_v,
                                       pos, rope=False, cross=True)
        return x + self.mlp(self.mlp_norm(x))


class EncDecLM(LMBase, L.Initialised):
    """Parameters ``embed.table``, ``pos``, ``enc_layers.<i>.*``,
    ``enc_norm.*``, ``dec_layers.<i>.*``, ``dec_norm.*``."""

    SPECS = {"pos": (None, L.EMBED)}

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.n_enc = cfg.n_enc_layers or cfg.n_layers
        self.n_dec = cfg.n_layers
        self.embed = L.Embedding(cfg)
        self.pos = L._param((cfg.max_position, cfg.d_model), cfg.p_dtype)
        self.INIT = {"pos": cfg.d_model}
        self.enc_layers = nn.ModuleList(EncBlock(cfg)
                                        for _ in range(self.n_enc))
        self.enc_norm = L.Norm(cfg, "layernorm")
        self.dec_layers = nn.ModuleList(DecBlock(cfg)
                                        for _ in range(self.n_dec))
        self.dec_norm = L.Norm(cfg, "layernorm")

    def encode(self, frames):
        x = frames.to(self.cfg.act_dtype)
        x = x + sinusoid(x.shape[1], self.cfg.d_model,
                         x.device).to(x.dtype)[None]
        for blk in self.enc_layers:
            x = blk(x)
        return self.enc_norm(x)

    def _dec_embed(self, tokens, pos0: int = 0):
        x = self._embed(tokens)
        return x + self.pos[pos0:pos0 + tokens.shape[1]].to(x.dtype)[None]

    def _decoder(self, batch):
        enc = self.encode(batch["frames"])
        x = self._dec_embed(batch["tokens"])
        caches = []
        for blk in self.dec_layers:
            x, self_kv, cross_kv = blk.apply(x, enc)
            caches.append((self_kv, cross_kv))
        return self.dec_norm(x), caches

    def loss_fn(self, batch) -> torch.Tensor:
        x, _ = self._decoder(batch)
        return xent_loss(self.embed.unembed(x), batch["labels"])

    def prefill(self, batch):
        act = self.cfg.act_dtype
        x, caches = self._decoder(batch)
        logits = self.embed.unembed(x[:, -1:, :])
        cache = {}
        for name, part, i in (("self_k", 0, 0), ("self_v", 0, 1),
                              ("cross_k", 1, 0), ("cross_v", 1, 1)):
            cache[name] = torch.stack([c[part][i].to(act) for c in caches])
        return logits, cache

    def decode_step(self, cache, tokens, pos: int):
        """Writes the token's self k and v into ``cache`` in place and
        returns (logits, cache)."""
        x = self._dec_embed(tokens, pos)
        for i, blk in enumerate(self.dec_layers):
            x = blk.decode(x, cache["self_k"][i], cache["self_v"][i],
                           cache["cross_k"][i], cache["cross_v"][i], pos)
        return self.embed.unembed(self.dec_norm(x)), cache

    def cache_spec(self, batch: int, max_seq: int):
        cfg = self.cfg
        hkv, dt = cfg.n_kv_heads, cfg.act_dtype
        self_shp = (self.n_dec, batch, max_seq, hkv, cfg.head_dim)
        cross_shp = (self.n_dec, batch, cfg.n_frames, hkv, cfg.head_dim)
        return {"self_k": L.TensorSpec(self_shp, dt),
                "self_v": L.TensorSpec(self_shp, dt),
                "cross_k": L.TensorSpec(cross_shp, dt),
                "cross_v": L.TensorSpec(cross_shp, dt)}

    def cache_axes(self):
        spec = (None, "batch", None, L.KV_HEADS, L.HEAD_DIM)
        return {k: spec for k in ("self_k", "self_v", "cross_k", "cross_v")}
