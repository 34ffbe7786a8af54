"""Shared building blocks of the LM stack: norms, embeddings, RoPE, GQA
attention (prefill and decode), MLP variants — the port of the JAX
package's ``models/layers.py``.

Conventions (as the reference's):
  * activations are (batch, seq, d_model); heads are a separate axis
    only inside attention;
  * math runs in the activation dtype, with f32 for norms, RoPE, softmax
    and the logits;
  * every weight is an ``nn.Parameter`` of the reference's shape and name,
    with the logical axes of that name in the module's ``SPECS``.  Modules
    are built on the ``meta`` device: ``init`` draws values, and
    ``models.api.Model`` binds a set of them before it runs.

Prefill attention runs through ``kernels.ops.attention`` (the
hand-written flash-attention kernel on a CUDA tensor, its plain version
on a CPU tensor); decode attention is plain tensor code, as the
reference's is plain ``jnp``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import mesh_ops
from ..kernels import ops

# logical axis names (the reference's; ``distributed.sharding`` maps them)
EMBED, MLP, HEADS, KV_HEADS, HEAD_DIM, VOCAB, EXPERTS = (
    "embed", "mlp", "heads", "kv_heads", "head_dim", "vocab", "experts")

#: the masked decode score, as the reference's
NEG_INF = -1e30


def _param(shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                        requires_grad=False)


def he_init(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    """N(0, 1 / fan_in) drawn in f32 on the generator's device, then cast
    (the reference's ``he_init``; fan_in defaults to shape[0])."""
    fan_in = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * (1.0 / math.sqrt(fan_in))).to(dtype)


class Initialised(nn.Module):
    """A module whose parameters ``draw`` fills: ``INIT`` maps a name to
    "ones", "zeros", a function of (shape, dtype, device) or the fan-in of
    a he_init draw (None = shape[0])."""

    INIT: Dict[str, object] = {}
    SPECS: Dict[str, Tuple] = {}

    def draw(self, name: str, shape, dtype,
             gen: torch.Generator) -> torch.Tensor:
        how = self.INIT.get(name)
        if how == "ones":
            return torch.ones(shape, dtype=dtype, device=gen.device)
        if how == "zeros":
            return torch.zeros(shape, dtype=dtype, device=gen.device)
        if callable(how):
            return how(shape, dtype, gen.device)
        return he_init(gen, shape, dtype, fan_in=how)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(scale, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(scale, bias, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


class Norm(Initialised):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) over d_model,
    in f32, eps 1e-5: ``kind`` ("rmsnorm" or "layernorm"), by default
    ``cfg.norm`` (the families' blocks that fix one kind pass it)."""

    INIT = {"scale": "ones", "bias": "zeros"}
    SPECS = {"scale": (EMBED,), "bias": (EMBED,)}

    def __init__(self, cfg, kind: str = None):
        super().__init__()
        self.layer = (kind or cfg.norm) == "layernorm"
        self.scale = _param((cfg.d_model,), cfg.p_dtype)
        if self.layer:
            self.bias = _param((cfg.d_model,), cfg.p_dtype)

    def forward(self, x):
        if self.layer:
            return layernorm(self.scale, self.bias, x)
        return rmsnorm(self.scale, x)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


class Embedding(Initialised):
    """The tied token table.  An id outside [0, vocab) raises (on the CPU)
    or trips a device assert (on the card), where the reference's
    ``jnp.take`` clamps it to the table's edge."""

    SPECS = {"table": (VOCAB, EMBED)}

    def __init__(self, cfg):
        super().__init__()
        self.table = _param((cfg.vocab, cfg.d_model), cfg.p_dtype)
        self.INIT = {"table": cfg.d_model}

    def embed(self, tokens):
        return mesh_ops.embedding(tokens, self.table)

    def unembed(self, x):
        """Tied logits in f32 (an f32 copy of the table on every call, as
        the reference makes)."""
        return torch.matmul(x.float(), self.table.float().t())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Half-split
    rotation in f32, the result in x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs           # (..., seq, d/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., seq, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def _project(x, w):
    """x (b, t, d) @ w (d, *out) -> (b, t, *out) in x's dtype."""
    b, t, d = x.shape
    y = torch.matmul(x, w.to(x.dtype).reshape(d, -1))
    return y.view(b, t, *w.shape[1:])


class Attention(Initialised):
    SPECS = {
        "wq": (EMBED, HEADS, HEAD_DIM), "wk": (EMBED, KV_HEADS, HEAD_DIM),
        "wv": (EMBED, KV_HEADS, HEAD_DIM), "wo": (HEADS, HEAD_DIM, EMBED),
        "bq": (HEADS, HEAD_DIM), "bk": (KV_HEADS, HEAD_DIM),
        "bv": (KV_HEADS, HEAD_DIM),
    }

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        hd, dt = cfg.head_dim, cfg.p_dtype
        self.wq = _param((cfg.d_model, cfg.n_heads, hd), dt)
        self.wk = _param((cfg.d_model, cfg.n_kv_heads, hd), dt)
        self.wv = _param((cfg.d_model, cfg.n_kv_heads, hd), dt)
        self.wo = _param((cfg.n_heads, hd, cfg.d_model), dt)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads, hd), dt)
            self.bk = _param((cfg.n_kv_heads, hd), dt)
            self.bv = _param((cfg.n_kv_heads, hd), dt)
        self.INIT = {"wo": cfg.n_heads * hd, "bq": "zeros", "bk": "zeros",
                     "bv": "zeros"}

    def qkv(self, x, positions, rope: bool = True):
        cfg = self.cfg
        k, v = _project(x, self.wk), _project(x, self.wv)
        if cfg.qkv_bias:
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        if rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        return self.query(x, positions, rope), k, v

    def query(self, x, positions, rope: bool = True):
        """q alone (a cross-attention's: its k and v come from another
        sequence)."""
        cfg = self.cfg
        q = _project(x, self.wq)
        if cfg.qkv_bias:
            q = q + self.bq.to(x.dtype)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        return q

    def cross_kv(self, src):
        """A cross-attention's k and v, (B, S_src, Hkv, hd), from the
        sequence ``src`` it attends to: its projections without bias, as
        the reference's encoder-decoder and vision models take them."""
        return _project(src, self.wk), _project(src, self.wv)

    def out(self, ctx, dtype):
        """ctx (b, t, H, hd) -> (b, t, d_model) through wo."""
        b, t = ctx.shape[:2]
        wo = self.wo.to(dtype)
        return torch.matmul(ctx.reshape(b, t, -1),
                            wo.reshape(-1, wo.shape[-1]))

    def prefill(self, x, causal: bool = True, rope: bool = True, kv=None):
        """Full-sequence attention.  Returns (out, (k, v)), k and v as
        (B, Skv, Hkv, hd).  ``kv``: the (k, v) of another sequence (a
        cross-attention, the reference's ``kv_override``), any Skv."""
        cfg = self.cfg
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device).expand(b, t)
        if kv is None:
            q, k, v = self.qkv(x, positions, rope)
        else:
            q, (k, v) = self.query(x, positions, rope), kv
        group = cfg.n_heads // cfg.n_kv_heads
        # (B, T, H, D) -> (B, H, T, D) views for the kernel
        ctx = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, group=group,
                            chunk=min(cfg.attn_chunk, k.shape[1]))
        return self.out(ctx.transpose(1, 2), x.dtype), (k, v)

    def decode(self, x, cache_k, cache_v, pos: int, rope: bool = True,
               cross: bool = False):
        """One token at position ``pos``.  x: (B, 1, d); cache_k/cache_v:
        (B, S, Hkv, hd), written in place at ``pos`` — or, with ``cross``,
        another sequence's k and v, all of them attended to and left as
        they are.  Returns out."""
        cfg = self.cfg
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        if cross:
            q = self.query(x, positions, rope)
        else:
            q, k, v = self.qkv(x, positions, rope)
            cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
            cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        group = cfg.n_heads // cfg.n_kv_heads
        qg = q[:, 0].reshape(b, cfg.n_kv_heads, group, cfg.head_dim)
        scores = torch.einsum("bhgk,bshk->bhgs", qg.float(),
                              cache_k.float()) * (cfg.head_dim ** -0.5)
        if not cross:
            valid = torch.arange(cache_k.shape[1], device=x.device) <= pos
            scores = torch.where(valid, scores,
                                 torch.tensor(NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhgs,bshk->bhgk", probs, cache_v.float())
        ctx = ctx.reshape(b, 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
        return self.out(ctx, x.dtype)


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def attention_cache_spec(cfg, batch: int, max_seq: int, dtype):
    """One layer's cache leaves, ``{"k", "v"}``, each (B, S, Hkv, hd)."""
    spec = TensorSpec((batch, max_seq, cfg.n_kv_heads, cfg.head_dim), dtype)
    return {"k": spec, "v": spec}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class Mlp(Initialised):
    """SwiGLU (wi, wg, wo), squared ReLU or GeLU (wi, wo).  GeLU is the
    tanh approximation, ``jax.nn.gelu``'s default."""

    SPECS = {"wi": (EMBED, MLP), "wg": (EMBED, MLP), "wo": (MLP, EMBED)}

    def __init__(self, cfg):
        super().__init__()
        self.variant = cfg.mlp_variant
        self.wi = _param((cfg.d_model, cfg.d_ff), cfg.p_dtype)
        if self.variant == "swiglu":
            self.wg = _param((cfg.d_model, cfg.d_ff), cfg.p_dtype)
        self.wo = _param((cfg.d_ff, cfg.d_model), cfg.p_dtype)
        self.INIT = {"wo": cfg.d_ff}

    def forward(self, x):
        h = torch.matmul(x, self.wi.to(x.dtype))
        if self.variant == "swiglu":
            g = torch.matmul(x, self.wg.to(x.dtype))
            h = F.silu(g) * h
        elif self.variant == "relu2":   # nemotron squared-ReLU
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        return torch.matmul(h, self.wo.to(x.dtype))
