"""Mamba2 (SSD) blocks and the zamba2 hybrid model — the port of the JAX
package's ``models/ssm.py``.

The SSD recurrence is computed in its chunked form, as the reference's:
within a chunk of ``ssm_chunk`` steps the terms are dense products, and
the (B, N, H, P) f32 state is carried from chunk to chunk by a Python
loop (the reference's ``lax.scan``).  Two differences of form, none of
value:

* the decays ``exp(cum_i - cum_j)`` are taken with the differences above
  the diagonal (j > i, masked) set to ``-inf`` first, so they are exact
  zeros; the reference takes ``exp`` of all of them and masks after,
  where a large positive difference overflows to ``inf`` (times the mask's
  0: no ``inf * 0`` can arise here).
* ``y_intra`` is contracted pairwise — the (b, c, c, H) weights of
  C_i·B_j times the decays first, then one batched product with
  dt·x — never the (b, c, c, H, P) product, which at zamba2's width
  (c = 128, H = P = 64) is 268 MB of f32 a sequence a chunk.

Decode is the recurrent step on the carried state and a 3-row window of
the causal convolution's input; the port updates both in the cache in
place, and takes the convolution as the prefill does (four products
summed in order in the activation dtype, where the reference's decode
sums them in one einsum): in bf16 a decoded token's convolution then
rounds as the prefill's does.  No TPU kernel runs in a Mamba2 block; the
shared attention block of zamba2 runs the flash-attention kernel once a
call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from .transformer import LMBase, stacked_spec, xent_loss


def _dims(cfg):
    d_inner = 2 * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_head_dim, cfg.ssm_state


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def decays(cum):
    """exp(cum_i - cum_j) for j <= i, else 0: (b, c, H) -> (b, c, c, H),
    the masked differences set to -inf before the exp."""
    c = cum.shape[1]
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    upper = torch.ones((c, c), dtype=torch.bool,
                       device=cum.device).triu(1)[None, :, :, None]
    return torch.exp(diff.masked_fill(upper, float("-inf")))


def chunk_scan(qc, kc, vc, dt, da, chunk: int, state):
    """The chunked SSD / mLSTM recurrence.  Per step i: S_i = a_i S_{i-1}
    + dt_i k_i (x) v_i and y_i = q_i . S_i, with a_i = exp(da_i).

    qc, kc: (b, T, H, N) or (b, T, N) (shared by every head); vc: (b, T,
    H, P); dt, da: (b, T, H), all f32; state: (b, N, H, P) f32.  Returns
    (y (b, T, H, P), final state)."""
    b, t = vc.shape[:2]
    shared = qc.dim() == 3
    ys = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb, dtb, dab = qc[:, sl], kc[:, sl], vc[:, sl], dt[:, sl], \
            da[:, sl]
        cum = torch.cumsum(dab, dim=1)           # (b, c, H) inclusive
        total = cum[:, -1:, :]                   # (b, 1, H)
        dtx = vb * dtb[..., None]                # (b, c, H, P)
        if shared:
            qk = torch.einsum("bin,bjn->bij", qb, kb)[..., None]
            y_inter = torch.einsum("bin,bnhp->bihp", qb, state)
            s_new = torch.einsum("bjn,bjhp->bnhp", kb,
                                 dtx * torch.exp(total - cum)[..., None])
        else:
            qk = torch.einsum("bihn,bjhn->bijh", qb, kb)
            y_inter = torch.einsum("bihn,bnhp->bihp", qb, state)
            s_new = torch.einsum("bjhn,bjhp->bnhp", kb,
                                 dtx * torch.exp(total - cum)[..., None])
        w = qk * decays(cum)                     # (b, c, c, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, dtx)
        ys.append(y_intra + y_inter * torch.exp(cum)[..., None])
        state = torch.exp(total[:, 0])[:, None, :, None] * state + s_new
    return torch.cat(ys, dim=1), state


class Mamba(L.Initialised):
    """One Mamba2 block (pre-RMSNorm, residual)."""

    SPECS = {"in_proj": (L.EMBED, L.MLP), "conv": (None, L.MLP),
             "A_log": (None,), "dt_bias": (None,), "D": (None,),
             "out_proj": (L.MLP, L.EMBED)}
    INIT = {"A_log": "zeros", "dt_bias": "zeros", "D": "ones"}

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        d_inner, nh, _, n = _dims(cfg)
        dt = cfg.p_dtype
        self.norm = L.Norm(cfg, "rmsnorm")
        self.in_proj = L._param((cfg.d_model, 2 * d_inner + 2 * n + nh), dt)
        self.conv = L._param((4, d_inner + 2 * n), dt)
        self.A_log = L._param((nh,), torch.float32)
        self.dt_bias = L._param((nh,), torch.float32)
        self.D = L._param((nh,), torch.float32)
        self.out_proj = L._param((d_inner, cfg.d_model), dt)

    def _split(self, proj):
        d_inner, _, _, n = _dims(self.cfg)
        return torch.split(proj, [d_inner, d_inner, n, n,
                                  proj.shape[-1] - 2 * d_inner - 2 * n],
                           dim=-1)

    def _gates(self, dt_raw):
        dt = softplus(dt_raw.float() + self.dt_bias)
        return dt, -torch.exp(self.A_log) * dt   # log decay (negative)

    def apply(self, x):
        """Full-sequence chunked SSD.  x: (B, T, d) -> (out, cache), the
        cache the final state and the last 3 conv inputs."""
        cfg = self.cfg
        b, t, _ = x.shape
        d_inner, nh, hp, n = _dims(cfg)
        xn = self.norm(x)
        z, xs, bmat, cmat, dt_raw = self._split(
            torch.matmul(xn, self.in_proj.to(xn.dtype)))
        conv_in = torch.cat([xs, bmat, cmat], dim=-1)
        w = self.conv.to(xn.dtype)
        pad = F.pad(conv_in, (0, 0, 3, 0))
        conv = 0
        for i in range(4):   # depthwise causal conv, width 4
            conv = conv + pad[:, i:i + t, :] * w[i]
        xs, bmat, cmat = torch.split(F.silu(conv), [d_inner, n, n], dim=-1)
        dt, da = self._gates(dt_raw)             # (B, T, H)

        c = min(cfg.ssm_chunk, t)
        assert t % c == 0, "seq_len must be a multiple of ssm_chunk"
        xh = xs.reshape(b, t, nh, hp).float()
        init = torch.zeros((b, n, nh, hp), dtype=torch.float32,
                           device=x.device)
        y, state = chunk_scan(cmat.float(), bmat.float(), xh, dt, da, c,
                              init)
        y = y + self.D[None, None, :, None] * xh
        y = y.reshape(b, t, d_inner).to(x.dtype) * F.silu(z)
        out = torch.matmul(y, self.out_proj.to(x.dtype))
        return x + out, {"state": state, "conv": conv_in[:, -3:, :].to(
            x.dtype)}

    def decode(self, x, state, conv):
        """One recurrent step.  x: (B, 1, d); state (B, N, H, P) f32 and the
        conv window (B, 3, C) are updated in place."""
        b = x.shape[0]
        d_inner, nh, hp, n = _dims(self.cfg)
        xn = self.norm(x)
        z, xs, bmat, cmat, dt_raw = self._split(
            torch.matmul(xn, self.in_proj.to(xn.dtype)))
        conv_in = torch.cat([xs, bmat, cmat], dim=-1)[:, 0]     # (B, C)
        window = torch.cat([conv, conv_in[:, None].to(conv.dtype)], dim=1)
        w = self.conv.to(xn.dtype)
        acc = 0
        for i in range(4):
            acc = acc + window[:, i] * w[i]
        conv_out = F.silu(acc)
        xs1, b1, c1 = torch.split(conv_out, [d_inner, n, n], dim=-1)
        dt, da = self._gates(dt_raw[:, 0])       # (B, H)
        xhp = xs1.reshape(b, nh, hp).float()
        upd = torch.einsum("bn,bhp->bnhp", b1.float(), xhp * dt[..., None])
        state.copy_(torch.exp(da)[:, None, :, None] * state + upd)
        y = torch.einsum("bn,bnhp->bhp", c1.float(), state)
        y = y + self.D[None, :, None] * xhp
        y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
        conv.copy_(window[:, 1:])
        return x + torch.matmul(y, self.out_proj.to(x.dtype))


def mamba_cache_spec(cfg, batch: int, dtype):
    d_inner, nh, hp, n = _dims(cfg)
    return {"state": L.TensorSpec((batch, n, nh, hp), torch.float32),
            "conv": L.TensorSpec((batch, 3, d_inner + 2 * n), dtype)}


class SharedAttn(nn.Module):
    """zamba2's shared attention + MLP block (RMSNorms), one parameter
    set applied after every group of Mamba2 blocks."""

    def __init__(self, cfg):
        super().__init__()
        self.norm = L.Norm(cfg, "rmsnorm")
        self.attn = L.Attention(cfg)
        self.mlp_norm = L.Norm(cfg, "rmsnorm")
        self.mlp = L.Mlp(cfg)

    def apply(self, x):
        h, kv = self.attn.prefill(self.norm(x), causal=True, rope=True)
        x = x + h
        return x + self.mlp(self.mlp_norm(x)), kv

    def decode(self, x, cache_k, cache_v, pos: int):
        x = x + self.attn.decode(self.norm(x), cache_k, cache_v, pos,
                                 rope=True)
        return x + self.mlp(self.mlp_norm(x))


class Zamba2LM(LMBase):
    """``attn_every`` Mamba2 blocks a group, the one shared attention
    block applied after each group (its per-call LoRA deltas omitted, as
    the reference omits them).  Parameters: ``mamba_layers.<i>.*``,
    ``shared_attn.*``; the cache ``{"ssm": {"state", "conv"}, "attn":
    {"k", "v"}}``, the attention's stacked by call."""

    def __init__(self, cfg):
        super().__init__()
        assert cfg.attn_every > 0
        self.cfg = cfg
        self.embed = L.Embedding(cfg)
        self.mamba_layers = nn.ModuleList(Mamba(cfg)
                                          for _ in range(cfg.n_layers))
        self.shared_attn = SharedAttn(cfg)
        self.final_norm = L.Norm(cfg, "rmsnorm")
        self.n_groups = len(self.groups())

    def groups(self):
        """(first layer, size) of each group: ``attn_every`` layers, the
        last group what is left."""
        every = self.cfg.attn_every
        return [(lo, min(every, self.cfg.n_layers - lo))
                for lo in range(0, self.cfg.n_layers, every)]

    def _forward(self, x, keep_cache: bool):
        """(x, ssm caches by layer, attention (k, v) by group), the caches
        empty unless ``keep_cache``.  Each Mamba2 block runs under
        :meth:`_layer` and the shared attention block does not, as the
        reference checkpoints its scan bodies and not the shared block."""
        ssm, attn = [], []
        for lo, size in self.groups():
            for blk in self.mamba_layers[lo:lo + size]:
                x, c = self._layer(blk.apply, x)
                if keep_cache:
                    ssm.append(c)
            x, kv = self.shared_attn.apply(x)
            if keep_cache:
                attn.append(kv)
        return self.final_norm(x), ssm, attn

    def loss_fn(self, batch) -> torch.Tensor:
        x, _, _ = self._forward(self._embed(batch["tokens"]), False)
        return xent_loss(self.embed.unembed(x), batch["labels"])

    def prefill(self, batch):
        act = self.cfg.act_dtype
        x, ssm, attn = self._forward(self._embed(batch["tokens"]), True)
        logits = self.embed.unembed(x[:, -1:, :])
        cache = {
            "ssm": {n: torch.stack([c[n] for c in ssm])
                    for n in ("state", "conv")},
            "attn": {"k": torch.stack([k.to(act) for k, _ in attn]),
                     "v": torch.stack([v.to(act) for _, v in attn])},
        }
        return logits, cache

    def decode_step(self, cache, tokens, pos: int):
        """Updates ``cache`` in place and returns (logits, cache)."""
        x = self._embed(tokens)
        st, cv = cache["ssm"]["state"], cache["ssm"]["conv"]
        ak, av = cache["attn"]["k"], cache["attn"]["v"]
        for g, (lo, size) in enumerate(self.groups()):
            for i in range(lo, lo + size):
                x = self.mamba_layers[i].decode(x, st[i], cv[i])
            x = self.shared_attn.decode(x, ak[g], av[g], pos)
        logits = self.embed.unembed(self.final_norm(x))
        return logits, cache

    def cache_spec(self, batch: int, max_seq: int):
        cfg = self.cfg
        one = mamba_cache_spec(cfg, batch, cfg.act_dtype)
        attn = L.attention_cache_spec(cfg, batch, max_seq, cfg.act_dtype)
        return {"ssm": {n: stacked_spec(s, cfg.n_layers)
                        for n, s in one.items()},
                "attn": {n: stacked_spec(s, self.n_groups)
                         for n, s in attn.items()}}

    def cache_axes(self):
        return {
            "ssm": {"state": (None, "batch", None, None, None),
                    "conv": (None, "batch", None, L.MLP)},
            "attn": {"k": (None, "batch", None, L.KV_HEADS, L.HEAD_DIM),
                     "v": (None, "batch", None, L.KV_HEADS, L.HEAD_DIM)},
        }
