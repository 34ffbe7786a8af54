"""xLSTM blocks: mLSTM (matrix memory, chunked) and sLSTM (scalar memory
with a hidden-to-hidden recurrence, a loop over time) — the port of the
JAX package's ``models/xlstm.py``.

As the reference: sigmoid input and forget gates for the mLSTM (its
chunked form is then Mamba2's SSD with per-head decays,
``ssm.chunk_scan``, decays from ``log(f + 1e-8)``, masked to ``-inf``
before the exp), and the normaliser folded in as an extra value column
(v' = [v, 1]), so h = num / max(|den|, 1) comes out of one recurrence.
The sLSTM's time scan (the reference's ``lax.scan``) is a Python loop over
T.  Decode carries the mLSTM state (B, hd, H, hd + 1) f32 and the sLSTM's
c, n (f32) and h, updated in the cache in place.  Training differentiates
``loss_fn``: the sLSTM's time loop runs under autograd, one small step a
position; under ``cfg.remat`` each mLSTM block is checkpointed and the
sLSTM blocks are not, as the reference's.  The family runs no TPU
kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .ssm import chunk_scan
from .transformer import LMBase, stacked_spec, xent_loss


def _dims(cfg):
    nh = cfg.n_heads
    return nh, cfg.d_model // nh   # heads, qk and v head dim


def _if_bias(shape, dtype, device):
    """Input gates' bias 0, forget gates' 2 (remember by default)."""
    nh = shape[0] // 2
    return torch.cat([torch.zeros(nh, dtype=dtype, device=device),
                      torch.full((nh,), 2.0, dtype=dtype, device=device)])


class MLstm(L.Initialised):
    SPECS = {"wqkv": (L.EMBED, L.MLP), "wif": (L.EMBED, None),
             "if_bias": (None,), "wo_gate": (L.EMBED, L.MLP),
             "out_proj": (L.MLP, L.EMBED)}
    INIT = {"if_bias": _if_bias}

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        nh, _ = _dims(cfg)
        d, dt = cfg.d_model, cfg.p_dtype
        self.norm = L.Norm(cfg, "rmsnorm")
        self.wqkv = L._param((d, 3 * d), dt)
        self.wif = L._param((d, 2 * nh), dt)
        self.if_bias = L._param((2 * nh,), torch.float32)
        self.wo_gate = L._param((d, d), dt)
        self.out_proj = L._param((d, d), dt)

    def _gates(self, xn):
        nh, _ = _dims(self.cfg)
        raw = torch.matmul(xn, self.wif.to(xn.dtype)).float() + self.if_bias
        return torch.sigmoid(raw[..., :nh]), torch.sigmoid(raw[..., nh:])

    def _out(self, x, xn, h):
        og = torch.sigmoid(torch.matmul(xn, self.wo_gate.to(xn.dtype)))
        return x + torch.matmul(h * og, self.out_proj.to(x.dtype))

    def apply(self, x):
        """(out, {"state"}) of the whole sequence."""
        b, t, d = x.shape
        nh, hd = _dims(self.cfg)
        xn = self.norm(x)
        q, k, v = torch.matmul(xn, self.wqkv.to(xn.dtype)).chunk(3, dim=-1)
        q = q.reshape(b, t, nh, hd)
        k = k.reshape(b, t, nh, hd) / (hd ** 0.5)
        v = v.reshape(b, t, nh, hd)
        i_g, f_g = self._gates(xn)
        v1 = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                      device=v.device)], dim=-1)
        c = min(self.cfg.ssm_chunk, t)
        assert t % c == 0
        init = torch.zeros((b, hd, nh, hd + 1), dtype=torch.float32,
                           device=x.device)
        yv, state = chunk_scan(q.float(), k.float(), v1.float(), i_g,
                               torch.log(f_g + 1e-8), c, init)
        num, den = yv[..., :hd], yv[..., hd:]
        h = (num / torch.clamp_min(den.abs(), 1.0)).reshape(b, t, d)
        return self._out(x, xn, h.to(x.dtype)), {"state": state}

    def decode(self, x, state):
        """One step; ``state`` (B, hd, H, hd + 1) updated in place."""
        b, _, d = x.shape
        nh, hd = _dims(self.cfg)
        xn = self.norm(x)
        q, k, v = torch.matmul(xn, self.wqkv.to(xn.dtype))[:, 0].chunk(
            3, dim=-1)
        q = q.reshape(b, nh, hd).float()
        k = (k.reshape(b, nh, hd) / (hd ** 0.5)).float()
        v = v.reshape(b, nh, hd).float()
        v1 = torch.cat([v, torch.ones((b, nh, 1), dtype=torch.float32,
                                      device=x.device)], dim=-1)
        i_g, f_g = self._gates(xn)
        i1, f1 = i_g[:, 0], f_g[:, 0]            # (B, H)
        state.copy_(f1[:, None, :, None] * state + torch.einsum(
            "bhn,bhp->bnhp", k, v1 * i1[..., None]))
        yv = torch.einsum("bhn,bnhp->bhp", q, state)
        num, den = yv[..., :hd], yv[..., hd:]
        h = (num / torch.clamp_min(den.abs(), 1.0)).reshape(b, 1, d)
        return self._out(x, xn, h.to(x.dtype))


class SLstm(L.Initialised):
    SPECS = {"wx": (L.EMBED, L.MLP), "rh": (L.HEADS, None, None),
             "bias": (None,), "out_proj": (L.MLP, L.EMBED)}

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        nh, hd = _dims(cfg)
        d, dt = cfg.d_model, cfg.p_dtype
        self.norm = L.Norm(cfg, "rmsnorm")
        self.wx = L._param((d, 4 * d), dt)            # z i f o
        self.rh = L._param((nh, hd, 4 * hd), dt)      # block-diagonal
        self.bias = L._param((4 * d,), torch.float32)
        self.out_proj = L._param((d, d), dt)
        self.INIT = {"rh": hd, "bias": "zeros"}

    def cell(self, xt, c_prev, n_prev, h_prev):
        """One step.  xt: (B, 4d) precomputed W x; returns (c, n, h)."""
        nh, hd = _dims(self.cfg)
        b = xt.shape[0]
        rec = torch.einsum("bhk,hkg->bhg", h_prev.reshape(b, nh, hd),
                           self.rh.to(h_prev.dtype)).reshape(b, 4 * nh * hd)
        pre = (xt + rec).float() + self.bias
        z, i, f, o = pre.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c_prev + i * torch.tanh(z)
        n_new = f * n_prev + i
        h_new = o * c_new / torch.clamp_min(n_new, 1.0)
        return c_new, n_new, h_new.to(h_prev.dtype)

    def apply(self, x):
        """(out, {"c", "n", "h"}) of the whole sequence."""
        b, t, d = x.shape
        wx = torch.matmul(self.norm(x), self.wx.to(x.dtype))
        c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        h = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        hs = []
        for i in range(t):
            c, n, h = self.cell(wx[:, i], c, n, h)
            hs.append(h)
        out = torch.matmul(torch.stack(hs, dim=1).to(x.dtype),
                           self.out_proj.to(x.dtype))
        return x + out, {"c": c, "n": n, "h": h}

    def decode(self, x, c, n, h):
        """One step; c, n, h (B, d) updated in place."""
        wx = torch.matmul(self.norm(x), self.wx.to(x.dtype))[:, 0]
        c1, n1, h1 = self.cell(wx, c, n, h)
        c.copy_(c1)
        n.copy_(n1)
        h.copy_(h1)
        return x + torch.matmul(h1.to(x.dtype),
                                self.out_proj.to(x.dtype))[:, None, :]


class XLSTMLM(LMBase):
    """mLSTM blocks with an sLSTM block at every ``slstm_every``-th place
    (i % k == k - 1).  Parameters ``mlstm_layers.<i>.*`` and
    ``slstm_layers.<i>.*`` (one sLSTM parameter set even when the config
    places none, as the reference draws); the cache ``{"mlstm":
    {"state"}, "slstm": {"c", "n", "h"}}``, stacked by block."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        k = cfg.slstm_every
        self.slstm_idx = [i for i in range(cfg.n_layers)
                          if k and i % k == k - 1]
        self.mlstm_idx = [i for i in range(cfg.n_layers)
                          if i not in self.slstm_idx]
        self.embed = L.Embedding(cfg)
        self.mlstm_layers = nn.ModuleList(MLstm(cfg)
                                          for _ in self.mlstm_idx)
        self.slstm_layers = nn.ModuleList(
            SLstm(cfg) for _ in range(max(len(self.slstm_idx), 1)))
        self.final_norm = L.Norm(cfg, "rmsnorm")

    def _order(self):
        """(kind, index within its kind) of each layer, in order."""
        out, mi, si = [], 0, 0
        for i in range(self.cfg.n_layers):
            if i in self.slstm_idx:
                out.append(("s", si))
                si += 1
            else:
                out.append(("m", mi))
                mi += 1
        return out

    def _forward(self, x, keep_cache: bool):
        """(x, mLSTM caches, sLSTM caches), the caches empty unless
        ``keep_cache``.  Each mLSTM block runs under :meth:`_layer` and
        the sLSTM blocks do not, as the reference checkpoints its mLSTM
        scan bodies only."""
        cm, cs = [], []
        for kind, j in self._order():
            if kind == "m":
                x, c = self._layer(self.mlstm_layers[j].apply, x)
                if keep_cache:
                    cm.append(c)
            else:
                x, c = self.slstm_layers[j].apply(x)
                if keep_cache:
                    cs.append(c)
        return self.final_norm(x), cm, cs

    def loss_fn(self, batch) -> torch.Tensor:
        x, _, _ = self._forward(self._embed(batch["tokens"]), False)
        return xent_loss(self.embed.unembed(x), batch["labels"])

    def prefill(self, batch):
        x, cm, cs = self._forward(self._embed(batch["tokens"]), True)
        logits = self.embed.unembed(x[:, -1:, :])
        cache = {"mlstm": {"state": torch.stack([c["state"] for c in cm])}}
        if cs:
            cache["slstm"] = {n: torch.stack([c[n] for c in cs])
                              for n in ("c", "n", "h")}
        return logits, cache

    def decode_step(self, cache, tokens, pos: int):
        """Updates ``cache`` in place and returns (logits, cache)."""
        x = self._embed(tokens)
        for kind, j in self._order():
            if kind == "m":
                x = self.mlstm_layers[j].decode(x,
                                                cache["mlstm"]["state"][j])
            else:
                s = cache["slstm"]
                x = self.slstm_layers[j].decode(x, s["c"][j], s["n"][j],
                                                s["h"][j])
        logits = self.embed.unembed(self.final_norm(x))
        return logits, cache

    def cache_spec(self, batch: int, max_seq: int):
        cfg = self.cfg
        nh, hd = _dims(cfg)
        out = {"mlstm": {"state": L.TensorSpec(
            (len(self.mlstm_idx), batch, hd, nh, hd + 1), torch.float32)}}
        if self.slstm_idx:
            n = len(self.slstm_idx)
            one = L.TensorSpec((batch, cfg.d_model), torch.float32)
            out["slstm"] = {"c": stacked_spec(one, n),
                            "n": stacked_spec(one, n),
                            "h": stacked_spec(L.TensorSpec(
                                (batch, cfg.d_model), cfg.act_dtype), n)}
        return out

    def cache_axes(self):
        out = {"mlstm": {"state": (None, "batch", None, L.HEADS, None)}}
        if self.slstm_idx:
            out["slstm"] = {"c": (None, "batch", L.EMBED),
                            "n": (None, "batch", L.EMBED),
                            "h": (None, "batch", L.EMBED)}
        return out
