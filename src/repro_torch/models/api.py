"""Uniform model interface of the port (the counterpart of the JAX
package's ``models/api.py``):

    model = build_model(cfg)
    params = model.init(gen)                  # or convert.params_from_jax
    loss = model.loss_fn(params, batch)
    loss, grads = model.loss_and_grad(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, cache, tokens, pos)

``input_specs(shape, kind)`` returns ``meta`` tensors standing in for
every input (no allocation) and ``input_axes(kind)`` their logical axes:
the dry run (``launch/dryrun.py``) traces against these.

Every family of the reference is served: dense and MoE
(``transformer.DenseLM``), the Mamba2 hybrid (``ssm.Zamba2LM``), xLSTM
(``xlstm.XLSTMLM``), encoder-decoder (``encdec.EncDecLM``: the batch also
carries ``frames``) and vision (``vlm.VisionLM``: ``images``).
``params`` is a dict of tensors named as the family's module names its
parameters.  The model is built on the ``meta`` device and holds no
weights of its own: an entry point binds the ``params`` it is given
(without copying them) and binds again when another dict comes or an
entry of the bound dict is replaced; an update in place
(``params[name].copy_(...)``) is seen as it is.  ``loss_and_grad`` runs
the module on the caller's tensors instead (``torch.func.functional_call``),
so that the gradient reaches them; it leaves the bound dict as it was.
Every family trains; a parameter the loss does not reach gets a zero
gradient, as ``jax.value_and_grad`` gives it (an xLSTM cut to fewer
layers than ``slstm_every`` draws an sLSTM parameter set it never runs).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from .encdec import EncDecLM
from .ssm import Zamba2LM
from .transformer import DenseLM, zeros_of
from .vlm import VisionLM
from .xlstm import XLSTMLM


def build_model(cfg: ModelConfig) -> "Model":
    fam = cfg.family
    if fam in ("dense", "moe"):
        return Model(cfg, DenseLM(cfg))
    if fam == "hybrid":
        return Model(cfg, Zamba2LM(cfg))
    if fam == "ssm":
        return Model(cfg, XLSTMLM(cfg))
    if fam == "encdec":
        return Model(cfg, EncDecLM(cfg))
    if fam == "vlm":
        return Model(cfg, VisionLM(cfg))
    raise ValueError(f"unknown family {fam}")


class Model:
    def __init__(self, cfg: ModelConfig, impl: nn.Module):
        self.cfg = cfg
        self.impl = impl
        self._bound: Optional[Dict[str, torch.Tensor]] = None
        self._bound_values: tuple = ()

    def _bind(self, params: Dict[str, torch.Tensor]) -> nn.Module:
        values = tuple(params.values())
        if params is not self._bound or len(values) != len(
                self._bound_values) or any(
                a is not b for a, b in zip(values, self._bound_values)):
            self.impl.load_state_dict(params, strict=True, assign=True)
            self._bound, self._bound_values = params, values
        return self.impl

    # -- delegation -------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """Parameters drawn from ``gen``, on the generator's device."""
        return self.impl.init(gen)

    def param_specs(self):
        return self.impl.param_specs()

    def loss_fn(self, params, batch):
        return self._bind(params).loss_fn(batch)

    def loss_and_grad(self, params, batch):
        """(loss, grads): the training loss and its gradient, a dict named
        like ``params`` with each gradient in its parameter's dtype (the
        reference's ``jax.value_and_grad(model.loss_fn)``).  ``params`` are
        not changed and need not require grad.  A parameter the loss does
        not reach gets a zero gradient."""
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            loss, grads = torch.func.functional_call(
                self.impl, leaves, (batch,), {"wrt": list(leaves.values())})
        return loss.detach(), dict(zip(names, grads))

    def prefill(self, params, batch):
        return self._bind(params).prefill(batch)

    def decode_step(self, params, cache, tokens, pos: int):
        return self._bind(params).decode_step(cache, tokens, pos)

    def cache_spec(self, batch: int, max_seq: int):
        return self.impl.cache_spec(batch, max_seq)

    def cache_init(self, batch: int, max_seq: int, device=None):
        return self.impl.cache_init(batch, max_seq, device)

    def cache_axes(self):
        return self.impl.cache_axes()

    # -- shape stand-ins ---------------------------------------------------------

    def input_specs(self, shape: ShapeConfig, kind: str = None) -> Dict:
        """``meta`` tensors for the batch dict of ``kind`` ("train" |
        "prefill" | "decode"; default ``shape.kind``): the reference's
        shapes and dtypes."""
        cfg = self.cfg
        kind = kind or shape.kind
        b, t = shape.global_batch, shape.seq_len

        def meta(dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if kind in ("train", "prefill"):
            specs = {"tokens": meta((b, t))}
            if kind == "train":
                specs["labels"] = meta((b, t))
            if cfg.family == "encdec":
                specs["frames"] = meta((b, cfg.n_frames, cfg.d_model),
                                       cfg.act_dtype)
            if cfg.family == "vlm":
                specs["images"] = meta((b, cfg.n_image_tokens, cfg.d_vision),
                                       cfg.act_dtype)
            return specs
        if kind == "decode":
            return {"tokens": meta((b, 1)), "pos": meta(()),
                    "cache": zeros_of(self.cache_spec(b, t), "meta")}
        raise ValueError(kind)

    def input_axes(self, kind: str) -> Dict:
        """Logical axes of each input (the batch axis sharded over data)."""
        cfg = self.cfg
        if kind in ("train", "prefill"):
            axes = {"tokens": ("batch", None)}
            if kind == "train":
                axes["labels"] = ("batch", None)
            if cfg.family == "encdec":
                axes["frames"] = ("batch", None, None)
            if cfg.family == "vlm":
                axes["images"] = ("batch", None, None)
            return axes
        if kind == "decode":
            return {"tokens": ("batch", None), "pos": (),
                    "cache": self.cache_axes()}
        raise ValueError(kind)

    def param_count(self, params=None) -> int:
        tensors = (self.impl.parameters() if params is None
                   else params.values())
        return sum(math.prod(t.shape) for t in tensors)

    def active_param_count(self) -> int:
        """For MoE: the parameters a token touches (the 6·N_active·D
        roofline), the routed experts it does not choose left out."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.family != "moe":
            return total
        per_expert = 3 * cfg.d_model * cfg.expert_d_ff
        n_moe_layers = cfg.n_layers - cfg.first_k_dense
        return total - n_moe_layers * (cfg.n_experts - cfg.top_k) \
            * per_expert
