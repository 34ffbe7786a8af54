"""Uniform model interface of the port (the counterpart of the JAX
package's ``models/api.py``):

    model = build_model(cfg)
    params = model.init(gen)                  # or convert.params_from_jax
    loss = model.loss_fn(params, batch)
    loss, grads = model.loss_and_grad(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, cache, tokens, pos)

``params`` is a dict of tensors named as ``DenseLM``'s parameters.  The
model is built on the ``meta`` device and holds no weights of its own:
an entry point binds the ``params`` it is given (without copying them)
and binds again when another dict comes or an entry of the bound dict
is replaced; an update in place (``params[name].copy_(...)``) is seen as
it is.  ``loss_and_grad`` runs the module on the caller's tensors
instead (``torch.func.functional_call``), so that the gradient reaches
them; it leaves the bound dict as it was.  Only the dense family is
ported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from .transformer import DenseLM

#: the families that wait for later slices (ROADMAP, queue A item 9)
_LATER = ("moe", "hybrid", "ssm", "encdec", "vlm")


def build_model(cfg: ModelConfig) -> "Model":
    if cfg.family == "dense":
        return Model(cfg, DenseLM(cfg))
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP, queue A "
            f"item 9: the LM stack's other families)")
    raise ValueError(f"unknown family {cfg.family}")


class Model:
    def __init__(self, cfg: ModelConfig, impl: DenseLM):
        self.cfg = cfg
        self.impl = impl
        self._bound: Optional[Dict[str, torch.Tensor]] = None
        self._bound_values: tuple = ()

    def _bind(self, params: Dict[str, torch.Tensor]) -> DenseLM:
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
        not changed and need not require grad."""
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

    def param_count(self, params=None) -> int:
        tensors = (self.impl.parameters() if params is None
                   else params.values())
        return sum(math.prod(t.shape) for t in tensors)
