"""Carry the JAX package's parameters across to the port.

The reference keeps each family's layers stacked on a leading axis
(``{"embed": {"table"}, "final_norm": {...}, "dense_layers": {"attn":
{"wq": (L, d, H, hd), ...}, ...}}``; the vision model's ``self_layers``
on two, (n_super, self_per_super, ...)); the port keeps one module per
layer.  :func:`params_from_jax` takes that tree with numpy leaves (what
``jax.device_get`` or ``np.asarray`` gives) and returns the port's
parameter dict: the same values in the same shapes, the layer axes taken
apart, each named after its tree path with the layer indices put in
(``dense_layers.3.attn.wq``, ``self_layers.0.2.mlp.wo``).  A stack is
any ``nn.ModuleList`` child of the model (``dense_layers``,
``moe_layers``, ``mamba_layers``, ``mlstm_layers``, ``slstm_layers``,
``enc_layers``, ``dec_layers``, ``cross_layers``; ``self_layers`` a list
of lists).  :func:`state_from_jax` does the same for an AdamW state,
whose moments stay f32.  Nothing here imports JAX.
"""
from __future__ import annotations

import itertools
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .api import build_model


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(np.array(a, copy=True).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def params_from_jax(cfg, tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's parameters (CPU tensors, each in its parameter's dtype:
    ``cfg.param_dtype``, and f32 where the reference keeps f32, as the
    MoE router) from the reference's layer-stacked tree of the same
    config."""
    return _named(cfg, tree, None)


def state_from_jax(cfg, opt_tree: Mapping) -> Dict:
    """The port's AdamW state from the reference's ``{"m", "v", "step"}``
    (``adamw_init``'s tree, or one a train step returned): m and v as f32
    CPU tensors named like the parameters, step a 0-dim int32 tensor."""
    return {"m": _named(cfg, opt_tree["m"], torch.float32),
            "v": _named(cfg, opt_tree["v"], torch.float32),
            "step": torch.tensor(int(np.asarray(opt_tree["step"])),
                                 dtype=torch.int32)}


def _stacks(impl: nn.Module) -> Dict[str, tuple]:
    """Each stacked child of the model and its stack shape: a list of
    blocks (n,), or of lists of blocks (n, m)."""
    out = {}
    for name, child in impl.named_children():
        if isinstance(child, nn.ModuleList):
            inner = child[0] if len(child) else None
            out[name] = ((len(child), len(inner))
                         if isinstance(inner, nn.ModuleList)
                         else (len(child),))
    return out


def _named(cfg, tree: Mapping, dtype) -> Dict[str, torch.Tensor]:
    """A layer-stacked tree shaped like the config's parameters, taken
    apart by layer, named as the port names them and cast to ``dtype``
    (None: each parameter's own)."""
    impl = build_model(cfg).impl
    want = {n: p for n, p in impl.named_parameters()}
    stacks = _stacks(impl)
    out = {}
    for name, leaf in _flatten(tree):
        t = _tensor(leaf)
        head, _, rest = name.partition(".")
        if head in stacks:
            shape = stacks[head]
            if tuple(t.shape[:len(shape)]) != shape:
                raise ValueError(f"{name}: {tuple(t.shape[:len(shape)])} "
                                 f"stacked layers, the config has {shape}")
            for idx in itertools.product(*map(range, shape)):
                out[".".join([head, *map(str, idx), rest])] = t[idx]
        else:
            out[name] = t
    if set(out) != set(want):
        raise ValueError(
            f"the tree does not hold the parameters of {cfg.name}: missing "
            f"{sorted(set(want) - set(out))}, unknown "
            f"{sorted(set(out) - set(want))}")
    for name, t in out.items():
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the config "
                             f"gives {tuple(want[name].shape)}")
        out[name] = t.to(dtype or want[name].dtype)
    return out
