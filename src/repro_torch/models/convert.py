"""Carry the JAX package's parameters across to the port.

The reference keeps a dense LM's layers stacked on a leading axis
(``{"embed": {"table"}, "final_norm": {...}, "dense_layers": {"attn":
{"wq": (L, d, H, hd), ...}, ...}}``); the port keeps one block per layer.
:func:`params_from_jax` takes that tree with numpy leaves (what
``jax.device_get`` or ``np.asarray`` gives) and returns the port's
parameter dict: the same values in the same shapes, the layer axis taken
apart, each named after its tree path with the layer index put in
(``dense_layers.3.attn.wq``).  :func:`state_from_jax` does the same for
an AdamW state, whose moments stay f32.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .transformer import DenseLM


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
    """The port's parameters (CPU tensors of ``cfg.param_dtype``) from the
    reference's layer-stacked tree of the same config."""
    return _named(cfg, tree, cfg.p_dtype)


def state_from_jax(cfg, opt_tree: Mapping) -> Dict:
    """The port's AdamW state from the reference's ``{"m", "v", "step"}``
    (``adamw_init``'s tree, or one a train step returned): m and v as f32
    CPU tensors named like the parameters, step a 0-dim int32 tensor."""
    return {"m": _named(cfg, opt_tree["m"], torch.float32),
            "v": _named(cfg, opt_tree["v"], torch.float32),
            "step": torch.tensor(int(np.asarray(opt_tree["step"])),
                                 dtype=torch.int32)}


def _named(cfg, tree: Mapping, dtype) -> Dict[str, torch.Tensor]:
    """A layer-stacked tree shaped like the config's parameters, taken
    apart by layer, named as the port names them and cast to ``dtype``."""
    want = {n: p for n, p in DenseLM(cfg).named_parameters()}
    out = {}
    for name, leaf in _flatten(tree):
        t = _tensor(leaf)
        head, _, rest = name.partition(".")
        if head == "dense_layers":
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: {t.shape[0]} stacked layers, the "
                                 f"config has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                out[f"{head}.{i}.{rest}"] = t[i]
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
        out[name] = t.to(dtype)
    return out
