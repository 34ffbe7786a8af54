"""LR schedules (the port of the reference's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``: a 0-dim f32 tensor on the
    CPU, computed in f32 in the reference's order."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32).cpu()
    # divisors as tensors: a true division, as the reference's
    warm = peak_lr * step / torch.tensor(max(warmup, 1), dtype=f32)
    prog = torch.clip((step - warmup)
                      / torch.tensor(max(total - warmup, 1), dtype=f32), 0, 1)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
