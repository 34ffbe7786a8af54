"""Checkpoint substrate: async, integrity-checked save/restore of the
full training state (params, optimizer, data cursor, step)."""
from .ckpt import Checkpointer  # noqa: F401
