"""Optimizer substrate of the port: AdamW over parameter dicts (the
hand-written fused kernel per tensor on the card), gradient clipping and
the cosine-warmup schedule.  The int8 error-feedback compression of the
reference (``optim/compress.py``) is a collective and comes with the
distributed slice."""
from .adamw import adamw_init, adamw_update_tree, clip_by_global_norm  # noqa: F401
from .schedule import cosine_warmup  # noqa: F401
