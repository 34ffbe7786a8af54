"""Optimizer substrate of the port: AdamW over parameter dicts (the
hand-written fused kernel per tensor on the card, on each rank's ZeRO-1
shards on a mesh), gradient clipping, the cosine-warmup schedule and the
int8 error-feedback compression (``compress``)."""
from .adamw import adamw_init, adamw_update_tree, clip_by_global_norm  # noqa: F401
from .compress import (compressed_psum, dequantize_int8,  # noqa: F401
                       init_error_buffers, quantize_int8,
                       tree_compressed_psum)
from .schedule import cosine_warmup  # noqa: F401
