"""The launch counts a model's structure implies: what a harness holds
the wrappers' counters (:mod:`._count`) to after a prefill or a training
step.  Read off the config alone; the models keep no bookkeeping of
their own."""
from __future__ import annotations

from typing import Tuple


def attention_calls(cfg, training: bool = False) -> Tuple[int, int]:
    """(flash_attention forwards, backwards) of one prefill or, with
    ``training``, of one ``loss_and_grad`` of a micro-batch.

    The structure has one attention call a layer (dense, MoE), one a
    shared-block call (hybrid), none (xLSTM), encoder + 2 x decoder
    (encdec: self and cross) or one a layer (vision: the self blocks and
    each super-block's cross block).  Training runs each call's backward
    once, and under ``cfg.remat`` each checkpoint recomputes the forwards
    inside it once more: every layer (dense, MoE, encdec), none (hybrid:
    the shared block is not checkpointed), and for vision a self block
    twice (its super-block's recompute and its own) and a cross block
    once."""
    fam = cfg.family
    if fam == "hybrid":
        calls = -(-cfg.n_layers // cfg.attn_every)
    elif fam == "ssm":
        calls = 0
    elif fam == "encdec":
        calls = (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers
    else:
        calls = cfg.n_layers
    if not training:
        return calls, 0
    if not cfg.remat or fam in ("hybrid", "ssm"):
        return calls, calls
    if fam == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        n_self = n_super * (cfg.cross_attn_every - 1)
        return calls + 2 * n_self + n_super, calls
    return 2 * calls, calls
