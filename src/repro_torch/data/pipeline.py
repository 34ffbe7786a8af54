"""Deterministic synthetic token pipeline (a copy of the JAX package's
``data/pipeline.py``; numpy only, and ``preprocess_weld`` evaluates
through the port's ``core.lazy``).

Properties a 1000-node fleet needs, all tested:
  * **shard-aware** — batch(step, shard k of n) is a disjoint, stable
    slice of the global batch; re-sharding to a different n yields the
    same global stream (elastic restarts don't skew data);
  * **stateful & checkpointable** — `state()`/`restore()` round-trip the
    cursor, so preempt/resume is bitwise identical;
  * **fused preprocessing** — the shift/mask/mixture transforms run as
    one Weld program per batch (`preprocess_weld`), the paper's pipeline
    integration.

Tokens are a fixed mixture of synthetic "documents" (Zipf-ish ids keyed
by a counter hash), so losses are reproducible across runs and hosts
without any dataset download.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


def _keyed_bits(seed: int, lo: int, n: int) -> np.ndarray:
    """Deterministic uint32 stream independent of shard layout: value at
    global index i depends only on (seed, i)."""
    out = np.empty(n, np.uint64)
    # counter-mode hashing in blocks of 8192 for speed
    idx = np.arange(lo, lo + n, dtype=np.uint64)
    x = idx * np.uint64(0x9E3779B97F4A7C15) ^ np.uint64(seed)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    out[:] = x
    return out


@dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    step: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0, (
            "global batch must divide across data shards"
        )

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    # -- state (checkpointed) ---------------------------------------------------

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    # -- batches -----------------------------------------------------------------

    def _tokens_for(self, step: int, row: int) -> np.ndarray:
        """Global row `row` of global step `step` (shard-independent)."""
        base = (step * self.global_batch + row) * (self.seq_len + 1)
        bits = _keyed_bits(self.seed, base, self.seq_len + 1)
        # Zipf-ish skew: square a uniform, keeps a learnable bigram bias
        u = (bits % np.uint64(1 << 30)).astype(np.float64) / float(1 << 30)
        toks = (u * u * (self.vocab - 1)).astype(np.int64)
        # inject structure so the LM has something to learn: tok[i+1]
        # sometimes repeats tok[i]
        rep = bits % np.uint64(4) == 0
        toks[1:] = np.where(rep[1:], toks[:-1], toks[1:])
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        rows = range(self.shard * self.local_batch,
                     (self.shard + 1) * self.local_batch)
        seqs = np.stack([self._tokens_for(self.step, r) for r in rows])
        self.step += 1
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }

    # -- Weld-fused preprocessing -------------------------------------------------

    def preprocess_weld(self, raw: np.ndarray,
                        pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Shift + pad-mask in ONE fused pass (two outputs, one loop) —
        the paper's Listing 3 pattern on the data path."""
        from ..core import ir, macros as M, wtypes as wt
        from ..core.lazy import Evaluate, NewWeldObject

        flat = raw.astype(np.int64).reshape(-1)
        d = NewWeldObject(flat, None)
        did = ir.Ident(d.obj_id, d.weld_type())
        bt = wt.StructBuilder((wt.VecBuilder(wt.I64), wt.VecBuilder(wt.I64)))
        b = ir.Ident(ir.fresh("b"), bt)
        i = ir.Ident(ir.fresh("i"), wt.I64)
        x = ir.Ident(ir.fresh("x"), wt.I64)
        body = ir.MakeStruct((
            ir.Merge(ir.GetField(b, 0), x),
            ir.Merge(
                ir.GetField(b, 1),
                ir.Select(ir.BinOp("==", x, M.lit(pad_id)),
                          M.lit(0), M.lit(1)),
            ),
        ))
        loop = ir.Result(ir.For(
            (ir.Iter(did),),
            ir.MakeStruct((ir.NewBuilder(wt.VecBuilder(wt.I64)),
                           ir.NewBuilder(wt.VecBuilder(wt.I64)))),
            ir.Lambda((b, i, x), body),
        ))
        toks, mask = Evaluate(NewWeldObject([d], loop)).value
        return (np.asarray(toks).reshape(raw.shape),
                np.asarray(mask).reshape(raw.shape))
