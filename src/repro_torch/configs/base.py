"""Config schema + registry + the assigned input-shape suite (a copy of
the JAX package's ``configs/base.py``; the dtype names map to ``torch``
dtypes)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import torch


#: the dtype names a config may give, as torch dtypes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: the assigned LM shape suite (seq_len × global_batch)
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads
    mlp_variant: str = "gelu"         # gelu | swiglu | relu2
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0               # zamba2: shared attn period
    slstm_every: int = 0              # xlstm: sLSTM block period

    # enc-dec
    n_enc_layers: int = 0
    n_frames: int = 1500              # whisper stub frame count

    # vlm
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    d_vision: int = 0

    # numerics / runtime
    dtype: str = "float32"            # activation/compute dtype
    param_dtype: str = "float32"
    attn_chunk: int = 1024
    remat: bool = True
    max_position: int = 1 << 20
    #: unroll layer/chunk scans.  Execution default is False (compact HLO,
    #: fast compiles); the dry-run lowers with True because XLA's cost
    #: analysis counts while-loop bodies ONCE — unrolled HLO makes the
    #: roofline terms exact (see launch/dryrun.py).
    scan_unroll: bool = False

    # sub-quadratic? (decides long_500k eligibility)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("hybrid", "ssm")

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def p_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def shape_supported(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """Assignment rules: long_500k only for sub-quadratic archs."""
        if shape.name == "long_500k" and not self.subquadratic:
            return False, (
                "long_500k requires sub-quadratic attention; "
                f"{self.name} is full-attention (skip per assignment rule)"
            )
        return True, ""


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]):
    cfg = full()
    _REGISTRY[cfg.name] = full
    _SMOKE[cfg.name] = smoke
    return cfg.name


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_configs() -> List[str]:
    return sorted(_REGISTRY)
