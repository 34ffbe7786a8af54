"""Three-term roofline of a traced step against the H100's published
peaks (the port of the JAX package's ``roofline/analysis.py``):

    compute    = FLOPs / peak FLOP/s of the step's product dtype
    memory     = bytes / HBM rate
    collective = collective operand bytes / link rate

All three per card: the counts come from rank 0's local tensors (a
step traced on DTensors under fake tensors, ``launch/dryrun.py``), so
per-card quantities over per-card peaks, as the reference's per-chip
``cost_analysis`` over per-chip peaks.

The counts come from :class:`StepCounter`, a ``TorchDispatchMode`` over
the ops a step dispatches on its local tensors: FLOPs by
``torch.utils.flop_counter``'s formulas (the ones ``FlopCounterMode``
uses, the B12 kernel's registered beside them), the bytes every op
reads and writes, and the operand bytes of every collective.  The
reference parses XLA's partitioned HLO for the collectives
(``collective_bytes_from_hlo``); the port has no HLO, so
:func:`collective_bytes` counts the ``c10d`` and ``_c10d_functional``
ops a function issues, in the reference's byte convention: the operand's
bytes (all-reduce, all-to-all and permute: operand = result; all-gather:
result / participants; reduce-scatter: result × participants).

This module also holds the model-FLOP formulas the MFU of a training
step divides by the bf16 peak (:func:`train_flops`,
:func:`family_train_flops`).
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

#: NVIDIA H100 SXM5 80GB, per card, dense rates at the full 700 W power
#: limit (NVIDIA's H100 data sheet): bf16 989 TFLOP/s, TF32 495 and FP64
#: 67 on the tensor cores, FP32 67 and FP64 34 on the CUDA cores; HBM3
#: 3.35 TB/s, 80 GB (five 16 GiB stacks); NVLink 4, 900 GB/s to the
#: other cards of the host, 450 GB/s each way.  Between hosts a card has
#: its own 400 Gb/s NDR InfiniBand port (NVIDIA's DGX H100 data sheet:
#: eight ConnectX-7 adapters for eight cards), 50 GB/s each way.
HW_H100 = {
    "peak_flops_bf16": 989e12,    # FLOP/s
    "peak_flops_tf32": 495e12,
    "peak_flops_f32": 67e12,
    "peak_flops_f64": 34e12,
    # the FP64 tensor cores (DMMA)
    "peak_flops_f64_tc": 67e12,
    "hbm_bw": 3.35e12,            # B/s
    "hbm_bytes": 80 * 1024 ** 3,
    "nvlink_bw": 450e9,           # B/s each way, to a card of the host
    "net_bw": 50e9,               # B/s each way, to a card of another host
    "cards_per_host": 8,
}

#: the peak a step's products run at, by the dtype they run in (f32
#: products run on the CUDA cores: the port keeps TF32 off)
PEAK_KEYS = {
    "bfloat16": "peak_flops_bf16",
    "float16": "peak_flops_bf16",
    "float32": "peak_flops_f32",
    "float64": "peak_flops_f64_tc",
}

#: the reference's collective kinds (XLA's op names)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: (namespace, op name) of each collective -> (kind, index of the operand
#: argument); ``wait_tensor``, ``recv_`` and the like move nothing more
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced_"): ("all-reduce", 0),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", 0),
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "send"): ("collective-permute", 0),
}

#: tensor types a counter counts ops on (with fake tensors); any other
#: (a DTensor) dispatches to local ops first
_PLAIN = (torch.Tensor, torch.nn.Parameter)

#: ops that allocate without writing, or view without reading
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_unsafe_view"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the memory a tensor's elements span (an expanded
    dimension read once)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return min(t.numel(), span) * t.element_size()


def _fake_mode_of(args, out):
    """The fake mode of an op's first fake tensor (inputs, then outputs),
    or None: ops on another mode's tensors (DTensor's sharding
    propagation) are not the step's."""
    for t in _tensors(list(args)) + _tensors(out):
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return None


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


class StepCounter(TorchDispatchMode):
    """What the ops run inside it cost, per card: ``flops`` (by dtype in
    ``flops_by_dtype``, from ``torch.utils.flop_counter.flop_registry``),
    ``bytes`` (each op's inputs read once and outputs, mutated inputs
    included, written once; views move nothing), ``collectives``
    (operand bytes by kind, and ``total``) and ``peak_bytes``, the most
    bytes of storage live at once: the storages given to :meth:`track`
    and every storage an op returns, each until it is freed (as
    ``MemTracker`` follows them; ``MemTracker`` itself hooks the
    gradient of every module parameter, which the port's bound,
    gradient-free parameters refuse).

    Only ops on plain tensors are counted: an op on DTensors is handed
    back to DTensor (its local ops come here again, at the local shapes),
    and under a fake mode only ops on that mode's fake tensors count (not
    DTensor's sharding propagation), as
    ``torch.distributed._tools.mem_tracker.MemTracker`` does."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_dtype: Dict[str, int] = {}
        self.bytes = 0
        self.collectives = {k: 0 for k in KINDS}
        self.collectives["total"] = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        #: while True, nothing is counted (a caller's bookkeeping ops)
        self.paused = False

    def track(self, *tensors) -> None:
        """Count the storages of ``tensors`` (a DTensor's local one) as
        live from now until they are freed."""
        for t in tensors:
            local = t.to_local() if hasattr(t, "to_local") else t
            st = local.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __enter__(self):
        self._entry_fake = active_fake_mode()
        return super().__enter__()

    def cost(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes": float(self.bytes)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t not in _PLAIN and not issubclass(t, FakeTensor)
               for t in types):
            return NotImplemented   # a DTensor: its local ops come back
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused and _fake_mode_of(args, out) is self._entry_fake:
            self._count(func, args, kwargs, out)
            self.track(*_tensors(out))
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = packet._qualified_op_name.split("::")[0]
        name = func._schema.name.split("::")[-1]
        coll = _COLLECTIVES.get((ns, name))
        if coll is not None:
            kind, at = coll
            n = sum(tensor_bytes(t) for t in _tensors(args[at]))
            self.collectives[kind] += n
            self.collectives["total"] += n
            return
        if ns in ("c10d", "_c10d_functional", "prim") or func.is_view:
            return
        formula = flop_registry.get(packet)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            first = _tensors(list(args))
            dt = str(first[0].dtype).split(".")[-1] if first else "none"
            self.flops += n
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + n
        if name in _NO_BYTES:
            return
        ins = _tensors(list(args)) + _tensors(list(kwargs.values()))
        outs = _tensors(out)
        written = {id(t) for t in outs}
        for a, v in zip(func._schema.arguments, args):
            if a.alias_info is not None and a.alias_info.is_write:
                outs += [t for t in _tensors(v) if id(t) not in written]
        self.bytes += sum(tensor_bytes(t) for t in ins + outs)


def collective_bytes(fn, *args, **kwargs) -> Dict[str, int]:
    """Operand bytes of every collective ``fn(*args, **kwargs)`` issues on
    this rank, by kind (:data:`KINDS`), and their ``total``."""
    with StepCounter() as c:
        fn(*args, **kwargs)
    return dict(c.collectives)


def extract_cost(cost: Optional[dict]) -> Dict[str, float]:
    """Normalize a cost dict: ``{"flops", "bytes"}`` as they are, or
    XLA's ``cost_analysis()`` keys (``"bytes accessed"``, or the
    per-operand ``"bytes accessed…"`` keys summed)."""
    c = cost or {}
    if isinstance(c, (list, tuple)):
        c = c[0] if c else {}
    if "bytes" in c:  # already normalized
        return {"flops": float(c.get("flops", 0.0)),
                "bytes": float(c["bytes"])}
    flops = float(c.get("flops", 0.0))
    bytes_accessed = float(c.get("bytes accessed", 0.0))
    if bytes_accessed == 0.0:
        bytes_accessed = sum(
            float(v) for k, v in c.items()
            if isinstance(k, str) and k.startswith("bytes accessed")
        )
    return {"flops": flops, "bytes": bytes_accessed}


def link_key(hw: dict, chips: int) -> str:
    """The key of ``hw``'s link rate for a collective over ``chips``
    cards: a TPU table's one ``ici_bw``; on the H100 NVLink within a host,
    the network between hosts."""
    if "ici_bw" in hw:
        return "ici_bw"
    return "nvlink_bw" if chips <= hw["cards_per_host"] else "net_bw"


def roofline_terms(cost: dict, coll_bytes_per_dev: int, *,
                   hw: dict = HW_H100, dtype: str = "bfloat16",
                   chips: int = 1) -> Dict[str, float]:
    """All terms in SECONDS (per-card quantities over per-card peaks):
    the FLOPs over the peak of ``dtype`` (the step's products; recorded
    as ``peak_key``), the bytes over the HBM rate, the collective bytes
    over :func:`link_key`'s rate for ``chips`` cards (``link_key``)."""
    c = extract_cost(cost)
    peak = PEAK_KEYS[dtype]
    link = link_key(hw, chips)
    t_compute = c["flops"] / hw[peak]
    t_memory = c["bytes"] / hw["hbm_bw"]
    t_coll = coll_bytes_per_dev / hw[link]
    dom = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_coll), key=lambda kv: kv[1],
    )[0]
    total = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom,
        "bound_s": total,
        "hlo_flops_per_dev": c["flops"],
        "hlo_bytes_per_dev": c["bytes"],
        "coll_bytes_per_dev": float(coll_bytes_per_dev),
        "peak_key": peak,
        "link_key": link,
    }


def model_flops(cfg, n_params_active: int, tokens: int,
                kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference forward)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of a dense model: 6 N per token,
    plus the causal attention's 12 L B S**2 d_head H / 2."""
    return (6.0 * n_params * batch * seq
            + 12.0 * cfg.n_layers * batch * seq * seq * cfg.head_dim
            * cfg.n_heads / 2)


def family_train_flops(cfg, model, b: int, seq: int) -> float:
    """Model FLOPs of one training step of any family: 6 per parameter
    and position it multiplies (the active experts only; the encoder's
    layers and the cross-attentions' k and v projections at the frames or
    image tokens, the vision projection at the image tokens, every other
    parameter at the text tokens; the learned positions multiply
    nothing), plus 12 B hd H Sq Skv a call for the attention (halved when
    causal), as :func:`train_flops`.  The SSM scans (Mamba2's, the
    mLSTM's) and the sLSTM's pointwise recurrence are left out."""
    fam = cfg.family
    other = {"encdec": cfg.n_frames, "vlm": cfg.n_image_tokens}.get(fam, 0)
    at_other = 0
    for name, p in model.impl.named_parameters():
        kv = name.rsplit(".", 1)[-1] in ("wk", "wv")
        if fam == "encdec" and (name.startswith("enc_") or (
                ".cross_attn." in name and kv)):
            at_other += p.numel()
        elif fam == "vlm" and (name == "img_proj" or (
                name.startswith("cross_layers.") and kv)):
            at_other += p.numel()
    skip = model.impl.pos.numel() if fam == "encdec" else 0
    at_text = model.active_param_count() - at_other - skip
    flops = 6.0 * b * (at_text * seq + at_other * other)
    unit = 12.0 * b * cfg.head_dim * cfg.n_heads
    if fam in ("dense", "moe"):
        flops += unit * cfg.n_layers * seq * seq / 2
    elif fam == "hybrid":
        flops += unit * -(-cfg.n_layers // cfg.attn_every) * seq * seq / 2
    elif fam == "encdec":
        n_enc = cfg.n_enc_layers or cfg.n_layers
        flops += unit * (n_enc * other * other + cfg.n_layers * (
            seq * seq / 2 + seq * other))
    elif fam == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        flops += unit * (cfg.n_layers - n_super) * seq * seq / 2 \
            + unit * n_super * seq * other
    return flops

