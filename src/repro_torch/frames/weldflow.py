"""weldflow — the TensorFlow integration (paper §6).

A tiny lazily-evaluated dataflow-graph library: ops build a graph of
`Node`s; `Session.run` executes.  The Weld integration follows the paper:
(i) a `WeldOp` node runs an arbitrary Weld expression, and (ii) a *graph
transformer* replaces every maximal subgraph of Weld-portable operators
with one WeldOp (relying on Weld to fuse the merged expressions).  The
engine itself is untouched.

Three execution modes, on the default device:
  * ``native`` — one eager PyTorch operator per node, each result
    materialized and the device synchronized after each op
    (TensorFlow-without-XLA);
  * ``xla``    — the whole graph function through one ``torch.compile``
    (the counterpart of the reference's one ``jax.jit``: a baseline
    session, never on Weld's path);
  * ``weld``   — graph transformer + WeldOp + Weld optimizer, evaluated
    by the port's runtime (its kernels under the process default
    ``kernelize`` mode).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import ir, macros as M, wtypes as wt
from ..core.lazy import Evaluate, NewWeldObject, WeldObject
from ..device import default_device

_ids = itertools.count()


class Node:
    def __init__(self, op: str, inputs: List["Node"], payload=None):
        self.op = op
        self.inputs = inputs
        self.payload = payload  # constants: numpy array
        self.nid = next(_ids)

    # operator sugar
    def __add__(self, o):
        return Node("add", [self, _const(o)])

    def __sub__(self, o):
        return Node("sub", [self, _const(o)])

    def __mul__(self, o):
        return Node("mul", [self, _const(o)])


def _const(v) -> Node:
    if isinstance(v, Node):
        return v
    return Node("const", [], payload=np.asarray(v))


def placeholder() -> Node:
    return Node("placeholder", [])


def constant(v) -> Node:
    return _const(v)


def matvec(m: Node, v: Node) -> Node:
    return Node("matvec", [m, v])


def sigmoid(x: Node) -> Node:
    return Node("sigmoid", [x])


def log(x: Node) -> Node:
    return Node("log", [x])


def reduce_mean(x: Node) -> Node:
    return Node("mean", [x])


def reduce_sum(x: Node) -> Node:
    return Node("sum", [x])


#: ops our Weld port understands (the paper ports a subset; the rest run
#: natively and break WeldOp regions)
WELD_PORTABLE = {
    "add", "sub", "mul", "sigmoid", "log", "mean", "sum", "matvec", "const",
    "placeholder", "weldop",
}

#: one PyTorch operator per graph op (the native and compiled sessions)
_TORCH_OPS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "sigmoid": lambda x: 1 / (1 + torch.exp(-x)),
    "log": torch.log,
    "mean": torch.mean,
    "sum": torch.sum,
    "matvec": lambda m, v: m @ v,
}


class Session:
    """``mode`` is "native", "xla" or "weld".  The weld session plans its
    kernels under the process default
    (``repro_torch.core.kernelplan.set_default_kernelize``)."""

    def __init__(self, mode: str = "weld"):
        assert mode in ("native", "xla", "weld")
        self.mode = mode

    def run(self, node: Node, feed: Dict[Node, np.ndarray],
            collect_stats: Optional[dict] = None):
        if self.mode == "native":
            return _run_native(node, feed)
        if self.mode == "xla":
            return _run_xla(node, feed)
        return _run_weld(node, feed, collect_stats)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# -- native per-op execution ---------------------------------------------------


def _run_native(node: Node, feed) -> np.ndarray:
    dev = default_device()
    cache: Dict[int, torch.Tensor] = {}

    # each op dispatches its own kernel and materializes the result — the
    # function-call interface the paper's §1 describes.
    def ev(n: Node):
        if n.nid in cache:
            return cache[n.nid]
        if n.op == "placeholder":
            v = torch.as_tensor(np.asarray(feed[n])).to(dev)
        elif n.op == "const":
            v = torch.as_tensor(n.payload).to(dev)
        else:
            args = [ev(i) for i in n.inputs]
            v = _TORCH_OPS[n.op](*args)
            _sync(dev)
        cache[n.nid] = v
        return v

    return _host(ev(node))


# -- the whole graph through one torch.compile ----------------------------------


_COMPILED: Dict[Tuple[int, str], object] = {}


def _run_xla(node: Node, feed) -> np.ndarray:
    dev = default_device()
    order = sorted(feed.keys(), key=lambda n: n.nid)

    def fn(*arrays):
        env = {n.nid: a for n, a in zip(order, arrays)}

        def ev(n: Node):
            if n.nid in env:
                return env[n.nid]
            if n.op == "const":
                v = torch.as_tensor(n.payload, device=arrays[0].device)
            else:
                v = _TORCH_OPS[n.op](*[ev(i) for i in n.inputs])
            env[n.nid] = v
            return v

        return ev(node)

    key = (node.nid, str(dev))
    compiled = _COMPILED.get(key)
    if compiled is None:
        compiled = torch.compile(fn, dynamic=False)
        _COMPILED[key] = compiled
    out = compiled(*[torch.as_tensor(np.asarray(feed[n])).to(dev)
                     for n in order])
    _sync(dev)
    return _host(out)


# -- Weld graph transformer ------------------------------------------------------


def transform_graph(node: Node, feed) -> Tuple[WeldObject, int]:
    """Replace the maximal Weld-portable subgraph with one WeldOp.

    Returns the WeldObject for `node` and the number of graph nodes merged
    into the WeldOp region.  (All ops in this demo library are portable, so
    the whole graph merges — with a non-portable op the transformer would
    cut the region there, matching the paper's incremental-porting story.)
    """
    merged = 0
    cache: Dict[int, Tuple[WeldObject, ir.Expr, tuple]] = {}

    def ev(n: Node):
        nonlocal merged
        if n.nid in cache:
            return cache[n.nid]
        if n.op == "placeholder":
            obj = NewWeldObject(np.asarray(feed[n]), None)
            out = (obj, ir.Ident(obj.obj_id, obj.weld_type()),
                   np.asarray(feed[n]).shape)
        elif n.op == "const":
            obj = NewWeldObject(np.asarray(n.payload), None)
            out = (obj, ir.Ident(obj.obj_id, obj.weld_type()),
                   np.asarray(n.payload).shape)
        else:
            ins = [ev(i) for i in n.inputs]
            merged += 1
            out = _weld_op(n.op, ins)
        cache[n.nid] = out
        return out

    obj, expr, shape = ev(node)
    return NewWeldObject(_deps_of(expr, cache), expr), merged


def _deps_of(expr: ir.Expr, cache) -> List[WeldObject]:
    names = set(ir.free_vars(expr))
    out = []
    for obj, e, shape in cache.values():
        if obj.obj_id in names:
            out.append(obj)
    return out


def _weld_op(op: str, ins) -> Tuple[WeldObject, ir.Expr, tuple]:
    exprs = [e for _, e, _ in ins]
    shapes = [s for _, _, s in ins]
    deps = [o for o, _, _ in ins]

    def binop(o):
        a, b = exprs
        sa, sb = shapes
        if sa == sb and len(sa) >= 1:
            e = M.zip_map([a, b], lambda x, y: ir.BinOp(o, x, y))
            return e, sa
        if len(sa) >= 1 and len(sb) == 0:
            e = M.map_(a, lambda x: ir.BinOp(o, x, b))
            return e, sa
        if len(sb) >= 1 and len(sa) == 0:
            e = M.map_(b, lambda x: ir.BinOp(o, a, x))
            return e, sb
        return ir.BinOp(o, a, b), ()

    if op in ("add", "sub", "mul"):
        sym = {"add": "+", "sub": "-", "mul": "*"}[op]
        e, shape = binop(sym)
    elif op in ("sigmoid", "log"):
        (a,), (sa,) = exprs, shapes
        e = M.map_(a, lambda x: ir.UnaryOp(op, x)) if len(sa) >= 1 \
            else ir.UnaryOp(op, a)
        shape = sa
    elif op == "sum":
        e = M.reduce_(exprs[0], "+")
        shape = ()
    elif op == "mean":
        s = M.reduce_(exprs[0], "+")
        n = ir.Cast(ir.Len(exprs[0]), wt.F64)
        e = ir.BinOp("/", ir.Cast(s, wt.F64), n)
        shape = ()
    elif op == "matvec":
        m, v = exprs
        e = ir.CUDF("linalg.matvec", (m, v), wt.Vec(wt.F64))
        shape = (shapes[0][0],)
    else:
        raise ValueError(f"op {op} not weld-portable")

    obj = NewWeldObject(deps, e)
    return obj, ir.Ident(obj.obj_id, obj.weld_type()), shape


def _run_weld(node: Node, feed,
              collect_stats: Optional[dict] = None) -> np.ndarray:
    obj, merged = transform_graph(node, feed)
    res = Evaluate(obj, collect_stats=collect_stats)
    return np.asarray(res.value)
