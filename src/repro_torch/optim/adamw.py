"""AdamW over parameter dicts (the port of the reference's
``optim/adamw.py``).

``adamw_update_tree`` runs ``ops.adamw_update`` on every parameter
tensor, and the tensors' device decides the route: on the card the
hand-written fused kernel (``kernels/csrc/fused_adamw.cu``, one launch
per tensor), on the CPU its plain version.  That is the reference's
``impl="pallas"`` leaf update; its ``impl="jax"`` chain is the same
function, which XLA fuses inside the jitted step and eager PyTorch
would not.  Parameters and moments are updated in place.

On a mesh the parameters, gradients and moments are DTensors, the
moments ZeRO-1 sharded over "data" as well: each parameter and its
gradient are brought to its moments' placement, the kernel runs on every
rank's local shards (one launch per parameter tensor per rank, as on
one device), and the updated shard is gathered back into the parameter.

``adamw_update_weld`` is the Weld-IR form of one flat step, evaluated
through the port's ``core.lazy`` (the reference keeps it for its
benchmarks).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..distributed import mesh_ops, sharding
from ..kernels import ops


def adamw_init(params: Dict[str, torch.Tensor],
               moment_specs: Optional[Dict] = None) -> Dict:
    """{"m": f32 zeros like each parameter, "v": the same, "step": a 0-dim
    int32 CPU tensor}.  On a mesh (DTensor parameters) ``moment_specs``
    gives each moment's spec (``sharding.zero1_moment_shardings``: ZeRO-1
    shards them over "data" too); the zeros are made shard by shard."""
    def zeros(k, p):
        if mesh_ops.is_dtensor(p):
            from torch.distributed.tensor import zeros as dzeros

            pl = (sharding.placements(moment_specs[k], p.device_mesh)
                  if moment_specs is not None else p.placements)
            return dzeros(p.shape, dtype=torch.float32,
                          device_mesh=p.device_mesh, placements=pl)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": {k: zeros(k, p) for k, p in params.items()},
            "v": {k: zeros(k, p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every gradient by min(1, max_norm / ||grads||), the norm taken
    in f32 over all of them; each keeps its dtype.  Returns (grads, norm)
    — the grads scaled in place (the reference returns new arrays) and the
    norm as a 0-dim f32 tensor on their device.  DTensor gradients (on a
    mesh, none of them ``Partial``) give the global norm, a full reduce,
    and are scaled shard by shard."""
    sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    if mesh_ops.is_dtensor(sq):
        sq = sq.full_tensor()
    gn = torch.sqrt(sq)
    scale = torch.clamp(torch.full_like(gn, max_norm)
                        / torch.clamp_min(gn, 1e-9), max=1.0)
    for g in grads.values():
        g = mesh_ops.local(g)
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, gn


def adamw_update_tree(params: Dict[str, torch.Tensor],
                      grads: Dict[str, torch.Tensor], state: Dict, lr, *,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      wd: float = 0.01):
    """One AdamW step of every parameter at t = state["step"] + 1, in
    place.  Returns (params, state), the same dicts, with state["step"]
    advanced."""
    step = state["step"] + 1
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        if not mesh_ops.is_dtensor(p):
            ops.adamw_update(p, grads[k], m, v, lr, step, b1=b1, b2=b2,
                             eps=eps, wd=wd)
            continue
        # ZeRO-1: p and g to the moments' placement, the kernel on each
        # rank's shards, p gathered back to its own placement
        mesh, zpl = m.device_mesh, m.placements
        same = zpl == p.placements
        pl = (p if same else p.redistribute(mesh, zpl)).to_local()
        gl = grads[k].redistribute(mesh, zpl).to_local()
        pc, gc = pl.contiguous(), gl.contiguous()
        ops.adamw_update(pc, gc, m.to_local(), v.to_local(), lr, step,
                         b1=b1, b2=b2, eps=eps, wd=wd)
        if same:
            if pc is not pl:
                pl.copy_(pc)
            continue
        from torch.distributed.tensor import DTensor

        full = DTensor.from_local(pc, mesh, zpl, run_check=False,
                                  shape=p.shape, stride=p.stride())
        p.to_local().copy_(full.redistribute(mesh, p.placements).to_local())
    return params, {"m": state["m"], "v": state["v"], "step": step}


#: the largest |m^ / sqrt(v^)| of AdamW's second step at b1 0.9, b2 0.999
#: (Cauchy-Schwarz over the two steps' gradients)
T2_BOUND = 1.0013


def second_step_limit(p, v, lr: float, c2: float, grad_rel: float):
    """The per-element limit of |p_a - p_b| between two runs of two AdamW
    steps from the same parameters, the first at lr 0 (so that both start
    the second from the same parameters), whose gradients differ by at most
    ``grad_rel`` of a leaf's scale; ``p`` and ``v`` of one run, ``lr`` and
    the bias correction ``c2`` of the second step.  The step's update
    lr m^ / (sqrt(v^) + eps) is homogeneous of degree 0 in the gradients:
    such an error moves it by at most about 2 grad_rel s / sqrt(v^) of lr,
    s the leaf's largest sqrt(v^), and never by more than T2_BOUND lr
    either way; plus 2**-22 |p|, two f32 roundings of p."""
    rms = torch.sqrt(v / c2)
    step = torch.clamp(2 * grad_rel * float(rms.max()) / (rms + 1e-8),
                       max=2 * T2_BOUND)
    return lr * step + 2.0 ** -22 * p.abs()


# ---------------------------------------------------------------------------
# Weld-expressed AdamW (the paper-native form)
# ---------------------------------------------------------------------------


def adamw_update_weld(p, g, m, v, lr: float, t: float, b1=0.9, b2=0.999,
                      eps=1e-8, wd=0.01):
    """One flat-leaf AdamW step as a single fused Weld program, in f64.

    Eight logical elementwise passes fuse to ONE loop producing three
    outputs through a struct of builders (Listing 3's pattern at
    production scale).  Returns numpy (p, m, v)."""
    from ..core import ir, wtypes as wt
    from ..core.lazy import Evaluate, NewWeldObject

    po = NewWeldObject(np.asarray(p, np.float64), None)
    go = NewWeldObject(np.asarray(g, np.float64), None)
    mo = NewWeldObject(np.asarray(m, np.float64), None)
    vo = NewWeldObject(np.asarray(v, np.float64), None)
    ids = {o.obj_id: ir.Ident(o.obj_id, o.weld_type())
           for o in (po, go, mo, vo)}
    pi, gi, mi, vi = ids.values()

    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    f = lambda x: ir.Literal(float(x), wt.F64)  # noqa: E731

    def body(pp, gg, mm, vv):
        m_new = ir.BinOp("+", ir.BinOp("*", f(b1), mm),
                         ir.BinOp("*", f(1 - b1), gg))
        v_new = ir.BinOp("+", ir.BinOp("*", f(b2), vv),
                         ir.BinOp("*", f(1 - b2), ir.BinOp("*", gg, gg)))
        mlet = ir.Ident(ir.fresh("mn"), wt.F64)
        vlet = ir.Ident(ir.fresh("vn"), wt.F64)
        upd = ir.BinOp(
            "+",
            ir.BinOp("/", ir.BinOp("/", mlet, f(c1)),
                     ir.BinOp("+", ir.UnaryOp(
                         "sqrt", ir.BinOp("/", vlet, f(c2))), f(eps))),
            ir.BinOp("*", f(wd), pp),
        )
        p_new = ir.BinOp("-", pp, ir.BinOp("*", f(lr), upd))
        return ir.Let(mlet.name, m_new, ir.Let(
            vlet.name, v_new,
            ir.MakeStruct((p_new, mlet, vlet))))

    st = wt.Struct((wt.F64, wt.F64, wt.F64, wt.F64))
    bt = wt.StructBuilder((
        wt.VecBuilder(wt.F64), wt.VecBuilder(wt.F64), wt.VecBuilder(wt.F64)))
    b = ir.Ident(ir.fresh("b"), bt)
    i = ir.Ident(ir.fresh("i"), wt.I64)
    x = ir.Ident(ir.fresh("x"), st)
    res = body(*[ir.GetField(x, k) for k in range(4)])
    out = ir.Ident(ir.fresh("o"), wt.Struct((wt.F64, wt.F64, wt.F64)))
    lam_body = ir.Let(
        out.name, res,
        ir.MakeStruct((
            ir.Merge(ir.GetField(b, 0), ir.GetField(out, 0)),
            ir.Merge(ir.GetField(b, 1), ir.GetField(out, 1)),
            ir.Merge(ir.GetField(b, 2), ir.GetField(out, 2)),
        )),
    )
    loop = ir.Result(ir.For(
        (ir.Iter(pi), ir.Iter(gi), ir.Iter(mi), ir.Iter(vi)),
        ir.MakeStruct((ir.NewBuilder(wt.VecBuilder(wt.F64)),) * 3),
        ir.Lambda((b, i, x), lam_body),
    ))
    obj = NewWeldObject([po, go, mo, vo], loop)
    out_p, out_m, out_v = Evaluate(obj).value
    return out_p, out_m, out_v
