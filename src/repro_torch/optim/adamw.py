"""AdamW over parameter dicts (the port of the reference's
``optim/adamw.py``).

``adamw_update_tree`` runs ``ops.adamw_update`` on every parameter
tensor, and the tensors' device decides the route: on the card the
hand-written fused kernel (``kernels/csrc/fused_adamw.cu``, one launch
per tensor), on the CPU its plain version.  That is the reference's
``impl="pallas"`` leaf update; its ``impl="jax"`` chain is the same
function, which XLA fuses inside the jitted step and eager PyTorch
would not.  Parameters and moments are updated in place.

``adamw_update_weld`` is the Weld-IR form of one flat step, evaluated
through the port's ``core.lazy`` (the reference keeps it for its
benchmarks).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kernels import ops


def adamw_init(params: Dict[str, torch.Tensor]) -> Dict:
    """{"m": f32 zeros like each parameter, "v": the same, "step": a 0-dim
    int32 CPU tensor}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every gradient by min(1, max_norm / ||grads||), the norm taken
    in f32 over all of them; each keeps its dtype.  Returns (grads, norm)
    — the grads scaled in place (the reference returns new arrays) and the
    norm as a 0-dim f32 tensor on their device."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(torch.full_like(gn, max_norm)
                        / torch.clamp_min(gn, 1e-9), max=1.0)
    for g in grads.values():
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
        ops.adamw_update(p, grads[k], state["m"][k], state["v"][k], lr, step,
                         b1=b1, b2=b2, eps=eps, wd=wd)
    return params, {"m": state["m"], "v": state["v"], "step": step}


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
