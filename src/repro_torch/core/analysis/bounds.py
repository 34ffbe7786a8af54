"""weldbound: interval abstract interpretation + peak-memory certificates.

Two artifacts come out of one pass over a (planned or generic) program:

* **per-builder size intervals** — for every vecbuilder, dictmerger /
  groupbuilder, and kernel expansion buffer, a bound ``[lo, hi]``
  symbolic in the input lengths: filter ⇒ ``[0, n]``, map ⇒ ``[n, n]``,
  dict/group build ⇒ ``[0, min(n, capacity)]``, grouplookup expansion
  (the m:n join CSR fan-out) ⇒ ``[0, n_probe * n_build]`` (``lo =
  n_probe`` for an unfiltered left join, where every probe row emits at
  least its miss row);
* **a whole-plan peak-memory certificate** — the symbolic byte
  expression the backend's emitter would charge against
  ``memory_limit`` at trace time (hinted vecbuilder buffers + kernel
  scratch footprints), mirrored term-for-term so evaluating the
  certificate at bind time and tracing the program agree exactly.

Consumers: the runtime's admission check (reject before compiling),
the planner (static capacities on the host-count-free replay path and
interval-midpoint costing), the recovery ladder (clamp capacity regrow
at the proven need), and the WV5xx weldcheck lints.

Soundness contract: every observed runtime size must land inside its
derived interval — enforced differentially by the join fuzzer's bounds
profile, not by trust.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import ir
from .. import wtypes as wt
from . import domain as d
from .domain import INF, Interval, Shapes, Sym

ENV_BOUNDS = "WELD_BOUNDS"
_override: Optional[bool] = None


def enabled() -> bool:
    """Bounds analysis on/off — ``WELD_BOUNDS`` env knob, default ON."""
    if _override is not None:
        return _override
    return os.environ.get(ENV_BOUNDS, "1").lower() not in (
        "0", "off", "false", "no")


def set_enabled(v: Optional[bool]) -> None:
    """Force on/off from code (None restores the env default)."""
    global _override
    _override = v


# -- IR expr -> Sym (mirror of the emitter's _static_eval) ----------------


def sym_of(e: Optional[ir.Expr]) -> Optional[Sym]:
    """Symbolic form of a size expression, exactly the fragment the
    backend can statically resolve: literals, ``len(input)``, and
    ``+ - * / min max`` over those.  None = the emitter would bail too."""
    if e is None:
        return None
    if isinstance(e, ir.Literal):
        try:
            return d.const(int(e.value))
        except (TypeError, ValueError):
            return None
    if isinstance(e, ir.Len) and isinstance(e.expr, ir.Ident):
        return d.length(e.expr.name)
    if isinstance(e, ir.BinOp) and e.op in ("+", "-", "*", "/",
                                            "min", "max"):
        a = sym_of(e.left)
        b = sym_of(e.right)
        if a is None or b is None:
            return None
        return {"+": d.add, "-": d.sub, "*": d.mul, "/": d.div,
                "min": d.smin, "max": d.smax}[e.op](a, b)
    return None


def static_size(e: Optional[ir.Expr], shapes: Optional[Shapes]) -> Optional[int]:
    """Resolve a size expression to a concrete int against input shapes
    (None entries tolerated).  The planner's replacement for its old
    Literal-only capacity checks."""
    s = sym_of(e)
    if s is None:
        return None
    shp = {k: tuple(v) for k, v in (shapes or {}).items() if v}
    v = d.evaluate(s, shp)
    if v is None or v == INF:
        return None
    return int(v)


# -- abstract values ------------------------------------------------------


@dataclass
class AVec:
    """A vector whose length lies in ``n``."""

    n: Interval


@dataclass
class ADict:
    """A dict/group result: ``size`` distinct keys, ``total`` merged
    rows (the CSR fan-out mass for groupbuilders), ``cap`` the declared
    slot budget."""

    size: Interval
    total: Interval
    cap: Optional[Sym]
    group: bool = False


@dataclass
class AStruct:
    items: Tuple[object, ...]


@dataclass
class BuilderBound:
    """One sized allocation site and what the analysis proved about it."""

    node: ir.Expr
    kind: str  # vecbuilder[ty] | dictmerger | groupbuilder | group_probe
    #: derived need (rows to be merged / emitted), UNclamped by declared
    rows: Interval
    #: the declared size (vecbuilder hint / dict capacity / probe out_cap)
    declared: Optional[Sym]
    role: str  # "hint" | "cap" | "out_cap"


class _Unknown(Exception):
    """A merge whose target builder can't be identified — poison the
    enclosing loop's bounds rather than under-count."""


# -- certificate terms (mirror of the emitter's charge sites) -------------


def _charge_terms(e: ir.Expr) -> List[Tuple[str, Sym]]:
    """One term per emitter charge: hinted scalar vecbuilders (the
    generic lowerings and the m:n group-probe buffers both charge
    ``hint * itemsize``) and kernel footprint hooks.  Unresolvable
    terms evaluate to nothing — exactly what the emitter charges when
    it can't statically size an allocation."""
    terms: List[Tuple[str, Sym]] = []
    for node in ir.walk(e):
        if (isinstance(node, ir.NewBuilder)
                and isinstance(node.ty, wt.VecBuilder)
                and node.size_hint is not None
                and isinstance(node.ty.elem, wt.Scalar)):
            hs = sym_of(node.size_hint)
            if hs is not None:
                itemsize = int(np.dtype(node.ty.elem.np_dtype).itemsize)
                terms.append((f"vecbuilder[{node.ty.elem}]",
                              d.mul(hs, d.const(itemsize))))
        elif isinstance(node, ir.KernelCall):
            t = _kernel_term(node)
            if t is not None:
                terms.append((node.kernel, t))
    return terms


def _kernel_term(x: ir.KernelCall) -> Optional[Sym]:
    try:
        from ..kernelplan import registry as kreg
        spec = kreg.get(x.kernel)
    except Exception:
        return None
    fp = getattr(spec, "footprint", None)
    if fp is None:
        return None
    params = dict(x.params)
    itemsize = wt.elem_bytes(x.ret_ty)
    getters: List[Tuple[str, object]] = []
    for a in x.args:
        if isinstance(a, ir.Ident):
            getters.append(("name", a.name))
        elif isinstance(a, ir.MakeVec):
            getters.append(("const", (len(a.items),)))
        else:
            getters.append(("opaque", None))

    def ev(shapes: Shapes) -> int:
        arg_shapes = []
        for kind, v in getters:
            if kind == "name":
                shp = shapes.get(v)
                arg_shapes.append(tuple(shp) if shp else ())
            elif kind == "const":
                arg_shapes.append(v)
            else:
                arg_shapes.append(())
        try:
            return int(fp(arg_shapes, itemsize, params))
        except Exception:
            return 0

    # display the driving length (probe kernels iterate args[1:])
    n_arg = None
    pick = 1 if x.kernel in ("hash_probe", "group_probe") else 0
    if pick < len(x.args) and isinstance(x.args[pick], ir.Ident):
        n_arg = d.length(x.args[pick].name)
    return d.SCall(x.kernel, ev, n_arg)


# -- the abstract interpreter ---------------------------------------------


class _Analyzer:
    def __init__(self):
        self.builders: List[BuilderBound] = []
        self.name_rows: Dict[str, Interval] = {}

    # .. value evaluation ..................................................

    def eval(self, e: ir.Expr, env: Dict[str, object]):
        if isinstance(e, ir.Ident):
            return env.get(e.name)
        if isinstance(e, ir.Let):
            v = self.eval(e.value, env)
            if isinstance(v, AVec):
                self.name_rows[e.name] = v.n
            env2 = dict(env)
            env2[e.name] = v
            return self.eval(e.body, env2)
        if isinstance(e, (ir.If, ir.Select)):
            self.eval(e.cond, env)
            return self._join(self.eval(e.on_true, env),
                              self.eval(e.on_false, env))
        if isinstance(e, ir.MakeStruct):
            return AStruct(tuple(self.eval(i, env) for i in e.items))
        if isinstance(e, ir.GetField):
            v = self.eval(e.expr, env)
            if isinstance(v, AStruct) and e.index < len(v.items):
                return v.items[e.index]
            return None
        if isinstance(e, ir.MakeVec):
            return AVec(d.point(d.const(len(e.items))))
        if isinstance(e, ir.Result):
            if isinstance(e.builder, ir.For):
                return self._ev_for(e.builder, env)
            return self.eval(e.builder, env)
        if isinstance(e, ir.For):
            return self._ev_for(e, env)
        if isinstance(e, ir.GroupLookup):
            dv = self.eval(e.expr, env)
            self.eval(e.key, env)
            hi = dv.total.hi if isinstance(dv, ADict) else d.const(INF)
            return AVec(Interval(d.const(0), hi))
        if isinstance(e, ir.KernelCall):
            return self._ev_kernelcall(e, env)
        # leaves and nodes with no size meaning: still traverse children
        # so nested Lets/loops get analyzed
        for c in e.children():
            self.eval(c, env)
        return None

    def _join(self, a, b):
        if isinstance(a, AVec) and isinstance(b, AVec):
            return AVec(a.n.join(b.n))
        if isinstance(a, AStruct) and isinstance(b, AStruct) \
                and len(a.items) == len(b.items):
            return AStruct(tuple(self._join(x, y)
                                 for x, y in zip(a.items, b.items)))
        if isinstance(a, ADict) and isinstance(b, ADict):
            return ADict(a.size.join(b.size), a.total.join(b.total),
                         a.cap if a.cap == b.cap else None,
                         a.group and b.group)
        return None

    # .. loops .............................................................

    def _vec_interval(self, data: ir.Expr, env, guards) -> Interval:
        if isinstance(data, ir.GroupLookup) \
                and isinstance(data.expr, ir.Ident):
            dv = env.get(data.expr.name)
            hi = dv.total.hi if isinstance(dv, ADict) else d.const(INF)
            lo = d.const(0)
            try:
                if (data.expr.name, ir.canon_key(data.key)) in guards:
                    lo = d.const(1)  # key proven present: >= 1 group row
            except Exception:
                pass
            return Interval(lo, hi)
        v = self.eval(data, env)
        if isinstance(v, AVec):
            return v.n
        return d.top()

    def _iter_interval(self, iters: Sequence[ir.Iter], env,
                       guards) -> Interval:
        out: Optional[Interval] = None
        for it in iters:
            if not it.is_plain:
                return d.top()  # strided views: length not yet modeled
            iv = self._vec_interval(it.data, env, guards)
            out = iv if out is None else Interval(
                d.smin(out.lo, iv.lo), d.smin(out.hi, iv.hi))
        return out if out is not None else d.ZERO

    def _ev_for(self, loop: ir.For, env):
        try:
            return self._ev_for_inner(loop, env)
        except _Unknown:
            return None  # unanalyzable body: no bounds recorded

    def _ev_for_inner(self, loop: ir.For, env):
        n_it = self._iter_interval(loop.iters, env, frozenset())
        if len(loop.func.params) != 3:
            raise _Unknown
        b_name = loop.func.params[0].name
        counts = self._count_merges(loop.func.body, env, frozenset())

        def tot(idx) -> Interval:
            per = counts.get((b_name, idx), d.ZERO)
            return per.mul(n_it)

        init = loop.builder
        if isinstance(init, ir.NewBuilder):
            return self._builder_result(init, tot(None), env)
        if isinstance(init, ir.MakeStruct):
            items = []
            for k, nb in enumerate(init.items):
                if isinstance(nb, ir.NewBuilder):
                    items.append(self._builder_result(nb, tot(k), env))
                else:
                    items.append(None)
            return AStruct(tuple(items))
        if isinstance(init, ir.Ident):
            return env.get(init.name)
        return None

    def _count_merges(self, e: ir.Expr, env, guards
                      ) -> Dict[Tuple[str, Optional[int]], Interval]:
        """Per-iteration merge counts into each named builder slot."""
        if isinstance(e, ir.Merge):
            counts = self._count_merges(e.value, env, guards)
            tgt = e.builder
            if isinstance(tgt, ir.Merge):
                counts = _sum(counts, self._count_merges(tgt, env, guards))
            slot = _root_slot(tgt)
            if slot is None:
                raise _Unknown  # can't attribute this merge: poison
            return _sum(counts, {slot: d.ONE})
        if isinstance(e, ir.If):
            g2 = guards
            if isinstance(e.cond, ir.KeyExists) \
                    and isinstance(e.cond.expr, ir.Ident):
                try:
                    g2 = guards | {(e.cond.expr.name,
                                    ir.canon_key(e.cond.key))}
                except Exception:
                    pass
            c = self._count_merges(e.cond, env, guards)
            t = self._count_merges(e.on_true, env, g2)
            f = self._count_merges(e.on_false, env, guards)
            return _sum(c, _join_counts(t, f))
        if isinstance(e, ir.For):
            if len(e.func.params) != 3:
                raise _Unknown
            fan = self._iter_interval(e.iters, env, guards)
            inner = self._count_merges(e.func.body, env, guards)
            bp = e.func.params[0].name
            out: Dict[Tuple[str, Optional[int]], Interval] = {}
            for (nm, idx), cnt in inner.items():
                key = (nm, idx)
                if nm == bp:
                    # rename the inner loop's builder param to the outer
                    # target it initializes from
                    tgt = e.builder
                    if isinstance(tgt, ir.Ident):
                        key = (tgt.name, idx)
                    elif (isinstance(tgt, ir.GetField)
                          and isinstance(tgt.expr, ir.Ident)
                          and idx is None):
                        key = (tgt.expr.name, tgt.index)
                    else:
                        raise _Unknown
                out = _sum(out, {key: cnt.mul(fan)})
            # the nested loop's own init builders get their bounds too
            self._ev_for(e, env)
            return out
        if isinstance(e, ir.Lambda):
            return {}  # kernel fns / non-loop lambdas: no outer merges
        if isinstance(e, (ir.Ident, ir.Literal)):
            return {}
        out = {}
        for c in e.children():
            out = _sum(out, self._count_merges(c, env, guards))
        return out

    def _builder_result(self, nb: ir.NewBuilder, tot: Interval, env):
        bt = nb.ty
        if isinstance(bt, wt.VecBuilder):
            hint = sym_of(nb.size_hint) if nb.size_hint is not None else None
            self.builders.append(BuilderBound(
                nb, f"vecbuilder[{bt.elem}]", tot, hint, "hint"))
            return AVec(tot)
        if isinstance(bt, (wt.DictMerger, wt.GroupBuilder)):
            cap = sym_of(nb.arg) if nb.arg is not None else d.const(1024)
            kind = ("groupbuilder" if isinstance(bt, wt.GroupBuilder)
                    else "dictmerger")
            self.builders.append(BuilderBound(nb, kind, tot, cap, "cap"))
            hi = tot.hi if cap is None else d.smin(tot.hi, cap)
            return ADict(size=Interval(d.const(0), hi), total=tot,
                         cap=cap, group=isinstance(bt, wt.GroupBuilder))
        if isinstance(bt, wt.VecMerger):
            base = self.eval(nb.arg, env) if nb.arg is not None else None
            return base if isinstance(base, AVec) else None
        return None  # merger: scalar result, no size

    # .. kernel transfer functions .........................................

    def _ev_kernelcall(self, x: ir.KernelCall, env):
        for a in x.args:
            self.eval(a, env)
        params = dict(x.params)
        k = x.kernel

        def args_interval(exprs) -> Interval:
            out: Optional[Interval] = None
            for a in exprs:
                iv = self._vec_interval(a, env, frozenset())
                out = iv if out is None else Interval(
                    d.smin(out.lo, iv.lo), d.smin(out.hi, iv.hi))
            return out if out is not None else d.ZERO

        if k == "map_elementwise":
            return AVec(args_interval(x.args))
        if k == "vecmerger_segment_sum":
            base = self.eval(x.args[0], env)
            return base if isinstance(base, AVec) else None
        if k in ("dict_hash_build", "dict_group_sum", "group_build"):
            n_b = args_interval(x.args)
            cap = params.get("capacity")
            cap_s = d.const(int(cap)) if cap is not None else None
            lo = d.const(0)
            total = Interval(
                lo if params.get("has_pred") else n_b.lo, n_b.hi)
            hi = n_b.hi if cap_s is None else d.smin(n_b.hi, cap_s)
            return ADict(size=Interval(d.const(0), hi), total=total,
                         cap=cap_s, group=(k == "group_build"))
        if k == "hash_probe":
            n_pr = args_interval(x.args[1:])
            how = params.get("how", "inner")
            lo = (n_pr.lo if how == "left" and not params.get("has_pred")
                  else d.const(0))
            rows = Interval(lo, n_pr.hi)
            return self._probe_struct(x, rows)
        if k == "group_probe":
            n_iters = int(params.get("n_iters", 1))
            n_pr = args_interval(x.args[1:1 + n_iters])
            dv = self.eval(x.args[0], env) if x.args else None
            fan_hi = dv.total.hi if isinstance(dv, ADict) else d.const(INF)
            how = params.get("how", "inner")
            if how == "left":
                exp_hi = d.mul(n_pr.hi, d.smax(fan_hi, d.const(1)))
                lo = (n_pr.lo if not params.get("has_pred")
                      else d.const(0))
            else:
                exp_hi = d.mul(n_pr.hi, fan_hi)
                lo = d.const(0)
            derived = Interval(lo, exp_hi)
            out_cap = params.get("out_cap")
            decl = d.const(int(out_cap)) if out_cap is not None else None
            self.builders.append(BuilderBound(
                x, "group_probe", derived, decl, "out_cap"))
            hi = exp_hi if decl is None else d.smin(decl, exp_hi)
            return self._probe_struct(x, Interval(lo, hi))
        return None  # matmul/matvec/filter_reduce: no row-count meaning

    def _probe_struct(self, x: ir.KernelCall, rows: Interval):
        ret = x.ret_ty
        if isinstance(ret, wt.Struct):
            return AStruct(tuple(AVec(rows) for _ in ret.fields))
        return AVec(rows)


def _root_slot(tgt: ir.Expr):
    while isinstance(tgt, ir.Merge):
        tgt = tgt.builder
    if isinstance(tgt, ir.GetField) and isinstance(tgt.expr, ir.Ident):
        return (tgt.expr.name, tgt.index)
    if isinstance(tgt, ir.Ident):
        return (tgt.name, None)
    return None


def _sum(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out[k].add(v) if k in out else v
    return out


def _join_counts(t: Dict, f: Dict) -> Dict:
    out = {}
    for k in set(t) | set(f):
        out[k] = t.get(k, d.ZERO).join(f.get(k, d.ZERO))
    return out


# -- report ---------------------------------------------------------------


@dataclass
class BoundsReport:
    expr: ir.Expr
    inputs: List[str]
    rename: Dict[str, str]
    builders: List[BuilderBound] = field(default_factory=list)
    terms: List[Tuple[str, Sym]] = field(default_factory=list)
    result: object = None
    name_rows: Dict[str, Interval] = field(default_factory=dict)

    def certificate(self) -> str:
        """The symbolic peak-memory expression, human-readable."""
        if not self.terms:
            return "0"
        return " + ".join(d.render(t, self.rename) for _, t in self.terms)

    def peak(self, shapes: Optional[Shapes]) -> int:
        """Certificate evaluated at concrete shapes (bytes).  Terms the
        emitter couldn't resolve either charge 0 there too."""
        shp = {k: tuple(v) for k, v in (shapes or {}).items() if v}
        total = 0
        for _, t in self.terms:
            v = d.evaluate(t, shp)
            if v is None or v == INF:
                continue
            total += int(v)
        return total

    def result_interval(self) -> Optional[Interval]:
        v = self.result
        if isinstance(v, AStruct):
            for item in v.items:
                if isinstance(item, AVec):
                    return item.n
            return None
        if isinstance(v, AVec):
            return v.n
        if isinstance(v, ADict):
            return v.size
        return None

    def result_rows(self, shapes: Optional[Shapes]
                    ) -> Optional[Tuple[int, Optional[int]]]:
        iv = self.result_interval()
        if iv is None:
            return None
        shp = {k: tuple(v) for k, v in (shapes or {}).items() if v}
        hi = iv.hi_val(shp)
        return (iv.lo_val(shp), None if hi == INF else int(hi))

    def name_bounds(self, shapes: Optional[Shapes]
                    ) -> Dict[str, Tuple[int, Optional[int]]]:
        """Concrete ``[lo, hi]`` per let-bound vector — the planner's
        interval-midpoint cost inputs."""
        shp = {k: tuple(v) for k, v in (shapes or {}).items() if v}
        out = {}
        for name, iv in self.name_rows.items():
            hi = iv.hi_val(shp)
            out[name] = (iv.lo_val(shp), None if hi == INF else int(hi))
        return out

    def capacity_bounds(self, shapes: Optional[Shapes]
                        ) -> Dict[int, Tuple[int, Optional[int]]]:
        """``id(NewBuilder) -> (lb, ub)`` for dict/group capacity sites
        — the recovery ladder's clamp.  ``lb`` is a lower bound on the
        SLOTS needed (distinct keys: >=1 whenever anything merges), ub
        an upper bound (total merged rows)."""
        shp = {k: tuple(v) for k, v in (shapes or {}).items() if v}
        out = {}
        for bb in self.builders:
            if bb.role != "cap":
                continue
            lb = 1 if bb.rows.lo_val(shp) >= 1 else 0
            hi = bb.rows.hi_val(shp)
            out[id(bb.node)] = (lb, None if hi == INF else int(hi))
        return out

    def builder_lines(self, shapes: Optional[Shapes]) -> List[str]:
        shp = {k: tuple(v) for k, v in (shapes or {}).items() if v}
        lines = []
        for bb in self.builders:
            hi = bb.rows.hi_val(shp)
            hi_s = "inf" if hi == INF else str(int(hi))
            decl = ""
            if bb.declared is not None:
                dv = d.evaluate(bb.declared, shp)
                shown = (d.render(bb.declared, self.rename)
                         if dv is None else str(int(dv)))
                decl = f" {bb.role}={shown}"
            lines.append(
                f"{bb.kind:<22} rows={bb.rows.render(self.rename)}"
                f" = [{bb.rows.lo_val(shp)}, {hi_s}]{decl}")
        return lines


def analyze(e: ir.Expr, env=None) -> BoundsReport:
    """Run the interval interpreter + certificate walk over a program.
    ``env`` (name -> WeldType) is accepted for checkpoint-API symmetry;
    input types come from the program's free variables."""
    fv = ir.free_vars(e)
    inputs = sorted(fv)
    rename = {n: f"in{i}" for i, n in enumerate(inputs)}
    a = _Analyzer()
    env0: Dict[str, object] = {}
    for name, ty in fv.items():
        if isinstance(ty, wt.Vec):
            n = d.length(name)
            env0[name] = AVec(d.point(n))
    result = a.eval(e, env0)
    return BoundsReport(expr=e, inputs=inputs, rename=rename,
                        builders=a.builders, terms=_charge_terms(e),
                        result=result, name_rows=a.name_rows)
