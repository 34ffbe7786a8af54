"""weldcheck: a static IR verifier + race/linearity linter.

Four analyses over a Weld program, run from one shared non-throwing type
annotation pass (so a checkpoint costs one O(n) walk plus three linear
lints, never repeated inference):

1. **types** (``verify_types.annotate``) — whole-program type/shape
   re-verification closing over ``Let``/``Lambda``/``For`` environments,
   including planner ``KernelCall`` output types (WV1xx);
2. **linearity** (``linear.lint_linearity``) — every builder consumed
   exactly once per control path (WV2xx);
3. **races** (``races.lint_races``) — non-commutative merges, reads of a
   builder mid-construction, aliasing scatters (WV3xx);
4. **capacity** (``capacity.lint_capacity``) — capacity/poison
   soundness, plus the differential ``verify_rewrite`` used by
   recovery's regrow (WV4xx);
5. **bounds** (``bounds_lint.lint_bounds``) — declared sizes vs. the
   weldbound interval analysis (hint below the derived lower bound,
   capacity above the proven upper bound, peak-memory certificate
   contradicting ``memory_limit``) (WV5xx).

The pipeline calls :func:`checkpoint` after every optimizer pass, after
kernel planning, and after every recovery rewrite.  Checkpoints are
no-ops unless ``WELD_VERIFY=1`` (tests/CI default it on); a violation
raises :class:`~repro_torch.core.errors.WeldVerifyError` naming the pass, the
diagnostic code, and the pretty-printed offending subexpression.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

from .. import ir
from .. import obs
from .. import wtypes as wt
from ..errors import WeldVerifyError
from .bounds_lint import lint_bounds
from .capacity import check_regrow_monotone, lint_capacity
from .diagnostics import CODES, Diagnostic
from .linear import lint_linearity
from .races import lint_races
from .verify_types import annotate

__all__ = [
    "CODES",
    "Diagnostic",
    "WeldVerifyError",
    "ENV_VERIFY",
    "enabled",
    "set_enabled",
    "annotate",
    "verify",
    "checkpoint",
    "verify_rewrite",
]

ENV_VERIFY = "WELD_VERIFY"

#: analysis name -> lint entrypoint (all take (expr, types) -> [Diagnostic];
#: "bounds" additionally receives shapes/memory_limit keywords)
ANALYSES = {
    "linearity": lint_linearity,
    "races": lint_races,
    "capacity": lint_capacity,
    "bounds": lint_bounds,
}

_override: Optional[bool] = None


def enabled() -> bool:
    """True when checkpoints should run (``WELD_VERIFY=1`` or a
    programmatic override).  Read dynamically so tests can flip it."""
    if _override is not None:
        return _override
    v = os.environ.get(ENV_VERIFY, "")
    return str(v).strip().lower() not in ("", "0", "false", "no", "off")


def set_enabled(value: Optional[bool]) -> None:
    """Force verification on/off regardless of the environment;
    ``None`` restores environment control."""
    global _override
    _override = value


def verify(
    e: ir.Expr,
    env: Optional[Dict[str, wt.WeldType]] = None,
    analyses: Optional[Sequence[str]] = None,
    shapes: Optional[dict] = None,
    memory_limit: Optional[int] = None,
) -> List[Diagnostic]:
    """Run the verifier over ``e`` and return every diagnostic found.

    ``env`` types the program's free identifiers; when omitted it is
    recovered from the idents' own annotations (sufficient for
    post-frontend IR, where frames stamp input types on the roots).
    ``shapes`` (input name -> shape) lets the bounds lint resolve
    symbolic sizes; ``memory_limit`` additionally arms the WV503
    certificate-contradiction check (checkpoints never pass it — the
    admission path owns that rejection with a typed ResourceError).
    """
    if env is None:
        env = {k: t for k, t in ir.free_vars(e).items() if t is not None}
    types, diags = annotate(e, env)
    root_ty = types.get(id(e))
    if isinstance(root_ty, wt.BuilderType):
        diags.append(Diagnostic(
            "WV201",
            f"program evaluates to an unconsumed builder ({root_ty}) — "
            f"missing result()",
            e, analysis="linearity"))
    for name in (analyses if analyses is not None else ANALYSES):
        if name == "bounds":
            diags.extend(ANALYSES[name](e, types, shapes=shapes,
                                        memory_limit=memory_limit))
        else:
            diags.extend(ANALYSES[name](e, types))
    return diags


def checkpoint(
    phase: str,
    e: ir.Expr,
    env: Optional[Dict[str, wt.WeldType]] = None,
    stats: Optional[dict] = None,
    shapes: Optional[dict] = None,
) -> None:
    """Verify ``e`` at a named pipeline point; raise on violations.

    No-op when verification is disabled.  Timing and outcome land in
    ``stats["verify.*"]`` and a weldtrace ``verify`` span.
    """
    if not enabled():
        return
    t0 = time.perf_counter()
    with obs.span("verify", phase=phase) as sp:
        diags = verify(e, env=env, shapes=shapes)
        sp.set("diagnostics", len(diags))
    ms = (time.perf_counter() - t0) * 1e3
    if stats is not None:
        stats["verify.runs"] = stats.get("verify.runs", 0) + 1
        stats["verify.ms"] = stats.get("verify.ms", 0.0) + ms
        stats.setdefault("verify.phases", []).append((phase, round(ms, 3)))
    if diags:
        _raise(phase, e, diags)


def verify_rewrite(
    phase: str,
    before: ir.Expr,
    after: ir.Expr,
    stats: Optional[dict] = None,
) -> None:
    """Differential checkpoint for capacity rewrites: ``after`` must
    verify clean *and* every capacity must dominate its counterpart in
    ``before`` (WV404)."""
    if not enabled():
        return
    t0 = time.perf_counter()
    with obs.span("verify", phase=phase, differential=True) as sp:
        diags = check_regrow_monotone(before, after)
        diags.extend(verify(after))
        sp.set("diagnostics", len(diags))
    ms = (time.perf_counter() - t0) * 1e3
    if stats is not None:
        stats["verify.runs"] = stats.get("verify.runs", 0) + 1
        stats["verify.ms"] = stats.get("verify.ms", 0.0) + ms
        stats.setdefault("verify.phases", []).append((phase, round(ms, 3)))
    if diags:
        _raise(phase, after, diags)


def _raise(phase: str, root: ir.Expr, diags: List[Diagnostic]) -> None:
    from ..pretty import pretty

    lines = [f"weldcheck failed after {phase!r} "
             f"({len(diags)} diagnostic{'s' if len(diags) != 1 else ''}):"]
    lines += [f"  {d.render(root)}" for d in diags]
    first = next((d.node for d in diags if d.node is not None), None)
    if first is not None:
        lines.append("program (offender highlighted):")
        lines.append(pretty(root, anchors=True, highlight=first))
    raise WeldVerifyError("\n".join(lines), phase=phase, diagnostics=diags)
