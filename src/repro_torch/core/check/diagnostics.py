"""Diagnostic objects and the weldcheck code registry.

Codes are grouped by analysis family:

* ``WV1xx`` — whole-program type/shape re-verification
* ``WV2xx`` — builder linearity (consumed exactly once per path)
* ``WV3xx`` — merge-race lint (parallel-loop soundness)
* ``WV4xx`` — capacity / poison soundness
* ``WV5xx`` — weldbound size/memory-bounds contradictions

Every diagnostic carries the offending IR node so callers (the
``WeldVerifyError`` message, ``tools/weldlint.py``) can point at the
exact subexpression via ``pretty.anchor_of`` / ``highlight=``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .. import ir

#: code -> (slug, one-line description)
CODES = {
    # -- types ------------------------------------------------------------
    "WV101": ("type-error",
              "expression fails whole-program type re-verification"),
    "WV102": ("stale-ident-type",
              "identifier annotation disagrees with its binding's type"),
    "WV103": ("unknown-kernel",
              "KernelCall names a kernel absent from the registry"),
    "WV104": ("builder-arg-type",
              "NewBuilder argument has the wrong type for the builder"),
    # -- linearity --------------------------------------------------------
    "WV201": ("builder-unused",
              "builder bound but never consumed on any path"),
    "WV202": ("builder-reused",
              "builder consumed more than once along a control path"),
    "WV203": ("merge-after-result",
              "builder used again after result() consumed it"),
    "WV204": ("builder-captured-by-loop",
              "free builder captured by a loop body (consumed per iteration)"),
    "WV205": ("builder-branch-imbalance",
              "builder consumed on some control paths but not others"),
    "WV206": ("builder-valued-select",
              "select() over builders: both sides evaluate, breaking "
              "linearity"),
    # -- races ------------------------------------------------------------
    "WV301": ("noncommutative-merge",
              "merger-family builder carries a non-commutative merge op"),
    "WV302": ("read-during-build",
              "loop body reads a builder that is still being built"),
    "WV303": ("aliasing-scatter",
              "vecmerger scatter index can alias under a non-commutative "
              "combine"),
    # -- capacity ---------------------------------------------------------
    "WV401": ("bad-capacity",
              "dict/group builder capacity literal is not a positive int"),
    "WV402": ("kernel-capacity-mismatch",
              "KernelCall capacity param invalid or disagrees with the "
              "builder it lowers"),
    "WV403": ("unsound-size-hint",
              "size hint is negative or duplicates a loop"),
    "WV404": ("regrow-not-monotone",
              "capacity rewrite shrank a capacity (regrow must grow)"),
    # -- bounds (weldbound interval analysis) -----------------------------
    "WV501": ("size-below-lower-bound",
              "declared size is below the derived lower bound (buffer "
              "provably truncates)"),
    "WV502": ("size-above-upper-bound",
              "declared size exceeds the derived upper bound (allocation "
              "provably wastes budget)"),
    "WV503": ("certificate-exceeds-limit",
              "peak-memory certificate exceeds the plan's memory_limit"),
}


@dataclass
class Diagnostic:
    code: str
    message: str
    node: Optional[ir.Expr] = None
    #: analysis that produced it ("types", "linearity", "races", "capacity")
    analysis: str = ""
    #: extra structured context (binder name, counts, ...)
    data: dict = field(default_factory=dict)

    @property
    def slug(self) -> str:
        return CODES.get(self.code, ("?", ""))[0]

    def render(self, root: Optional[ir.Expr] = None) -> str:
        from ..pretty import anchor_of, short

        loc = ""
        if self.node is not None:
            anchor = anchor_of(root, self.node) if root is not None else None
            at = f"{anchor} " if anchor else ""
            loc = f" at {at}`{short(self.node)}`"
        return f"[{self.code} {self.slug}] {self.message}{loc}"

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.render()
