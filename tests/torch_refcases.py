"""Run the JAX package's own test cases against the port.

:func:`port_cases` reads ``tests/<name>.py``, renames the package
(``repro`` → ``repro_torch``, ``jaxgen`` → ``torchgen``), drops the cases
it is told to leave out, executes the result, and adds its cases and
fixtures to the caller's namespace, so pytest collects every remaining
case as a test of the port (each case keeps the helpers of its own
file).  Every case keeps its body, its inputs and its
oracle (``interp`` for the IR, numpy for values); an autouse fixture
evaluates on the CPU.  The untouched file runs the same cases against
the JAX package in the same suite.
"""
from __future__ import annotations

import ast
import linecache
import re
from pathlib import Path

import pytest

import repro_torch

_TESTS = Path(__file__).resolve().parent

_RENAMES = (
    (re.compile(r"\brepro\b(?!_torch)"), "repro_torch"),
    (re.compile(r"\bjaxgen\b"), "torchgen"),
)


def _drop(src: str, leave_out) -> str:
    """The source without the top-level functions named in leave_out."""
    if not leave_out:
        return src
    tree = ast.parse(src)
    lines = src.splitlines(keepends=True)
    cut = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in leave_out:
            first = min([node.lineno] + [d.lineno for d in
                                         node.decorator_list])
            cut.update(range(first - 1, node.end_lineno))
    missing = set(leave_out) - {
        n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    if missing:
        raise ValueError(f"no such cases to leave out: {sorted(missing)}")
    # keep the line numbers: a cut line becomes empty
    return "".join("\n" if i in cut else ln for i, ln in enumerate(lines))


def _cases_but(src: str, only) -> tuple:
    """The names of the top-level test functions not in ``only``."""
    names = {n.name for n in ast.parse(src).body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test")}
    missing = set(only) - names
    if missing:
        raise ValueError(f"no such cases to keep: {sorted(missing)}")
    return tuple(sorted(names - set(only)))


def port_cases(name: str, namespace: dict, leave_out=(), only=None) -> None:
    """Execute the port's copy of ``tests/<name>.py`` in ``namespace``;
    ``only`` keeps just the named cases (and every helper and fixture)."""
    path = _TESTS / f"{name}.py"
    text = path.read_text()
    if only is not None:
        leave_out = tuple(leave_out) + _cases_but(text, only)
    src = _drop(text, leave_out)
    for pat, new in _RENAMES:
        src = pat.sub(new, src)
    fname = f"{path} (on repro_torch)"
    # inspect.getsource (the UDF translator reads it) finds the text here
    linecache.cache[fname] = (len(src), None, src.splitlines(True), fname)
    cases = {"__name__": namespace["__name__"], "__file__": fname}
    exec(compile(src, fname, "exec"), cases)
    for key, value in cases.items():
        if key.startswith("__"):
            continue
        if key in namespace and namespace[key] is not value:
            if key.startswith("test"):
                raise ValueError(f"{name}: case {key} is already defined")
            continue  # a helper of the same name: each case keeps its own
        namespace[key] = value

    @pytest.fixture(autouse=True, scope="module")
    def _port_on_cpu():
        repro_torch.set_default_device("cpu")
        yield
        repro_torch.set_default_device("cuda")

    namespace["_port_on_cpu"] = _port_on_cpu
