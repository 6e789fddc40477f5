"""simlint: the determinism lint for the event-kernel codebase.

AST rules encoding the determinism contract (docs/determinism.md) that
every ``src/repro_torch`` module must obey for virtual-time runs to be
reproducible (a copy of ``repro.analysis.lint``, the same rules):

  * **SIM001** — ``except Exception`` (or bare ``except``) inside a
    generator function with no ``except Interrupt`` ahead of it.
    ``sim.Interrupt`` subclasses ``Exception``, so a broad handler on a
    generator-process call path silently eats kernel control flow;
  * **SIM002** — wall-clock or unseeded randomness where the virtual
    clock should rule: ``time.time``/``time.monotonic``,
    ``datetime.now``, bare stdlib ``random.*``, legacy unseeded
    ``np.random.*`` (``default_rng(seed)`` and seeded generators stay
    legal);
  * **SIM003** — ordering-sensitive iteration at scheduling decision
    points: ``for x in set(...)`` / set literals, fan-out into ``any_of``
    built from a live ``dict.keys()`` view, and collections mutated while
    being iterated;
  * **SIM004** — busy-poll loops (``while ...: yield <small const>``):
    polling burns heap events and couples behaviour to the poll phase —
    wait on a Condition instead;
  * **SIM005** — ``Condition.on_trigger`` registration inside a loop in a
    function with no paired ``detach``: each pass grows the callback list
    of a (potentially long-lived) condition forever.

Suppress a finding with ``# simlint: disable=SIM002`` (comma-separated
list) on the flagged line or the line directly above it.  ``--json``
emits machine-readable findings.  Exit status 1 iff any un-suppressed
finding remains.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Set

RULES: Dict[str, str] = {
    "SIM001": "broad except can swallow sim.Interrupt in a generator",
    "SIM002": "wall-clock time or unseeded randomness under the virtual clock",
    "SIM003": "ordering-sensitive iteration at a scheduling decision point",
    "SIM004": "busy-poll loop (while ...: yield <small const>)",
    "SIM005": "on_trigger registration in a loop without a paired detach",
}

_DISABLE_RE = re.compile(r"#\s*simlint:\s*disable=([A-Z0-9, ]+)")

# stdlib wall-clock calls (time.perf_counter stays legal: it measures the
# duration of real model compute, never drives the schedule)
_WALLCLOCK_TIME = {"time", "time_ns", "monotonic", "monotonic_ns"}
_WALLCLOCK_DATETIME = {"now", "utcnow", "today"}
# numpy legacy global-state RNG (np.random.default_rng(seed) is fine)
_NP_LEGACY_RANDOM = {"rand", "randn", "randint", "random", "random_sample",
                     "choice", "shuffle", "permutation", "seed", "uniform",
                     "normal", "exponential", "poisson"}
_BUSY_POLL_MAX_S = 1.0


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _suppressed(lines: Sequence[str], finding: Finding) -> bool:
    """True when the flagged line (or the line directly above) carries a
    ``# simlint: disable=...`` pragma naming the rule."""
    for lineno in (finding.line, finding.line - 1):
        if 1 <= lineno <= len(lines):
            m = _DISABLE_RE.search(lines[lineno - 1])
            if m and finding.rule in {r.strip()
                                      for r in m.group(1).split(",")}:
                return True
    return False


def _is_generator(fn: ast.AST) -> bool:
    """Does this function body yield (ignoring nested defs)?"""
    for node in ast.walk(fn):
        if node is fn:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # don't descend into nested functions
            for sub in list(ast.walk(node)):
                sub._simlint_skip = True  # type: ignore[attr-defined]
    for node in ast.walk(fn):
        if getattr(node, "_simlint_skip", False) or node is fn:
            continue
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            return True
    return False


def _names_in(expr: Optional[ast.AST]) -> Set[str]:
    """Identifier names mentioned in an except-clause type expression."""
    if expr is None:
        return set()
    out: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def _expr_key(expr: ast.AST) -> str:
    """A stable textual key for 'is this the same collection expression'."""
    return ast.dump(expr)


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._fn_stack: List[dict] = []
        self._loop_depth = 0

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(self.path, node.lineno,
                                     node.col_offset, rule, message))

    # -- function context ------------------------------------------------------
    def _visit_function(self, node) -> None:
        info = {"node": node, "is_gen": _is_generator(node),
                "on_trigger_sites": [], "has_detach": False,
                "outer_loop_depth": self._loop_depth}
        self._fn_stack.append(info)
        saved, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = saved
        self._fn_stack.pop()
        if not info["has_detach"]:
            for site in info["on_trigger_sites"]:
                self._flag(
                    site, "SIM005",
                    "on_trigger registered inside a loop with no paired "
                    "detach in this function: each pass grows the "
                    "condition's callback list forever")

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _in_generator(self) -> bool:
        return bool(self._fn_stack) and self._fn_stack[-1]["is_gen"]

    # -- SIM001 ----------------------------------------------------------------
    def visit_Try(self, node: ast.Try) -> None:
        if self._in_generator():
            interrupt_handled = False
            for handler in node.handlers:
                names = _names_in(handler.type)
                if "Interrupt" in names or "GeneratorExit" in names:
                    interrupt_handled = True
                    continue
                broad = handler.type is None or bool(
                    names & {"Exception", "BaseException"})
                reraises = (len(handler.body) == 1
                            and isinstance(handler.body[0], ast.Raise)
                            and handler.body[0].exc is None)
                if broad and not interrupt_handled and not reraises:
                    self._flag(
                        handler, "SIM001",
                        "broad except in a generator with no prior "
                        "'except Interrupt: raise': sim.Interrupt "
                        "subclasses Exception and would be swallowed here")
        self.generic_visit(node)

    # -- SIM002 ----------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name):
                if base.id == "time" and fn.attr in _WALLCLOCK_TIME:
                    self._flag(node, "SIM002",
                               f"time.{fn.attr}() reads the wall clock; "
                               f"use sim.now under the virtual clock")
                elif base.id == "datetime" and fn.attr in _WALLCLOCK_DATETIME:
                    self._flag(node, "SIM002",
                               f"datetime.{fn.attr}() reads the wall clock")
                elif base.id == "random":
                    self._flag(node, "SIM002",
                               f"bare random.{fn.attr}() draws from global "
                               f"unseeded state; use np.random.default_rng"
                               f"(seed)")
            elif (isinstance(base, ast.Attribute) and base.attr == "random"
                    and isinstance(base.value, ast.Name)
                    and base.value.id in ("np", "numpy")
                    and fn.attr in _NP_LEGACY_RANDOM):
                self._flag(node, "SIM002",
                           f"np.random.{fn.attr}() uses the legacy global "
                           f"RNG; use np.random.default_rng(seed)")
            if fn.attr == "on_trigger" and self._fn_stack:
                if self._loop_depth > 0:
                    self._fn_stack[-1]["on_trigger_sites"].append(node)
            elif fn.attr in ("detach", "remove_on_processed",
                            "remove_migration_listener", "unlisten_all"):
                for info in self._fn_stack:
                    info["has_detach"] = True
        elif isinstance(fn, ast.Name) and fn.id == "unlisten_all":
            for info in self._fn_stack:
                info["has_detach"] = True
        self._check_anyof_fanout(node)
        self.generic_visit(node)

    # -- SIM003 ----------------------------------------------------------------
    def _check_anyof_fanout(self, node: ast.Call) -> None:
        fn = node.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else "")
        if name != "any_of":
            return
        for arg in node.args:
            if not isinstance(arg, ast.Starred):
                continue
            v = arg.value
            live_view = (isinstance(v, ast.Call)
                         and isinstance(v.func, ast.Attribute)
                         and v.func.attr in ("keys", "values", "items"))
            unordered = (isinstance(v, (ast.Set, ast.SetComp))
                         or (isinstance(v, ast.Call)
                             and isinstance(v.func, ast.Name)
                             and v.func.id in ("set", "frozenset")))
            if live_view:
                self._flag(node, "SIM003",
                           "any_of fan-out built from a live dict view; "
                           "snapshot it (list(...)) in explicit order "
                           "before yielding")
            elif unordered:
                self._flag(node, "SIM003",
                           "any_of fan-out built from an unordered set: "
                           "callback arm order follows object hashes")

    def _visit_loop(self, node) -> None:
        if isinstance(node, ast.For):
            it = node.iter
            if (isinstance(it, (ast.Set, ast.SetComp))
                    or (isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id in ("set", "frozenset"))):
                self._flag(node, "SIM003",
                           "iterating a set at a decision point: visit "
                           "order follows object hashes — sort or use an "
                           "insertion-ordered dict")
            elif isinstance(it, (ast.Name, ast.Attribute)):
                key = _expr_key(it)
                for sub in ast.walk(node):
                    mutates = (
                        (isinstance(sub, ast.Call)
                         and isinstance(sub.func, ast.Attribute)
                         and sub.func.attr in ("pop", "add", "remove",
                                               "discard", "popitem",
                                               "clear", "append")
                         and _expr_key(sub.func.value) == key)
                        or (isinstance(sub, ast.Delete)
                            and any(isinstance(t, ast.Subscript)
                                    and _expr_key(t.value) == key
                                    for t in sub.targets))
                        or (isinstance(sub, ast.Assign)
                            and any(isinstance(t, ast.Subscript)
                                    and _expr_key(t.value) == key
                                    for t in sub.targets)))
                    if mutates:
                        self._flag(sub, "SIM003",
                                   "collection mutated while being "
                                   "iterated: snapshot it (list(...)) "
                                   "first")
                        break
        if isinstance(node, ast.While) and self._in_generator():
            for stmt in ast.walk(node):
                if (isinstance(stmt, ast.Expr)
                        and isinstance(stmt.value, ast.Yield)
                        and isinstance(stmt.value.value, ast.Constant)
                        and isinstance(stmt.value.value.value, (int, float))
                        and 0 < stmt.value.value.value <= _BUSY_POLL_MAX_S):
                    self._flag(stmt, "SIM004",
                               f"busy-poll: yields a constant "
                               f"{stmt.value.value.value!r}s inside a "
                               f"while loop — wait on a Condition instead")
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop


def lint_source(text: str, path: str = "<string>") -> List[Finding]:
    tree = ast.parse(text, filename=path)
    checker = _Checker(path)
    checker.visit(tree)
    lines = text.splitlines()
    out = [f for f in checker.findings if not _suppressed(lines, f)]
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def lint_file(path: str) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            findings.extend(lint_file(root))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, fname)))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="simlint",
        description="determinism lint for the event-kernel codebase")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths)
    if args.json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        if not findings:
            print(f"simlint OK ({len(RULES)} rules, no findings)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
