"""guarded-by: lock discipline for annotated shared state.

Registration (file-scoped — analysis is per-file so caching stays sound):

    _resident_bytes = 0          # guarded-by: _res_lock
    self._data: Dict[...] = {}   # guarded-by: self._mu

Every later read or write of a registered module global (by name) or
`self.<attr>` (within the registering file) must be lexically inside
`with <lock>:` — matched on the exact source text of the with-item — or
inside a function annotated `# holds-lock: <lock>` on its def line
(meaning: the caller holds the lock; call sites of such functions are then
checked for the same guard). Exemptions: the registering statement itself,
module top level and class bodies (single-threaded import time), and
`__init__`/`__new__` (the object is not yet shared).

A `# holds-lock:` that names another module's lock class by its canonical
name (`ops.stage._prepare_lock`: a dynamic set of stage objects' locks,
taken by explicit acquire in id order, ops/sharedscan.py::_run_group) is
an entry context of the lock-order graph; no `with` of this file can name
it lexically, so its call sites are left to the lock-order rule and the
runtime witness."""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ballista_tpu_torch.analysis.core import Finding, SourceFile, register


def _norm(expr: str) -> str:
    return expr.replace(" ", "")


def _lexical(lock: str) -> bool:
    """A lock expression of this file (`self._mu`, `_res_lock`), not a
    canonical `<module>.<attr>` class name of another module."""
    t = lock.strip()
    return "." not in t or t.startswith(("self.", "cls."))


def _target_keys(stmt: ast.AST) -> List[Tuple[str, str]]:
    """('global', name) / ('attr', name) keys for an assignment's targets."""
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    out = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(("global", t.id))
        elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self":
            out.append(("attr", t.attr))
    return out


class _Checker(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, guards: Dict[Tuple[str, str], str],
                 registration_lines: Set[int]):
        self.sf = sf
        self.guards = guards
        self.registration_lines = registration_lines
        self.findings: List[Finding] = []
        self.held: List[str] = []
        self.func_stack: List[ast.AST] = []
        self.holds_fns: Dict[str, str] = {}  # func name -> lock it requires

    # -- context tracking ---------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        locks = [
            _norm(ast.unparse(item.context_expr)) for item in node.items
        ]
        self.held.extend(locks)
        self.generic_visit(node)
        del self.held[len(self.held) - len(locks):]

    def _visit_func(self, node) -> None:
        held_here = self.sf.holds_lock(node)
        if held_here and _lexical(held_here):
            self.holds_fns[node.name] = _norm(held_here)
        saved = self.held
        self.held = [_norm(held_here)] if held_here else []
        self.func_stack.append(node)
        self.generic_visit(node)
        self.func_stack.pop()
        self.held = saved

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- access checks ------------------------------------------------------
    def _exempt(self) -> bool:
        if not self.func_stack:
            return True  # module top level / class body: import-time init
        return self.func_stack[-1].name in ("__init__", "__new__")

    def _check(self, node: ast.AST, key: Tuple[str, str], shown: str) -> None:
        lock = self.guards.get(key)
        if lock is None or self._exempt():
            return
        if node.lineno in self.registration_lines:
            return
        if _norm(lock) in self.held:
            return
        fn = self.func_stack[-1].name if self.func_stack else "<module>"
        self.findings.append(Finding(
            "guarded-by", self.sf.path, node.lineno, node.col_offset,
            f"'{shown}' is guarded by '{lock}' but accessed outside "
            f"`with {lock}` in '{fn}' — acquire the lock or annotate the "
            f"function `# holds-lock: {lock}`",
        ))

    def visit_Name(self, node: ast.Name) -> None:
        self._check(node, ("global", node.id), node.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            self._check(node, ("attr", node.attr), f"self.{node.attr}")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # a call to a holds-lock function must itself happen under the lock
        fname = None
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        elif isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        lock = self.holds_fns.get(fname or "")
        if lock and lock not in self.held and not self._exempt():
            fn = self.func_stack[-1].name if self.func_stack else "<module>"
            self.findings.append(Finding(
                "guarded-by", self.sf.path, node.lineno, node.col_offset,
                f"'{fname}' requires holding '{lock}' (holds-lock "
                f"annotation) but is called without it in '{fn}'",
            ))
        self.generic_visit(node)


@register("guarded-by")
def check(sf: SourceFile) -> List[Finding]:
    guards: Dict[Tuple[str, str], str] = {}
    registration_lines: Set[int] = set()
    for stmt, lock in sf.guarded_targets():
        for key in _target_keys(stmt):
            guards[key] = lock
        registration_lines.add(stmt.lineno)
    # collect holds-lock functions FIRST so call-site checks see them all
    checker = _Checker(sf, guards, registration_lines)
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            held = sf.holds_lock(node)
            if held and _lexical(held):
                checker.holds_fns[node.name] = _norm(held)
    if not guards and not checker.holds_fns:
        return []
    checker.visit(sf.tree)
    return checker.findings
