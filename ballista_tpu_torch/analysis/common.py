"""Shared AST machinery: dotted-name resolution, function-local taint
propagation and device-path scoping."""

from __future__ import annotations

import ast
import re
from typing import Callable, Iterable, List, Optional, Set

# the package root every display path is relative to; lock and module
# names are `<module>.<attr>` below it, as in the JAX package
PACKAGE = "ballista_tpu_torch"
PACKAGE_PREFIX = PACKAGE + "/"
DEVICE_PATH_RE = re.compile(r"(?:^|/)ballista_tpu_torch/(ops|parallel)/[^/]+\.py$")


def in_package(display_path: str) -> bool:
    return display_path.replace("\\", "/").startswith(PACKAGE_PREFIX)


def is_device_path(display_path: str) -> bool:
    return bool(DEVICE_PATH_RE.search(display_path.replace("\\", "/")))


def dotted(node: ast.AST) -> Optional[str]:
    """'np.asarray' for Attribute/Name chains; None for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def final_name(node: ast.AST) -> Optional[str]:
    """Last segment of a Name/Attribute (call targets of any base)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def walk_no_nested_defs(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested function/class
    definitions (they are analyzed as their own scopes)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def iter_functions(tree: ast.Module):
    """Yield (func, enclosing_class_or_None) for every def at any depth."""
    def rec(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from rec(child, cls)
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, child)
            else:
                yield from rec(child, cls)

    yield from rec(tree, None)


class Taint:
    """Function-local forward taint: seeds are expressions `is_source`
    accepts; assignment targets of tainted right-hand sides become tainted,
    as do calls through tainted callees, subscripts, and attributes.
    Iterates to a fixpoint so textual order doesn't matter."""

    def __init__(self, func: ast.AST,
                 is_source: Callable[[ast.Call, "Taint"], bool]):
        self.func = func
        self.is_source = is_source
        self.names: Set[str] = set()
        self._solve()

    def expr_tainted(self, expr: ast.AST) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and node.id in self.names:
                return True
            if isinstance(node, ast.Call) and self.call_tainted(node):
                return True
        return False

    def call_tainted(self, call: ast.Call) -> bool:
        if self.is_source(call, self):
            return True
        # call through a tainted value: run(...), program(...)(...)
        f = call.func
        if isinstance(f, ast.Name) and f.id in self.names:
            return True
        if isinstance(f, ast.Call) and self.call_tainted(f):
            return True
        return False

    def _targets(self, t: ast.AST) -> List[str]:
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, (ast.Tuple, ast.List)):
            out = []
            for e in t.elts:
                out.extend(self._targets(e))
            return out
        if isinstance(t, ast.Starred):
            return self._targets(t.value)
        return []

    def _solve(self) -> None:
        # (value, targets): assignments, and the loop variables of `for`
        # statements and comprehensions over a tainted iterable
        binds = []
        for n in walk_no_nested_defs(self.func):
            if isinstance(n, ast.Assign):
                binds.append((n.value, n.targets))
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
                binds.append((n.value, [n.target]))
            elif isinstance(n, (ast.For, ast.AsyncFor, ast.comprehension)):
                binds.append((n.iter, [n.target]))
        for _ in range(6):
            changed = False
            for value, targets in binds:
                if value is None:
                    continue
                if not self.expr_tainted(value):
                    continue
                for t in targets:
                    for name in self._targets(t):
                        if name not in self.names:
                            self.names.add(name)
                            changed = True
            if not changed:
                return
