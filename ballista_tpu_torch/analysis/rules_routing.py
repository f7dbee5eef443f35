"""routing-discipline: every decline is a routing decision, and routing
decisions must be observable.

The adaptive-execution bench block (`routing`) is only truthful if every
site that sends work off the device path records that it did. Any call to
one of the canonical decline helpers — ``decline`` / ``host_fallback`` /
``step_aside`` (ops/kernels.py) — in a device-path module must therefore
be paired with a routing observation in the same function (or a lexically
enclosing one):

- ``record_routing`` / ``record_routing_event`` (ops/runtime.py), or
- ``record_join_path`` (the join counters feed the same bench truth), or
- ``costmodel.observe(...)`` — qualified, so an unrelated object's
  ``.observe()`` method cannot silence the rule (the decline's cost
  became evidence).

A site that is genuinely not a routing decision — a compile-time shape
check whose consumer records the decision, a test-only shim — carries a
``# cold-path: <why>`` annotation on the call line or the line above it,
which is this rule's equivalent of guarded-by's documented opt-out: the
exemption is visible and reviewable at the site.

The helper DEFINITIONS themselves (functions named decline /
host_fallback / step_aside) are exempt — they are the channel, not a
site."""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from ballista_tpu_torch.analysis.common import (
    final_name,
    is_device_path,
    iter_functions,
    walk_no_nested_defs,
)
from ballista_tpu_torch.analysis.core import Finding, SourceFile, register

_DECLINE_HELPERS = {"decline", "host_fallback", "step_aside"}
_RECORDERS = {
    "record_routing",
    "record_routing_event",
    "record_join_path",
}
_COLD_PATH_RE = re.compile(r"#\s*cold-path:\s*\S")


def _parent_map(tree: ast.Module) -> Dict[ast.AST, Optional[ast.AST]]:
    """func def -> lexically enclosing func def (None at module level)."""
    parents: Dict[ast.AST, Optional[ast.AST]] = {}

    def rec(node, cur):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                parents[child] = cur
                rec(child, child)
            else:
                rec(child, cur)

    rec(tree, None)
    return parents


def _records_routing(func: ast.AST) -> bool:
    # walk_no_nested_defs for symmetry with the decline scan: a recorder
    # inside a nested def (possibly never invoked on the decline path)
    # must not vouch for the enclosing function — enclosing scopes vouch
    # via the parents chain in check(), never inner ones
    for node in walk_no_nested_defs(func):
        if not isinstance(node, ast.Call):
            continue
        if final_name(node.func) in _RECORDERS:
            return True
        # cost-store observation counts ONLY when qualified on the
        # costmodel module — a bare/foreign .observe() must not satisfy
        # the pairing
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "observe"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "costmodel"
        ):
            return True
    return False


@register("routing-discipline")
def check(sf: SourceFile) -> List[Finding]:
    if not is_device_path(sf.path):
        return []
    parents = _parent_map(sf.tree)
    findings: List[Finding] = []
    for func, _cls in iter_functions(sf.tree):
        if func.name in _DECLINE_HELPERS:
            continue  # the canonical channel itself, not a call site
        # walk_no_nested_defs: a nested def's calls are attributed to the
        # nested def, which iter_functions visits as its own scope
        for node in walk_no_nested_defs(func):
            if not (
                isinstance(node, ast.Call)
                and final_name(node.func) in _DECLINE_HELPERS
            ):
                continue
            # cold-path annotation on the call line or the line above
            annotated = any(
                0 < ln <= len(sf.lines)
                and _COLD_PATH_RE.search(sf.lines[ln - 1])
                for ln in (node.lineno, node.lineno - 1)
            )
            if annotated:
                continue
            # a recorder anywhere in this function or a lexically
            # enclosing one satisfies the pairing
            cur: Optional[ast.AST] = func
            recorded = False
            while cur is not None:
                if _records_routing(cur):
                    recorded = True
                    break
                cur = parents.get(cur)
            if not recorded:
                findings.append(Finding(
                    "routing-discipline", sf.path, node.lineno,
                    node.col_offset,
                    f"`{final_name(node.func)}` call without a routing "
                    "observation in scope — pair it with record_routing/"
                    "record_routing_event/record_join_path (or annotate "
                    "`# cold-path: <why>`) so the bench routing block "
                    "stays truthful",
                ))
    return findings
