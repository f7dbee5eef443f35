"""failure-discipline: the failure-recovery paths stay analyzable.

Three invariants, scoped to the whole ballista_tpu_torch package:

1. A `fetch_failed` status must CARRY THE LOST LOCATION. Any function that
   assigns `<status>.fetch_failed.error` must also assign
   `.fetch_failed.map_executor_id` and `.fetch_failed.path` — without the
   lineage the scheduler cannot recompute the lost map partition and the
   report degrades into an anonymous failure.

2. Chaos injection sites must be REGISTERED. Calls to the injector
   (`maybe_fail` / `should_inject`) must name a literal site present in
   `ballista_tpu_torch/utils/chaos.py::SITES`, and `ChaosInjected` may only be
   raised by the injector itself — ad-hoc raises (or `random`-driven ones)
   are invisible to the registry and break chaos-run determinism.

3. Speculative duplicates must FLOW THROUGH THE LEDGER. A scope
   that MINTS a speculative attempt — assigns a literal `True` to a
   `.speculative` field — must also record it durably in the same scope
   (`_spec_put`, or `_ledger_put` for a promotion into the assignment
   ledger). An ad-hoc second-attempt path is invisible to scheduler-restart
   recovery and to the first-completion-wins bookkeeping; echo sites
   (`td.speculative = flag`) copy a non-literal and are exempt.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from ballista_tpu_torch.analysis.common import walk_no_nested_defs
from ballista_tpu_torch.analysis.core import Finding, SourceFile, register

_INJECTOR_METHODS = {"maybe_fail", "should_inject"}
_CHAOS_MODULE_SUFFIX = "ballista_tpu_torch/utils/chaos.py"

# durable-record calls that legitimize a minted speculative attempt: the
# speculation ledger itself, or the assignment ledger for a promotion
_SPEC_LEDGER_METHODS = {"_spec_put", "_ledger_put"}

# fallback if chaos.py cannot be located from the scanned file (fixtures
# analyzed outside the repo tree); keep in sync with utils/chaos.py::SITES
_DEFAULT_SITES = frozenset(
    {
        "flight.fetch", "rpc.call", "task.execute", "kv.put",
        "executor.death", "scheduler.plan_write", "scheduler.crash",
        "cache.put", "scheduler.admit", "scheduler.push", "aot.load",
        "scheduler.batch", "task.slow", "shuffle.store", "fleet.scale",
        "exchange.evict", "cache.advance", "scheduler.lease", "kv.lease",
    }
)

_sites_cache: Dict[str, frozenset] = {}


def _registered_sites(real_path: str) -> frozenset:
    """SITES parsed from the chaos module nearest the scanned file: walk up
    from its directory until ballista_tpu_torch/utils/chaos.py appears, so the
    rule checks against the registry of the tree actually being linted."""
    d = os.path.dirname(os.path.abspath(real_path))
    while True:
        candidate = os.path.join(d, _CHAOS_MODULE_SUFFIX.replace("/", os.sep))
        if os.path.isfile(candidate):
            if candidate not in _sites_cache:
                _sites_cache[candidate] = _parse_sites(candidate)
            return _sites_cache[candidate]
        parent = os.path.dirname(d)
        if parent == d:
            return _DEFAULT_SITES
        d = parent


def _parse_sites(chaos_path: str) -> frozenset:
    try:
        with open(chaos_path) as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return _DEFAULT_SITES
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "SITES" for t in node.targets
        ):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List, ast.Set)):
            vals = [
                e.value
                for e in node.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            ]
            if vals:
                return frozenset(vals)
    return _DEFAULT_SITES


def _fetch_failed_field(node: ast.AST) -> Optional[str]:
    """'error' for targets shaped <base>.fetch_failed.<field>."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Attribute)
        and node.value.attr == "fetch_failed"
    ):
        return node.attr
    return None


def _scopes(tree: ast.Module):
    """Module + every def: fetch_failed field assignments are aggregated
    per enclosing scope (the status is built in one function)."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


@register("failure-discipline")
def check(sf: SourceFile) -> List[Finding]:
    path = sf.path.replace("\\", "/")
    in_chaos_module = path.endswith("utils/chaos.py")
    findings: List[Finding] = []

    # -- 1. fetch_failed must carry the lost location -----------------------
    for scope in _scopes(sf.tree):
        fields: Set[str] = set()
        error_assign = None
        # walk without descending into nested defs: each is its own scope
        for node in walk_no_nested_defs(scope):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    f = _fetch_failed_field(t)
                    if f is not None:
                        fields.add(f)
                        if f == "error" and error_assign is None:
                            error_assign = node
        if error_assign is not None and not {"map_executor_id", "path"} <= fields:
            missing = sorted({"map_executor_id", "path"} - fields)
            findings.append(Finding(
                "failure-discipline", sf.path,
                error_assign.lineno, error_assign.col_offset,
                "fetch_failed status without the lost location (missing "
                f"{', '.join(missing)}) — the scheduler cannot recompute "
                "the lost map partition from an anonymous fetch failure",
            ))

    # -- 3. speculative attempts must flow through the ledger ----------------
    # a scope assigning a LITERAL True to `.speculative` is minting a new
    # duplicate attempt (echo sites copy a flag, a non-literal); without a
    # same-scope _spec_put/_ledger_put the attempt is invisible to restart
    # recovery and to first-completion-wins bookkeeping
    for scope in _scopes(sf.tree):
        mint = None
        ledgered = False
        for node in walk_no_nested_defs(scope):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and t.attr == "speculative"
                        and isinstance(node.value, ast.Constant)
                        and node.value.value is True
                        and mint is None
                    ):
                        mint = node
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SPEC_LEDGER_METHODS
            ):
                ledgered = True
        if mint is not None and not ledgered:
            findings.append(Finding(
                "failure-discipline", sf.path,
                mint.lineno, mint.col_offset,
                "ad-hoc speculative attempt: `.speculative = True` without "
                "a durable ledger record in the same scope — duplicate "
                "dispatch must flow through _spec_put (or _ledger_put for "
                "a promotion) so restart recovery and first-completion-"
                "wins bookkeeping can see it",
            ))

    # -- 2. chaos sites must be registered ----------------------------------
    if not in_chaos_module:
        sites = _registered_sites(sf.real_path)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _INJECTOR_METHODS:
                arg = node.args[0] if node.args else None
                if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                    findings.append(Finding(
                        "failure-discipline", sf.path,
                        node.lineno, node.col_offset,
                        f"chaos {node.func.attr}() site must be a string "
                        "literal from chaos.SITES (a computed site evades "
                        "the registry)",
                    ))
                elif arg.value not in sites:
                    findings.append(Finding(
                        "failure-discipline", sf.path,
                        node.lineno, node.col_offset,
                        f"unregistered chaos site {arg.value!r} — register "
                        "it in ballista_tpu_torch/utils/chaos.py::SITES first",
                    ))
            elif isinstance(node, ast.Raise) and node.exc is not None:
                target = node.exc.func if isinstance(node.exc, ast.Call) else node.exc
                name = target.attr if isinstance(target, ast.Attribute) else (
                    target.id if isinstance(target, ast.Name) else None
                )
                if name == "ChaosInjected":
                    findings.append(Finding(
                        "failure-discipline", sf.path,
                        node.lineno, node.col_offset,
                        "ad-hoc `raise ChaosInjected` outside the injector "
                        "— faults must come from a registered site via "
                        "ChaosInjector.maybe_fail",
                    ))
    return findings
