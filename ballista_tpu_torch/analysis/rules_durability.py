"""durability: replica-coherence classification of scheduler state.

The multi-scheduler direction (ROADMAP round 8) needs every piece of
``SchedulerState`` to be provably durable, derivable, or deliberately
replica-local. Each attribute assigned on a manifest-owned class
(``SchedulerState``, the KV-adjacent caches in scheduler/server.py) must
carry a classification annotation::

    # durability: durable(<kv-prefix>) | derived(<rebuild-fn>) | ephemeral(<reason>)

analysis/durability.toml is the authoritative table (owners, the
attr classification rows, attempt-guard policy, ephemeral budgets).

**Per-file checks** (cached like every rule):

- *coverage & agreement*: every ``self.X = ...`` attribute of a
  participating class has at least one annotated assignment site, the
  annotation's argument parses (durable needs a prefix token, derived an
  identifier, ephemeral a reason), and owner-class annotations agree
  with the manifest's [attrs] rows.
- *durable write-through*: every mutation site of a durable attribute
  (attribute rebind outside __init__, item write/del, aug-assign, or a
  mutating method call) must have a KV operation against the declared
  prefix reachable in the same function scope — directly or through
  same-file callees (the ``_ledger_put``/``_spec_del`` helper idiom).
  The lock-order rule's atomicity sweep is reused over the durable key set, so
  check-then-act across a kv-lock release on durable state is flagged.
- *attempt-guard discipline*: a function folding a ``TaskStatus`` into
  durable state (calls ``save_task_status``) must be a guard, call one,
  be reviewed in the manifest, or carry ``# attempt-guard-ok: <reason>``
  (a stale echo must not overwrite a newer attempt, machine-checked).

**Whole-program pass** (``register_global``): every derived(<fn>)
rebuild must be reachable from the owner's recover() in the static call
graph (the lockgraph cross-module resolver is reused — a read-through
cache that recovery forgets is a lint error, not a restart surprise);
per-module ephemeral counts stay within [budgets]; and [attrs] rows for
analyzed owner modules must still exist in source (stale-row check).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

try:  # py3.11+
    import tomllib as _toml
except ImportError:  # pragma: no cover - py3.10 fallback
    import tomli as _toml  # type: ignore

from ballista_tpu_torch.analysis.common import dotted, final_name, in_package, \
    iter_functions, walk_no_nested_defs
from ballista_tpu_torch.analysis.core import Finding, SourceFile, durability_manifest_path, \
    register, register_facts, register_global
from ballista_tpu_torch.analysis.lockgraph import module_of
from ballista_tpu_torch.analysis.rules_lockorder import _atomicity_findings, _resolve_calls

RULE = "durability"

# mutating container methods: calling one on a durable attribute is a
# mutation site that needs a paired KV operation
_MUTATORS = {
    "add", "append", "clear", "discard", "extend", "insert", "pop",
    "popitem", "remove", "setdefault", "update",
}
# KV operations that synchronize in-memory durable state with the store:
# the writes (write-through) and the prefix reads (rebuild-from-KV, the
# recover() direction)
_KV_OPS = {"put", "put_all", "delete", "delete_prefix", "get", "get_prefix"}
# the function that folds an executor-reported TaskStatus into KV state
_FOLD_FN = "save_task_status"

_VALUE_RE = re.compile(r"^(durable|derived|ephemeral)(?:\(\s*(.*?)\s*\))?$")
_IDENT_RE = re.compile(r"^[A-Za-z_]\w*$")
_PREFIX_RE = re.compile(r"^[A-Za-z_][\w-]*$")


def _manifest() -> dict:
    try:
        with open(durability_manifest_path(), "rb") as f:
            return _toml.load(f)
    except (OSError, ValueError):
        return {}


def _owner_for(man: dict, module: str, cls: str) -> Optional[dict]:
    for o in man.get("owners", ()):
        if o.get("module") == module and o.get("class") == cls:
            return o
    return None


def _owner_modules(man: dict) -> Set[str]:
    return {o.get("module", "") for o in man.get("owners", ())}


# -- class / attribute scan ---------------------------------------------------

def _self_attr_of(expr: ast.AST) -> Optional[str]:
    """`self.X`, `self.X[k]`, `self.X[k][j]` -> X; else None."""
    t = expr
    while isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return t.attr
    return None


def _scan_classes(sf: SourceFile) -> Dict[str, dict]:
    """class name -> {"assigned": {attr: first bind line},
    "annotated": {attr: (class, arg, line)}, "conflicts": [...]} from
    every `self.X = ...` bind in the class's methods."""
    out: Dict[str, dict] = {}
    for func, cls in iter_functions(sf.tree):
        if cls is None:
            continue
        info = out.setdefault(
            cls.name, {"assigned": {}, "annotated": {}, "conflicts": []}
        )
        for node in walk_no_nested_defs(func):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue  # plain binds only; item writes are mutations
                attr = t.attr
                first = info["assigned"].get(attr)
                if first is None or node.lineno < first:
                    info["assigned"][attr] = node.lineno
                ann = sf.durability.get(node.lineno)
                if ann is None:
                    continue
                prev = info["annotated"].get(attr)
                if prev is None:
                    info["annotated"][attr] = (ann[0], ann[1], node.lineno)
                elif (prev[0], prev[1]) != ann:
                    info["conflicts"].append((attr, node.lineno, ann, prev))
    return out


# -- durable write-through ---------------------------------------------------

def _prefix_in_expr(expr: ast.AST, helpers: Dict[str, str],
                    locals_p: Dict[str, str]) -> Optional[str]:
    """KV prefix an expression references: a `self._key("<prefix>", ...)`
    call, a call to a key-building helper, or a local bound from one."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            name = final_name(node.func)
            if name == "_key" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                return node.args[0].value
            if name in helpers:
                return helpers[name]
        elif isinstance(node, ast.Name) and node.id in locals_p:
            return locals_p[node.id]
    return None


def _helper_prefixes(sf: SourceFile) -> Dict[str, str]:
    """Key-building helpers: functions returning `self._key("<p>", ...)`
    (`_ledger_key` -> assignments, `_spec_key` -> speculation)."""
    out: Dict[str, str] = {}
    for func, _cls in iter_functions(sf.tree):
        for node in walk_no_nested_defs(func):
            if isinstance(node, ast.Return) and node.value is not None:
                p = _prefix_in_expr(node.value, {}, {})
                if p is not None:
                    out[func.name] = p
    return out


def _kv_prefixes(func: ast.AST, helpers: Dict[str, str]) -> Set[str]:
    """Prefixes this function touches with a KV op (kv.put/get/...) —
    after resolving locals bound from key-building expressions."""
    locals_p: Dict[str, str] = {}
    for node in walk_no_nested_defs(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            p = _prefix_in_expr(node.value, helpers, {})
            if p is not None:
                locals_p[node.targets[0].id] = p
    out: Set[str] = set()
    for node in walk_no_nested_defs(func):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _KV_OPS:
            continue
        base = dotted(node.func.value)
        if not base or base.split(".")[-1] != "kv":
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            p = _prefix_in_expr(arg, helpers, locals_p)
            if p is not None:
                out.add(p)
    return out


def _closure_prefixes(sf: SourceFile) -> Dict[int, Set[str]]:
    """id(func) -> KV prefixes reachable from it through same-file calls
    (bare-name / self-method resolution, the lockgraph convention)."""
    helpers = _helper_prefixes(sf)
    funcs = [f for f, _c in iter_functions(sf.tree)]
    by_name: Dict[str, List[ast.AST]] = {}
    for f in funcs:
        by_name.setdefault(f.name, []).append(f)
    reach = {id(f): _kv_prefixes(f, helpers) for f in funcs}
    calls: Dict[int, Set[str]] = {}
    for f in funcs:
        names: Set[str] = set()
        for node in walk_no_nested_defs(f):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                names.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                base = dotted(node.func.value)
                if base in ("self", "cls"):
                    names.add(node.func.attr)
        calls[id(f)] = names
    for _ in range(len(funcs) + 2):
        changed = False
        for f in funcs:
            mine = reach[id(f)]
            before = len(mine)
            for name in calls[id(f)]:
                for g in by_name.get(name, ()):
                    mine |= reach[id(g)]
            if len(mine) != before:
                changed = True
        if not changed:
            break
    return reach


def _writethrough_findings(sf: SourceFile,
                           durable: Dict[str, Dict[str, str]]) -> List[Finding]:
    """Every mutation site of a durable attribute must have a KV op
    against its declared prefix reachable in the same function scope.
    `durable`: class name -> {attr: prefix}."""
    findings: List[Finding] = []
    reach = _closure_prefixes(sf)

    def mutated_attrs(node: ast.AST) -> List[Tuple[str, int]]:
        hits: List[Tuple[str, int]] = []
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr_of(t)
                if attr is not None:
                    hits.append((attr, node.lineno))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr_of(t)
                if attr is not None:
                    hits.append((attr, node.lineno))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = _self_attr_of(node.func.value)
            if attr is not None:
                hits.append((attr, node.lineno))
        return hits

    for func, cls in iter_functions(sf.tree):
        if cls is None or cls.name not in durable:
            continue
        if func.name == "__init__":
            continue  # initialization of empty containers, not mutation
        attrs = durable[cls.name]
        for node in walk_no_nested_defs(func):
            for attr, line in mutated_attrs(node):
                prefix = attrs.get(attr)
                if prefix is None or prefix in reach[id(func)]:
                    continue
                findings.append(Finding(
                    RULE, sf.path, line, 0,
                    f"mutation of durable attribute 'self.{attr}' "
                    f"(durable({prefix})) in '{func.name}' has no KV "
                    f"operation against prefix '{prefix}' reachable in "
                    "the same function scope — pair it with kv.put/"
                    f"put_all/delete via self._key({prefix!r}, ...) "
                    "(directly or through a same-file helper), or "
                    "reclassify the attribute",
                ))
    return findings


# -- attempt-guard discipline ------------------------------------------------

def _attempt_guard_findings(sf: SourceFile, module: str,
                            man: dict) -> List[Finding]:
    ag = man.get("attempt_guard", {})
    guards = set(ag.get("guards", ()))
    reviewed = dict(ag.get("reviewed", {}))
    if not guards:
        return []
    if module not in _owner_modules(man) and not sf.durability:
        return []  # only files participating in the durability contract
    findings: List[Finding] = []
    for func, _cls in iter_functions(sf.tree):
        called = {
            final_name(n.func)
            for n in walk_no_nested_defs(func) if isinstance(n, ast.Call)
        }
        if _FOLD_FN not in called or func.name == _FOLD_FN:
            continue
        if func.name in guards or called & guards:
            continue
        if func.name in reviewed or sf.attempt_ok_of(func):
            continue
        findings.append(Finding(
            RULE, sf.path, func.lineno, 0,
            f"'{func.name}' folds a TaskStatus into durable state "
            f"(calls {_FOLD_FN}) without consulting the attempt/ledger "
            f"guard ({sorted(guards)}) — call a guard, list the function "
            "under [attempt_guard.reviewed] in durability.toml with a "
            "reason, or annotate the def `# attempt-guard-ok: <reason>`",
        ))
    return findings


# -- per-file check ----------------------------------------------------------

@register(RULE)
def check(sf: SourceFile) -> List[Finding]:
    module = module_of(sf.path)
    man = _manifest()
    classes = _scan_classes(sf)
    findings: List[Finding] = []
    consumed: Set[int] = set()
    durable: Dict[str, Dict[str, str]] = {}
    for cls_name in sorted(classes):
        info = classes[cls_name]
        owner = _owner_for(man, module, cls_name)
        if owner is None and not info["annotated"]:
            continue  # class does not participate in the contract
        for attr, line in sorted(info["assigned"].items(),
                                 key=lambda kv: (kv[1], kv[0])):
            if attr not in info["annotated"]:
                findings.append(Finding(
                    RULE, sf.path, line, 0,
                    f"attribute 'self.{attr}' of {cls_name} has no "
                    "`# durability:` annotation on any assignment site — "
                    "classify it durable(<kv-prefix>), "
                    "derived(<rebuild-fn>), or ephemeral(<reason>)",
                ))
        for attr, lineno, ann, prev in info["conflicts"]:
            consumed.add(lineno)  # conflicting, not dangling
            findings.append(Finding(
                RULE, sf.path, lineno, 0,
                f"conflicting durability classification for "
                f"'{cls_name}.{attr}': {ann[0]}({ann[1]}) here vs "
                f"{prev[0]}({prev[1]}) at line {prev[2]}",
            ))
        for attr in sorted(info["annotated"]):
            dclass, arg, line = info["annotated"][attr]
            consumed.add(line)
            if dclass == "durable" and not _PREFIX_RE.match(arg):
                findings.append(Finding(
                    RULE, sf.path, line, 0,
                    f"durable({arg!r}) on '{cls_name}.{attr}' needs a KV "
                    "prefix token (the first self._key(...) segment), "
                    "e.g. durable(assignments)",
                ))
            elif dclass == "derived" and not _IDENT_RE.match(arg):
                findings.append(Finding(
                    RULE, sf.path, line, 0,
                    f"derived({arg!r}) on '{cls_name}.{attr}' needs the "
                    "rebuild function's name, e.g. "
                    "derived(_ensure_task_index)",
                ))
            elif dclass == "ephemeral" and not arg:
                findings.append(Finding(
                    RULE, sf.path, line, 0,
                    f"ephemeral() on '{cls_name}.{attr}' needs a reason — "
                    "why is it correct for a scheduler replica to lose "
                    "this on restart?",
                ))
            if dclass == "durable" and _PREFIX_RE.match(arg):
                durable.setdefault(cls_name, {})[attr] = arg
            if owner is not None:
                key = f"{module}.{cls_name}.{attr}"
                row = man.get("attrs", {}).get(key)
                m = _VALUE_RE.match(row.strip()) if isinstance(row, str) \
                    else None
                if row is None:
                    findings.append(Finding(
                        RULE, sf.path, line, 0,
                        f"'{key}' is annotated {dclass}({arg}) but has no "
                        "[attrs] row in durability.toml — the manifest is "
                        "the reviewed classification table; add the row",
                    ))
                elif m is None or m.group(1) != dclass or (
                    dclass in ("durable", "derived")
                    and (m.group(2) or "") != arg
                ):
                    findings.append(Finding(
                        RULE, sf.path, line, 0,
                        f"'{key}' is annotated {dclass}({arg}) but "
                        f"durability.toml [attrs] says {row!r} — source "
                        "and manifest must agree",
                    ))
    for line in sorted(set(sf.durability) - consumed):
        dclass, arg = sf.durability[line]
        findings.append(Finding(
            RULE, sf.path, line, 0,
            f"dangling `# durability: {dclass}({arg})` annotation: no "
            "`self.<attr> = ...` bind on this line — attach it to an "
            "assignment site (inline, or standalone directly above)",
        ))
    if durable:
        durable_keys = {
            ("attr", attr) for attrs in durable.values() for attr in attrs
        }
        findings.extend(_atomicity_findings(
            sf, module, set(), keys_override=durable_keys, rule=RULE,
        ))
        findings.extend(_writethrough_findings(sf, durable))
    findings.extend(_attempt_guard_findings(sf, module, man))
    return findings


# -- facts for the whole-program pass ----------------------------------------

@register_facts(RULE)
def extract_facts(sf: SourceFile) -> dict:
    module = module_of(sf.path)
    classes = _scan_classes(sf)
    out_classes: Dict[str, dict] = {}
    ephemeral = 0
    derived: List[list] = []
    for cls_name in sorted(classes):
        annotated = classes[cls_name]["annotated"]
        if not annotated:
            continue
        table = {}
        for attr in sorted(annotated):
            dclass, arg, line = annotated[attr]
            table[attr] = [dclass, arg, line]
            if dclass == "ephemeral":
                ephemeral += 1
            elif dclass == "derived":
                derived.append([cls_name, attr, arg, line])
        out_classes[cls_name] = table
    return {
        "module": module,
        "path": sf.path,
        "project": in_package(sf.path),
        "classes": out_classes,
        "ephemeral": ephemeral,
        "derived": derived,
    }


# -- whole-program pass ------------------------------------------------------

@register_global(RULE)
def global_check(facts_by_path: Dict[str, dict]) -> List[Finding]:
    man = _manifest()
    dur = {
        p: (f.get(RULE, {}) if isinstance(f, dict) else {})
        for p, f in facts_by_path.items()
    }
    findings: List[Finding] = []

    budgets = man.get("budgets", {})
    default_budget = int(budgets.get("default", 0))
    modules_present: Set[str] = set()
    observed: Set[str] = set()
    derived_decls: List[Tuple[str, str, str, str, str, int]] = []
    for f in dur.values():
        if not f or not f.get("project"):
            continue
        modules_present.add(f["module"])
        count = f.get("ephemeral", 0)
        if count:
            budget = int(budgets.get(f["module"], default_budget))
            if count > budget:
                findings.append(Finding(
                    RULE, f["path"], 1, 0,
                    f"module '{f['module']}' declares {count} ephemeral "
                    f"attributes, over its budget of {budget} — ephemeral "
                    "growth is a reviewed decision: raise the [budgets] "
                    "entry in durability.toml or make the state "
                    "durable/derived",
                ))
        for cls, table in f.get("classes", {}).items():
            for attr in table:
                observed.add(f"{f['module']}.{cls}.{attr}")
        for cls, attr, fn, line in f.get("derived", ()):
            derived_decls.append((f["module"], f["path"], cls, attr, fn, line))

    if derived_decls:
        lock = {
            p: (f.get("lock-order", {}) if isinstance(f, dict) else {})
            for p, f in facts_by_path.items()
        }
        _kinds, recs, resolved, _ma, _extras = _resolve_calls(lock)
        by_module: Dict[str, List[dict]] = {}
        for mod, _path, frec in recs:
            by_module.setdefault(mod, []).append(frec)
        cache: Dict[Tuple[str, str], Optional[Set[str]]] = {}

        def reachable_names(module: str, entry: str) -> Optional[Set[str]]:
            """Function names reachable from `module.entry` (any module),
            or None when no such entry function exists."""
            key = (module, entry)
            if key in cache:
                return cache[key]
            seeds = [f for f in by_module.get(module, ())
                     if f["name"] == entry]
            if not seeds:
                cache[key] = None
                return None
            seen: Set[int] = {id(f) for f in seeds}
            names: Set[str] = {f["name"] for f in seeds}
            work = list(seeds)
            while work:
                frec = work.pop()
                for cands in resolved.get(id(frec), ()):
                    for g in cands:
                        if id(g) in seen:
                            continue
                        seen.add(id(g))
                        names.add(g["name"])
                        work.append(g)
            cache[key] = names
            return names

        for module, path, cls, attr, fn, line in sorted(derived_decls):
            owner = _owner_for(man, module, cls)
            entry = owner.get("recover", "") if owner is not None \
                else "recover"
            if not entry:
                findings.append(Finding(
                    RULE, path, line, 0,
                    f"'{cls}.{attr}' is derived({fn}) but its owner entry "
                    "in durability.toml declares no `recover` function — "
                    "a derived classification needs a recovery entry "
                    "point to validate against",
                ))
                continue
            names = reachable_names(module, entry)
            if names is None:
                findings.append(Finding(
                    RULE, path, line, 0,
                    f"'{cls}.{attr}' is derived({fn}) but no '{entry}' "
                    f"function exists in module '{module}' to rebuild it "
                    "from",
                ))
            elif fn not in names:
                findings.append(Finding(
                    RULE, path, line, 0,
                    f"derived rebuild '{fn}' for '{cls}.{attr}' is NOT "
                    f"reachable from {module}.{entry}() in the static "
                    "call graph — a restarted replica would never rebuild "
                    f"it. Call {fn}() from recovery (directly or "
                    "transitively), or reclassify the attribute",
                ))

    for key in sorted(man.get("attrs", {})):
        mod = key.rsplit(".", 2)[0]
        if mod in modules_present and key not in observed:
            path = next(
                (f["path"] for f in dur.values()
                 if f and f.get("module") == mod), mod,
            )
            findings.append(Finding(
                RULE, path, 1, 0,
                f"stale durability.toml [attrs] row '{key}': no such "
                "annotated attribute in source — remove the row or "
                "restore the annotation",
            ))
    return findings
