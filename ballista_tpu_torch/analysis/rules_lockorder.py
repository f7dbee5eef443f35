"""lock-order: interprocedural lock-order graph + deadlock detection.

Two layers share one per-file extraction:

**Per-file checks** (cached like every rule):

- *creation discipline*: every lock bound to a module global or instance
  attribute in ballista_tpu_torch/ must be created through
  ``utils.locks.make_lock/make_rlock`` with its canonical
  ``<module>.<attr>`` name (so the dynamic witness can wrap it and speak
  the analyzer's vocabulary), and must be referenced by at least one
  ``guarded-by:``/``holds-lock:`` annotation in the file (the
  annotation-coverage meta-check).
- *atomicity*: a read of guarded state into a local under ``with lock:``
  followed by a dependent write under a RE-acquired ``with lock:`` is
  check-then-act across a release — flagged unless the write re-reads the
  state it writes (the double-checked-insert idiom) or carries an
  ``# atomicity-ok: <reason>`` annotation.

**Whole-program pass** (``register_global``, run by core.run_paths over
every file's facts): builds the acquired-while-held edge set — direct
``with b:`` inside ``with a:`` nesting, same-module call chains (the
tracer-hygiene style walk), ``# holds-lock:`` entry contexts, cross-module
calls resolved by dotted-base module match or unique bare name, and
``# may-acquire:`` annotations on dynamic-dispatch seams — then reports
every cycle (potential deadlock, both acquisition paths printed) and
enforces the package's analysis/lockorder.toml: every edge declared with a reason,
every edge forward in the canonical order.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ballista_tpu_torch.analysis import lockgraph
from ballista_tpu_torch.analysis.common import PACKAGE_PREFIX, dotted, final_name, \
    in_package, iter_functions
from ballista_tpu_torch.analysis.core import Finding, SourceFile, register, register_facts, \
    register_global
from ballista_tpu_torch.analysis.lockgraph import (
    ALIASES,
    KV_LOCK,
    LOCKISH_RE,
    EdgeSite,
    LockGraph,
    Manifest,
    canonical,
    module_of,
)

RULE = "lock-order"

_LOCK_CTORS = {"Lock", "RLock"}
_MAKE_CTORS = {"make_lock": "lock", "make_rlock": "rlock"}
# threading.Semaphore/BoundedSemaphore/Event/Condition are not mutual-
# exclusion locks; they stay raw and outside the graph


def _is_project_path(display_path: str) -> bool:
    return in_package(display_path)


def _lock_name_of_expr(expr: ast.AST, module: str,
                       known: Set[str]) -> Optional[str]:
    """Canonical lock name a with-item (or annotation target) denotes, or
    None when it does not look like a lock acquisition."""
    if isinstance(expr, ast.Call):
        # `<anything>.lock()` / `<client>.lock(name)`: the global KV lock
        if final_name(expr.func) == "lock":
            return KV_LOCK
        return None
    name = final_name(expr)
    if name is None:
        return None
    if name in known or LOCKISH_RE.search(name):
        return canonical(f"{module}.{name}")
    return None


def _lock_name_of_text(text: str, module: str) -> Optional[str]:
    """Canonical lock name from an annotation's source text
    (`self._mu`, `_res_lock`, `self.kv.lock()`, or an already-canonical
    dotted name)."""
    t = text.strip().rstrip(":")
    if t.endswith(".lock()") or t == "lock()":
        return KV_LOCK
    t = t.split("(")[0]
    leaf = t.split(".")[-1].strip()
    if not leaf:
        return None
    if "." in t and not t.startswith("self.") and not t.startswith("cls."):
        # already-canonical dotted form (may-acquire annotations)
        return canonical(t)
    return canonical(f"{module}.{leaf}")


class _Creation:
    __slots__ = ("attr", "kind", "line", "literal", "raw")

    def __init__(self, attr: str, kind: str, line: int,
                 literal: Optional[str], raw: bool) -> None:
        self.attr = attr
        self.kind = kind  # "lock" | "rlock"
        self.line = line
        self.literal = literal  # make_lock("...") name argument
        self.raw = raw  # created via threading.Lock/RLock directly


def _creations(sf: SourceFile) -> List[_Creation]:
    out: List[_Creation] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        fname = final_name(value.func)
        kind = None
        literal = None
        raw = False
        if fname in _LOCK_CTORS:
            base = dotted(value.func) or ""
            if not base.split(".")[0].lstrip("_").startswith("threading"):
                continue
            kind = "lock" if fname == "Lock" else "rlock"
            raw = True
        elif fname in _MAKE_CTORS:
            kind = _MAKE_CTORS[fname]
            if value.args and isinstance(value.args[0], ast.Constant) \
                    and isinstance(value.args[0].value, str):
                literal = value.args[0].value
        else:
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            attr = None
            if isinstance(t, ast.Name):
                attr = t.id
            elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id in ("self", "obj"):
                # `obj._mu = ...` covers the SqliteBackend.temporary()
                # __new__-style constructor
                attr = t.attr
            if attr is not None:
                out.append(_Creation(attr, kind, node.lineno, literal, raw))
    return out


def _method_aliases(sf: SourceFile) -> List[Tuple[str, str, str, int]]:
    """(alias, method, base, line) for each module-level bind of another
    object's method (`ingest_stats = counters.ingest.stats`, tuple
    unpacking included): a call to the alias is a call to `method` on
    `base`, resolved as any attribute call is."""
    out: List[Tuple[str, str, str, int]] = []
    for node in sf.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple):
                pairs = list(zip(t.elts, node.value.elts))
            else:
                pairs = [(t, node.value)]
            for name, value in pairs:
                base = dotted(value.value) if isinstance(value, ast.Attribute) else None
                if isinstance(name, ast.Name) and base:
                    out.append((name.id, value.attr, base, node.lineno))
    return out


class _FuncWalk(ast.NodeVisitor):
    """One function's acquisition/nesting/call record, tracking the held
    stack through `with` statements (entry context from holds-lock)."""

    def __init__(self, sf: SourceFile, module: str, known: Set[str],
                 entry: Optional[str]) -> None:
        self.sf = sf
        self.module = module
        self.known = known
        self.held: List[str] = [entry] if entry else []
        self.acquires: List[Tuple[str, int]] = []
        self.nested: List[Tuple[str, str, int]] = []
        self.calls: List[Tuple[str, str, int, Tuple[str, ...]]] = []

    def visit_With(self, node: ast.With) -> None:
        locks = []
        for item in node.items:
            name = _lock_name_of_expr(item.context_expr, self.module, self.known)
            if name is not None:
                self.acquires.append((name, node.lineno))
                if name in self.held:
                    # re-acquisition of a held lock class: record ONLY the
                    # self pair (an rlock re-entry is dropped at build
                    # time, a plain lock self-deadlocks) — NOT edges from
                    # the other held locks, which a reentrant re-entry can
                    # never deadlock against (it cannot block)
                    self.nested.append((name, name, node.lineno))
                else:
                    for h in self.held:
                        self.nested.append((h, name, node.lineno))
                locks.append(name)
        self.held.extend(locks)
        self.generic_visit(node)
        if locks:
            del self.held[-len(locks):]

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        callee = final_name(node.func)
        if callee and callee != "lock":
            base = ""
            if isinstance(node.func, ast.Attribute):
                # "<attr>" marks an attribute call whose base is not a
                # plain name chain (subscript, call result): it must NOT
                # fall through to bare-name resolution
                base = dotted(node.func.value) or "<attr>"
            self.calls.append((callee, base, node.lineno, tuple(self.held)))
        self.generic_visit(node)

    def _skip_nested_def(self, node) -> None:
        # nested defs are walked as their own functions (with the
        # DEFINING context's held stack as entry — a closure launched on a
        # thread starts lock-free, but one *called* inline inherits; the
        # conservative choice is the empty stack plus its own holds-lock)
        return

    visit_FunctionDef = _skip_nested_def
    visit_AsyncFunctionDef = _skip_nested_def
    visit_Lambda = _skip_nested_def


@register_facts(RULE)
def extract_facts(sf: SourceFile) -> dict:
    """Locks created + per-function acquisition/call records for the
    whole-program pass. JSON-serializable (cached per file)."""
    module = module_of(sf.path)
    creations = _creations(sf)
    known = {c.attr for c in creations}
    locks: Dict[str, dict] = {}
    for c in creations:
        name = canonical(f"{module}.{c.attr}")
        prev = locks.get(name)
        kind = c.kind
        if prev is not None and prev["kind"] == "rlock":
            kind = "rlock"  # merged classes: reentrant wins (conservative
            # for self-edges is "lock", but a merged rlock IS reentrant)
        locks[name] = {"kind": kind, "line": c.line}
    functions = []
    for func, _cls in iter_functions(sf.tree):
        entry_text = sf.holds_lock(func)
        entry = _lock_name_of_text(entry_text, module) if entry_text else None
        extra_text = sf.may_acquire_of(func)
        extra = []
        if extra_text:
            for part in extra_text.split(","):
                part = part.strip()
                if part.startswith("group:"):
                    # expanded against the manifest's [groups] in the
                    # whole-program pass (facts stay manifest-independent)
                    extra.append(part)
                    continue
                n = _lock_name_of_text(part, module)
                if n:
                    extra.append(n)
        walk = _FuncWalk(sf, module, known, entry)
        for stmt in func.body:
            walk.visit(stmt)
        functions.append({
            "name": func.name,
            "line": func.lineno,
            "entry": entry,
            "extra": extra,
            "acquires": [[n, ln] for n, ln in walk.acquires],
            "nested": [[h, n, ln] for h, n, ln in walk.nested],
            "calls": [
                [callee, base, ln, list(held)]
                for callee, base, ln, held in walk.calls
            ],
        })
    # an alias calls its method, so cross-module callers resolve it by name
    for alias, method, base, line in _method_aliases(sf):
        functions.append({"name": alias, "line": line, "entry": None, "extra": [],
                          "acquires": [], "nested": [], "calls": [[method, base, line, []]]})
    return {
        "module": module,
        "path": sf.path,
        "project": _is_project_path(sf.path),
        "locks": locks,
        "functions": functions,
    }


# -- per-file checks ---------------------------------------------------------

def _annotation_lock_names(sf: SourceFile, module: str) -> Set[str]:
    out: Set[str] = set()
    for table in (sf.guarded, sf.holds):
        for text in table.values():
            n = _lock_name_of_text(text, module)
            if n:
                out.add(n)
    return out


def _guarded_keys_for(sf: SourceFile, module: str,
                      lock: str) -> Set[Tuple[str, str]]:
    """('global'|'attr', name) state keys annotated guarded-by `lock`."""
    keys: Set[Tuple[str, str]] = set()
    for stmt, text in sf.guarded_targets():
        if _lock_name_of_text(text, module) != lock:
            continue
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                keys.add(("global", t.id))
            elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                keys.add(("attr", t.attr))
    return keys


def _reads_of(expr: ast.AST, keys: Set[Tuple[str, str]]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and ("global", node.id) in keys:
            return True
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and ("attr", node.attr) in keys:
            return True
    return False


def _written_key(target: ast.AST) -> Optional[Tuple[str, str]]:
    t = target
    while isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Name):
        return ("global", t.id)
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return ("attr", t.attr)
    return None


def _atomicity_findings(sf: SourceFile, module: str,
                        known: Set[str],
                        keys_override: Optional[Set[Tuple[str, str]]] = None,
                        rule: str = RULE) -> List[Finding]:
    """Check-then-act across a release: block A reads guarded state into
    locals, the lock is released, block B (same function, same lock)
    writes guarded state from those locals without re-reading it.

    `keys_override` swaps the guarded-by-derived state keys for an
    explicit set — rules_durability reuses this sweep over the durable
    attribute set, reporting under its own `rule`."""
    findings: List[Finding] = []
    for func, _cls in iter_functions(sf.tree):
        # with-blocks per lock, in source order, top-level walk of this
        # function only (nested defs handled as their own functions)
        blocks: Dict[str, List[ast.With]] = {}
        stack = list(func.body)
        while stack:
            node = stack.pop(0)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    name = _lock_name_of_expr(item.context_expr, module, known)
                    if name is not None:
                        blocks.setdefault(name, []).append(node)
            stack.extend(ast.iter_child_nodes(node))
        for lock, withs in blocks.items():
            if len(withs) < 2:
                continue
            keys = keys_override if keys_override is not None \
                else _guarded_keys_for(sf, module, lock)
            if not keys:
                continue
            withs.sort(key=lambda w: w.lineno)

            def covering(lineno: int) -> Optional[ast.With]:
                for w in withs:
                    if w.lineno <= lineno <= (w.end_lineno or w.lineno):
                        return w
                return None

            # ONE flow-ordered sweep over the function's assignments:
            # reading guarded state inside a with-block taints the target
            # locals (remembering WHICH block); a reassignment from fresh
            # (unguarded, untainted) data KILLS the taint — `x = walk_disk()`
            # between the blocks means the later write is not stale.
            assigns = sorted(
                (n for n in ast.walk(func)
                 if isinstance(n, (ast.Assign, ast.AugAssign))
                 and n.value is not None),
                key=lambda n: (n.lineno, n.col_offset),
            )
            tainted: Dict[str, ast.With] = {}  # local -> source block
            for node in assigns:
                here = covering(node.lineno)
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                value = node.value
                taint_sources = {
                    n.id for n in ast.walk(value)
                    if isinstance(n, ast.Name) and n.id in tainted
                }
                reads_guarded = _reads_of(value, keys)
                # the check itself: a guarded-state write inside a LATER
                # with-block from a local tainted by an EARLIER one
                if here is not None:
                    for t in targets:
                        key = _written_key(t)
                        if key is None or key not in keys:
                            continue
                        stale = {
                            n for n in taint_sources
                            if tainted[n] is not here
                        }
                        if not stale:
                            continue
                        # double-checked idiom: this block re-reads the
                        # state it writes before writing
                        reread = any(
                            _reads_of(n, {key})
                            for n in ast.walk(here)
                            if isinstance(n, (ast.Assign, ast.If))
                            and n.lineno < node.lineno
                        )
                        if reread:
                            continue
                        if node.lineno in sf.atomicity_ok or \
                                here.lineno in sf.atomicity_ok:
                            continue
                        src_w = tainted[next(iter(stale))]
                        shown = key[1] if key[0] == "global" else f"self.{key[1]}"
                        findings.append(Finding(
                            rule, sf.path, node.lineno, node.col_offset,
                            f"check-then-act across a release of '{lock}': "
                            f"'{shown}' is written from state read under an "
                            f"EARLIER `with` (line {src_w.lineno}) — the "
                            "lock was released in between, so the read may "
                            "be stale. Re-read under this acquisition or "
                            "annotate `# atomicity-ok: <reason>`",
                        ))
                # taint propagation / kill, in flow order
                for t in targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if reads_guarded and here is not None:
                        tainted[t.id] = here
                    elif taint_sources:
                        # derived from a tainted local: inherit its block
                        tainted[t.id] = tainted[next(iter(taint_sources))]
                    else:
                        tainted.pop(t.id, None)  # fresh reassignment kills
    return findings


@register(RULE)
def check(sf: SourceFile) -> List[Finding]:
    module = module_of(sf.path)
    creations = _creations(sf)
    known = {c.attr for c in creations}
    findings: List[Finding] = []
    project = _is_project_path(sf.path)
    annotated = _annotation_lock_names(sf, module)
    is_locks_module = sf.path.replace("\\", "/").endswith(
        PACKAGE_PREFIX + "utils/locks.py"
    )
    for c in creations:
        derived = canonical(f"{module}.{c.attr}")
        if project and c.raw and not is_locks_module:
            findings.append(Finding(
                RULE, sf.path, c.line, 0,
                f"raw threading.{'RLock' if c.kind == 'rlock' else 'Lock'}() "
                f"bound to '{c.attr}' — create project locks via "
                f"utils.locks.make_{'r' if c.kind == 'rlock' else ''}lock("
                f"{derived!r}) so the lock witness can wrap them",
            ))
        if c.literal is not None and c.literal != derived:
            findings.append(Finding(
                RULE, sf.path, c.line, 0,
                f"lock name {c.literal!r} does not match its canonical "
                f"identity {derived!r} (module.attr; aliases: {ALIASES}) — "
                "the static graph and the runtime witness must agree",
            ))
        if project and derived not in annotated and not is_locks_module:
            findings.append(Finding(
                RULE, sf.path, c.line, 0,
                f"lock '{c.attr}' has no guarded-by:/holds-lock: "
                "annotation in this file — annotate the state it guards "
                "(annotation-coverage meta-check)",
            ))
    findings.extend(_atomicity_findings(sf, module, known))
    return findings


# -- whole-program pass ------------------------------------------------------

def _resolve_calls(facts_by_path: Dict[str, dict]):
    """(lock kinds, per-function records with resolved callees).

    Resolution: same module by bare name first; else a dotted-base segment
    matching a module's last component (`self.kv.put` -> scheduler.kv,
    `costmodel.predict` -> ops.costmodel); else unique-ish bare name among
    lock-acquiring functions everywhere (bounded union — dynamic dispatch
    the name can't disambiguate is the witness's job, or a
    `# may-acquire:` annotation's)."""
    kinds: Dict[str, str] = {}
    by_module: Dict[str, Dict[str, List[dict]]] = {}
    last_comp: Dict[str, List[str]] = {}
    for facts in facts_by_path.values():
        if not facts:
            continue
        for name, info in facts.get("locks", {}).items():
            prev = kinds.get(name)
            kinds[name] = "rlock" if "rlock" in (prev, info["kind"]) else \
                info["kind"]
        mod = facts["module"]
        table = by_module.setdefault(mod, {})
        for f in facts.get("functions", ()):
            table.setdefault(f["name"], []).append(f)
        last_comp.setdefault(mod.split(".")[-1], []).append(mod)

    # seed may_acquire with direct acquisitions + annotations (group:NAME
    # tokens expand against the manifest's [groups] table)
    groups = Manifest.load().groups
    ma: Dict[int, Set[str]] = {}
    extras: Dict[int, Set[str]] = {}
    recs: List[Tuple[str, str, dict]] = []  # (module, path, frec)
    for path, facts in facts_by_path.items():
        if not facts:
            continue
        for f in facts.get("functions", ()):
            extra: Set[str] = set()
            for e in f["extra"]:
                if e.startswith("group:"):
                    extra |= set(groups.get(e[len("group:"):], ()))
                else:
                    extra.add(e)
            extras[id(f)] = extra
            ma[id(f)] = {n for n, _ln in f["acquires"]} | extra
            recs.append((facts["module"], facts["path"], f))

    def candidates(mod: str, callee: str, base: str) -> List[dict]:
        segs = [s.lstrip("_") for s in base.split(".") if s
                and s not in ("self", "cls")]
        if not segs:
            # bare name (imported function) or self-method: same module
            # first, else unique-ish among ACQUIRING functions anywhere
            local = by_module.get(mod, {}).get(callee)
            if local:
                return local
            hits = []
            for m, table in by_module.items():
                for g in table.get(callee, ()):
                    if ma[id(g)]:
                        hits.append(g)
            return hits if len(hits) <= 8 else []
        # attribute call: only a dotted-base segment naming a module can
        # resolve it (`self.kv.put` -> scheduler.kv, `costmodel.predict` ->
        # ops.costmodel). Anything else (`self._cache.get`, `q.put`) is a
        # collection/foreign method — resolving those by bare name painted
        # phantom kv.get edges under every counter lock. Dynamic dispatch a
        # base can't name (plan.execute, callbacks) is what the
        # `# may-acquire:` annotation and the runtime witness are for.
        for seg in segs:
            for m in last_comp.get(seg, ()):
                hit = by_module.get(m, {}).get(callee)
                if hit:
                    return hit
        return []

    resolved: Dict[int, List[List[dict]]] = {}
    for mod, _path, f in recs:
        resolved[id(f)] = [
            candidates(mod, callee, base)
            for callee, base, _ln, _held in f["calls"]
        ]
    # fixpoint: fold callee acquisitions upward until stable
    for _ in range(len(recs) + 2):
        changed = False
        for _mod, _path, f in recs:
            mine = ma[id(f)]
            before = len(mine)
            for cands in resolved[id(f)]:
                for g in cands:
                    mine |= ma[id(g)]
            if len(mine) != before:
                changed = True
        if not changed:
            break
    return kinds, recs, resolved, ma, extras


def build_graph(facts_by_path: Dict[str, dict]) -> Tuple[LockGraph, Dict[str, str]]:
    """The whole-program acquired-while-held graph from per-file facts."""
    kinds, recs, resolved, ma, extras = _resolve_calls(facts_by_path)
    graph = LockGraph()

    def reentrant_self(name: str) -> bool:
        return kinds.get(name) == "rlock"

    for _mod, path, f in recs:
        for h, n, ln in f["nested"]:
            if h == n and reentrant_self(n):
                continue
            graph.add(EdgeSite(h, n, path, ln, f["name"], ""))
        # a `# may-acquire:` annotation describes dynamic work inside THIS
        # function's body: it contributes edges from every lock the
        # function itself holds (its own acquisitions + its holds-lock
        # entry context), not just from its call sites
        held_here = {n for n, _ln in f["acquires"]}
        if f["entry"]:
            held_here.add(f["entry"])
        for h in held_here:
            for l in extras.get(id(f), ()):
                if h == l and reentrant_self(l):
                    continue
                graph.add(EdgeSite(h, l, path, f["line"], f["name"],
                                   "may-acquire"))
        for (callee, _base, ln, held), cands in zip(f["calls"],
                                                    resolved[id(f)]):
            if not held or not cands:
                continue
            acq: Set[str] = set()
            for g in cands:
                acq |= ma[id(g)]
            for h in held:
                for l in acq:
                    if reentrant_self(l) and l in held:
                        # the callee re-enters a reentrant lock this
                        # scope already holds (kv.lock -> counter lock ->
                        # kv.get): a re-entry cannot block, so it is not
                        # an ordering edge against ANY held lock
                        continue
                    graph.add(EdgeSite(h, l, path, ln, f["name"],
                                       f"{callee}()"))
    return graph, kinds


@register_global(RULE)
def global_check(facts_by_path: Dict[str, dict]) -> List[Finding]:
    # facts_by_path maps display path -> {rule name -> facts}; unwrap ours
    unwrapped = {
        p: f.get(RULE, {}) if isinstance(f, dict) else {}
        for p, f in facts_by_path.items()
    }
    graph, _kinds = build_graph(unwrapped)
    manifest = Manifest.load()
    findings: List[Finding] = []
    for (src, dst) in sorted(graph.edge_set()):
        complaint = manifest.check_edge(src, dst)
        if complaint is not None:
            site = graph.site(src, dst)
            findings.append(Finding(
                RULE, site.path, site.line, 0,
                complaint + f" [{site.describe()}]",
            ))
    # cycle detection over the graph MINUS plan-tree pairs (structurally
    # ordered per instance — a class-level cycle there is not a deadlock)
    cycle_graph = LockGraph()
    for (src, dst), sites in graph.edges.items():
        if not manifest.plan_pair(src, dst):
            cycle_graph.add(sites[0])
    for cycle in cycle_graph.cycles():
        if len(cycle) == 2 and cycle[0] == cycle[1]:
            continue  # self-edges already reported via check_edge
        anchor = cycle_graph.site(cycle[0], cycle[1])
        findings.append(Finding(
            RULE, anchor.path if anchor else "<graph>",
            anchor.line if anchor else 0, 0,
            "potential deadlock: lock-order cycle "
            + " -> ".join(cycle) + "\n" + cycle_graph.cycle_report(cycle),
        ))
    return findings


def static_edges(paths: List[str], use_cache: bool = True,
                 cache_path: Optional[str] = None) -> Set[Tuple[str, str]]:
    """The statically derived edge set for --check-witness (honors the
    CLI's cache flags)."""
    from ballista_tpu_torch.analysis.core import collect_facts

    facts = collect_facts(paths, use_cache=use_cache, cache_path=cache_path)
    unwrapped = {p: f.get(RULE, {}) for p, f in facts.items()}
    graph, _kinds = build_graph(unwrapped)
    return graph.edge_set()
