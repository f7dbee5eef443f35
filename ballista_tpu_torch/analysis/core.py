"""Framework: findings, per-file source model (comments, suppressions,
annotations), rule registry, per-file cache, and the directory runner."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Dict, List, Optional, Tuple

META_RULE = "lint-usage"

# populated by the rules_* modules at import time (rule name -> check fn)
_REGISTRY: Dict[str, object] = {}
# per-file fact extractors feeding whole-program passes (name -> fn(sf))
_FACTS: Dict[str, object] = {}
# whole-program passes run by the runner over every file's cached facts
# (name -> fn(facts_by_path) -> findings). Their findings are recomputed on
# every run — never cached per file, since they depend on OTHER files.
_GLOBAL: Dict[str, object] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def register_facts(name: str):
    def deco(fn):
        _FACTS[name] = fn
        return fn

    return deco


def register_global(name: str):
    def deco(fn):
        _GLOBAL[name] = fn
        return fn

    return deco


def RULE_NAMES() -> List[str]:
    _load_rules()
    return sorted(set(_REGISTRY) | set(_GLOBAL)) + [META_RULE]


_RULES_LOADED = False


def _load_rules() -> None:
    # a dedicated flag, NOT `if _REGISTRY:` — importing one rule module
    # directly (tests do) pre-populates the registry, and the truthiness
    # guard would then silently skip loading every other rule
    global _RULES_LOADED
    if _RULES_LOADED:
        return
    _RULES_LOADED = True
    from ballista_tpu_torch.analysis import (  # noqa: F401
        rules_decline,
        rules_dtype,
        rules_durability,
        rules_failure,
        rules_guarded,
        rules_lockorder,
        rules_readback,
        rules_routing,
    )


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_DIRECTIVE_RE = re.compile(r"#\s*ballista-lint:\s*(.*)")
_DISABLE_RE = re.compile(r"disable=([\w.,-]+)(?:\s*--\s*(.*\S))?\s*$")
_PATH_RE = re.compile(r"path=(\S+)")
_GUARDED_RE = re.compile(r"[#;]\s*guarded-by:\s*(\S[^#]*?)\s*$")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*(\S[^#]*?)\s*$")
# check-then-act across a lock release, reviewed and accepted
_ATOMICITY_OK_RE = re.compile(r"#\s*atomicity-ok:\s*(\S[^#]*?)\s*$")
# dynamic-dispatch seam (callback, plan-tree execute): the annotated def
# may acquire the named canonical locks even though no call edge resolves
# to them statically — feeds the lock-order graph
_MAY_ACQUIRE_RE = re.compile(r"#\s*may-acquire:\s*(\S[^#]*?)\s*$")
# replica-coherence classification of scheduler state:
# durable(<kv-prefix>) | derived(<rebuild-fn>) | ephemeral(<reason>)
_DURABILITY_RE = re.compile(
    r"#\s*durability:\s*(durable|derived|ephemeral)\(([^()]*)\)"
)
# a function folding a TaskStatus into durable state without the attempt/
# ledger guard, reviewed and accepted
_ATTEMPT_OK_RE = re.compile(r"#\s*attempt-guard-ok:\s*(\S[^#]*?)\s*$")


@dataclasses.dataclass
class Suppression:
    lines: Tuple[int, ...]  # physical lines this suppression covers
    rules: Tuple[str, ...]
    reason: Optional[str]
    comment_line: int
    used: bool = False


class SourceFile:
    """Parsed view of one file: AST + comment-driven directives.

    `path` is the display/scoping path: relative to the repo root when the
    file lives under it, and overridable by a `# ballista-lint: path=...`
    header so test fixtures can exercise device-path-scoped rules."""

    def __init__(self, real_path: str, source: str, display_path: str):
        self.real_path = real_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=real_path)
        self.suppressions: List[Suppression] = []
        self.guarded: Dict[int, str] = {}  # line -> lock expr
        self.holds: Dict[int, str] = {}  # line -> lock expr
        self.atomicity_ok: Dict[int, str] = {}  # line -> reason
        self.may_acquire: Dict[int, str] = {}  # line -> lock list expr
        self.durability: Dict[int, Tuple[str, str]] = {}  # line -> (class, arg)
        self.attempt_ok: Dict[int, str] = {}  # line -> reason
        self.meta_findings: List[Finding] = []
        self.path = display_path
        self._scan_comments()

    # -- comment scanning --------------------------------------------------
    def _scan_comments(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(self.source).readline))
        except tokenize.TokenError:
            return
        known = set(_REGISTRY) | {META_RULE}
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            standalone = self.lines[line - 1][: tok.start[1]].strip() == ""
            text = tok.string
            g = _GUARDED_RE.search(text)
            if g:
                # a standalone annotation covers the next line's statement
                self.guarded[line if not standalone else line + 1] = g.group(1).strip()
            h = _HOLDS_RE.search(text)
            if h:
                self.holds[line] = h.group(1).strip()
            a = _ATOMICITY_OK_RE.search(text)
            if a:
                # a standalone annotation covers the next line's statement
                self.atomicity_ok[line if not standalone else line + 1] = \
                    a.group(1).strip()
            ma = _MAY_ACQUIRE_RE.search(text)
            if ma:
                self.may_acquire[line] = ma.group(1).strip()
            du = _DURABILITY_RE.search(text)
            if du:
                # a standalone annotation covers the next line's statement
                self.durability[line if not standalone else line + 1] = (
                    du.group(1), du.group(2).strip()
                )
            ao = _ATTEMPT_OK_RE.search(text)
            if ao:
                self.attempt_ok[line] = ao.group(1).strip()
            m = _DIRECTIVE_RE.search(text)
            if not m:
                continue
            body = m.group(1).strip()
            if line <= 10 and _PATH_RE.match(body):
                self.path = _PATH_RE.match(body).group(1)
                continue
            d = _DISABLE_RE.match(body)
            if not d:
                self.meta_findings.append(
                    Finding(META_RULE, self.path, line, tok.start[1],
                            f"unrecognized ballista-lint directive: {body!r}")
                )
                continue
            rules = tuple(r.strip() for r in d.group(1).split(",") if r.strip())
            reason = d.group(2)
            unknown = [r for r in rules if r not in known]
            if unknown:
                self.meta_findings.append(
                    Finding(META_RULE, self.path, line, tok.start[1],
                            f"suppression names unknown rule(s) {unknown}; "
                            f"known: {sorted(known)}")
                )
            if not reason:
                self.meta_findings.append(
                    Finding(META_RULE, self.path, line, tok.start[1],
                            "suppression without a reason — write "
                            "'# ballista-lint: disable=<rule> -- <why>'")
                )
                continue  # a reasonless suppression does not suppress
            covered = (line,) if not standalone else (line, line + 1)
            self.suppressions.append(Suppression(covered, rules, reason, line))

    # -- annotation lookup -------------------------------------------------
    def guarded_targets(self) -> List[Tuple[ast.AST, str]]:
        """(assignment statement, lock expr) pairs for every statement a
        guarded-by comment attaches to."""
        out = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                lock = self.guarded.get(node.lineno)
                if lock:
                    out.append((node, lock))
        return out

    def holds_lock(self, func: ast.AST) -> Optional[str]:
        """Lock named by a `# holds-lock:` comment on the def's signature."""
        return self._def_annotation(func, self.holds)

    def may_acquire_of(self, func: ast.AST) -> Optional[str]:
        """Lock list named by a `# may-acquire:` comment on the def."""
        return self._def_annotation(func, self.may_acquire)

    def attempt_ok_of(self, func: ast.AST) -> Optional[str]:
        """Reason named by an `# attempt-guard-ok:` comment on the def."""
        return self._def_annotation(func, self.attempt_ok)

    def _def_annotation(self, func: ast.AST, table: Dict[int, str]) -> Optional[str]:
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        end = func.body[0].lineno if func.body else func.lineno + 1
        # lineno-1 covers a standalone annotation directly above the def
        for line in range(func.lineno - 1, end + 1):
            if line in table:
                return table[line]
        return None

    # -- suppression application -------------------------------------------
    def apply_suppressions(self, findings: List[Finding]) -> List[Finding]:
        kept = []
        for f in findings:
            hit = None
            for s in self.suppressions:
                if f.rule in s.rules and f.line in s.lines:
                    hit = s
                    break
            if hit is None:
                kept.append(f)
            else:
                hit.used = True
        for s in self.suppressions:
            if not s.used:
                kept.append(
                    Finding(META_RULE, self.path, s.comment_line, 0,
                            f"unused suppression for {', '.join(s.rules)} — "
                            "remove it or move it onto the flagged line")
                )
        return kept


# -- per-file analysis -------------------------------------------------------

def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _display_path(path: str) -> str:
    ap = os.path.abspath(path)
    root = _repo_root()
    return os.path.relpath(ap, root) if ap.startswith(root + os.sep) else path


def _analyze(path: str) -> Tuple[List[Finding], int, dict, Dict[str, float]]:
    """(surviving findings, reasoned-suppression count, facts, per-rule
    wall seconds) for one file — one read/parse/tokenize pass serves all
    four. Facts feed the whole-program passes (lock-order graph, durability
    coverage) and are cached beside the findings; timings are never cached
    (they describe THIS run's work)."""
    import time as _time

    _load_rules()
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    try:
        sf = SourceFile(path, source, _display_path(path))
    except SyntaxError as e:
        return [Finding(META_RULE, _display_path(path), e.lineno or 1, 0,
                        f"syntax error: {e.msg}")], 0, {}, {}
    findings: List[Finding] = []
    timings: Dict[str, float] = {}
    for name, check in sorted(_REGISTRY.items()):
        t0 = _time.perf_counter()
        findings.extend(check(sf))
        timings[name] = timings.get(name, 0.0) + (_time.perf_counter() - t0)
    findings = sf.apply_suppressions(findings)
    findings.extend(sf.meta_findings)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    facts = {}
    for name, fn in sorted(_FACTS.items()):
        t0 = _time.perf_counter()
        facts[name] = fn(sf)
        # fact extraction bills to its rule: the cost is real either way
        timings[name] = timings.get(name, 0.0) + (_time.perf_counter() - t0)
    return findings, len(sf.suppressions), facts, timings


def _global_findings(
    facts_by_path: Dict[str, dict],
    timings: Optional[Dict[str, float]] = None,
) -> List[Finding]:
    """Run every whole-program pass over the collected per-file facts.
    When `timings` is given, each pass's wall seconds accumulate into it
    under the pass's rule name."""
    import time as _time

    _load_rules()
    findings: List[Finding] = []
    for name, fn in sorted(_GLOBAL.items()):
        t0 = _time.perf_counter()
        findings.extend(fn(facts_by_path))
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + (
                _time.perf_counter() - t0
            )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_file(path: str) -> List[Finding]:
    """All surviving findings for one file (suppressions applied) —
    including the whole-program passes scoped to just this file, so a
    single-file CLI run (and the fixture pair tests) exercise the
    lock-order graph checks."""
    findings, _n, facts, _t = _analyze(path)
    findings = findings + _global_findings({_display_path(path): facts})
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def suppression_count(path: str) -> int:
    """Reasoned suppressions present in a file (for budget accounting)."""
    return _analyze(path)[1]


# -- cache -------------------------------------------------------------------

CACHE_BASENAME = ".ballista_torch_lint_cache.json"


def _analyzer_hash() -> str:
    """Hash of the analyzer's own sources AND the in-tree manifests: a
    rule or manifest change invalidates every cached verdict."""
    d = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha1()
    for name in sorted(os.listdir(d)):
        if name.endswith(".py") or name.endswith(".toml"):
            with open(os.path.join(d, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()[:16]


def durability_manifest_path() -> str:
    """durability.toml beside this module, overridable via
    BALLISTA_TORCH_DURABILITY_MANIFEST (tests point it at scratch
    manifests; the JAX package's analyzer reads its own variable)."""
    return os.environ.get("BALLISTA_TORCH_DURABILITY_MANIFEST") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "durability.toml"
    )


def _manifest_hash() -> str:
    """Hash of the manifests as resolved right now (the durability
    override included). Folded into every per-file cache key: per-file
    findings depend on the manifests (durability agreement)."""
    from ballista_tpu_torch.analysis.lockgraph import default_manifest_path

    h = hashlib.sha1()
    for path in (default_manifest_path(), durability_manifest_path()):
        h.update(path.encode())
        try:
            with open(path, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"<absent>")
    return h.hexdigest()[:12]


class FileCache:
    def __init__(self, cache_path: Optional[str]):
        self.cache_path = cache_path
        self.data: Dict[str, dict] = {}
        self.dirty = False
        self.hits = 0
        self._ahash = _analyzer_hash()
        self._mhash = _manifest_hash()
        if cache_path and os.path.exists(cache_path):
            try:
                with open(cache_path) as f:
                    blob = json.load(f)
                if blob.get("analyzer") == self._ahash:
                    self.data = blob.get("files", {})
            except (OSError, ValueError):
                pass

    def _key(self, path: str) -> str:
        st = os.stat(path)
        return f"{st.st_mtime_ns}:{st.st_size}:{self._mhash}"

    def get(self, path: str) -> Optional[Tuple[List[Finding], int, dict]]:
        ap = os.path.abspath(path)
        ent = self.data.get(ap)
        if ent is None or ent.get("key") != self._key(path):
            return None
        self.hits += 1
        return (
            [Finding(**f) for f in ent["findings"]],
            ent.get("suppressions", 0),
            ent.get("facts", {}),
        )

    def put(self, path: str, findings: List[Finding], suppressions: int,
            facts: dict) -> None:
        ap = os.path.abspath(path)
        self.data[ap] = {
            "key": self._key(path),
            "findings": [f.to_dict() for f in findings],
            "suppressions": suppressions,
            "facts": facts,
        }
        self.dirty = True

    def save(self) -> None:
        if not self.cache_path or not self.dirty:
            return
        tmp = self.cache_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"analyzer": self._ahash, "files": self.data}, f)
            os.replace(tmp, self.cache_path)
        except OSError:
            pass


# -- runner ------------------------------------------------------------------

# this subpackage: a directory walk never lints the analyzer itself (the
# JAX package's analyzer lives outside its package for the same reason); a
# file of it named on the command line is still linted
_ANALYZER_DIR = os.path.dirname(os.path.abspath(__file__))


def collect_py_files(paths: List[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".jax_cache")
                    and os.path.abspath(os.path.join(root, d)) != _ANALYZER_DIR
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        elif p.endswith(".py"):
            out.append(p)
    return out


def run_paths(paths: List[str], use_cache: bool = True,
              cache_path: Optional[str] = None) -> Tuple[List[Finding], dict]:
    """Analyze every .py under `paths`. Returns (findings, stats).

    The whole-program lock-order pass then runs over every file's facts,
    cached or fresh; its findings depend on OTHER files and are
    recomputed each run, never cached."""
    _load_rules()
    files = collect_py_files(paths)
    if use_cache and cache_path is None:
        cache_path = os.path.join(_repo_root(), CACHE_BASENAME)
    cache = FileCache(cache_path if use_cache else None)
    per_file: Dict[str, Tuple[List[Finding], int, dict]] = {}
    rule_wall: Dict[str, float] = {}
    fresh = []
    for path in files:
        cached = cache.get(path) if use_cache else None
        if cached is not None:
            per_file[path] = cached
        else:
            fresh.append(path)
    for path in fresh:
        findings_f, n_supp, facts, timings = _analyze(path)
        per_file[path] = (findings_f, n_supp, facts)
        for rule, secs in timings.items():
            rule_wall[rule] = rule_wall.get(rule, 0.0) + secs
    findings: List[Finding] = []
    n_suppressions = 0
    facts_by_path: Dict[str, dict] = {}
    fresh_set = set(fresh)
    for path in files:
        result, n_supp, facts = per_file[path]
        if use_cache and path in fresh_set:
            cache.put(path, result, n_supp, facts)
        findings.extend(result)
        n_suppressions += n_supp
        facts_by_path[_display_path(path)] = facts
    cache.save()
    findings.extend(_global_findings(facts_by_path, timings=rule_wall))
    # per-rule finding counts + wall seconds: CI logs
    # make a rule whose cost regresses visible. Wall covers FRESH analyses
    # + the global passes; cached files cost (and bill) nothing.
    by_rule: Dict[str, dict] = {}
    for f in findings:
        by_rule.setdefault(f.rule, {"findings": 0, "wall_s": 0.0})
        by_rule[f.rule]["findings"] += 1
    for rule, secs in rule_wall.items():
        by_rule.setdefault(rule, {"findings": 0, "wall_s": 0.0})
        by_rule[rule]["wall_s"] = round(secs, 4)
    stats = {
        "files": len(files),
        "cache_hits": cache.hits,
        "suppressions": n_suppressions,
        "findings": len(findings),
        "rules": dict(sorted(by_rule.items())),
    }
    return findings, stats


def collect_facts(paths: List[str], use_cache: bool = True,
                  cache_path: Optional[str] = None) -> Dict[str, dict]:
    """Per-file facts for every .py under `paths` (display path -> facts)
    — the static side of the witness cross-check."""
    _load_rules()
    files = collect_py_files(paths)
    if use_cache and cache_path is None:
        cache_path = os.path.join(_repo_root(), CACHE_BASENAME)
    cache = FileCache(cache_path if use_cache else None)
    out: Dict[str, dict] = {}
    for path in files:
        cached = cache.get(path) if use_cache else None
        if cached is not None:
            out[_display_path(path)] = cached[2]
        else:
            findings, n_supp, facts, _t = _analyze(path)
            if use_cache:
                cache.put(path, findings, n_supp, facts)
            out[_display_path(path)] = facts
    cache.save()
    return out
