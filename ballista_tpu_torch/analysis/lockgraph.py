"""Whole-program lock-order graph.

Model shared by the static rule (rules_lockorder.py), the runner's global
pass (core.run_paths), and the dynamic witness cross-check
(`python -m ballista_tpu_torch.analysis --check-witness`).

Canonical lock names
--------------------
A lock's identity is its *class*, not its instance: `<module>.<name>` where
`<module>` is the source path under ballista_tpu_torch/ with slashes -> dots and
no extension (`scheduler.state`, `ops.runtime`) and `<name>` is the module
global or instance attribute the lock is bound to (`_res_lock`,
`_tenant_mu`). Two instances of one class share a name — conservative:
merging can only add edges, never hide one. Special case: the global
scheduler KV lock is acquired as `<anything>.lock()` (the KvBackend.lock()
contract) and canonicalizes to `scheduler.kv.lock`; the backends' own
`self._mu` RLocks ARE that lock, so ALIASES folds them in.

Manifest (lockorder.toml)
-------------------------
`order` ranks every known lock: an observed edge src->dst must go FORWARD
(rank[src] < rank[dst]) and be explicitly declared in `[[edges]]` with a
reason — an undeclared nested acquisition is a lint error, so new nesting
is a reviewed decision, not an accident. `[locks."<name>"]` carries
per-lock attributes: `reentrant = true` (RLock semantics: self-edges are
legal re-entry) and `instance_tree = "<reason>"` (distinct instances of
this class nest in an acyclic structural order, e.g. a plan tree's join
build locks; same-OBJECT re-acquisition is still a deadlock and the
dynamic witness asserts on it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

try:  # py3.11+
    import tomllib as _toml
except ImportError:  # pragma: no cover - py3.10 fallback
    import tomli as _toml  # type: ignore

from ballista_tpu_torch.analysis.common import PACKAGE_PREFIX

MANIFEST_BASENAME = "lockorder.toml"

# the global scheduler lock: `with <x>.lock():` anywhere, and the KV
# backends' own `self._mu` reentrant locks that implement it
KV_LOCK = "scheduler.kv.lock"
ALIASES = {
    "scheduler.kv._mu": KV_LOCK,
    # factagg acquires its INNER FusedAggregateStage's prepare lock
    # (`with self.inner._prepare_lock:`); same lock class, stage's module
    "ops.factagg._prepare_lock": "ops.stage._prepare_lock",
    # shared scan holds every member stage's prepare lock (id order)
    "ops.sharedscan._prepare_lock": "ops.stage._prepare_lock",
}

# with-item expressions that look like lock acquisitions even when the
# lock object was created elsewhere (bare Name / self-attribute form)
LOCKISH_RE = re.compile(r"(_mu|_lock)\d*$|^_?lock$")


def canonical(name: str) -> str:
    return ALIASES.get(name, name)


def module_of(display_path: str) -> str:
    """`ballista_tpu_torch/scheduler/state.py` -> `scheduler.state`, the
    name the JAX package gives the same module (tests keep their own
    prefix so fixture locks can't collide with production ones)."""
    p = display_path.replace("\\", "/")
    if p.startswith(PACKAGE_PREFIX):
        p = p[len(PACKAGE_PREFIX):]
    if p.endswith(".py"):
        p = p[:-3]
    return p.replace("/", ".")


@dataclasses.dataclass(frozen=True)
class EdgeSite:
    """One concrete place an acquired-while-held edge was observed."""

    src: str
    dst: str
    path: str
    line: int
    func: str
    via: str  # "" for a direct `with` nesting, else the call chain

    def describe(self) -> str:
        how = f" via {self.via}" if self.via else ""
        return (f"{self.path}:{self.line} in {self.func}: "
                f"{self.src} -> {self.dst}{how}")


class LockGraph:
    """Directed graph of acquired-while-held edges with example sites."""

    def __init__(self) -> None:
        self.edges: Dict[Tuple[str, str], List[EdgeSite]] = {}

    def add(self, site: EdgeSite) -> None:
        self.edges.setdefault((site.src, site.dst), []).append(site)

    def edge_set(self) -> Set[Tuple[str, str]]:
        return set(self.edges)

    def locks(self) -> Set[str]:
        out: Set[str] = set()
        for s, d in self.edges:
            out.add(s)
            out.add(d)
        return out

    def site(self, src: str, dst: str) -> Optional[EdgeSite]:
        sites = self.edges.get((src, dst))
        return sites[0] if sites else None

    def cycles(self) -> List[List[str]]:
        """Elementary cycles (each reported once, smallest-lock-first
        rotation), via iterative DFS back-edge detection per SCC member.
        The graphs here are tiny; clarity over asymptotics."""
        adj: Dict[str, Set[str]] = {}
        for s, d in self.edges:  # self-loops included: a cycle of one
            adj.setdefault(s, set()).add(d)
        seen: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []

        def norm(cycle: List[str]) -> Tuple[str, ...]:
            i = cycle.index(min(cycle))
            return tuple(cycle[i:] + cycle[:i])

        for start in sorted(adj):
            # DFS from `start`, only visiting nodes >= start to bound work
            stack: List[Tuple[str, List[str]]] = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start:
                        key = norm(path)
                        if key not in seen:
                            seen.add(key)
                            out.append(path + [start])
                    elif nxt not in path and len(path) < 8:
                        stack.append((nxt, path + [nxt]))
        return out

    def cycle_report(self, cycle: List[str]) -> str:
        """Both (all) acquisition paths of a cycle, one line per edge."""
        lines = []
        for a, b in zip(cycle, cycle[1:]):
            site = self.site(a, b)
            lines.append("  " + (site.describe() if site else f"{a} -> {b}"))
        return "\n".join(lines)


class Manifest:
    """Parsed lockorder.toml: ranks, declared edges, per-lock attributes,
    lock groups (an edge with `dst_group` declares src -> every member)."""

    def __init__(self, data: Optional[dict] = None) -> None:
        data = data or {}
        self.order: List[str] = list(data.get("order", ()))
        self.rank: Dict[str, int] = {n: i for i, n in enumerate(self.order)}
        self.groups: Dict[str, List[str]] = dict(data.get("groups", {}))
        self.declared: Dict[Tuple[str, str], str] = {}
        for e in data.get("edges", ()):
            dsts = [e["dst"]] if "dst" in e else list(
                self.groups.get(e.get("dst_group", ""), ())
            )
            for dst in dsts:
                self.declared[(e["src"], dst)] = e.get("reason", "")
        self.attrs: Dict[str, dict] = dict(data.get("locks", {}))

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Manifest":
        if path is None:
            path = default_manifest_path()
        if not os.path.exists(path):
            return cls()
        with open(path, "rb") as f:
            return cls(_toml.load(f))

    def reentrant(self, lock: str) -> bool:
        return bool(self.attrs.get(lock, {}).get("reentrant"))

    def instance_tree(self, lock: str) -> bool:
        return bool(self.attrs.get(lock, {}).get("instance_tree")
                    or self.attrs.get(lock, {}).get("plan_tree"))

    def plan_tree(self, lock: str) -> bool:
        """Plan-tree node lock: distinct instances acquire along the plan
        tree, which is acyclic across instances by construction — so
        class-level edges AMONG plan-tree locks are exempt from the
        declared order (a class-level cycle there does not imply an
        instance-level one)."""
        return bool(self.attrs.get(lock, {}).get("plan_tree"))

    def plan_pair(self, src: str, dst: str) -> bool:
        return self.plan_tree(src) and self.plan_tree(dst)

    def check_edge(self, src: str, dst: str) -> Optional[str]:
        """None if the edge is declared and forward; else the complaint."""
        if src != dst and self.plan_pair(src, dst):
            return None
        if src == dst:
            if self.reentrant(src) or self.instance_tree(src):
                return None
            return (f"self-acquisition of non-reentrant lock '{src}' would "
                    "self-deadlock — use an RLock, restructure, or declare "
                    f"`instance_tree` for it in {MANIFEST_BASENAME}")
        if (src, dst) not in self.declared:
            return (f"undeclared lock-order edge {src} -> {dst}: declare it "
                    f"in {MANIFEST_BASENAME} [[edges]] (with a reason) or "
                    "restructure to avoid the nested acquisition")
        rs, rd = self.rank.get(src), self.rank.get(dst)
        if rs is None or rd is None:
            missing = src if rs is None else dst
            return (f"lock '{missing}' is missing from the canonical `order` "
                    f"list in {MANIFEST_BASENAME}")
        if rs >= rd:
            return (f"lock-order inversion: {src} (rank {rs}) acquired "
                    f"before {dst} (rank {rd}) but the canonical order says "
                    f"{dst} < {src}")
        return None

    def check_locks_ranked(self, locks: Iterable[str]) -> List[str]:
        return [n for n in sorted(locks) if n not in self.rank]


def default_manifest_path() -> str:
    # the one manifest: utils/locks.py::manifest_path() names the same file
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        MANIFEST_BASENAME)


# -- witness cross-check ------------------------------------------------------

def load_witness(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def diff_witness(witness: dict, static_edges: Set[Tuple[str, str]],
                 manifest: Manifest) -> dict:
    """Cross-check a runtime witness dump against the static graph:

    - `missed`: edges the runtime actually took but the static analyzer
      never derived — analyzer bugs (or a missing `# may-acquire:`
      annotation on a dynamic-dispatch seam). Hard failures.
    - `stale`: declared manifest edges neither witnessed at runtime nor
      (for extra signal) derived statically — candidates for removal.
    - `violations`: order inversions the witness recorded as they
      happened (each carries both stacks in the dump).
    """
    runtime = {
        (e["src"], e["dst"]) for e in witness.get("edges", ())
        if e["src"] != e["dst"]
    }
    # plan-tree pairs are structurally ordered per instance; the static
    # analyzer does not chase dynamic plan composition among them
    missed = sorted(
        (s, d) for (s, d) in runtime - static_edges
        if not manifest.plan_pair(s, d)
    )
    witnessed = runtime | {(d, s) for s, d in runtime}
    stale = sorted(
        (s, d) for (s, d) in manifest.declared
        if (s, d) not in witnessed and (s, d) not in static_edges
    )
    never_witnessed = sorted(
        (s, d) for (s, d) in manifest.declared if (s, d) not in runtime
    )
    return {
        "missed": missed,
        "stale": stale,
        "never_witnessed": never_witnessed,
        "violations": list(witness.get("violations", ())),
        "runtime_edges": len(runtime),
    }
