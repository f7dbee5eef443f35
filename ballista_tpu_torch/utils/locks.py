"""Project lock factory + dynamic lock-order witness.

Every project lock is created through ``make_lock(name)`` / ``make_rlock``
with its CANONICAL name — the same `<module>.<attr>` identity the port's
static analyzer (ballista_tpu_torch/analysis/rules_lockorder.py) derives,
so the runtime and the static lock-order graph speak one vocabulary (the
analyzer meta-checks the literal against the derived name).

Normally a lock is a thin proxy over ``threading.Lock``/``RLock`` whose
acquire fast-path is one module-global flag check. In **witness mode**
(``ballista.debug.lock_witness`` / env ``BALLISTA_LOCK_WITNESS=1``) every
acquisition is checked against a thread-local stack of held locks:

- each acquired-while-held pair records an edge (with both acquisition
  stacks the first time it is seen);
- an edge that INVERTS the canonical order declared in the port's
  analysis/lockorder.toml raises ``LockOrderViolation`` at the moment
  it happens, naming both locks and carrying both stacks — and is also
  recorded in the dump, so a daemon thread swallowing the raise cannot
  hide it from CI;
- re-acquiring the same OBJECT is legal for rlocks and fatal for plain
  locks (that thread would deadlock for real one line later); distinct
  instances of an ``instance_tree`` lock class (e.g. a plan tree's join
  build locks) may nest.

``dump()`` writes the observed edges + violations as JSON for
``python -m ballista_tpu_torch.analysis --check-witness``: runtime edges the static
analyzer missed are analyzer bugs; declared edges never witnessed are
flagged stale. ``BALLISTA_LOCK_WITNESS_OUT=<path>`` dumps at interpreter
exit.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

_ENABLED = False
# witness bookkeeping — internal, leaf-only (never held while taking a
# project lock), deliberately a raw threading.Lock so it cannot recurse
# into the witness itself
_wmu = threading.Lock()
_edges: Dict[Tuple[str, str], dict] = {}  # guarded-by: _wmu
_violations: List[dict] = []  # guarded-by: _wmu
_ranks: Optional[Dict[str, int]] = None  # guarded-by: _wmu
_tree_locks: frozenset = frozenset()  # instance/plan-tree classes; guarded-by: _wmu
_plan_locks: frozenset = frozenset()  # plan_tree classes; guarded-by: _wmu
_held = threading.local()  # per-thread stack of _Held entries


class LockOrderViolation(AssertionError):
    """A lock acquisition inverted the canonical order declared in
    ballista_tpu_torch/analysis/lockorder.toml, observed as it happened."""


class _Held:
    __slots__ = ("name", "obj_id", "reentrant", "stack")

    def __init__(self, name: str, obj_id: int, reentrant: bool, stack: str):
        self.name = name
        self.obj_id = obj_id
        self.reentrant = reentrant
        self.stack = stack


def _stack() -> str:
    # drop the witness's own frames (last two)
    return "".join(traceback.format_stack(limit=16)[:-2])


def _load_manifest() -> Tuple[Dict[str, int], frozenset, frozenset]:
    """(ranks, instance-tree lock names, plan-tree lock names) from the
    port's own manifest, ballista_tpu_torch/analysis/lockorder.toml;
    empty when it (or tomllib) is absent — edges still record, only the
    declared-order assertion is disarmed."""
    try:
        path = manifest_path()
        if not os.path.exists(path):
            return {}, frozenset(), frozenset()
        try:
            import tomllib as toml  # py3.11+
        except ImportError:  # pragma: no cover - py3.10 fallback
            import tomli as toml  # type: ignore
        with open(path, "rb") as f:
            data = toml.load(f)
        ranks = {n: i for i, n in enumerate(data.get("order", ()))}
        locks = data.get("locks", {})
        plan = frozenset(
            n for n, attrs in locks.items() if attrs.get("plan_tree")
        )
        tree = plan | frozenset(
            n for n, attrs in locks.items() if attrs.get("instance_tree")
        )
        return ranks, tree, plan
    except Exception:
        return {}, frozenset(), frozenset()


def manifest_path() -> str:
    """The lock-order manifest the witness holds acquisitions to."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "analysis", "lockorder.toml")


def _held_stack() -> list:
    s = getattr(_held, "stack", None)
    if s is None:
        s = _held.stack = []
    return s


def _on_acquired(name: str, obj_id: int, reentrant: bool) -> None:
    """Record edges/violations for one successful acquisition and push it
    onto the thread's held stack. Called only in witness mode."""
    global _ranks, _tree_locks, _plan_locks
    held = _held_stack()
    stack = _stack()
    if held:
        # reentrant re-entry of an ALREADY-HELD object is not an
        # acquisition in ordering terms at all — it can never block, so it
        # must not paint edges (or rank violations) against the OTHER
        # locks acquired since (kv.lock -> counter lock -> kv.get is the
        # canonical legal shape). Same-object re-entry of a plain lock is
        # a guaranteed deadlock and asserts before blocking.
        for h in held:
            if h.obj_id == obj_id:
                if reentrant:
                    held.append(_Held(name, obj_id, reentrant, stack))
                    return
                with _wmu:
                    _violations.append({
                        "kind": "self_deadlock", "lock": name,
                        "held_stack": h.stack, "acquire_stack": stack,
                    })
                raise LockOrderViolation(
                    f"same-object re-acquisition of non-reentrant "
                    f"lock '{name}' — this thread deadlocks now\n"
                    f"first acquired at:\n{h.stack}\n"
                    f"re-acquired at:\n{stack}"
                )
        with _wmu:
            if _ranks is None:
                _ranks, _tree_locks, _plan_locks = _load_manifest()
            for h in held:
                if h.name == name and name in _tree_locks:
                    continue  # distinct instances, declared tree-ordered
                ent = _edges.get((h.name, name))
                if ent is None:
                    _edges[(h.name, name)] = {
                        "count": 1, "held_stack": h.stack,
                        "acquire_stack": stack,
                    }
                else:
                    ent["count"] += 1
                if h.name in _plan_locks and name in _plan_locks:
                    # plan-tree pair: instances acquire along the (acyclic)
                    # plan tree; class-level rank does not apply
                    continue
                rs = _ranks.get(h.name)
                rd = _ranks.get(name)
                if rs is not None and rd is not None and rs >= rd \
                        and h.name != name:
                    _violations.append({
                        "kind": "order_inversion", "src": h.name,
                        "dst": name, "held_stack": h.stack,
                        "acquire_stack": stack,
                    })
                    raise LockOrderViolation(
                        f"lock-order inversion: acquired '{name}' (rank "
                        f"{rd}) while holding '{h.name}' (rank {rs}); the "
                        f"declared order is the reverse\n"
                        f"'{h.name}' acquired at:\n{h.stack}\n"
                        f"'{name}' acquired at:\n{stack}"
                    )
    held.append(_Held(name, obj_id, reentrant, stack))


def _on_released(name: str, obj_id: int) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i].name == name and held[i].obj_id == obj_id:
            del held[i]
            return


class WitnessLock:
    """Proxy over a threading lock; one global-flag check when the witness
    is off. Supports the full with/acquire(blocking=, timeout=)/release/
    locked surface the project uses."""

    __slots__ = ("_lock", "name", "_reentrant")

    def __init__(self, name: str, reentrant: bool = False) -> None:
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self.name = name
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _ENABLED:
            # check/record BEFORE blocking: a would-deadlock acquisition
            # must assert, not hang the suite
            _on_acquired(self.name, id(self), self._reentrant)
            got = self._lock.acquire(blocking, timeout)
            if not got:
                _on_released(self.name, id(self))
            return got
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()
        if _ENABLED:
            _on_released(self.name, id(self))

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._lock
        if hasattr(inner, "locked"):
            return inner.locked()
        # RLock pre-3.12 has no locked(); approximate via non-blocking probe
        if inner.acquire(blocking=False):  # pragma: no cover
            inner.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover
        return f"<WitnessLock {self.name} reentrant={self._reentrant}>"


def make_lock(name: str) -> WitnessLock:
    """A mutual-exclusion lock with a canonical name (module.attr)."""
    return WitnessLock(name, reentrant=False)


def make_rlock(name: str) -> WitnessLock:
    """A reentrant lock with a canonical name (module.attr)."""
    return WitnessLock(name, reentrant=True)


# -- witness mode control -----------------------------------------------------

def witness_enabled() -> bool:
    return _ENABLED


_dump_registered = False  # one atexit dump per process; guarded-by: _wmu


def enable_witness(out: Optional[str] = None) -> None:
    """Arm the witness for this process (sticky; idempotent — every
    SchedulerServer/PollLoop construction calls through here, so the
    atexit dump registers exactly once). `out` registers an atexit JSON
    dump."""
    global _ENABLED, _dump_registered
    _ENABLED = True
    if out:
        with _wmu:
            if _dump_registered:
                return
            _dump_registered = True
        atexit.register(dump, out)


def disable_witness() -> None:
    global _ENABLED
    _ENABLED = False


def reset_witness() -> None:
    """Drop recorded edges/violations (tests)."""
    with _wmu:
        _edges.clear()
        _violations.clear()


def _env_dump_path() -> Optional[str]:
    """Per-process dump path for env-armed runs. Witness CI lanes fork
    worker processes that ALL inherit BALLISTA_LOCK_WITNESS_OUT; with one
    shared path the last atexit os.replace wins and every other process's
    edges vanish. Each process dumps to <OUT>.<pid> instead, and
    `--check-witness` accepts the whole set, merging edges before the
    static diff."""
    out = os.environ.get("BALLISTA_LOCK_WITNESS_OUT")
    return f"{out}.{os.getpid()}" if out else None


def maybe_enable_from_config(config) -> None:
    """Arm the witness when ballista.debug.lock_witness is set — called by
    the scheduler/executor entry points so one config flag covers a whole
    StandaloneCluster. Enabling is sticky and process-global."""
    try:
        if config.debug_lock_witness():
            enable_witness(_env_dump_path())
    except Exception:
        pass


def witness_edges() -> Dict[Tuple[str, str], int]:
    with _wmu:
        return {k: v["count"] for k, v in _edges.items()}


def witness_violations() -> List[dict]:
    with _wmu:
        return list(_violations)


def dump(path: str) -> dict:
    """Write the witness record (observed edges with example stacks, and
    any violations) as JSON; returns the record."""
    with _wmu:
        record = {
            "edges": [
                {"src": s, "dst": d, "count": v["count"],
                 "held_stack": v["held_stack"],
                 "acquire_stack": v["acquire_stack"]}
                for (s, d), v in sorted(_edges.items())
            ],
            "violations": list(_violations),
        }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=1)
    os.replace(tmp, path)
    return record


# env arming at import: one variable turns every subsequently created (and
# existing — the flag is checked per acquire) project lock into a witness
if os.environ.get("BALLISTA_LOCK_WITNESS", "").strip() in ("1", "true", "yes"):
    enable_witness(_env_dump_path())
