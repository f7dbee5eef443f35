"""Program spans and named counters.

    with span("stage.run"):
        ...

A span records its name, its start and end on `time.perf_counter_ns()`
(CLOCK_MONOTONIC on Linux, so the processes of one host share it, and the
clock a device trace is tied to), its thread, its parent (the enclosing span
on the same thread) and the query id of the context it runs in
(`query_scope`). Names are static strings of at most 32 characters. Spans
go into a ring of the last RING records; beside it, per-name totals (count,
total and self nanoseconds, self being the duration less that of the
children on the same thread) keep counting past the ring, and reading them
never resets them. `record_interval` adds an interval that starts on one
thread and ends on another (its self time is its duration); `mark` and
`since` time one from a keyed start.

Recording is off by default: `span()` then returns one shared null context
after a flag check and nothing is recorded. It is on while `enable(True)`
holds, in a process started with BALLISTA_TRACE_DIR set (the ring is then
written at exit as one Chrome trace, `<dir>/spans-<pid>.json`), and while
torch.profiler records in the process, so that a device trace always has
the program's spans beside it on one clock.

A span never stays open across a `yield`: the operators are generators,
and a span left open there would unbalance its thread's stack.

`incr()` and `counters()`, the registry's `named` counter set
(utils/counters.py), are always on."""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

from ballista_tpu_torch.utils import counters as _counters
from ballista_tpu_torch.utils.locks import make_lock

# records kept: a traced 51 s window of the hot cell runs about 1,150
# queries of 8-9 spans each, some 10,000 records
RING = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    self_ns: int
    thread: int
    parent: Optional[str]
    query: Optional[str]
    path: str
    depth: int


_local = threading.local()
_ring: "collections.deque[Span]" = collections.deque(maxlen=RING)  # guarded-by: _mu
_totals: Dict[str, List[int]] = {}  # name -> [count, total ns, self ns]; guarded-by: _mu
_marks: "collections.OrderedDict" = collections.OrderedDict()  # guarded-by: _mu
_stacks: Dict[int, list] = {}  # thread ident -> its span stack; guarded-by: _mu
_mu = make_lock("utils.tracing._mu")
_query: contextvars.ContextVar = contextvars.ContextVar("ballista_query", default=None)
_query_seq = itertools.count(1)
_on = False


def _profiling() -> bool:
    """torch.profiler records in this process (its process-wide flag)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def recording() -> bool:
    return _on or _profiling()


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        stack = _local.stack = []
        alive = {t.ident for t in threading.enumerate()}
        with _mu:
            for t in [t for t in _stacks if t not in alive]:
                del _stacks[t]
            _stacks[threading.get_ident()] = stack
        return stack


def open_spans() -> Dict[int, List[str]]:
    """The spans open now on each thread that has one, by thread ident."""
    with _mu:
        return {t: [s.name for s in st] for t, st in _stacks.items() if st}


def _record(rec: Span) -> None:
    with _mu:
        _ring.append(rec)
        t = _totals.get(rec.name)
        if t is None:
            _totals[rec.name] = [1, rec.end_ns - rec.start_ns, rec.self_ns]
        else:
            t[0] += 1
            t[1] += rec.end_ns - rec.start_ns
            t[2] += rec.self_ns


class _Span:
    __slots__ = ("name", "start", "child_ns")

    def __init__(self, name: str) -> None:
        self.name = name
        self.child_ns = 0

    def __enter__(self) -> None:
        _stack().append(self)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        dur = end - self.start
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += dur
        _record(Span(self.name, self.start, end, dur - self.child_ns,
                     threading.get_native_id(), parent.name if parent else None,
                     _query.get(), "/".join([s.name for s in stack] + [self.name]),
                     len(stack)))
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """A span over the `with` body; one shared null context when off."""
    if not (_on or _profiling()):
        return _NULL
    return _Span(name)


def record_interval(name: str, start_ns: int, end_ns: int,
                    query: Optional[str] = None) -> None:
    """An interval that starts on one thread and ends on another (a job's
    life, a task's wait); its self time is its duration."""
    if not recording():
        return
    q = query if query is not None else _query.get()
    _record(Span(name, start_ns, end_ns, end_ns - start_ns, threading.get_native_id(),
                 None, q, name, 0))


def mark(key, at: Optional[int] = None) -> None:
    """Remember now (or perf_counter_ns `at`) as the start of `key`'s
    interval; past RING marks the oldest go."""
    if not recording():
        return
    now = time.perf_counter_ns() if at is None else at
    with _mu:
        _marks[key] = now
        _marks.move_to_end(key)
        while len(_marks) > RING:
            _marks.popitem(last=False)


def marked(key) -> Optional[int]:
    with _mu:
        return _marks.get(key)


def since(name: str, key, query: Optional[str] = None) -> None:
    """Record `name` from `key`'s mark to now, and forget the mark."""
    with _mu:
        start = _marks.pop(key, None)
    if start is not None:
        record_interval(name, start, time.perf_counter_ns(), query)


# -- query ids ----------------------------------------------------------------
@contextlib.contextmanager
def query_scope(qid: Optional[str] = None) -> Iterator[str]:
    """Run the body under query id `qid`; None keeps the current id, or
    draws a fresh one where there is none."""
    if qid is None:
        qid = _query.get() or f"q{next(_query_seq)}"
    token = _query.set(str(qid))
    try:
        yield str(qid)
    finally:
        _query.reset(token)


# -- reading ------------------------------------------------------------------
def records() -> List[Span]:
    with _mu:
        return list(_ring)


def spans() -> List[Tuple[str, float, int]]:
    """(path, seconds, depth) of each record in the ring."""
    return [(r.path, (r.end_ns - r.start_ns) / 1e9, r.depth) for r in records()]


def totals() -> Dict[str, Dict[str, float]]:
    """{name: {"n", "s", "self_s"}} since the process started (or reset())."""
    with _mu:
        return {k: {"n": v[0], "s": v[1] / 1e9, "self_s": v[2] / 1e9}
                for k, v in _totals.items()}


def export() -> Optional[str]:
    """Write the ring as one Chrome trace (`"ph": "X"` events, `ts` and
    `dur` in microseconds of perf_counter_ns, `args.query`) to
    `<BALLISTA_TRACE_DIR>/spans-<pid>.json`; returns the path written, or
    None without the variable."""
    trace_dir = os.environ.get("BALLISTA_TRACE_DIR")
    if not trace_dir:
        return None
    pid = os.getpid()
    path = os.path.join(trace_dir, f"spans-{pid}.json")
    events = [{"name": r.name, "ph": "X", "ts": r.start_ns / 1e3,
               "dur": (r.end_ns - r.start_ns) / 1e3, "pid": pid, "tid": r.thread,
               "args": {"query": r.query, "parent": r.parent}}
              for r in records()]
    os.makedirs(trace_dir, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, path)
    return path


if os.environ.get("BALLISTA_TRACE_DIR"):
    _on = True
    atexit.register(export)


# -- counters -----------------------------------------------------------------
def incr(name: str, by: int = 1) -> None:
    """Monotonic named counter (e.g. spmd.mesh against spmd.host_declined),
    in the registry's `named` set (utils/counters.py)."""
    _counters.named.record(name, by)


def counters() -> Dict[str, int]:
    return _counters.named.stats()


def reset() -> None:
    with _mu:
        _ring.clear()
        _totals.clear()
        _marks.clear()
    _counters.named.stats(reset=True)
