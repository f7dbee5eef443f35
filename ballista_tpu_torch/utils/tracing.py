"""Lightweight tracing spans, named counters and an optional profiler hook.

    with span("physical_planning"):
        ...
    print(report())

With the environment variable BALLISTA_TRACE_DIR set, a span marked
device=True runs under torch.profiler (CPU activity, and CUDA activity when
the card is there) and exports one Chrome trace into that directory when it
ends (view it in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Tuple

from ballista_tpu_torch.utils.locks import make_lock

_local = threading.local()
_all_spans: List[Tuple[str, float, int]] = []  # (path, seconds, depth); guarded-by: _mu
_counters: Dict[str, int] = {}  # guarded-by: _mu
_mu = make_lock("utils.tracing._mu")


def _stack() -> List[str]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _device_trace(trace_dir: str, name: str):
    """A torch.profiler context that writes <trace_dir>/<name>-<pid>-<n>.json
    when it exits."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _mu:
        n = _trace_seq[0] = _trace_seq[0] + 1
    path = os.path.join(trace_dir, f"{name.replace('/', '_')}-{os.getpid()}-{n}.json")

    def export(prof) -> None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(path)

    return profile(activities=activities, on_trace_ready=export)


_trace_seq = [0]  # guarded-by: _mu


@contextlib.contextmanager
def span(name: str, device: bool = False) -> Iterator[None]:
    stack = _stack()
    stack.append(name)
    path = "/".join(stack)
    trace_dir = os.environ.get("BALLISTA_TRACE_DIR")
    ctx = contextlib.nullcontext()
    if device and trace_dir:
        ctx = _device_trace(trace_dir, name)
    t0 = time.perf_counter()
    try:
        with ctx:
            yield
    finally:
        dt = time.perf_counter() - t0
        with _mu:
            _all_spans.append((path, dt, len(stack) - 1))
        stack.pop()


def report(reset: bool = False) -> str:
    with _mu:
        lines = [
            f"{'  ' * depth}{path.split('/')[-1]}: {dt * 1000:.2f} ms"
            for path, dt, depth in _all_spans
        ]
        if reset:
            _all_spans.clear()
    return "\n".join(lines)


def spans() -> List[Tuple[str, float, int]]:
    with _mu:
        return list(_all_spans)


def incr(name: str, by: int = 1) -> None:
    """Monotonic named counter (e.g. spmd.mesh against spmd.host_declined)."""
    with _mu:
        _counters[name] = _counters.get(name, 0) + by


def counters() -> Dict[str, int]:
    with _mu:
        return dict(_counters)


def reset() -> None:
    with _mu:
        _all_spans.clear()
        _counters.clear()
