"""Lightweight tracing spans and named counters.

    with span("physical_planning"):
        ...
    print(report())

The JAX package's profiler hook is not carried over: device timelines on the
GPU come from torch.profiler or CUDA events around the code in question.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Tuple

_local = threading.local()
_all_spans: List[Tuple[str, float, int]] = []  # (path, seconds, depth); guarded-by: _mu
_counters: Dict[str, int] = {}  # guarded-by: _mu
_mu = threading.Lock()


def _stack() -> List[str]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    stack = _stack()
    stack.append(name)
    path = "/".join(stack)
    t0 = time.perf_counter()
    try:
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
    """Monotonic named counter (e.g. device.host_fallback)."""
    with _mu:
        _counters[name] = _counters.get(name, 0) + by


def counters() -> Dict[str, int]:
    with _mu:
        return dict(_counters)


def reset() -> None:
    with _mu:
        _all_spans.clear()
        _counters.clear()
