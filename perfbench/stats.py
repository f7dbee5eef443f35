"""Window statistics over every query of the window. The percentile is the
nearest-rank arithmetic of ballista_tpu_torch/bench/scenarios/latency.py::
_pct at commit aab2caf, copied; a failed query ranks above every latency.
The device's idle stretches are the complement of the union of its
intervals (chip_smoke.py::_device_busy_ms at commit aab2caf, in NumPy)."""

from __future__ import annotations

import math

import numpy as np


def latencies_ms(records: list) -> list:
    """Sorted latencies in ms, a failed query as +inf."""
    return sorted((r["t1"] - r["t0"]) * 1e3 if r["ok"] else math.inf for r in records)


def percentile(xs: list, q: float) -> float:
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def latency_percentile(records: list, q: float):
    """The q-th latency in ms of every query; None where there is none or
    it falls on a failed query."""
    xs = latencies_ms(records)
    v = percentile(xs, q) if xs else math.inf
    return None if v == math.inf else v


def geomean(xs: list) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def idle_stretches(starts, ends, lo: int, hi: int):
    """(starts, ends) of each stretch of [lo, hi] that no interval covers,
    for intervals (starts[i], ends[i]) inside [lo, hi] (NumPy arrays)."""
    order = np.argsort(starts, kind="stable")
    a, b = starts[order], np.maximum.accumulate(ends[order]) if len(ends) else ends
    # a stretch opens where an interval starts past every earlier end
    g0, g1 = np.concatenate(([lo], b)), np.concatenate((a, [hi]))
    idle = g1 > g0
    return g0[idle], g1[idle]
