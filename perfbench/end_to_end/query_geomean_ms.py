"""TPC-H's power measure, per query: the geometric mean of the latencies
of every query of the window. It moves when any template gets faster."""

from perfbench.stats import geomean, latencies_ms

UNIT = "ms"


def read(run: dict):
    xs = latencies_ms(run["records"])
    return geomean(xs) if xs and xs[-1] != float("inf") else None
