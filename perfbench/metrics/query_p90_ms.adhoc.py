"""The 90th-percentile latency of every query of the window, where the
window holds too few queries (about 27) for a tail with a bound: in a
cell whose end-to-end metrics leave `query_p90_ms` out."""

from perfbench.stats import latency_percentile

UNIT = "ms"


def read(run: dict):
    return latency_percentile(run["records"], 0.90)
