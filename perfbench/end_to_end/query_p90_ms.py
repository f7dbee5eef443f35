"""The 90th-percentile latency of every query of the window (a failed
query ranks above every latency)."""

from perfbench.stats import latency_percentile

UNIT = "ms"


def read(run: dict):
    return latency_percentile(run["records"], 0.90)
