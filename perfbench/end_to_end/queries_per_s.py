"""Queries completed per second over the whole window (TPC-H's throughput
measure, per second): every completed query over the window's length,
from its start to the last query's end."""

UNIT = "queries/s"


def read(run: dict):
    done = sum(r["ok"] for r in run["records"])
    return done / run["window_s"] if done else None
