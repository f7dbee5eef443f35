"""The scheduler's planning per query (layer: scheduler): the self time of
the span scheduler.plan (the physical and the distributed plan and the
plan's commit, scheduler/server.py::_plan_job) over the window, per
completed query. Engines with a scheduler only."""

from perfbench.spans import per_query_ms

UNIT = "ms"


def read(run: dict):
    return per_query_ms(run, lambda r: r.name == "scheduler.plan", need="scheduler.job")
