"""Tasks waiting for dispatch per query (layer: scheduler): the intervals
scheduler.task_wait, each from the moment a task became runnable (its
job's plan commit, its requeue or the last completion of an upstream
stage) to its hand-out by push or poll, summed over the window, per
completed query. Engines with a scheduler only."""

from perfbench.spans import per_query_ms

UNIT = "ms"


def read(run: dict):
    return per_query_ms(run, lambda r: r.name == "scheduler.task_wait", need="scheduler.job")
