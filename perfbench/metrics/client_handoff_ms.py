"""The client's hand-off per query (layer: client): the latency of the
window's completed queries less the scheduler's own life of their jobs
(the intervals scheduler.job, from ExecuteQuery's receipt to the final
status), per completed query: the submit, the status wait's notice and the
result fetch outside the scheduler's job. Engines with a scheduler only."""

from perfbench.spans import completed, window

UNIT = "ms"


def read(run: dict):
    spans, n = window(run), completed(run)
    jobs = [r for r in spans or () if r.name == "scheduler.job"]
    if not jobs or not n:
        return None
    latency_s = sum(r["t1"] - r["t0"] for r in run["records"] if r["ok"])
    return (latency_s * 1e3 - sum(r.end_ns - r.start_ns for r in jobs) / 1e6) / n
