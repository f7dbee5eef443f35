"""The program's own spans over a run's window, for the per-layer readers
of metrics/ and for `python -m perfbench.gaps`. The program records them
(ballista_tpu_torch/utils/tracing.py: name, start and end on
perf_counter_ns, self time, thread, parent, query id) while torch.profiler
records, so in a `--trace 1` run and not in a `--trace 0` one. A program
without span records (no `tracing.records`) or with none in the window
reads None, as does a window whose first spans the ring has already let go."""

from __future__ import annotations


def window(run: dict):
    """The span records that start inside the window (the first query's
    start to the last one's end), or None."""
    try:
        from ballista_tpu_torch.utils import tracing
    except ImportError:
        return None
    records = getattr(tracing, "records", None)
    if records is None or not run["records"]:
        return None
    lo = int(min(r["t0"] for r in run["records"]) * 1e9)
    hi = int(max(r["t1"] for r in run["records"]) * 1e9)
    recs = records()
    if not recs:
        return None
    if len(recs) >= getattr(tracing, "RING", len(recs) + 1) and recs[0].end_ns >= lo:
        return None
    return [r for r in recs if lo <= r.start_ns <= hi]


def completed(run: dict) -> int:
    return sum(r["ok"] for r in run["records"])


def per_query_ms(run: dict, pick, need: str | None = None):
    """Σ self time of the window's spans that `pick` takes, in ms per
    completed query; None without spans, or without one named `need`."""
    spans, n = window(run), completed(run)
    if spans is None or not n or (need and not any(r.name == need for r in spans)):
        return None
    return sum(r.self_ns for r in spans if pick(r)) / 1e6 / n
