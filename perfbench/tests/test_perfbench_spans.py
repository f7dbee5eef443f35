"""The readers of the program's spans (perfbench/spans.py, the five
metrics that read them) and the gap labels of perfbench/gaps.py, on
synthetic span records: what each reads, and None where the program has no
span records (the parent of the change that added them) or none in the
window."""

import pytest

from perfbench import catalog
from perfbench.gaps import label_gaps
from ballista_tpu_torch.utils import tracing

S = tracing.Span
MS = 1_000_000


def span(name, t0_ms, t1_ms, self_ms=None, parent=None, query="q1"):
    return S(name, t0_ms * MS, t1_ms * MS, (t1_ms - t0_ms if self_ms is None else self_ms) * MS,
             1, parent, query, name, 0)


def run(n=2):
    # two completed queries over [1000, 1400] ms and one failed one
    recs = [{"t0": 1.0 + 0.2 * i, "t1": 1.0 + 0.2 * i + 0.2, "ok": True,
             "spans": [("execute", 1.0 + 0.2 * i, 1.2 + 0.2 * i)]} for i in range(n)]
    recs.append({"t0": 1.4, "t1": 1.45, "ok": False, "spans": []})
    return {"records": recs}


SPANS = [
    span("op.SortExec", 1010, 1100, self_ms=30),
    span("op.HashJoinExec", 1200, 1300, self_ms=50),
    span("stage.run", 1020, 1090, self_ms=20),
    span("factagg.rank_search", 1030, 1040),
    span("join.flatten", 1210, 1215),
    span("join.gather", 1220, 1230),
    span("scheduler.plan", 1001, 1005, self_ms=3),
    span("scheduler.task_wait", 1005, 1011),
    span("scheduler.task_wait", 1205, 1207),
    span("scheduler.job", 1001, 1150),
    span("scheduler.job", 1201, 1350),
    span("op.SortExec", 900, 990, self_ms=90),  # before the window: left out
]


def read(metric, r):
    return catalog.reader(metric, True).read(r)


def test_readers_read_the_window_per_completed_query(monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: list(SPANS))
    r = run()
    assert read("host_ops_ms", r) == pytest.approx((30 + 50) / 2)
    assert read("join_host_ms", r) == pytest.approx((10 + 5 + 10) / 2)
    assert read("job_plan_ms", r) == pytest.approx(3 / 2)
    assert read("dispatch_wait_ms", r) == pytest.approx((6 + 2) / 2)
    assert read("client_handoff_ms", r) == pytest.approx((400 - 149 - 149) / 2)


def test_readers_read_none_without_span_records(monkeypatch):
    r = run()
    monkeypatch.setattr(tracing, "records", lambda: [])
    for m in ("host_ops_ms", "join_host_ms", "job_plan_ms", "dispatch_wait_ms",
              "client_handoff_ms"):
        assert read(m, r) is None
    # the parent of the change: a program without tracing.records
    monkeypatch.delattr(tracing, "records")
    for m in ("host_ops_ms", "join_host_ms", "client_handoff_ms"):
        assert read(m, r) is None


def test_scheduler_readers_read_none_without_a_scheduler(monkeypatch):
    local = [s for s in SPANS if not s.name.startswith("scheduler.")]
    monkeypatch.setattr(tracing, "records", lambda: local)
    r = run()
    assert read("host_ops_ms", r) == pytest.approx(40.0)
    for m in ("job_plan_ms", "dispatch_wait_ms", "client_handoff_ms"):
        assert read(m, r) is None


def test_a_ring_that_let_the_window_start_go_reads_none(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 3)
    monkeypatch.setattr(tracing, "records", lambda: [span("op.SortExec", 1100, 1150)] * 3)
    assert read("host_ops_ms", run()) is None


def test_gaps_are_labelled_by_the_innermost_open_program_span():
    harness = [("execute", 1.0, 1.2), ("plan", 1.2, 1.21), ("execute", 1.21, 1.4)]
    spans = [span("op.SortExec", 1010, 1100), span("factagg.rank_search", 1030, 1040),
             span("execute", 1210, 1400)]
    g0 = [x * MS for x in (1032, 1050, 1150, 1202, 1300)]
    g1 = [x * MS for x in (1036, 1060, 1160, 1204, 1310)]
    assert label_gaps(g0, g1, harness, spans) == [
        "execute:factagg.rank_search", "execute:op.SortExec", "execute", "plan", "execute"]
    assert label_gaps(g0, g1, harness, []) == ["execute", "execute", "execute", "plan", "execute"]
    assert label_gaps([5 * MS], [6 * MS], harness, spans) == ["harness"]
