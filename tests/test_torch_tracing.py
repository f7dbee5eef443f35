"""The port's span recorder (ballista_tpu_torch/utils/tracing.py): a
bounded ring beside per-name totals that keep counting, self time as the
duration less the children's, one query id per query (a job's id in the
cluster), off by default, on under torch.profiler, and the Chrome trace
written at exit under BALLISTA_TRACE_DIR."""

import collections
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu_torch.utils import tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETTINGS = {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": ""}
TEMPLATES = ["q1", "q3", "q5", "q6", "q10", "q12"]

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""


@pytest.fixture
def traced():
    """Recording on over the test, on an empty ring."""
    tracing.reset()
    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)
        tracing.reset()


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_tracing")
    generate(str(d), sf=0.002, parts=2, seed=20261018)
    return str(d)


def _sql(name: str) -> str:
    return (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()


def test_ring_stays_bounded_while_totals_keep_counting(traced):
    n = tracing.RING + 1000
    for _ in range(n):
        with tracing.span("tiny"):
            pass
    assert len(tracing.records()) == tracing.RING
    assert len(tracing.spans()) == tracing.RING
    tot = tracing.totals()["tiny"]
    assert tot["n"] == n
    assert tracing.totals()["tiny"]["n"] == n  # reading resets nothing


def test_self_time_is_duration_less_children(traced):
    with tracing.span("outer"):
        time.sleep(0.01)
        with tracing.span("inner"):
            time.sleep(0.02)
            with tracing.span("leaf"):
                time.sleep(0.005)
        with tracing.span("inner"):
            pass
    by = collections.defaultdict(list)
    for r in tracing.records():
        by[r.name].append(r)
    (outer,), inners, (leaf,) = by["outer"], by["inner"], by["leaf"]
    dur = lambda r: r.end_ns - r.start_ns  # noqa: E731
    assert outer.self_ns == dur(outer) - sum(dur(r) for r in inners)
    assert inners[0].self_ns == dur(inners[0]) - dur(leaf)
    assert leaf.self_ns == dur(leaf) and leaf.parent == "inner"
    assert inners[0].parent == "outer" and outer.parent is None
    assert [p for p, _s, _d in tracing.spans()] == [
        "outer/inner/leaf", "outer/inner", "outer/inner", "outer"]
    tot = tracing.totals()
    assert tot["outer"]["self_s"] == pytest.approx(outer.self_ns / 1e9)
    assert tot["inner"]["n"] == 2
    assert outer.self_ns >= 0.009e9 and inners[0].self_ns >= 0.019e9


def test_intervals_and_marks_take_their_duration_as_self_time(traced):
    tracing.record_interval("scheduler.job", 100, 350, query="job1")
    tracing.mark(("job", "j2"), at=time.perf_counter_ns() - 5_000_000)
    tracing.since("scheduler.job", ("job", "j2"), query="j2")
    tracing.since("scheduler.job", ("job", "never marked"))
    a, b = tracing.records()
    assert (a.self_ns, a.query, a.path) == (250, "job1", "scheduler.job")
    assert b.self_ns == b.end_ns - b.start_ns >= 5_000_000 and b.query == "j2"
    assert tracing.marked(("job", "j2")) is None


def test_off_by_default_records_nothing():
    tracing.reset()
    assert not tracing.recording()
    assert tracing.span("a") is tracing.span("b")  # the one shared null context
    with tracing.span("plan"):
        tracing.record_interval("scheduler.job", 0, 10)
        tracing.mark(("job", "x"))
    assert tracing.records() == [] and tracing.spans() == [] and tracing.totals() == {}
    assert tracing.marked(("job", "x")) is None
    tracing.incr("always.on")
    assert tracing.counters()["always.on"] == 1  # counters stay always on


def test_torch_profiler_turns_recording_on():
    from torch.profiler import ProfilerActivity, profile

    tracing.reset()
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: seen.append(tracing.recording()))
        t.start()
        t.join()
        with tracing.span("under.profiler"):
            pass
    with tracing.span("after.profiler"):
        pass
    assert seen == [True]  # process-wide, not per thread
    assert [r.name for r in tracing.records()] == ["under.profiler"]
    tracing.reset()


def test_pools_carry_the_query_id_into_their_workers(traced):
    from ballista_tpu_torch.ops.runtime import ordered_map, pipelined_map

    def work(x):
        with tracing.span("worker"):
            return threading.get_native_id()

    with tracing.query_scope("job-7"):
        threads = set(ordered_map(work, range(6), workers=3))
        threads |= set(pipelined_map(iter(range(6)), work, workers=3))
    with tracing.span("outside"):
        pass
    assert threading.get_native_id() not in threads  # the spans ran in the pools
    recs = tracing.records()
    assert len(recs) == 13
    assert {r.query for r in recs if r.name == "worker"} == {"job-7"}
    assert recs[-1].query is None


def test_tpch_templates_leave_stacks_empty_and_one_query_id_each(traced, tpch_dir):
    from benchmarks.tpch.datagen import register_all
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext

    ctx = ExecutionContext(BallistaConfig(dict(SETTINGS)), device="cpu")
    register_all(ctx, tpch_dir)
    ids = {}
    for name in TEMPLATES:
        before = len(tracing.records())
        df = ctx.sql(_sql(name))
        df.collect()
        recs = tracing.records()[before:]
        assert tracing.open_spans() == {}, name
        queries = {r.query for r in recs if r.name != "sql"}
        assert len(queries) == 1 and None not in queries, (name, queries)
        ids[name] = queries.pop()
        names = {r.name for r in recs}
        assert {"sql", "plan", "execute", "stage.run", "readback"} <= names, (name, names)
        assert any(n.startswith("op.") for n in names)
        assert all(len(r.name) <= 32 for r in recs)
        assert [p for p, _s, _d in tracing.spans()[before:] if p == "plan"] == ["plan"]
    assert len(set(ids.values())) == len(TEMPLATES)


def test_trace_dir_exports_chrome_trace_at_exit(tmp_path, tpch_dir):
    out = tmp_path / "spans"
    script = (
        "from benchmarks.tpch.datagen import register_all\n"
        "from ballista_tpu_torch.config import BallistaConfig\n"
        "from ballista_tpu_torch.engine import ExecutionContext\n"
        f"ctx = ExecutionContext(BallistaConfig({SETTINGS!r}), device='cpu')\n"
        f"register_all(ctx, {tpch_dir!r})\n"
        f"ctx.sql(open({str(ROOT / 'benchmarks/tpch/queries/q6.sql')!r}).read()).collect()\n"
        "import os; print(os.getpid())\n"
    )
    env = {**os.environ, "BALLISTA_TRACE_DIR": str(out), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    pid = proc.stdout.split()[-1]
    doc = json.loads((out / f"spans-{pid}.json").read_text())
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} == {"X"}
    by = {e["name"]: e for e in events}
    assert {"sql", "plan", "execute", "stage.run", "readback"} <= set(by)
    assert by["stage.run"]["args"]["query"] == by["execute"]["args"]["query"] is not None
    assert by["execute"]["ts"] <= by["stage.run"]["ts"]
    assert by["stage.run"]["ts"] + by["stage.run"]["dur"] <= (
        by["execute"]["ts"] + by["execute"]["dur"] + 1)
    assert all(isinstance(e["tid"], int) and e["dur"] >= 0 for e in events)


def test_cluster_spans_carry_the_job_id(traced, tpch_dir):
    from benchmarks.tpch.datagen import register_all
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster

    cluster = StandaloneCluster(n_executors=2, config=BallistaConfig(dict(SETTINGS)),
                                device="cpu")
    try:
        ctx = BallistaContext(*cluster.scheduler_addr, device="cpu",
                              settings={**SETTINGS, "ballista.cache.results": "false"})
        register_all(ctx, tpch_dir)
        ctx.sql(_sql("q3")).collect()
        ctx.close()
    finally:
        cluster.shutdown()
    recs = tracing.records()
    jobs = {r.query for r in recs if r.name == "scheduler.job"}
    assert len(jobs) == 1
    job = jobs.pop()
    names = collections.Counter(r.name for r in recs if r.query == job)
    for name in ("scheduler.job", "scheduler.plan", "scheduler.task_wait", "executor.task",
                 "shuffle.write", "client.wait", "client.fetch"):
        assert names[name] >= 1, (name, names)
    # the submit opens before the job has its id
    assert [r.query for r in recs if r.name == "client.submit"] == [None]
    assert names["executor.task"] == names["scheduler.task_wait"] >= 2
    assert {r.query for r in recs if r.name.startswith(("scheduler.", "executor."))} == {job}
    (j,) = [r for r in recs if r.name == "scheduler.job"]
    (plan,) = [r for r in recs if r.name == "scheduler.plan"]
    assert j.start_ns <= plan.start_ns and plan.end_ns <= j.end_ns
    assert tracing.open_spans() == {}
