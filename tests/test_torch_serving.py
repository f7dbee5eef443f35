"""The port's serving tier held to the JAX package's: each case runs the
same steps through a ballista_tpu_torch cluster (device="cpu", the "cuda"
backend, so the executors run the port's device stages) and a ballista_tpu
cluster (its default "cpu" backend), and asserts the reference tests'
contracts on both, plus equal answers and equal serving counters.

- streamed collect is bit-equal to collect, and a lost result partition
  recovers on the streaming path (tests/test_latency_tier.py:598, :638);
- a push-dispatched query takes zero polls, and a dropped stream falls back
  to polls and then resubscribes (:450, :472);
- on append the cached result advances: advance_hits 1, the advanced
  table bit-equal to a cache-off full run, a third submission a hit with
  zero tasks; an f32 SUM declines to a full recompute
  (tests/test_delta_advance.py:90, :185); the fold and fingerprint
  verdicts of scheduler/delta.py and scheduler/fingerprint.py match;
- weighted fair-share admission picks the same task order for the same
  submissions (tests/test_multitenant.py);
- a seeded task.slow straggler gets a speculative duplicate, whose
  completion wins with no double count
  (tests/test_speculation.py:661);
- an error on the device fails and retries that task, not the job.
"""

import importlib
import logging
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu_torch.ops import costmodel as port_costmodel
from test_fuzz_device import _compare, _delta_fuzz_queries
from test_torch_layout_cache import reset_jax, reset_port

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
logging.getLogger("ballista").setLevel(logging.CRITICAL)

PACKAGES = {"port": "ballista_tpu_torch", "reference": "ballista_tpu"}
NO_CACHE = {"ballista.cache.results": "false"}
GROUP_SQL = "select k, sum(v) as s, count(*) as n from t group by k"
DELTA_SQL = ("select g, sum(v) as sv, count(*) as c, min(v) as mn "
             "from t where w > -5 group by g order by g")
FLOAT_SQL = "select g, sum(f) as sf, count(*) as c from t group by g order by g"
PUSH_KEYS = ("dispatch_push", "dispatch_poll", "task_pushed")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def _cluster(pkg: str, settings: dict = None, **kw):
    cfg = _mod(pkg, "config").BallistaConfig(settings or {})
    if pkg == "port":
        kw["device"] = "cpu"
    kw.setdefault("n_executors", 2)
    return _mod(pkg, "executor.runtime").StandaloneCluster(config=cfg, **kw)


def _client(pkg: str, cluster, settings: dict = None):
    kw = {"device": "cpu"} if pkg == "port" else {}
    return _mod(pkg, "client").BallistaContext(
        *cluster.scheduler_addr, settings=settings or {}, **kw)


def _stats(pkg: str, name: str, reset: bool = True) -> dict:
    return getattr(_mod(pkg, "ops.runtime"), name)(reset=reset)


def _wait_for(predicate, timeout=10.0, interval=0.05) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(autouse=True)
def _fresh():
    reset_port()
    reset_jax()
    port_costmodel.reset(clear_dir=True)
    yield
    reset_port()
    reset_jax()
    port_costmodel.reset(clear_dir=True)


@pytest.fixture(scope="module")
def tpath(tmp_path_factory):
    """3-file Parquet table (test_latency_tier's): a multi-partition scan,
    so plans have a shuffle stage and several tasks per stage."""
    d = tmp_path_factory.mktemp("serving") / "t"
    d.mkdir()
    for part in range(3):
        rows = range(part * 200, (part + 1) * 200)
        pq.write_table(pa.table({
            "k": pa.array([i % 7 for i in rows], type=pa.int64()),
            "v": pa.array([float(i) * 0.5 for i in rows]),
        }), str(d / f"part-{part}.parquet"))
    return str(d)


@pytest.fixture(scope="module")
def clusters():
    """One default two-executor cluster per package, push dispatch on."""
    out = {}
    try:
        for pkg in PACKAGES:
            out[pkg] = _cluster(pkg)
        yield out
    finally:
        for cluster in out.values():
            cluster.shutdown()


def test_push_dispatch_takes_zero_polls(clusters, tpath):
    counts = {}
    for pkg, cluster in clusters.items():
        ctx = _client(pkg, cluster, NO_CACHE)
        try:
            ctx.register_parquet("t", tpath)
            _stats(pkg, "serving_stats")
            q = f"{GROUP_SQL} order by k"
            first = ctx.sql(q).collect()
            assert ctx.sql(q).collect().equals(first)
        finally:
            ctx.close()
        s = _stats(pkg, "serving_stats")
        assert s.get("dispatch_push", 0) > 0, (pkg, s)
        assert s.get("dispatch_poll", 0) == 0, (pkg, s)
        assert s.get("task_pushed") == s.get("dispatch_push"), (pkg, s)
        counts[pkg] = {k: s.get(k, 0) for k in PUSH_KEYS}
    assert counts["port"] == counts["reference"]


def test_streamed_collect_is_bit_equal_to_collect(clusters, tpath):
    answers = {}
    for pkg, cluster in clusters.items():
        base = {**NO_CACHE, "ballista.shuffle.partitions": "4"}
        buf = _client(pkg, cluster, base)
        st = _client(pkg, cluster, {**base, "ballista.client.stream_results": "true"})
        try:
            buf.register_parquet("t", tpath)
            st.register_parquet("t", tpath)
            buffered = buf.sql(GROUP_SQL).collect()
            assert st.sql(GROUP_SQL).collect().equals(buffered), pkg
            batches = list(st.collect_stream(st.sql(GROUP_SQL).logical_plan()))
            tbl = pa.Table.from_batches(
                batches, schema=batches[0].schema).cast(buffered.schema)
            assert tbl.equals(buffered), pkg
        finally:
            buf.close()
            st.close()
        answers[pkg] = buffered
    _compare(answers["port"].sort_by("k"), answers["reference"].sort_by("k"),
             GROUP_SQL)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_streamed_lost_partition_recovers(pkg, tpath):
    """The owning executor stops after the job completes: the streaming
    fetch reports the lost partition and the job recomputes it."""
    state_mod = _mod(pkg, "scheduler.state")
    # a 1 s lease with heartbeats held at their 0.25 s floor (ROADMAP §3, F5)
    cluster = _cluster(pkg, {"ballista.executor.idle_poll_max_s": "0.25"})
    old_lease = state_mod.EXECUTOR_LEASE_SECS
    state_mod.EXECUTOR_LEASE_SECS = 1.0
    cluster.scheduler_impl.lost_task_check_interval = 0.3
    try:
        ctx = _client(pkg, cluster, {**NO_CACHE,
                                     "ballista.client.stream_results": "true"})
        ctx.register_parquet("t", tpath)
        plan = ctx.sql("select k, sum(v) as s from t group by k order by k").logical_plan()
        baseline = ctx.collect(plan)
        job_id = ctx.submit(plan)
        st = cluster.scheduler_impl.state

        def completed():
            js = st.get_job_metadata(job_id)
            return js is not None and js.WhichOneof("status") == "completed"

        assert _wait_for(completed, timeout=60.0)
        owners = {pl.executor_meta.id for pl in
                  st.get_job_metadata(job_id).completed.partition_location}
        next(ex for ex in cluster.executors if ex.id in owners).stop()
        _stats(pkg, "recovery_stats")
        out = ctx._collect_results(job_id, plan.schema(), timeout=120)
        assert out.equals(baseline)
        rec = _stats(pkg, "recovery_stats")
        assert rec.get("result_fetch_restarted", 0) >= 1, rec
        assert rec.get("result_partition_restarted", 0) >= 1, rec
        ctx.close()
    finally:
        state_mod.EXECUTOR_LEASE_SECS = old_lease
        cluster.shutdown()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_dropped_stream_falls_back_to_polls_then_resubscribes(pkg, tpath):
    cluster = _cluster(pkg, n_executors=1)
    try:
        ctx = _client(pkg, cluster, NO_CACHE)
        ctx.register_parquet("t", tpath)
        q = "select k, count(*) as n from t group by k order by k"
        base = ctx.sql(q).collect()
        loop = cluster.executors[0].poll_loop
        cluster.scheduler_impl.push_enabled = False
        loop._cancel_push()
        assert _wait_for(lambda: not loop._stream_ok.is_set())
        _stats(pkg, "serving_stats")
        assert ctx.sql(q).collect().equals(base)
        s = _stats(pkg, "serving_stats")
        assert s.get("dispatch_poll", 0) > 0 and s.get("dispatch_push", 0) == 0, s
        cluster.scheduler_impl.push_enabled = True
        assert _wait_for(lambda: loop._stream_ok.is_set())
        _stats(pkg, "serving_stats")
        assert ctx.sql(q).collect().equals(base)
        s = _stats(pkg, "serving_stats")
        assert s.get("dispatch_push", 0) > 0 and s.get("dispatch_poll", 0) == 0, s
        ctx.close()
    finally:
        cluster.shutdown()


def _write_part(d: str, i: int, n: int = 200) -> None:
    """test_delta_advance's parts (rng 100 + i), plus the delta fuzz
    generator's second key h, drawn last."""
    rng = np.random.default_rng(100 + i)
    cols = {
        "g": pa.array(rng.integers(0, 7, n), type=pa.int64()),
        "v": pa.array(rng.integers(-50, 50, n), type=pa.int64()),
        "w": pa.array(rng.integers(-10, 10, n), type=pa.int64()),
        "f": pa.array(rng.random(n), type=pa.float64()),
    }
    cols["h"] = pa.array(rng.integers(0, 3, n), type=pa.int64())
    pq.write_table(pa.table(cols), os.path.join(d, f"part-{i}.parquet"))


def _advance(pkg: str, d: str, sql: str):
    """Cold run, one file appended, the same query again, a cache-off full
    run, a third submission. Returns the answers, the delta stats of the
    append, the tenancy stats of the third submission and the task lists of
    the jobs the cache served."""
    cluster = _cluster(pkg)
    try:
        ctx = _client(pkg, cluster, {"ballista.cache.advance": "true"})
        ctx.register_parquet("t", d)
        _stats(pkg, "delta_stats")
        cold = ctx.sql(sql).collect()
        _write_part(d, 2)
        ctx.register_parquet("t", d)
        advanced = ctx.sql(sql).collect()
        delta = _stats(pkg, "delta_stats")
        truth_ctx = _client(pkg, cluster, NO_CACHE)
        truth_ctx.register_parquet("t", d)
        truth = truth_ctx.sql(sql).collect()
        truth_ctx.close()
        _stats(pkg, "tenancy_stats")
        third = ctx.sql(sql).collect()
        tenancy = _stats(pkg, "tenancy_stats")
        st = cluster.scheduler_impl.state
        cached_tasks = []
        for k, _v in st.kv.get_prefix(st._key("jobs")):
            job = k.rsplit("/", 1)[1]
            js = st.get_job_metadata(job)
            if js.WhichOneof("status") == "completed" and js.completed.cached:
                cached_tasks.append(st.get_job_tasks(job))
        ctx.close()
        return {"cold": cold, "advanced": advanced, "truth": truth, "third": third,
                "delta": delta, "tenancy": tenancy, "cached_tasks": cached_tasks}
    finally:
        cluster.shutdown()


def _grow_dirs(tmp_path):
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        _write_part(str(d), 0)
        _write_part(str(d), 1)
        out[pkg] = str(d)
    return out


def test_append_advances_the_cached_result(tmp_path):
    runs = {pkg: _advance(pkg, d, DELTA_SQL)
            for pkg, d in _grow_dirs(tmp_path).items()}
    for pkg, r in runs.items():
        assert r["delta"].get("advance_hits") == 1, (pkg, r["delta"])
        assert r["advanced"].equals(r["truth"]), pkg
        assert not r["advanced"].equals(r["cold"]), pkg
        assert r["third"].equals(r["truth"]), pkg
        assert r["tenancy"].get("cache_hit") == 1, (pkg, r["tenancy"])
        assert r["cached_tasks"] and all(t == [] for t in r["cached_tasks"]), pkg
    port, ref = runs["port"], runs["reference"]
    assert port["advanced"].equals(ref["advanced"])
    assert port["delta"] == ref["delta"]
    assert port["tenancy"] == ref["tenancy"]


def test_float_sum_declines_to_full_recompute(tmp_path):
    runs = {pkg: _advance(pkg, d, FLOAT_SQL)
            for pkg, d in _grow_dirs(tmp_path).items()}
    for pkg, r in runs.items():
        assert r["delta"].get("advance_hits", 0) == 0, (pkg, r["delta"])
        assert r["delta"].get("advance_declined", 0) >= 1, (pkg, r["delta"])
        assert r["advanced"].equals(r["truth"]), pkg
    assert runs["port"]["delta"] == runs["reference"]["delta"]
    _compare(runs["port"]["advanced"], runs["reference"]["advanced"], FLOAT_SQL)


def test_fold_and_fingerprint_verdicts_match_reference(tmp_path):
    """scheduler/delta.py and scheduler/fingerprint.py give the JAX
    package's verdicts on the same plans and file sets: the fold spec (or
    its decline), both cache keys, the file facts and the appended files."""
    d = str(tmp_path / "grow")
    os.makedirs(d)
    _write_part(d, 0)
    _write_part(d, 1)
    queries = [DELTA_SQL, FLOAT_SQL, "select count(*) as c from t",
               "select g, avg(v) as a from t group by g order by g",
               "select g, max(v) as mx from t group by g"]
    queries += _delta_fuzz_queries(np.random.default_rng(29000))
    settings = {"ballista.shuffle.partitions": "4"}

    def verdicts(pkg: str) -> list:
        ctx_cls = _mod(pkg, "engine").ExecutionContext
        cfg = _mod(pkg, "config").BallistaConfig({"ballista.executor.backend": "cpu"})
        ctx = ctx_cls(cfg, device="cpu") if pkg == "port" else ctx_cls(cfg)
        ctx.register_parquet("t", d)
        delta = _mod(pkg, "scheduler.delta")
        fp = _mod(pkg, "scheduler.fingerprint")
        out = []
        for sql in queries:
            plan = ctx.sql(sql).logical_plan()
            spec = delta.fold_spec(plan)
            facts = fp.plan_file_facts(plan)
            out.append((
                None if spec is None else (spec.keys, spec.merges,
                                           spec.sort_keys, spec.nulls_first),
                fp.plan_fingerprint(plan, settings, facts),
                facts,
            ))
        return out

    base = {pkg: verdicts(pkg) for pkg in PACKAGES}
    assert base["port"] == base["reference"]
    _write_part(d, 2)
    grown = {pkg: verdicts(pkg) for pkg in PACKAGES}
    assert grown["port"] == grown["reference"]
    for pkg in PACKAGES:
        delta = _mod(pkg, "scheduler.delta")
        news = [delta.new_scan_files(g[2], b[2])
                for g, b in zip(grown[pkg], base[pkg])]
        assert news == [[os.path.join(d, "part-2.parquet")]] * len(queries)
    assert any(v[0] is None for v in base["port"])
    assert any(v[0] is not None for v in base["port"])


def _admission_order(pkg: str, seed: int) -> list:
    """Seeded tenants (weights, priorities, an in-flight quota) submit jobs
    of one scan stage; two executors take tasks and complete them in a
    seeded order. Returns the (job, stage, partition) assignment order."""
    pb = _mod(pkg, "proto.ballista_pb2")
    rng = np.random.default_rng(4100 + seed)
    ctx_cls = _mod(pkg, "engine").ExecutionContext
    cfg_cls = _mod(pkg, "config").BallistaConfig
    tenants = [f"tenant{i}" for i in range(int(rng.integers(2, 5)))]
    weights = ",".join(f"{t}:{int(rng.integers(1, 5))}" for t in tenants)
    state = _mod(pkg, "scheduler.state").SchedulerState(
        _mod(pkg, "scheduler.kv").MemoryBackend(), "t",
        config=cfg_cls({"ballista.tenant.weights": weights,
                        "ballista.tenant.max_inflight": str(int(rng.integers(2, 5)))}))
    for e in ("e1", "e2"):
        state.save_executor_metadata(pb.ExecutorMetadata(id=e, host="h", port=1))
    ctx = ctx_cls(device="cpu") if pkg == "port" else ctx_cls()
    for j in range(int(rng.integers(3, 7))):
        n_parts = int(rng.integers(1, 5))
        ctx.register_record_batches(
            "t", pa.table({"g": ["a", "b", "c", "d"]}), n_partitions=n_parts)
        physical = ctx.create_physical_plan(
            ctx.sql("select g from t").logical_plan())
        stage = _mod(pkg, "distributed.planner").DistributedPlanner() \
            .plan_query_stages("job", physical)[0]
        job = f"job{j:02d}"
        state.save_job_tenant(job, str(rng.choice(tenants)), int(rng.integers(0, 3)))
        state.save_stage_plan(job, stage.stage_id, stage)
        for p in range(n_parts):
            t = pb.TaskStatus()
            t.partition_id.job_id = job
            t.partition_id.stage_id = stage.stage_id
            t.partition_id.partition_id = p
            state.save_task_status(t)
    order, running = [], []
    for step in range(200):
        if running and (rng.random() < 0.4 or step % 2):
            done = pb.TaskStatus()
            done.CopyFrom(running.pop(int(rng.integers(0, len(running)))))
            done.completed.executor_id = "e1"
            done.completed.path = "/x"
            assert state.accept_task_status(done)
        got = state.assign_next_schedulable_task("e1" if step % 2 else "e2")
        if got is not None:
            pid = got[0].partition_id
            order.append((pid.job_id, pid.stage_id, pid.partition_id))
            running.append(got[0])
        elif not running:
            break
    return order


@pytest.mark.parametrize("seed", range(3))
def test_admission_order_matches_reference(seed):
    """The same assignment order, and the same tenancy events (quota
    deferrals) counted on the way."""
    runs = {}
    for pkg in PACKAGES:
        _stats(pkg, "tenancy_stats")
        runs[pkg] = (_admission_order(pkg, seed), _stats(pkg, "tenancy_stats"))
    assert runs["port"][0] and runs["port"] == runs["reference"]


def _spec_seed(pkg: str, coords: list, by_stage: dict, rate: float) -> int:
    """A chaos seed slowing exactly one task, in a stage with enough fast
    siblings to warm the prediction, whose duplicate draws fast."""
    injector = _mod(pkg, "utils.chaos").ChaosInjector
    min_obs = _mod(pkg, "ops.costmodel").MIN_OBSERVATIONS
    for cand in range(2000):
        inj = injector(cand, rate, sites=("task.slow",))
        slow = [c for c in coords
                if inj.should_inject("task.slow", f"{c[0]}/{c[1]}@a0")]
        if (len(slow) == 1 and len(by_stage[slow[0][0]]) >= min_obs + 1
                and not inj.should_inject("task.slow",
                                          f"{slow[0][0]}/{slow[0][1]}@a1")):
            return cand
    pytest.fail("no qualifying chaos seed in range")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_speculation_duplicate_wins_without_double_count(pkg):
    rng = np.random.default_rng(1101)
    n = 4000
    table = pa.table({
        "g": pa.array(rng.integers(0, 23, n), type=pa.int64()),
        "v": pa.array(rng.integers(-100, 100, n), type=pa.int64()),
    })
    sql = "select g, sum(v) as s, count(*) as n from t group by g order by g"
    base = {"ballista.shuffle.partitions": "2", **NO_CACHE,
            "ballista.tpu.cost_model_dir": ""}
    costmodel = _mod(pkg, "ops.costmodel")
    costmodel.reset()
    cluster = _cluster(pkg, {"ballista.tpu.cost_model_dir": "",
                             "ballista.speculation.min_runtime_ms": "150",
                             "ballista.speculation.multiplier": "3"})
    try:
        ctx = _client(pkg, cluster, base)
        ctx.register_record_batches("t", table, n_partitions=6)
        clean = ctx.sql(sql).collect()
        ctx.close()
        st = cluster.scheduler_impl.state
        coords = []
        for k, _v in st.kv.get_prefix(st._key("tasks")):
            tail = k.rsplit("/", 3)
            coords.append((int(tail[2]), int(tail[3])))
        by_stage = {}
        for c in coords:
            by_stage.setdefault(c[0], []).append(c)
        rate = 0.12
        seed = _spec_seed(pkg, coords, by_stage, rate)
        _stats(pkg, "speculation_stats")
        ctx2 = _client(pkg, cluster, {
            **base, "ballista.chaos.rate": str(rate),
            "ballista.chaos.seed": str(seed),
            "ballista.chaos.sites": "task.slow",
            "ballista.chaos.slow_ms": "4000"})
        ctx2.register_record_batches("t", table, n_partitions=6)
        t0 = time.perf_counter()
        chaotic = ctx2.sql(sql).collect()
        dt = time.perf_counter() - t0
        ctx2.close()
        stats = _stats(pkg, "speculation_stats")
    finally:
        cluster.shutdown()
        costmodel.reset()
    # first completion wins: exact integer sums and counts, no double count
    assert chaotic.equals(clean), (chaotic.to_pydict(), clean.to_pydict())
    assert sum(chaotic.column("n").to_pylist()) == n
    assert stats.get("launched", 0) >= 1, stats
    assert stats.get("won", 0) >= 1, stats
    assert dt < 3.5, f"speculation did not rescue the tail: {dt:.2f}s"
    assert seed == _spec_seed(
        "reference" if pkg == "port" else "port", coords, by_stage, rate)


def test_device_error_fails_and_retries_the_task(monkeypatch, tpath):
    """A RuntimeError out of the port's device stage (as a CUDA error would
    surface) fails that task; the scheduler retries it and the job answers
    as a clean run does."""
    from ballista_tpu_torch.ops import stage as port_stage

    cluster = _cluster("port")
    try:
        ctx = _client("port", cluster, NO_CACHE)
        ctx.register_parquet("t", tpath)
        q = f"{GROUP_SQL} order by k"
        clean = ctx.sql(q).collect()
        reset_port()
        real_run = port_stage.FusedAggregateStage.run
        fired = threading.Event()

        def failing_run(self, partition, tctx):
            if not fired.is_set():
                fired.set()
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            return real_run(self, partition, tctx)

        monkeypatch.setattr(port_stage.FusedAggregateStage, "run", failing_run)
        _stats("port", "recovery_stats")
        out = ctx.sql(q).collect()
        rec = _stats("port", "recovery_stats")
        ctx.close()
    finally:
        cluster.shutdown()
    assert fired.is_set()
    assert out.equals(clean)
    assert rec.get("task_retry", 0) >= 1, rec
    assert rec.get("job_failed_exhausted", 0) == 0, rec


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_fleet_grows_under_backlog_and_drains_idle(pkg, tmp_path):
    """tests/test_elastic_shuffle.py:599 on both packages: a burst of jobs
    grows the fleet toward ballista.fleet.max, every job answers as the
    fixed fleet did, the idle fleet drains back to ballista.fleet.min with
    zero retries; in the port every spawned executor runs on the cluster's
    device."""
    rng = np.random.default_rng(5)
    n = 20_000
    table = pa.table({
        "g": pa.array(rng.integers(0, 9, n), type=pa.int64()),
        "v": pa.array(rng.integers(-100, 100, n), type=pa.int64()),
    })
    sql = "select g, sum(v) as s, count(*) as c from t group by g order by g"
    pb = _mod(pkg, "proto.ballista_pb2")
    _stats(pkg, "fleet_stats")
    _stats(pkg, "recovery_stats")
    cluster = _cluster(pkg, {"ballista.fleet.min": "1", "ballista.fleet.max": "3",
                             "ballista.fleet.interval_s": "0.1",
                             "ballista.fleet.target_backlog_s": "0.05"},
                       n_executors=1)
    try:
        ctx = _client(pkg, cluster, {"ballista.shuffle.tier": "shared",
                                     "ballista.shuffle.dir": str(tmp_path / "store"),
                                     "ballista.shuffle.partitions": "8", **NO_CACHE})
        ctx.register_record_batches("t", table, n_partitions=8)
        ref = ctx.sql(sql).collect()
        jobs = [ctx.submit(ctx.sql(sql).logical_plan()) for _ in range(4)]
        peak, devices = cluster.fleet_size(), set()
        deadline = time.time() + 60
        while time.time() < deadline:
            peak = max(peak, cluster.fleet_size())
            if pkg == "port":
                with cluster._fleet_mu:
                    devices |= {ex.device for ex in cluster.executors}
            states = [ctx._client.get_job_status(pb.GetJobStatusParams(job_id=j))
                      .status.WhichOneof("status") for j in jobs]
            if all(s in ("completed", "failed") for s in states):
                break
            time.sleep(0.05)
        assert states == ["completed"] * len(jobs), states
        for j in jobs:
            assert ctx._collect_results(j, ref.schema).equals(ref), j
        assert _wait_for(lambda: cluster.fleet_size() == 1, timeout=30.0)
        ctx.close()
    finally:
        cluster.shutdown()
    fleet = _stats(pkg, "fleet_stats")
    assert peak > 1, f"fleet never grew (peak {peak})"
    assert fleet.get("scale_up", 0) >= 1 and fleet.get("scale_down", 0) >= 1, fleet
    assert fleet.get("drain_completed", 0) >= fleet.get("scale_down", 0), fleet
    assert _stats(pkg, "recovery_stats").get("task_retry", 0) == 0
    if pkg == "port":
        assert devices == {cluster.device}, devices


def test_dbapi_through_both_clusters(clusters, tpath):
    """client/dbapi.py over each package's cluster: the same rows, the same
    column descriptions."""
    out = {}
    for pkg, cluster in clusters.items():
        kw = {"device": "cpu"} if pkg == "port" else {}
        dbapi = _mod(pkg, "client.dbapi")
        conn = dbapi.connect(*cluster.scheduler_addr, settings=NO_CACHE, **kw)
        try:
            conn.context.register_parquet("t", tpath)
            cur = conn.cursor()
            cur.execute("select k, count(*) as n from t where k > ? group by k order by k",
                        [2])
            # type codes are each package's own objects: compare their kind
            out[pkg] = ([d[0] for d in cur.description], cur.fetchall(),
                        [(c[0], c[1] == dbapi.NUMBER, *c[2:])
                         for c in conn.get_columns("t")])
        finally:
            conn.close()
    assert out["port"] == out["reference"]
    assert out["port"][1] == [(k, 86 if k < 5 else 85) for k in (3, 4, 5, 6)]


def test_chaos_sites_fire_at_the_reference_decisions():
    """utils/chaos.py: the serving tier's sites draw the JAX package's
    verdicts for the same seed, rate and keys (attempt-keyed task sites,
    the scheduler's write sequences, the advancement publish)."""
    keys = [f"{s}/{p}@a{a}" for s in range(1, 5) for p in range(8) for a in range(3)]
    keys += [f"put{i}" for i in range(64)] + [f"advance{i}" for i in range(16)]
    sites = ("task.execute", "task.slow", "flight.fetch", "kv.put",
             "scheduler.plan_write", "cache.advance")
    for seed in (7, 19, 90):
        for rate in (0.05, 0.3):
            port = _mod("port", "utils.chaos").ChaosInjector(seed, rate)
            ref = _mod("reference", "utils.chaos").ChaosInjector(seed, rate)
            for site in sites:
                got = [port.should_inject(site, k) for k in keys]
                assert got == [ref.should_inject(site, k) for k in keys], (seed, rate, site)
                assert any(got) or rate < 0.1, (seed, rate, site)


def test_failed_duplicate_is_not_relaunched_onto_its_executor():
    """The port's scheduler keeps maybe_speculate's contract ("never on an
    executor that failed a previous attempt of it") for a failed duplicate
    too: after e2's duplicate fails, e2 gets no new duplicate of the same
    straggler (the JAX package relaunches one at once, and a duplicate that
    fails its fetch then fails again in a loop); another executor may."""
    pb = _mod("port", "proto.ballista_pb2")
    costmodel = _mod("port", "ops.costmodel")
    from ballista_tpu_torch.physical.basic import EmptyExec

    costmodel.reset()
    state = _mod("port", "scheduler.state").SchedulerState(
        _mod("port", "scheduler.kv").MemoryBackend(), "t",
        config=_mod("port", "config").BallistaConfig({
            "ballista.tpu.cost_model_dir": "",
            "ballista.speculation.min_runtime_ms": "0",
            "ballista.speculation.multiplier": "2"}))
    running = pb.JobStatus()
    running.running.SetInParent()
    state.save_job_metadata("j", running)
    for e in ("e1", "e2", "e3"):
        state.save_executor_metadata(pb.ExecutorMetadata(id=e, host="h", port=1))
    state.save_stage_plan("j", 1, EmptyExec(True, pa.schema([("a", pa.int64())])))
    task = pb.TaskStatus()
    task.partition_id.job_id, task.partition_id.stage_id = "j", 1
    state.save_task_status(task)
    assert state.assign_next_schedulable_task("e1") is not None
    costmodel.seed(state._task_run_op("j", 1), 1.0, 0.001, engine="task")
    owner, attempt, t0 = state._running_since[("j", 1, 0)]
    state._running_since[("j", 1, 0)] = (owner, attempt, t0 - 5.0)
    _stats("port", "speculation_stats")
    dup, _plan = state.maybe_speculate("e2")
    failed = pb.TaskStatus()
    failed.CopyFrom(dup)
    failed.failed.error = "duplicate died"
    assert not state.accept_task_status(failed)
    assert state.maybe_speculate("e2") is None
    relaunched = state.maybe_speculate("e3")
    assert relaunched is not None and relaunched[0].speculative
    stats = _stats("port", "speculation_stats")
    assert stats.get("launched") == 2 and stats.get("failed") == 1, stats
    costmodel.reset()


def test_push_pump_ends_when_the_subscriber_lease_lapsed(monkeypatch):
    """A subscribed executor whose lease lapsed (its heartbeat slower than
    the lease) and a straggler to speculate: the port's pump returns. The
    JAX package's pump spins here for ever under the KV lock: the
    straggler monitor drops the duplicate of a lapsed executor and
    launches it again with the same attempt number, which takes no new
    push credit."""
    import ballista_tpu_torch.scheduler.state as state_mod
    from ballista_tpu_torch.physical.basic import EmptyExec
    from ballista_tpu_torch.scheduler.server import SchedulerServer, _PushSubscriber

    pb = _mod("port", "proto.ballista_pb2")
    costmodel = _mod("port", "ops.costmodel")
    costmodel.reset()
    server = SchedulerServer(
        _mod("port", "scheduler.kv").MemoryBackend(), synchronous_planning=True,
        config=_mod("port", "config").BallistaConfig({
            **NO_CACHE, "ballista.tpu.cost_model_dir": "",
            "ballista.speculation.min_runtime_ms": "0",
            "ballista.speculation.multiplier": "2"}))
    state = server.state
    running = pb.JobStatus()
    running.running.SetInParent()
    state.save_job_metadata("j", running)
    state.save_executor_metadata(pb.ExecutorMetadata(id="e1", host="h", port=1))
    monkeypatch.setattr(state_mod, "EXECUTOR_LEASE_SECS", 0.05)
    state.save_executor_metadata(pb.ExecutorMetadata(id="e2", host="h", port=1))
    state.save_stage_plan("j", 1, EmptyExec(True, pa.schema([("a", pa.int64())])))
    task = pb.TaskStatus()
    task.partition_id.job_id, task.partition_id.stage_id = "j", 1
    state.save_task_status(task)
    assert state.assign_next_schedulable_task("e1") is not None
    costmodel.seed(state._task_run_op("j", 1), 1.0, 0.001, engine="task")
    owner, attempt, t0 = state._running_since[("j", 1, 0)]
    state._running_since[("j", 1, 0)] = (owner, attempt, t0 - 5.0)
    assert _wait_for(lambda: "e2" not in {m.id for m in state.get_executors_metadata()})
    sub = _PushSubscriber("e2", slots=2)
    with server._push_mu:
        server._subscribers["e2"] = sub
    pushed = []

    def pump():
        with state.kv.lock():
            pushed.append(server._pump_one_locked(sub))

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    th.join(10)
    assert not th.is_alive(), "the push pump spins"
    assert pushed == [0] and sub.queue.qsize() == 0
    costmodel.reset()
