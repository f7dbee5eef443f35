"""Recovery on the port's distributed path, held to the JAX package's.

- An executor killed mid-job through the chaos harness (utils/chaos.py:
  "executor.death" at a seed where local-0 dies within its first polls and
  local-1 lives; task and fetch faults beside it) gives answers
  bit-identical to a clean run, in both packages with the same seed, and
  the two packages' injectors give the same verdicts.
- A scheduler crashed mid-job (seeded "scheduler.crash") and restarted on
  the same SqliteBackend store resumes the job bit-identical to the clean
  run, re-executing no task an executor still owned.
- The restart probe: a fresh SchedulerState over the live store recovers
  with scheduler_restart == 1, its task index seeded and its running-job
  count equal to the control's.

Both packages run their device backend ("cuda" on CPU tensors in the port,
"tpu" on CPU JAX in the JAX package) over the conftest's sales table.
"""

import importlib
import threading
import time

import pyarrow as pa
import pytest

from ballista_tpu.utils.chaos import ChaosInjector as JaxInjector
from ballista_tpu_torch.utils.chaos import ChaosInjector

PACKAGES = {"port": "ballista_tpu_torch", "reference": "ballista_tpu"}
BACKEND = {"port": "cuda", "reference": "tpu"}
GROUP_BY_SQL = (
    "select region, sum(amount) as s, count(*) as n from sales "
    "group by region order by region"
)
JOIN_SQL = (
    "select region, sum(amount * bonus) as weighted from sales, regions "
    "where region = name group by region order by region"
)
BASE = {"ballista.shuffle.partitions": "4", "ballista.tpu.layout_cache_dir": "",
        "ballista.tpu.cost_model_dir": "", "ballista.cache.results": "false"}
CHAOS = {**BASE, "ballista.chaos.rate": "0.10", "ballista.chaos.seed": "11",
         "ballista.chaos.sites": "task.execute,flight.fetch",
         "ballista.shuffle.max_task_retries": "5"}
RESTART_CLIENT = {**BASE, "ballista.rpc.retries": "20", "ballista.rpc.backoff_ms": "50"}
CRASH_RATE = 0.05


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def _cluster(pkg: str, config: dict, **kw):
    cluster_cls = _mod(pkg, "executor.runtime").StandaloneCluster
    cfg = _mod(pkg, "config").BallistaConfig({**BASE, **config})
    if pkg == "port":
        kw["device"] = "cpu"
    return cluster_cls(n_executors=2, config=cfg, **kw)


def _run(pkg: str, cluster, settings: dict, sales: pa.Table) -> dict:
    client_cls = _mod(pkg, "client").BallistaContext
    kw = {"device": "cpu"} if pkg == "port" else {}
    ctx = client_cls(*cluster.scheduler_addr, settings={
        **settings, "ballista.executor.backend": BACKEND[pkg]}, **kw)
    try:
        ctx.register_record_batches("sales", sales, n_partitions=4)
        ctx.register_record_batches("regions", pa.table(
            {"name": ["east", "west", "north"], "bonus": [1.0, 2.0, 3.0]}))
        return {name: ctx.sql(sql).collect()
                for name, sql in (("group_by", GROUP_BY_SQL), ("join", JOIN_SQL))}
    finally:
        ctx.close()


def _clean(pkg: str, sales: pa.Table) -> dict:
    cluster = _cluster(pkg, {})
    try:
        return _run(pkg, cluster, BASE, sales)
    finally:
        cluster.shutdown()


def _death_seed(injector_cls):
    """A seed where local-0 dies within its first polls and local-1 lives
    through the run (pure hashing, as tests/test_chaos.py scans it)."""
    for seed in range(2000):
        inj = injector_cls(seed, rate=0.005, sites={"executor.death"})

        def death_poll(eid, horizon):
            for n in range(1, horizon):
                if inj.should_inject("executor.death", f"{eid}/poll{n}"):
                    return n
            return None

        d0 = death_poll("local-0", 17)
        if d0 is not None and 4 <= d0 and death_poll("local-1", 400) is None:
            return seed
    pytest.fail("no death seed found in scan range")


def test_chaos_verdicts_match_reference():
    seed = _death_seed(ChaosInjector)
    assert seed == _death_seed(JaxInjector)
    keys = [f"{s}/{p}@a{a}" for s in range(1, 4) for p in range(4) for a in range(3)]
    for site in ("task.execute", "flight.fetch", "executor.death", "scheduler.crash"):
        port, ref = ChaosInjector(11, 0.3), JaxInjector(11, 0.3)
        assert ([port.should_inject(site, k) for k in keys]
                == [ref.should_inject(site, k) for k in keys])


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_executor_death_is_bit_identical(pkg, sales_table):
    state_mod = _mod(pkg, "scheduler.state")
    recovery_stats = _mod(pkg, "ops.runtime").recovery_stats
    injector = ChaosInjector if pkg == "port" else JaxInjector
    clean = _clean(pkg, sales_table)
    old_lease = state_mod.EXECUTOR_LEASE_SECS
    state_mod.EXECUTOR_LEASE_SECS = 1.0
    recovery_stats(reset=True)
    cluster = _cluster(pkg, {"ballista.chaos.rate": "0.005",
                             "ballista.chaos.seed": str(_death_seed(injector)),
                             "ballista.chaos.sites": "executor.death"})
    cluster.scheduler_impl.lost_task_check_interval = 0.3
    try:
        out = _run(pkg, cluster, CHAOS, sales_table)
    finally:
        state_mod.EXECUTOR_LEASE_SECS = old_lease
        cluster.shutdown()
    for name in ("group_by", "join"):
        assert out[name].equals(clean[name]), (name, out[name].to_pydict(),
                                               clean[name].to_pydict())
    stats = recovery_stats(reset=True)
    assert stats.get("chaos_injected", 0) > 0, stats
    assert stats.get("chaos_executor_death", 0) >= 1, stats


def _crash_seed():
    """A seed where generation 0 crashes the scheduler at accepted status
    2-4 and generation 1 survives the run (tests/test_scheduler_restart.py)."""
    for seed in range(20000):
        inj = ChaosInjector(seed, rate=CRASH_RATE, sites={"scheduler.crash"})

        def fires_at(gen, horizon):
            for n in range(1, horizon):
                if inj.should_inject("scheduler.crash", f"g{gen}/status{n}"):
                    return n
            return None

        if fires_at(0, 40) in (2, 3, 4) and fires_at(1, 120) is None:
            return seed
    pytest.fail("no crash seed found in scan range")


def test_scheduler_crash_and_restart_is_bit_identical(tmp_path, sales_table):
    from ballista_tpu_torch.ops.runtime import recovery_stats
    from ballista_tpu_torch.scheduler.kv import SqliteBackend

    clean = _clean("port", sales_table)
    recovery_stats(reset=True)
    cluster = _cluster("port", {
        "ballista.chaos.rate": str(CRASH_RATE), "ballista.chaos.seed": str(_crash_seed()),
        "ballista.chaos.sites": "scheduler.crash",
        "ballista.rpc.retries": "20", "ballista.rpc.backoff_ms": "50",
    }, kv=SqliteBackend(str(tmp_path / "sched.db")))
    stop = threading.Event()

    def supervisor():
        # restart the scheduler on the same store once the crash fires
        while not stop.is_set():
            if cluster.scheduler_impl.crashed:
                cluster.restart_scheduler()
            time.sleep(0.02)

    sup = threading.Thread(target=supervisor, daemon=True)
    sup.start()
    try:
        out = _run("port", cluster, RESTART_CLIENT, sales_table)
    finally:
        stop.set()
        sup.join(timeout=5)
        cluster.shutdown()
    for name in ("group_by", "join"):
        assert out[name].equals(clean[name]), name
    stats = recovery_stats(reset=True)
    assert stats.get("chaos_scheduler_crash", 0) >= 1, stats
    assert stats.get("scheduler_restart", 0) >= 1, stats
    assert stats.get("restart_job_resumed", 0) >= 1, stats
    assert stats.get("task_retry", 0) == 0 and stats.get("orphan_reassigned", 0) == 0, stats


def test_restart_probe_rebuilds_derived_state(sales_table):
    from ballista_tpu_torch.scheduler.state import SchedulerState

    cluster = _cluster("port", {})
    try:
        first = _run("port", cluster, BASE, sales_table)
        control = cluster.scheduler_impl.state
        replica = SchedulerState(control.kv, control.namespace)
        stats = replica.recover()
        assert stats.get("scheduler_restart") == 1, stats
        assert replica._task_index is not None
        assert replica._rc_count == control._ensure_rc_count()
        # the restarted state serves the next jobs: answers bit-identical
        again = _run("port", cluster, BASE, sales_table)
    finally:
        cluster.shutdown()
    for name in ("group_by", "join"):
        assert again[name].equals(first[name]), name
