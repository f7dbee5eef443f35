"""The port's differential sweep, chaos generators: the counterparts of
tests/test_fuzz_device.py's two-stage chaos, shared-tier chaos and
exchange chaos generators, with the same rng streams (14000+ / 15000+,
24000+ / 25000+, 26000+ / 27000+), seed ranges, chaos sites and rates,
through the port's StandaloneCluster(device="cpu") on its "cuda" backend.

Every chaotic run is bit-equal to its clean run, and each clean answer is
held to the JAX package's "cpu" backend with the reference's _compare
tolerance (test_torch_fuzz_cluster.clean_answers).

Executor death is keyed on poll numbers (local-0 dies at a poll from 4 to
16, local-1 lives through 400). Under push dispatch polls are heartbeats
whose interval doubles while the stream is healthy, so a short run can end
before poll 4 and no executor dies (the reference's
test_fuzz_exchange_chaos[0] can fail so). Here the death runs set
ballista.executor.idle_poll_max_s to POLL_MAX_S, the 0.25 s floor the
config allows, so the heartbeat never decays and local-0 reaches its death
poll within its first second; and they submit every query, wait for that
death, and only then collect the answers, so the death falls inside the
run whatever its length.
"""

import time

import numpy as np
import pytest

import ballista_tpu_torch.scheduler.state as state_mod
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.executor.runtime import StandaloneCluster
from ballista_tpu_torch.ops import costmodel, exchange
from ballista_tpu_torch.ops.runtime import (
    exchange_stats,
    recovery_stats,
    shuffle_tier_stats,
)
from ballista_tpu_torch.utils.chaos import ChaosInjector
from test_fuzz_device import _distributed_fuzz_queries
from test_torch_fuzz_cluster import (
    assert_bit_equal,
    clean_answers,
    clean_cluster,  # noqa: F401 (module fixture)
    fuzz_table,
    run_distributed,
)
from test_torch_layout_cache import reset_port

POLL_MAX_S = "0.25"
# local-0 dies at its 4th poll, at most ~1 s after it starts
DEATH_WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _fresh():
    reset_port()
    costmodel.reset(clear_dir=True)
    yield
    reset_port()
    costmodel.reset(clear_dir=True)


def _death_seed() -> int:
    """A seed where local-0 dies within its first polls and local-1 lives
    (pure hashing, scanned as the reference scans it)."""
    for cand in range(2000):
        inj = ChaosInjector(cand, 0.005, sites={"executor.death"})

        def death_poll(eid, horizon):
            for k in range(1, horizon):
                if inj.should_inject("executor.death", f"{eid}/poll{k}"):
                    return k
            return None

        d0 = death_poll("local-0", 17)
        if d0 is not None and 4 <= d0 and death_poll("local-1", 400) is None:
            return cand
    pytest.fail("no death seed in scan range")


def _death_cluster() -> dict:
    return {
        "ballista.chaos.rate": "0.005",
        "ballista.chaos.seed": str(_death_seed()),
        "ballista.chaos.sites": "executor.death",
        "ballista.shuffle.max_task_retries": "5",
        "ballista.executor.idle_poll_max_s": POLL_MAX_S,
    }


def _run_through_the_death(table, queries, client: dict, config: dict):
    """Submits every query, waits for local-0's seeded death, then collects
    (under a 1 s executor lease, so the loss is noticed within the run).
    Returns the answers and the registry keys local-0 left while its cluster
    still runs."""
    old_lease = state_mod.EXECUTOR_LEASE_SECS
    state_mod.EXECUTOR_LEASE_SECS = 1.0
    cluster = StandaloneCluster(n_executors=2, config=BallistaConfig(config),
                                device="cpu")
    try:
        dying = cluster.executors[0]
        assert dying.id == "local-0"
        ctx = BallistaContext(*cluster.scheduler_addr, settings=client,
                              device="cpu")
        try:
            ctx.register_record_batches("t", table, n_partitions=4)
            plans = [ctx.sql(sql).logical_plan() for sql in queries]
            jobs = [ctx.submit(plan) for plan in plans]
            deadline = time.time() + DEATH_WAIT_S
            while not dying.poll_loop._stop.is_set():
                assert time.time() < deadline, "local-0 never reached its death poll"
                time.sleep(0.01)
            out = [ctx._collect_results(job, plan.schema(), timeout=120)
                   for job, plan in zip(jobs, plans)]
        finally:
            ctx.close()
        with exchange._reg_lock:
            left = [k for k in exchange._entries if k[0] == "local-0"]
        return out, left
    finally:
        cluster.shutdown()
        state_mod.EXECUTOR_LEASE_SECS = old_lease


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_distributed_two_stage_chaos(clean_cluster, seed):  # noqa: F811
    """Task and fetch faults from the client's settings, KV-write and torn
    planning-write faults from the cluster's: bit-equal to the clean run."""
    rng = np.random.default_rng(14000 + seed)
    qrng = np.random.default_rng(15000 + seed)
    table = fuzz_table(rng, 2_000, 8_000)
    queries = _distributed_fuzz_queries(qrng)
    clean = clean_answers(clean_cluster, table, queries)
    chaos_client = {
        "ballista.shuffle.partitions": "4",
        "ballista.chaos.rate": "0.05",
        "ballista.chaos.seed": str(70 + seed),
        "ballista.chaos.sites": "task.execute,flight.fetch",
        "ballista.shuffle.max_task_retries": "5",
    }
    chaos_cluster = {
        "ballista.chaos.rate": "0.02",
        "ballista.chaos.seed": str(70 + seed),
        "ballista.chaos.sites": "kv.put,scheduler.plan_write",
        "ballista.shuffle.max_task_retries": "5",
    }
    recovery_stats(reset=True)
    chaotic = run_distributed(table, queries, chaos_client, chaos_cluster)
    stats = recovery_stats(reset=True)
    assert_bit_equal(queries, clean, chaotic)
    assert stats.get("chaos_injected", 0) > 0, stats


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_shared_tier_chaos(clean_cluster, seed, tmp_path):  # noqa: F811
    """The shared shuffle tier under torn storage publishes and reads, plus
    a seeded executor death: bit-equal to the local-tier clean run."""
    rng = np.random.default_rng(24000 + seed)
    qrng = np.random.default_rng(25000 + seed)
    table = fuzz_table(rng, 2_000, 8_000)
    queries = _distributed_fuzz_queries(qrng)
    clean = clean_answers(clean_cluster, table, queries)
    chaos_client = {
        "ballista.shuffle.partitions": "4",
        "ballista.shuffle.tier": "shared",
        "ballista.shuffle.dir": str(tmp_path / f"store{seed}"),
        # the storage ladder under torn publishes; the registry would serve
        # same-executor reads first (test_fuzz_exchange_chaos covers it)
        "ballista.tpu.exchange": "false",
        "ballista.chaos.rate": "0.05",
        "ballista.chaos.seed": str(170 + seed),
        "ballista.chaos.sites": "shuffle.store",
        "ballista.shuffle.max_task_retries": "5",
    }
    recovery_stats(reset=True)
    shuffle_tier_stats(reset=True)
    chaotic, _left = _run_through_the_death(table, queries, chaos_client,
                                           _death_cluster())
    stats = recovery_stats(reset=True)
    tier = shuffle_tier_stats(reset=True)
    assert_bit_equal(queries, clean, chaotic)
    assert stats.get("chaos_injected", 0) > 0, stats
    assert stats.get("chaos_executor_death", 0) >= 1, stats
    assert tier.get("storage_publish", 0) > 0, tier
    assert tier.get("storage_fetch", 0) > 0, tier


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_exchange_chaos(clean_cluster, seed):  # noqa: F811
    """The exchange registry on, its consume-time probes torn by
    exchange.evict chaos, plus a seeded executor death: bit-equal to the
    clean run with the registry off; the dead executor leaves no entry."""
    rng = np.random.default_rng(26000 + seed)
    qrng = np.random.default_rng(27000 + seed)
    table = fuzz_table(rng, 2_000, 8_000)
    queries = _distributed_fuzz_queries(qrng)
    clean = clean_answers(clean_cluster, table, queries,
                          **{"ballista.tpu.exchange": "false"})
    chaos_client = {
        "ballista.shuffle.partitions": "4",
        "ballista.chaos.rate": "0.3",
        "ballista.chaos.seed": str(190 + seed),
        "ballista.chaos.sites": "exchange.evict",
        "ballista.shuffle.max_task_retries": "5",
    }
    exchange.reset()
    exchange_stats(reset=True)
    recovery_stats(reset=True)
    chaotic, left = _run_through_the_death(table, queries, chaos_client,
                                          _death_cluster())
    stats = recovery_stats(reset=True)
    ex = exchange_stats(reset=True)
    assert_bit_equal(queries, clean, chaotic)
    assert stats.get("chaos_injected", 0) > 0, stats
    assert stats.get("chaos_executor_death", 0) >= 1, stats
    assert ex.get("published", 0) > 0, ex
    assert ex.get("evicted_chaos", 0) >= 1, ex
    assert left == [], left
