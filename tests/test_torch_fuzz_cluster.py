"""The port's differential sweep, cluster generators: the counterparts of
tests/test_fuzz_device.py's concurrent-submission, speculation, delta-append
and replica-failover generators, with the same rng streams (16000+ /
17000+, 20000+ / 21000+, 28000+ / 29000+, 30000+ / 31000+) and seed
ranges, through the port's StandaloneCluster(device="cpu") on its default
"cuda" backend.

Where the reference asserts bit identity, so does the port: every replayed
or cache-served answer against a cache-off run, a speculated run against
its clean pass, an advanced result against a cache-off full run over the
grown set, failover against no failover. Each clean answer is also held
against the JAX package's "cpu" backend over the same table with the
reference's _compare tolerance (the cluster sums f32 partials in another
order). The clean runs share one cluster per module (the reference builds
one per seed; the answers do not depend on it).
"""

import logging
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.executor.runtime import StandaloneCluster
from ballista_tpu_torch.ops import costmodel
from ballista_tpu_torch.ops.runtime import (
    delta_stats,
    recovery_stats,
    speculation_stats,
    tenancy_stats,
)
from test_fuzz_device import _compare, _delta_fuzz_queries, _distributed_fuzz_queries
from test_torch_layout_cache import reset_port

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
logging.getLogger("ballista").setLevel(logging.CRITICAL)

CLEAN = {"ballista.shuffle.partitions": "4", "ballista.cache.results": "false"}


@pytest.fixture(autouse=True)
def _fresh():
    reset_port()
    costmodel.reset(clear_dir=True)
    yield
    reset_port()
    costmodel.reset(clear_dir=True)


@pytest.fixture(scope="module")
def clean_cluster():
    """One cluster for every clean (fault-free, cache-off) baseline."""
    cluster = StandaloneCluster(n_executors=2, device="cpu")
    try:
        yield cluster
    finally:
        cluster.shutdown()


def fuzz_table(rng, lo: int, hi: int, groups: int = 50) -> pa.Table:
    """The reference generators' 2-stage table, drawn in their order."""
    n = int(rng.integers(lo, hi))
    return pa.table({
        "g": pa.array(rng.integers(0, groups, n), type=pa.int64()),
        "v": pa.array(np.round(rng.uniform(-100, 100, n), 2)),
        "q": pa.array(rng.integers(1, 50, n), type=pa.int64()),
        "s": pa.array([f"t{x}" for x in rng.integers(0, 5, n)]),
    })


def run_queries(cluster, table: pa.Table, queries, settings: dict,
                **client_kw) -> list:
    ctx = BallistaContext(*cluster.scheduler_addr, settings=settings,
                          device="cpu", **client_kw)
    try:
        ctx.register_record_batches("t", table, n_partitions=4)
        return [ctx.sql(sql).collect() for sql in queries]
    finally:
        ctx.close()


def run_distributed(table: pa.Table, queries, settings: dict,
                    cluster_config: dict = None) -> list:
    """The reference's _run_distributed on the port: a fresh two-executor
    cluster, shut down in a finally."""
    cluster = StandaloneCluster(
        n_executors=2, config=BallistaConfig(cluster_config or {}),
        device="cpu")
    try:
        return run_queries(cluster, table, queries, settings)
    finally:
        cluster.shutdown()


def clean_answers(cluster, table: pa.Table, queries, **settings) -> list:
    """Fault-free, cache-off answers, each held to the JAX package's host
    backend over the same table."""
    out = run_queries(cluster, table, queries, {**CLEAN, **settings})
    jax_ctx = JaxContext(JaxConfig({"ballista.executor.backend": "cpu"}))
    jax_ctx.register_record_batches("t", table, n_partitions=4)
    for sql, got in zip(queries, out):
        _compare(got, jax_ctx.sql(sql).collect(), sql)
    return out


def assert_bit_equal(queries, expected, got) -> None:
    for sql, e, g in zip(queries, expected, got):
        assert g.equals(e), (sql, g.to_pydict(), e.to_pydict())


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_concurrent_submission_cache(clean_cluster, seed):
    """Four tenants replay a Zipf-repeated mix against one cluster with the
    result cache on: every answer, cache-served or cold, bit-equal to the
    cache-off run, and the repetition produces hits."""
    rng = np.random.default_rng(16000 + seed)
    qrng = np.random.default_rng(17000 + seed)
    table = fuzz_table(rng, 2_000, 6_000, groups=40)
    queries = _distributed_fuzz_queries(qrng, k=4)
    n_tenants = 4
    schedules = [
        [int(z - 1) % len(queries)
         for z in qrng.zipf(1.6, size=int(qrng.integers(4, 7)))]
        for _ in range(n_tenants)
    ]
    cold = clean_answers(clean_cluster, table, queries)
    cluster = StandaloneCluster(n_executors=2, device="cpu")
    try:
        tenancy_stats(reset=True)
        results, errors = {}, []

        def replay(i):
            try:
                results[i] = list(zip(schedules[i], run_queries(
                    cluster, table, [queries[qi] for qi in schedules[i]],
                    {"ballista.tenant.name": f"tenant{i}",
                     "ballista.shuffle.partitions": "4"})))
            except Exception as e:  # surfaced in the main thread
                errors.append((i, e))

        threads = [threading.Thread(target=replay, args=(i,))
                   for i in range(n_tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for i in range(n_tenants):
            for qi, got in results[i]:
                assert got.equals(cold[qi]), (i, queries[qi])
        stats = tenancy_stats(reset=True)
        total = sum(len(s) for s in schedules)
        assert stats.get("cache_hit", 0) > 0, (stats, schedules)
        assert stats.get("cache_hit", 0) + stats.get("cache_miss", 0) >= total
    finally:
        cluster.shutdown()


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_speculation_straggler(seed):
    """Seeded task.slow stragglers with speculation armed (thresholds as the
    reference's, predictions warmed by the clean pass on the same cluster):
    at least one duplicate launches and the answers stay bit-equal to the
    clean pass whoever wins."""
    rng = np.random.default_rng(20000 + seed)
    qrng = np.random.default_rng(21000 + seed)
    table = fuzz_table(rng, 2_000, 8_000)
    queries = _distributed_fuzz_queries(qrng)
    spec_cluster = BallistaConfig({
        "ballista.tpu.cost_model_dir": "",
        "ballista.speculation.min_runtime_ms": "100",
        "ballista.speculation.multiplier": "2",
    })
    base = {**CLEAN, "ballista.tpu.cost_model_dir": ""}
    chaos = {**base, "ballista.chaos.rate": "0.2",
             "ballista.chaos.seed": str(90 + seed),
             "ballista.chaos.sites": "task.slow",
             "ballista.chaos.slow_ms": "2000"}
    cluster = StandaloneCluster(n_executors=2, config=spec_cluster,
                                device="cpu")
    try:
        clean = run_queries(cluster, table, queries, base)
        recovery_stats(reset=True)
        speculation_stats(reset=True)
        chaotic = run_queries(cluster, table, queries, chaos)
        rec = recovery_stats(reset=True)
        spec = speculation_stats(reset=True)
    finally:
        cluster.shutdown()
    jax_ctx = JaxContext(JaxConfig({"ballista.executor.backend": "cpu"}))
    jax_ctx.register_record_batches("t", table, n_partitions=4)
    for sql, got in zip(queries, clean):
        _compare(got, jax_ctx.sql(sql).collect(), sql)
    assert_bit_equal(queries, clean, chaotic)
    assert rec.get("chaos_slow_injected", 0) > 0, rec
    assert spec.get("launched", 0) >= 1, (spec, rec)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_delta_append(tmp_path, seed):
    """Eligible and ineligible aggregations over a Parquet set that grows by
    one file, with the result cache advancing on the append, fault-free and
    with every advanced publish torn by cache.advance chaos: bit-equal to a
    cache-off full run over the grown set, the float sum declining."""
    rng = np.random.default_rng(28000 + seed)
    qrng = np.random.default_rng(29000 + seed)
    d = str(tmp_path / "grow")
    os.makedirs(d)

    def write_part(i):
        n = int(rng.integers(1_000, 4_000))
        pq.write_table(pa.table({
            "g": pa.array(rng.integers(0, 9, n), type=pa.int64()),
            "h": pa.array(rng.integers(0, 3, n), type=pa.int64()),
            "v": pa.array(rng.integers(-100, 100, n), type=pa.int64()),
            "w": pa.array(rng.integers(-10, 10, n), type=pa.int64()),
            "f": pa.array(rng.random(n), type=pa.float64()),
        }), os.path.join(d, f"part-{i}.parquet"))

    write_part(0)
    write_part(1)
    queries = _delta_fuzz_queries(qrng)
    next_part = [2]

    def run_grow(cluster_config=None):
        cluster = StandaloneCluster(
            n_executors=2, config=BallistaConfig(cluster_config or {}),
            device="cpu")
        try:
            ctx = BallistaContext(*cluster.scheduler_addr, settings={
                "ballista.cache.advance": "true"}, device="cpu")
            ctx.register_parquet("t", d)
            for sql in queries:
                ctx.sql(sql).collect()
            write_part(next_part[0])
            next_part[0] += 1
            ctx.register_parquet("t", d)
            grown = [ctx.sql(sql).collect() for sql in queries]
            truth_ctx = BallistaContext(*cluster.scheduler_addr, settings={
                "ballista.cache.results": "false"}, device="cpu")
            truth_ctx.register_parquet("t", d)
            truth = [truth_ctx.sql(sql).collect() for sql in queries]
            ctx.close()
            truth_ctx.close()
            return grown, truth
        finally:
            cluster.shutdown()

    delta_stats(reset=True)
    grown, truth = run_grow()
    stats = delta_stats(reset=True)
    assert_bit_equal(queries, truth, grown)
    jax_ctx = JaxContext(JaxConfig({"ballista.executor.backend": "cpu"}))
    jax_ctx.register_parquet("t", d)
    for sql, got in zip(queries, truth):
        _compare(got, jax_ctx.sql(sql).collect(), sql)
    assert stats.get("advance_hits", 0) >= 1, stats
    assert stats.get("advance_declined", 0) >= 1, stats

    delta_stats(reset=True)
    chaos_grown, chaos_truth = run_grow({
        "ballista.chaos.rate": "1.0",
        "ballista.chaos.seed": str(70 + seed),
        "ballista.chaos.sites": "cache.advance",
    })
    stats = delta_stats(reset=True)
    assert_bit_equal(queries, chaos_truth, chaos_grown)
    assert stats.get("advance_hits", 0) == 0, stats
    assert stats.get("advance_declined", 0) >= 1, stats


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_replica_failover(clean_cluster, seed):
    """Two scheduler replicas over one KV store with scheduler.lease chaos
    and a seeded hard kill of replica 0 partway through: every answer
    bit-equal to the single-scheduler run, and no task re-executed."""
    rng = np.random.default_rng(30000 + seed)
    qrng = np.random.default_rng(31000 + seed)
    table = fuzz_table(rng, 2_000, 6_000)
    queries = _distributed_fuzz_queries(qrng, k=3)
    kill_after = int(rng.integers(1, len(queries)))
    oracle = clean_answers(clean_cluster, table, queries)
    reset_port()
    recovery_stats(reset=True)
    cluster = StandaloneCluster(
        n_executors=2, n_schedulers=2, device="cpu",
        config=BallistaConfig({
            "ballista.scheduler.lease_ttl_s": "0.3",
            "ballista.chaos.rate": "0.25",
            "ballista.chaos.seed": str(90 + seed),
            "ballista.chaos.sites": "scheduler.lease",
        }),
    )
    try:
        ctx = BallistaContext(*cluster.scheduler_addr,
                              settings={"ballista.shuffle.partitions": "4"},
                              endpoints=cluster.scheduler_endpoints,
                              device="cpu")
        ctx.register_record_batches("t", table, n_partitions=4)
        got = []
        for i, sql in enumerate(queries):
            if i == kill_after:
                cluster.kill_scheduler(0)
            got.append(ctx.sql(sql).collect())
        ctx.close()
    finally:
        cluster.shutdown()
    assert_bit_equal(queries, oracle, got)
    stats = recovery_stats(reset=True)
    assert stats.get("task_retry", 0) == 0, stats
