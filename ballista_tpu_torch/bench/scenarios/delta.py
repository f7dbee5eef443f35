"""Incremental-execution scenario (bench.py `_delta_scenario`): a cached
aggregation over a growing Parquet chunk set, four ways: chunk reuse
through the persisted layout store after an append (chunks_reused >= 1);
advancement through a cluster (advance_hits >= 1, bit-equal to a cold full
run); a torn publish under cache.advance chaos (declined, a full
recompute, still bit-equal); and the advanced entry served as a cache hit
across a scheduler restart. Knobs: BENCH_DELTA_ROWS (50000 per file),
BENCH_DELTA_SEED (19)."""

from __future__ import annotations

import os
import sys
import tempfile
import time

from ballista_tpu_torch.bench import device_arg, synchronize
from ballista_tpu_torch.bench.scenarios import digest_ipc
from ballista_tpu_torch.bench.tpch import AnswerMismatch
from ballista_tpu_torch.utils import counters


def _delta_scenario(device=None) -> dict:
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.ops.runtime import reset_residency
    from ballista_tpu_torch.scheduler.kv import SqliteBackend

    n_rows = int(os.environ.get("BENCH_DELTA_ROWS", "50000"))
    chaos_seed = int(os.environ.get("BENCH_DELTA_SEED", "19"))
    dev = device_arg(device)
    sql = ("select g, sum(v) as sv, count(*) as c, min(v) as mn "
           "from t where w > -5 group by g order by g")

    def write_part(d, i):
        rng = np.random.default_rng(190 + i)
        pq.write_table(pa.table({
            "g": pa.array(rng.integers(0, 7, n_rows), type=pa.int64()),
            "v": pa.array(rng.integers(-50, 50, n_rows), type=pa.int64()),
            "w": pa.array(rng.integers(-10, 10, n_rows), type=pa.int64()),
        }), os.path.join(d, f"part-{i}.parquet"))

    def reset_stage_caches():
        # a fresh process: the chunk-reuse leg must reload tiles from the
        # persisted store, not from this process's stage cache
        kernels.clear_stage_cache()
        reset_residency()

    # -- leg 1: chunk reuse through the persisted layout store --------------
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as cache_dir:
        write_part(d, 0)
        write_part(d, 1)

        def engine_run():
            ctx = ExecutionContext(BallistaConfig({
                "ballista.executor.backend": "cuda",
                "ballista.tpu.layout_cache_dir": cache_dir,
                "ballista.batch.size": "4096",
            }), device=dev)
            ctx.register_parquet("t", d)
            return ctx.sql(sql).collect()

        counters.delta.stats(reset=True)
        engine_run()
        write_part(d, 2)
        reset_stage_caches()
        engine_run()
        chunk_stats = counters.delta.stats(reset=True)
        reset_stage_caches()

    def cluster_run(d, cluster, settings=None):
        ctx = BallistaContext(*cluster.scheduler_addr, device=dev, settings={
            "ballista.cache.advance": "true",
            **(settings or {}),
        })
        ctx.register_parquet("t", d)
        t0 = time.perf_counter()
        out = ctx.sql(sql).collect()
        synchronize(device)
        dt = time.perf_counter() - t0
        ctx.close()
        return out, dt

    # -- leg 2: advancement vs cold full run --------------------------------
    with tempfile.TemporaryDirectory() as d:
        write_part(d, 0)
        write_part(d, 1)
        cluster = StandaloneCluster(n_executors=2, device=dev)
        try:
            counters.delta.stats(reset=True)
            cluster_run(d, cluster)
            write_part(d, 2)
            adv_out, adv_dt = cluster_run(d, cluster)
            adv_stats = counters.delta.stats(reset=True)
            no_cache = {"ballista.cache.results": "false"}
            cold_out, cold_dt = cluster_run(d, cluster, settings=no_cache)
            cold_dt = min(cold_dt, cluster_run(d, cluster, settings=no_cache)[1])
        finally:
            cluster.shutdown()

    # -- leg 3: torn publish under cache.advance chaos ----------------------
    with tempfile.TemporaryDirectory() as d:
        write_part(d, 0)
        write_part(d, 1)
        chaos_cfg = BallistaConfig({
            "ballista.chaos.seed": str(chaos_seed),
            "ballista.chaos.rate": "1.0",
            "ballista.chaos.sites": "cache.advance",
        })
        cluster = StandaloneCluster(n_executors=2, config=chaos_cfg, device=dev)
        try:
            counters.delta.stats(reset=True)
            cluster_run(d, cluster)
            write_part(d, 2)
            chaos_out, _ = cluster_run(d, cluster)
            chaos_stats = counters.delta.stats(reset=True)
        finally:
            cluster.shutdown()

    # -- leg 4: advanced entry across a scheduler restart -------------------
    with tempfile.TemporaryDirectory() as d:
        write_part(d, 0)
        write_part(d, 1)
        kv = SqliteBackend.temporary()
        cluster = StandaloneCluster(n_executors=1, kv=kv, device=dev)
        try:
            counters.delta.stats(reset=True)
            cluster_run(d, cluster)
            write_part(d, 2)
            cluster_run(d, cluster)
            restart_advanced = counters.delta.stats(reset=True).get("advance_hits", 0) >= 1
            cluster.restart_scheduler()
            counters.tenancy.stats(reset=True)
            restart_out, _ = cluster_run(d, cluster)
            restart_hit = counters.tenancy.stats(reset=True).get("cache_hit", 0) >= 1
        finally:
            cluster.shutdown()

    bit_identical = (adv_out.equals(cold_out) and chaos_out.equals(cold_out)
                     and restart_out.equals(cold_out))
    result = {
        "rows_per_file": n_rows,
        "digest": digest_ipc(cold_out),
        "bit_identical": bit_identical,
        "advance_ms": round(adv_dt * 1000, 1),
        "cold_ms": round(cold_dt * 1000, 1),
        "speedup": round(cold_dt / adv_dt, 2) if adv_dt else None,
        "chunks_reused": int(chunk_stats.get("chunks_reused", 0)),
        "chunks_prepared": int(chunk_stats.get("chunks_prepared", 0)),
        "bytes_reprepared_saved": int(chunk_stats.get("bytes_reprepared_saved", 0)),
        "advance_hits": int(adv_stats.get("advance_hits", 0)),
        "advance_declined": int(adv_stats.get("advance_declined", 0)),
        "chaos": {
            "advance_hits": int(chaos_stats.get("advance_hits", 0)),
            "advance_declined": int(chaos_stats.get("advance_declined", 0)),
        },
        "restart_advanced": restart_advanced,
        "restart_cache_hit": restart_hit,
    }
    print(f"[delta] advance_ms={result['advance_ms']} cold_ms={result['cold_ms']} "
          f"chunks_reused={result['chunks_reused']} advance_hits={result['advance_hits']} "
          f"bit_identical={bit_identical}", file=sys.stderr)
    if not bit_identical:
        raise AnswerMismatch(f"delta: the advanced, torn and restarted answers differ "
                             f"from the full run's: {result}")
    return result
