"""Device-resident exchange scenario (bench.py `_exchange_scenario`): a
two-stage aggregation on one executor, run with the exchange registry on
(the reduce side resolves its map pieces from the registry: no decode, no
re-upload), off (the Arrow piece ladder, the bit-identity oracle), and on
under seeded exchange.evict chaos (every probe torn: reads fall back to
the ladder with zero task retries). Knobs: BENCH_EXCHANGE_ROWS (60000),
BENCH_EXCHANGE_SEED (5)."""

from __future__ import annotations

import os
import sys
import time

from ballista_tpu_torch.bench import device_arg, synchronize
from ballista_tpu_torch.bench.scenarios import digest_ipc
from ballista_tpu_torch.bench.tpch import AnswerMismatch
from ballista_tpu_torch.utils import counters


def _exchange_scenario(device=None) -> dict:
    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.ops import exchange

    n_rows = int(os.environ.get("BENCH_EXCHANGE_ROWS", "60000"))
    chaos_seed = int(os.environ.get("BENCH_EXCHANGE_SEED", "5"))
    dev = device_arg(device)
    rng = np.random.default_rng(16)
    table = pa.table({
        "g": pa.array(rng.integers(0, 13, n_rows), type=pa.int64()),
        "v": pa.array(np.round(rng.uniform(-100, 100, n_rows), 2)),
        "q": pa.array(rng.integers(1, 50, n_rows), type=pa.int64()),
    })
    sql = ("select g, sum(v) as s, min(q) as mn, max(q) as mx, count(*) as n "
           "from t group by g order by g")

    def run(settings):
        exchange.reset()
        counters.exchange.stats(reset=True)
        counters.recovery.stats(reset=True)
        cluster = StandaloneCluster(n_executors=1, device=dev)
        try:
            ctx = BallistaContext(*cluster.scheduler_addr, device=dev, settings={
                "ballista.shuffle.partitions": "8",
                "ballista.cache.results": "false",
                **settings,
            })
            ctx.register_record_batches("t", table, n_partitions=8)
            t0 = time.perf_counter()
            out = ctx.sql(sql).collect()
            synchronize(device)
            dt = time.perf_counter() - t0
            ctx.close()
        finally:
            cluster.shutdown()
        return out, dt, counters.exchange.stats(reset=True), counters.recovery.stats(reset=True)

    on_out, on_dt, on_stats, on_rec = run({})
    off_out, off_dt, off_stats, _ = run({"ballista.tpu.exchange": "false"})
    chaos_out, chaos_dt, chaos_stats, chaos_rec = run({
        "ballista.chaos.rate": "1.0",
        "ballista.chaos.seed": str(chaos_seed),
        "ballista.chaos.sites": "exchange.evict",
    })

    bit_identical = on_out.equals(off_out) and chaos_out.equals(off_out)
    result = {
        "rows": n_rows,
        "digest": digest_ipc(off_out),
        "bit_identical": bit_identical,
        "on_ms": round(on_dt * 1000, 1),
        "off_ms": round(off_dt * 1000, 1),
        "chaos_ms": round(chaos_dt * 1000, 1),
        "published": int(on_stats.get("published", 0)),
        "reupload_skipped": int(on_stats.get("reupload_skipped", 0)),
        "h2d_bytes_saved": int(on_stats.get("h2d_bytes_saved", 0)),
        "served_from_registry": int(on_stats.get("served_from_registry", 0)),
        "d2h_bytes_saved": int(on_stats.get("d2h_bytes_saved", 0)),
        "off_stats_empty": off_stats == {},
        "task_retries": int(on_rec.get("task_retry", 0)),
        "chaos": {
            "evicted_chaos": int(chaos_stats.get("evicted_chaos", 0)),
            "miss": int(chaos_stats.get("miss", 0)),
            "injected": int(chaos_rec.get("chaos_injected", 0)),
            "task_retries": int(chaos_rec.get("task_retry", 0)),
        },
    }
    print(f"[exchange] reupload_skipped={result['reupload_skipped']} "
          f"h2d_bytes_saved={result['h2d_bytes_saved']} "
          f"d2h_bytes_saved={result['d2h_bytes_saved']} "
          f"chaos_evicted={result['chaos']['evicted_chaos']} "
          f"bit_identical={bit_identical}", file=sys.stderr)
    if not bit_identical:
        raise AnswerMismatch(f"exchange: the three runs' answers differ: {result}")
    return result
