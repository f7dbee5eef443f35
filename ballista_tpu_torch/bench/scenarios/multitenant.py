"""Multi-tenant serving scenario (bench.py `_multitenant_scenario`): N
tenant clients replay a Zipf-repeated dashboard mix against one cluster,
each answer held against the port's "cpu" backend; reports p50 / p99
latency, the result-cache hit rate and the per-tenant task shares.
Knobs: BENCH_MT_TENANTS (4), BENCH_MT_REPLAYS (24)."""

from __future__ import annotations

import os
import sys
import threading
import time

from ballista_tpu_torch.bench import data, device_arg, synchronize
from ballista_tpu_torch.bench.scenarios import ScenarioFailed
from ballista_tpu_torch.bench.tpch import QUERIES_DIR, check_answer
from ballista_tpu_torch.utils import counters
from ballista_tpu_torch.utils.locks import make_lock


def _multitenant_scenario(device=None) -> dict:
    import numpy as np
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.executor.runtime import StandaloneCluster

    n_tenants = int(os.environ.get("BENCH_MT_TENANTS", "4"))
    replays = int(os.environ.get("BENCH_MT_REPLAYS", "24"))
    dev = device_arg(device)
    d = data.ensure_tpch("tpch_mt001", 0.01, 2)
    # the dashboard mix: two real TPC-H shapes + two point-ish aggregates
    queries = [
        (QUERIES_DIR / "q1.sql").read_text(),
        (QUERIES_DIR / "q6.sql").read_text(),
        "select l_returnflag, count(*) as n from lineitem group by "
        "l_returnflag order by l_returnflag",
        "select max(l_extendedprice) as m, min(l_shipdate) as d from lineitem",
    ]
    host = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}), device="cpu")
    register_all(host, str(d))
    want = [host.sql(q).collect() for q in queries]
    cluster = StandaloneCluster(
        n_executors=2, device=dev,
        config=BallistaConfig({"ballista.tenant.max_inflight": "8"}),
    )
    try:
        counters.tenancy.stats(reset=True)
        rng = np.random.default_rng(7)
        schedules = [
            [int(z - 1) % len(queries) for z in rng.zipf(1.5, size=replays)]
            for _ in range(n_tenants)
        ]
        lat_lock = make_lock("bench.scenarios.multitenant.lat_lock")
        samples: list = []  # (query index, seconds); guarded-by: lat_lock
        errors: list = []

        def replay(i: int) -> None:
            try:
                ctx = BallistaContext(*cluster.scheduler_addr, device=dev,
                                      settings={"ballista.tenant.name": f"tenant{i}"})
                register_all(ctx, str(d))
                for qi in schedules[i]:
                    t0 = time.perf_counter()
                    out = ctx.sql(queries[qi]).collect()
                    synchronize(device)
                    dt = time.perf_counter() - t0
                    check_answer(f"multitenant q{qi}", out, want[qi])
                    with lat_lock:
                        samples.append((qi, dt))
                ctx.close()
            except Exception as e:
                errors.append(f"tenant{i}: {e!r}")

        threads = [threading.Thread(target=replay, args=(i,)) for i in range(n_tenants)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        for i, t in enumerate(threads):
            if t.is_alive():
                errors.append(f"tenant{i}: still running after 600s")
        with lat_lock:
            lat = list(samples)
        if errors or not lat:
            raise ScenarioFailed(f"multitenant: {errors or ['no latencies']}")
        stats = counters.tenancy.stats(reset=True)
        shares = cluster.scheduler_impl.state.tenant_task_shares()
        secs = sorted(s for _qi, s in lat)
        hits = stats.get("cache_hit", 0)
        misses = (stats.get("cache_miss", 0) + stats.get("cache_unkeyable", 0)
                  + stats.get("cache_invalidated", 0))
        row = {
            "tenants": n_tenants,
            "queries": len(lat),
            "match": True,
            "wall_s": round(wall, 3),
            "qps": round(len(lat) / wall, 1),
            "p50_ms": round(1000 * secs[len(secs) // 2], 1),
            "p99_ms": round(1000 * secs[min(len(secs) - 1, int(len(secs) * 0.99))], 1),
            "cache_hit_rate": round(hits / max(1, hits + misses), 3),
            "plan_cache_hits": stats.get("plan_cache_hit", 0),
            "task_share": shares,
            "fairness_ratio": round(min(shares.values()) / max(shares.values()), 3)
            if shares else None,
        }
        print(f"[multitenant] {row}", file=sys.stderr)
        return row
    finally:
        cluster.shutdown()
