"""Elastic-fleet scenario (bench.py `_elastic_scenario`): a burst of
concurrent jobs on the shared shuffle tier against an autoscaled cluster
(min 1, max BENCH_ELASTIC_MAX): the backlog grows the fleet, every job
answers as a fixed one-executor cluster does, with zero task retries, and
the idle fleet drains back to min. Knobs: BENCH_ELASTIC_JOBS (6),
BENCH_ELASTIC_ROWS (60000), BENCH_ELASTIC_MAX (3)."""

from __future__ import annotations

import os
import sys
import tempfile
import time

from ballista_tpu_torch.bench import device_arg, synchronize
from ballista_tpu_torch.bench.scenarios import ScenarioFailed
from ballista_tpu_torch.bench.tpch import AnswerMismatch
from ballista_tpu_torch.utils import counters


def _elastic_scenario(device=None) -> dict:
    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.proto import ballista_pb2 as pb

    n_jobs = int(os.environ.get("BENCH_ELASTIC_JOBS", "6"))
    n_rows = int(os.environ.get("BENCH_ELASTIC_ROWS", "60000"))
    fleet_max = int(os.environ.get("BENCH_ELASTIC_MAX", "3"))
    dev = device_arg(device)
    rng = np.random.default_rng(15)
    table = pa.table({
        "g": pa.array(rng.integers(0, 11, n_rows), type=pa.int64()),
        "v": pa.array(np.round(rng.uniform(-100, 100, n_rows), 2)),
        "q": pa.array(rng.integers(1, 50, n_rows), type=pa.int64()),
    })
    sql = ("select g, sum(v) as s, min(q) as mn, max(q) as mx, count(*) as n "
           "from t group by g order by g")

    with tempfile.TemporaryDirectory(prefix="ballista-elastic-") as shared:
        client_settings = {
            "ballista.shuffle.partitions": "8",
            "ballista.cache.results": "false",
            "ballista.shuffle.tier": "shared",
            "ballista.shuffle.dir": shared,
        }
        # fixed single-executor reference (also the bit-identity oracle)
        cluster = StandaloneCluster(n_executors=1, device=dev)
        try:
            ctx = BallistaContext(*cluster.scheduler_addr, settings=client_settings, device=dev)
            ctx.register_record_batches("t", table, n_partitions=8)
            ref = ctx.sql(sql).collect()
            ctx.close()
        finally:
            cluster.shutdown()

        counters.fleet.stats(reset=True)
        counters.recovery.stats(reset=True)
        counters.shuffle_tier.stats(reset=True)
        cluster = StandaloneCluster(
            n_executors=1, device=dev,
            config=BallistaConfig({
                "ballista.fleet.min": "1",
                "ballista.fleet.max": str(fleet_max),
                "ballista.fleet.interval_s": "0.1",
                "ballista.fleet.target_backlog_s": "0.05",
            }),
        )
        try:
            ctx = BallistaContext(*cluster.scheduler_addr, settings=client_settings, device=dev)
            ctx.register_record_batches("t", table, n_partitions=8)
            t0 = time.perf_counter()
            jobs = [ctx.submit(ctx.sql(sql).logical_plan()) for _ in range(n_jobs)]
            peak = cluster.fleet_size()
            deadline = time.time() + 120
            statuses = []
            while time.time() < deadline:
                peak = max(peak, cluster.fleet_size())
                statuses = [
                    ctx._client.get_job_status(pb.GetJobStatusParams(job_id=j)).status
                    for j in jobs
                ]
                if all(s.WhichOneof("status") in ("completed", "failed") for s in statuses):
                    break
                time.sleep(0.05)
            completed = sum(1 for s in statuses if s.WhichOneof("status") == "completed")
            if completed != n_jobs:
                raise ScenarioFailed(f"elastic: {completed}/{n_jobs} jobs completed "
                                     f"({[s.WhichOneof('status') for s in statuses]})")
            bit_identical = True
            for j in jobs:
                got = ctx._collect_results(j, ref.schema)
                bit_identical = bit_identical and got.equals(ref)
            synchronize(device)
            wall = time.perf_counter() - t0
            # idle drain back to min
            deadline = time.time() + 60
            while time.time() < deadline and cluster.fleet_size() > 1:
                time.sleep(0.1)
            fleet_final = cluster.fleet_size()
            ctx.close()
        finally:
            cluster.shutdown()

    fl = counters.fleet.stats(reset=True)
    tier = counters.shuffle_tier.stats(reset=True)
    rec = counters.recovery.stats(reset=True)
    result = {
        "jobs": n_jobs,
        "fleet_min": 1,
        "fleet_max": fleet_max,
        "fleet_peak": int(peak),
        "fleet_final": int(fleet_final),
        "backlog_ms_peak": round(fl.get("backlog_ms_peak", 0.0), 1),
        "wall_s": round(wall, 2),
        "bit_identical": bit_identical,
        "fleet": dict(fl),
        "shuffle_tier": tier,
        "task_retries": int(rec.get("task_retry", 0)),
        "recovery": {k: v for k, v in rec.items() if v},
    }
    print(f"[elastic] peak={result['fleet_peak']} final={result['fleet_final']} "
          f"backlog_ms_peak={result['backlog_ms_peak']} "
          f"storage_fetch={tier.get('storage_fetch', 0)} "
          f"peer_fetch={tier.get('peer_fetch', 0)} task_retries={result['task_retries']} "
          f"bit_identical={bit_identical}", file=sys.stderr)
    if not bit_identical:
        raise AnswerMismatch(f"elastic: a job's answer differs from the fixed fleet's: {result}")
    return result
