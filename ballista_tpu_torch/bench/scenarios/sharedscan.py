"""Shared-scan serving scenario (bench.py `_sharedscan_scenario`): N
tenants each replay one distinct aggregate over the same table closed-loop
against a one-slot cluster, so that shared-scan batching serves a whole
wave from one upload; every batched answer must be bit-equal to the same
query run alone with shared scan off. Eager PyTorch compiles nothing, so
the reference's synchronous-compile warm rounds are plain warm rounds
here. Knobs: BENCH_SS_SF (0.1), BENCH_SS_DURATION (6 s per level),
BENCH_SS_TENANTS ("1,2,4,8")."""

from __future__ import annotations

import os
import sys
import threading
import time

from ballista_tpu_torch.bench import data, device_arg
from ballista_tpu_torch.bench.scenarios import ScenarioFailed, digest_rows
from ballista_tpu_torch.bench.tpch import AnswerMismatch
from ballista_tpu_torch.utils import counters

GBY = "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
QUERIES = [
    f"select l_returnflag, l_linestatus, sum(l_quantity) as s, count(*) as n from lineitem {GBY}",
    f"select l_returnflag, l_linestatus, sum(l_extendedprice) as s "
    f"from lineitem where l_quantity < 25 {GBY}",
    f"select l_returnflag, l_linestatus, min(l_discount) as mn, max(l_tax) as mx "
    f"from lineitem {GBY}",
    f"select l_returnflag, l_linestatus, count(*) as n from lineitem "
    f"where l_shipdate >= date '1994-01-01' {GBY}",
    f"select l_returnflag, l_linestatus, sum(l_extendedprice * (1 - l_discount)) as rev "
    f"from lineitem {GBY}",
    f"select l_returnflag, l_linestatus, min(l_shipdate) as d0, max(l_shipdate) as d1 "
    f"from lineitem {GBY}",
    f"select l_returnflag, l_linestatus, avg(l_quantity) as aq "
    f"from lineitem where l_discount > 0.02 {GBY}",
    f"select l_returnflag, l_linestatus, sum(l_quantity) as sq "
    f"from lineitem where l_tax < 0.05 {GBY}",
]


def settings(shared: bool) -> dict:
    return {
        "ballista.executor.backend": "cuda",
        "ballista.cache.results": "false",
        # few large row batches, so that per-batch overhead does not drown the work
        "ballista.batch.size": "4194304",
        "ballista.shuffle.partitions": "1",
        "ballista.shared_scan": "true" if shared else "false",
        # the scan-per-query regime (working sets past device residency):
        # a resident member would rightly run solo
        "ballista.tpu.device_cache": "false",
        "ballista.tpu.cost_model_dir": "",
        "ballista.scan.cache": "false",
        "ballista.tpu.layout_cache_dir": "",
    }


def _sharedscan_scenario(device=None) -> dict:
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster

    sf = float(os.environ.get("BENCH_SS_SF", "0.1"))
    duration = float(os.environ.get("BENCH_SS_DURATION", "6"))
    levels = [int(c) for c in os.environ.get("BENCH_SS_TENANTS", "1,2,4,8").split(",")
              if c.strip()]
    dev = device_arg(device)
    d = data.ensure_tpch(f"tpch_ss{sf}", sf, 1)

    # never-batched reference (sequential, shared scan off)
    reference, reference_tables = {}, {}
    cluster = StandaloneCluster(n_executors=1, device=dev,
                                config=BallistaConfig({"ballista.shared_scan": "false"}))
    try:
        ctx = BallistaContext(*cluster.scheduler_addr, settings=settings(False), device=dev)
        register_all(ctx, str(d))
        for i, sql in enumerate(QUERIES):
            tbl = ctx.sql(sql).collect()
            reference[i] = digest_rows(tbl)
            reference_tables[i] = tbl.to_pydict()
        ctx.close()
    finally:
        cluster.shutdown()

    sweep = []
    mismatches: list = []
    for tenants in levels:
        # one executor slot: solo tenants queue behind each other, and
        # shared scan serves a queue's wave from one scan
        cluster = StandaloneCluster(n_executors=1, concurrent_tasks=1, device=dev,
                                    config=BallistaConfig({"ballista.tpu.cost_model_dir": ""}))
        counters.shared_scan.stats(reset=True)
        try:
            counts = [0] * tenants
            errors: list = []

            def warm_round() -> None:
                def one(i: int) -> None:
                    try:
                        ctx = BallistaContext(*cluster.scheduler_addr,
                                              settings=settings(True), device=dev)
                        register_all(ctx, str(d))
                        ctx.sql(QUERIES[i % len(QUERIES)]).collect()
                        ctx.close()
                    except Exception as e:
                        errors.append(f"warm{i}: {e!r}")

                ws = [threading.Thread(target=one, args=(i,)) for i in range(tenants)]
                for w in ws:
                    w.start()
                for w in ws:
                    w.join(120)

            warm_round()
            warm_round()
            counters.shared_scan.stats(reset=True)

            def tenant_loop(i: int) -> None:
                try:
                    ctx = BallistaContext(*cluster.scheduler_addr, settings=settings(True),
                                          device=dev)
                    register_all(ctx, str(d))
                    qi = i % len(QUERIES)
                    t0 = time.perf_counter()
                    while time.perf_counter() - t0 < duration:
                        tbl = ctx.sql(QUERIES[qi]).collect()
                        if digest_rows(tbl) != reference[qi]:
                            mismatches.append((qi, reference_tables[qi], tbl.to_pydict()))
                            return
                        counts[i] += 1
                    ctx.close()
                except Exception as e:
                    errors.append(f"tenant{i}: {e!r}")

            threads = [threading.Thread(target=tenant_loop, args=(i,)) for i in range(tenants)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(duration + 120)
            wall = time.perf_counter() - t0
            if errors or any(t.is_alive() for t in threads) or not sum(counts):
                raise ScenarioFailed(f"sharedscan tenants={tenants}: "
                                     f"{errors or ['hung or empty']}")
            row = {"tenants": tenants, "queries": sum(counts),
                   "qps": round(sum(counts) / wall, 2),
                   "shared_scan": counters.shared_scan.stats(reset=True)}
            print(f"[sharedscan] {row}", file=sys.stderr)
            sweep.append(row)
        finally:
            cluster.shutdown()
    by_tenants = {r["tenants"]: r for r in sweep}
    result = {"sf": sf, "duration_s": duration, "distinct_queries": len(QUERIES),
              "sweep": sweep, "bit_identical": not mismatches}
    if 1 in by_tenants and 4 in by_tenants:
        result["qps_1"] = by_tenants[1]["qps"]
        result["qps_4"] = by_tenants[4]["qps"]
        result["qps_4_over_1"] = round(by_tenants[4]["qps"] / max(by_tenants[1]["qps"], 1e-9), 2)
    print(f"[sharedscan] sweep done: {[(r['tenants'], r['qps']) for r in sweep]} "
          f"bit_identical={result['bit_identical']}", file=sys.stderr)
    if mismatches:
        qi, want, got = mismatches[0]
        raise AnswerMismatch(f"sharedscan: query {qi} batched {got} != alone {want}")
    return result
