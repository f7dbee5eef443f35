"""Replicated control plane scenario (bench.py `_replica_scenario`):
closed-loop admission against one cluster with one scheduler, then two
lease-sharded replicas over the same KV store, then two replicas of which
one is killed halfway through the window (the failover). Client
processes, homed round-robin over the replicas with their peers armed for
redirect, run a fixed aggregation mix for a fixed window; the union of
result digests must be the same in all three. Knobs: BENCH_REPLICA_DURATION (4 s),
BENCH_REPLICA_CLIENTS (4), BENCH_REPLICA_ROWS (40000)."""

from __future__ import annotations

import os
import sys
import time

from ballista_tpu_torch.bench import device_arg
from ballista_tpu_torch.bench.scenarios import ScenarioFailed, digest_rows
from ballista_tpu_torch.bench.tpch import AnswerMismatch
from ballista_tpu_torch.utils import counters


def _replica_client_proc(endpoints, home, table, settings, qlist, idx, duration, out_q,
                         device) -> None:
    """One closed-loop client process homed to replica `home`; runs on
    `device` as the bench does. Collects every query and hashes its rows."""
    try:
        from ballista_tpu_torch.client import BallistaContext

        host, port = endpoints[home]
        ctx = BallistaContext(host, port, settings=settings,
                              endpoints=endpoints[home:] + endpoints[:home],
                              device=device_arg(device))
        ctx.register_record_batches("t", table, n_partitions=4)
        out_q.put(("started", idx))
        digests = set()
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < duration:
            sql = qlist[(idx + n) % len(qlist)]
            n += 1
            digests.add(digest_rows(ctx.sql(sql).collect()))
        wall = time.perf_counter() - t0
        ctx.close()
        out_q.put(("ok", idx, n, wall, sorted(digests)))
    except Exception as e:
        out_q.put(("error", idx, repr(e)))


def _replica_scenario(device=None) -> dict:
    import multiprocessing as mp

    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.executor.runtime import StandaloneCluster

    duration = float(os.environ.get("BENCH_REPLICA_DURATION", "4"))
    clients = int(os.environ.get("BENCH_REPLICA_CLIENTS", "4"))
    n_rows = int(os.environ.get("BENCH_REPLICA_ROWS", "40000"))
    rng = np.random.default_rng(20)
    table = pa.table({
        "g": pa.array(rng.integers(0, 40, n_rows), type=pa.int64()),
        "v": pa.array(np.round(rng.uniform(-100, 100, n_rows), 2)),
        "q": pa.array(rng.integers(1, 50, n_rows), type=pa.int64()),
        "s": pa.array([f"t{x}" for x in rng.integers(0, 5, n_rows)]),
    })
    settings = {"ballista.shuffle.partitions": "4"}
    qlist = [
        "select g, sum(v) as s, count(*) as n from t group by g order by g",
        "select s, min(q) as mn, max(q) as mx from t group by s order by s",
        "select g, sum(q) as sq from t where v > 0 group by g order by g",
        "select s, count(*) as n from t where q < 30 group by s order by s",
        "select g, s, sum(v) as sv from t group by g, s order by g, s",
        "select s, sum(v) as sv, sum(q) as sq from t group by s order by s",
    ]

    def run(n_schedulers: int, kill_at: float | None = None):
        cluster = StandaloneCluster(n_executors=2, n_schedulers=n_schedulers,
                                    device=device_arg(device))
        procs = []
        try:
            endpoints = [("127.0.0.1", p) for p in cluster.ports]
            mpctx = mp.get_context("spawn")  # never fork a process running grpc or CUDA
            out_q = mpctx.Queue()
            procs = [
                mpctx.Process(target=_replica_client_proc,
                              args=(endpoints, i % n_schedulers, table, settings, qlist, i,
                                    duration, out_q, device),
                              daemon=True)
                for i in range(clients)
            ]
            for p in procs:
                p.start()
            qps, digests, errors, got, started, killed = 0.0, set(), [], 0, 0, False
            t0 = None  # when the last client started its loop
            deadline = time.monotonic() + duration + 240
            while got < clients and time.monotonic() < deadline:
                if (kill_at is not None and t0 is not None
                        and time.monotonic() - t0 >= kill_at):
                    # replica 1 dies for good: its clients and executors move
                    # to replica 0, which adopts its jobs once their leases lapse
                    cluster.kill_scheduler(1)
                    kill_at, killed = None, True
                try:
                    msg = out_q.get(timeout=0.1 if kill_at is not None
                                    else max(0.1, deadline - time.monotonic()))
                except Exception:
                    if kill_at is not None:
                        continue
                    break
                if msg[0] == "started":
                    started += 1
                    if started == clients:
                        t0 = time.monotonic()
                    continue
                got += 1
                if msg[0] == "error":
                    errors.append(f"client{msg[1]}: {msg[2]}")
                    continue
                _tag, _idx, n, wall, ds = msg
                qps += n / max(wall, 1e-9)
                digests.update(ds)
            for p in procs:
                p.join(10)
                if p.is_alive():
                    errors.append("client process still running; terminated")
            if got < clients and not errors:
                errors.append(f"only {got}/{clients} clients reported")
            if errors:
                raise ScenarioFailed(f"replica ({n_schedulers} schedulers): {errors}")
            return qps, digests, killed
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            cluster.shutdown()

    one_qps, one_digests, _ = run(1)
    two_qps, two_digests, _ = run(2)
    counters.recovery.stats(reset=True)
    fo_qps, fo_digests, killed = run(2, kill_at=duration / 2)
    fo_recovery = {k: v for k, v in counters.recovery.stats(reset=True).items() if v}
    result = {
        "rows": n_rows,
        "clients": clients,
        "duration_s": duration,
        "one": {"schedulers": 1, "qps": round(one_qps, 2)},
        "two": {"schedulers": 2, "qps": round(two_qps, 2)},
        "failover": {"schedulers": 2, "killed": killed, "killed_at_s": duration / 2,
                     "qps": round(fo_qps, 2), "recovery": fo_recovery},
        "speedup": round(two_qps / max(one_qps, 1e-9), 3),
        "digests_identical": one_digests == two_digests == fo_digests,
        "n_digests": len(one_digests),
    }
    print(f"[replica] 1-replica={result['one']['qps']}qps "
          f"2-replica={result['two']['qps']}qps speedup={result['speedup']} "
          f"failover={result['failover']['qps']}qps {fo_recovery} "
          f"digests_identical={result['digests_identical']}", file=sys.stderr)
    if not result["digests_identical"]:
        raise AnswerMismatch(f"replica: answers differ between 1, 2 and failed-over schedulers: {result}")
    return result
