"""Low-latency serving scenario (bench.py `_latency_scenario`): a
closed-loop QPS sweep of point / filter / group queries against one
cluster with push dispatch, the kernel libraries prewarmed and streamed
results; reports p50 / p95 / p99, time to first batch and the serving
counters (pushes against polls, kernel-library hits). The result cache is
off: the scenario measures execution. Each client is its own process
(BENCH_LAT_DRIVER=process, the default) on the bench's device, as the JAX
bench's clients are on its device. Knobs: BENCH_LAT_SF (0.01),
BENCH_LAT_DURATION (10 s per level), BENCH_LAT_CLIENTS ("1,4"),
BENCH_LAT_BACKEND (cuda), BENCH_LAT_DRIVER (process | thread)."""

from __future__ import annotations

import os
import sys
import threading
import time

from ballista_tpu_torch.bench import data, device_arg
from ballista_tpu_torch.bench.scenarios import ScenarioFailed
from ballista_tpu_torch.utils import counters
from ballista_tpu_torch.utils.locks import make_lock

QUERIES = {
    "point": ("select count(*) as n, sum(l_extendedprice) as s from lineitem "
              "where l_orderkey = 1"),
    "filter": ("select sum(l_extendedprice) as revenue, count(*) as n "
               "from lineitem where l_shipdate >= date '1994-01-01' and "
               "l_shipdate < date '1995-01-01' and l_quantity < 24"),
    "group": ("select l_returnflag, count(*) as n from lineitem "
              "group by l_returnflag order by l_returnflag"),
}


def _timed_stream_query(ctx, sql: str):
    """(total_s, ttfb_s) for one streamed query; None on no rows. A
    client process holds no device work of its own (the executors ran it),
    so the clock stops when the last batch has arrived."""
    plan = ctx.sql(sql).logical_plan()
    t0 = time.perf_counter()
    ttfb = None
    rows = 0
    for b in ctx.collect_stream(plan, timeout=120):
        if ttfb is None:
            ttfb = time.perf_counter() - t0
        rows += b.num_rows
    total = time.perf_counter() - t0
    return (total, ttfb if ttfb is not None else total) if rows else None


def _client_proc(host, port, data_path, settings, qlist, idx, duration, out_q, digest,
                 device) -> None:
    """One closed-loop client process on `device`. With digest=True each
    result is collected whole and its rows hashed, so that the parent can
    assert bit-identity across the process boundary."""
    try:
        from benchmarks.tpch.datagen import register_all

        from ballista_tpu_torch.bench.scenarios import digest_rows
        from ballista_tpu_torch.client import BallistaContext

        ctx = BallistaContext(host, port, settings=settings, device=device_arg(device))
        register_all(ctx, data_path)
        lats, ttfbs, digests = [], [], set()
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < duration:
            sql = qlist[(idx + n) % len(qlist)]
            n += 1
            if digest:
                q0 = time.perf_counter()
                tbl = ctx.sql(sql).collect()
                dt = time.perf_counter() - q0
                if tbl.num_rows == 0:
                    out_q.put(("error", idx, "empty result"))
                    return
                lats.append(dt)
                ttfbs.append(dt)
                digests.add(digest_rows(tbl))
            else:
                r = _timed_stream_query(ctx, sql)
                if r is None:
                    out_q.put(("error", idx, "empty result"))
                    return
                lats.append(r[0])
                ttfbs.append(r[1])
        wall = time.perf_counter() - t0
        ctx.close()
        out_q.put(("ok", idx, lats, ttfbs, wall, sorted(digests)))
    except Exception as e:
        out_q.put(("error", idx, repr(e)))


def _drive_clients(host, port, data_path, settings, qlist, clients, duration,
                   digest=False, device=None):
    """Run `clients` closed-loop client processes against the scheduler;
    returns (lats, ttfbs, qps, digests) or raises ScenarioFailed naming the
    failures. qps sums each worker's own samples over its own wall time."""
    import multiprocessing as mp

    mpctx = mp.get_context("spawn")  # never fork a process running grpc or CUDA
    out_q = mpctx.Queue()
    procs = [
        mpctx.Process(target=_client_proc,
                      args=(host, port, data_path, settings, qlist, i, duration, out_q,
                            digest, device),
                      daemon=True)
        for i in range(clients)
    ]
    for p in procs:
        p.start()
    lats, ttfbs, qps, digests, errors = [], [], 0.0, set(), []
    got = 0
    deadline = time.monotonic() + duration + 240
    try:
        while got < clients and time.monotonic() < deadline:
            try:
                msg = out_q.get(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                break
            got += 1
            if msg[0] == "error":
                errors.append(f"client{msg[1]}: {msg[2]}")
                continue
            _tag, _idx, ls, ts, wall, ds = msg
            lats.extend(ls)
            ttfbs.extend(ts)
            qps += len(ls) / max(wall, 1e-9)
            digests.update(ds)
        for p in procs:
            p.join(10)
            if p.is_alive():
                errors.append("client process still running; terminated")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
    if got < clients and not errors:
        errors.append(f"only {got}/{clients} clients reported")
    if errors or not lats:
        raise ScenarioFailed(str(errors or ["no samples"]))
    return lats, ttfbs, qps, digests


def _pct(xs, q):
    return round(1000 * xs[min(len(xs) - 1, int(len(xs) * q))], 1)


def _latency_scenario(device=None) -> dict:
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster

    sf = float(os.environ.get("BENCH_LAT_SF", "0.01"))
    duration = float(os.environ.get("BENCH_LAT_DURATION", "10"))
    levels = [int(c) for c in os.environ.get("BENCH_LAT_CLIENTS", "1,4").split(",")
              if c.strip()]
    backend = os.environ.get("BENCH_LAT_BACKEND", "cuda")
    driver = os.environ.get("BENCH_LAT_DRIVER", "process")
    dev = device_arg(device)
    d = data.ensure_tpch(f"tpch_lat{sf}", sf, 2)
    cluster = StandaloneCluster(
        n_executors=2, device=dev,
        config=BallistaConfig({
            "ballista.executor.backend": backend,
            "ballista.tpu.prewarm": "true",
            "ballista.tpu.layout_cache_dir": str(data.CACHE / "layouts_lat"),
            "ballista.cache.results": "false",
        }),
    )
    client_settings = {
        "ballista.executor.backend": backend,
        "ballista.cache.results": "false",
        "ballista.client.stream_results": "true",
        # a 16-way shuffle is pure overhead for point queries
        "ballista.shuffle.partitions": "2",
    }
    try:
        def mk_ctx():
            ctx = BallistaContext(*cluster.scheduler_addr, settings=client_settings, device=dev)
            register_all(ctx, str(d))
            return ctx

        warm_ctx = mk_ctx()
        for sql in QUERIES.values():  # warmup: libraries, layouts, caches
            _timed_stream_query(warm_ctx, sql)
        warm_ctx.close()
        warm = counters.serving.stats(reset=True)

        sweep = []
        qlist = list(QUERIES.values())
        host, port = cluster.scheduler_addr
        for clients in levels:
            if driver == "process":
                lat, ttfbs, qps, _digests = _drive_clients(
                    host, port, str(d), client_settings, qlist, clients, duration,
                    device=device)
            else:
                errors = []
                samples_lock = make_lock("bench.scenarios.latency.samples_lock")
                samples: list = []  # (latency, ttfb); guarded-by: samples_lock

                def worker(i: int) -> None:
                    try:
                        ctx = mk_ctx()
                        n = 0
                        while time.perf_counter() - t0 < duration:
                            r = _timed_stream_query(ctx, qlist[(i + n) % len(qlist)])
                            n += 1
                            if r is None:
                                errors.append(f"client{i}: empty result")
                                return
                            with samples_lock:
                                samples.append((r[0], r[1]))
                        ctx.close()
                    except Exception as e:
                        errors.append(f"client{i}: {e!r}")

                threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(duration + 240)
                wall = time.perf_counter() - t0
                with samples_lock:
                    lat = [s[0] for s in samples]
                    ttfbs = [s[1] for s in samples]
                qps = len(lat) / max(wall, 1e-9)
                if errors or not lat:
                    raise ScenarioFailed(f"latency clients={clients}: "
                                         f"{errors or ['no samples']}")
            lat.sort()
            ttfbs.sort()
            row = {"clients": clients, "queries": len(lat), "qps": round(qps, 1),
                   "p50_ms": _pct(lat, 0.50), "p95_ms": _pct(lat, 0.95),
                   "p99_ms": _pct(lat, 0.99), "ttfb_p50_ms": _pct(ttfbs, 0.50)}
            print(f"[latency] {row}", file=sys.stderr)
            sweep.append(row)

        s = counters.serving.stats(reset=True)
        hits = (s.get("compile_hit_memory", 0) + s.get("compile_hit_disk", 0)
                + s.get("compile_prewarmed", 0))
        builds = s.get("kernel_built", 0)
        result = {
            "sf": sf,
            "duration_s": duration,
            "driver": driver,
            "backend": backend,
            "sweep": sweep,
            "dispatch_push": s.get("dispatch_push", 0),
            "dispatch_poll": s.get("dispatch_poll", 0),
            "kernel_built": builds,
            "compile_hits": hits,
            "compile_hit_rate": round(hits / max(1, hits + builds), 3),
            "stream_partitions_early": s.get("stream_partition_early", 0),
            "warmup": {k: v for k, v in warm.items() if v},
        }
        print(f"[latency] serving counters: {result['dispatch_push']} push / "
              f"{result['dispatch_poll']} poll dispatches, library hit rate "
              f"{result['compile_hit_rate']}", file=sys.stderr)
        return result
    finally:
        cluster.shutdown()
