"""The window statistics on fixed samples: rate, p50, p90 and geomean
over every query, a failed query ranked above every latency; the device
busy time as a union of intervals and the idle gaps between them."""

import math

import pytest

from perfbench import catalog
import numpy as np

from perfbench.stats import idle_stretches, latency_percentile


def _run(latencies_s, window_s=10.0, failed=0):
    recs = [{"ok": True, "t0": 1.0, "t1": 1.0 + x} for x in latencies_s]
    recs += [{"ok": False, "t0": 1.0, "t1": 2.0} for _ in range(failed)]
    return {"records": recs, "window_s": window_s, "setup_s": 3.5, "counters": {},
            "trace": None}


def _read(name, run):
    return catalog.reader(name, False).read(run)


def test_rate_percentiles_and_geomean_over_every_query():
    run = _run([0.001 * k for k in range(1, 11)], window_s=4.0)  # 1..10 ms
    assert _read("queries_per_s", run) == pytest.approx(2.5)
    assert latency_percentile(run["records"], 0.5) == pytest.approx(6.0)  # nearest rank: xs[5]
    assert _read("query_p90_ms", run) == pytest.approx(10.0)  # xs[9]
    want = math.exp(sum(math.log(k) for k in range(1, 11)) / 10)
    assert _read("query_geomean_ms", run) == pytest.approx(want)
    assert _read("setup_s", run) == 3.5


def test_a_failed_query_misses_every_latency():
    run = _run([0.001] * 8, failed=2)
    assert _read("queries_per_s", run) == pytest.approx(0.8)
    assert latency_percentile(run["records"], 0.5) == pytest.approx(1.0)
    assert _read("query_p90_ms", run) is None  # the 90th lands on a failure
    assert _read("query_geomean_ms", run) is None


def test_idle_stretches_are_what_no_interval_covers():
    a, b = np.array([5, 0, 1, 5]), np.array([6, 2, 3, 5.8])
    g0, g1 = idle_stretches(a, b, 0, 8)
    assert list(zip(g0, g1)) == [(3, 5), (6, 8)]
    assert 8 - (g1 - g0).sum() == 4  # the busy time, overlaps counted once
    g0, g1 = idle_stretches(np.clip(a, -1, 2.5), np.clip(b, -1, 2.5), -1, 2.5)
    assert list(zip(g0, g1)) == [(-1, 0)]
    g0, g1 = idle_stretches(np.array([]), np.array([]), 0, 3)
    assert list(zip(g0, g1)) == [(0, 3)]


def test_per_layer_readers_read_counters_per_query():
    run = _run([0.01] * 4)
    run["counters"] = {"ingest_wall_s": 2.0, "routes_host": 2, "readback_bytes": 8192,
                       "dispatch_push": 6, "dispatch_poll": 2}
    run["trace"] = {"busy_s": 1.0, "window_s": 4.0}
    r = {n: catalog.reader(n, True).read(run) for n in
         ("prepare_ms", "host_routes", "readback_kib", "dispatch_per_query", "device_ms",
          "device_idle_pct", "plan_ms")}
    assert r == {"prepare_ms": 500.0, "host_routes": 0.5, "readback_kib": 2.0,
                 "dispatch_per_query": 2.0, "device_ms": 250.0, "device_idle_pct": 75.0,
                 "plan_ms": None}
