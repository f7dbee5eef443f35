"""python -m ballista_tpu_torch.bench: the port's benchmark (bench.py `main`).

Prints ONE JSON line: {"metric": "tpch_q1_sf<SF>_rows_per_sec", "value":
lineitem rows / the best warm q1 seconds on the card, "unit", "vs_baseline":
the "cpu" backend's seconds over the card's, "device", "configs": [the
TPC-H rows, then the taxi rows, each held against the "cpu" backend
(`tpch.measure`)], "skipped": [rows not run, with the reason], and one
record per serving scenario}. BENCH_<NAME>_ONLY=1 runs only that scenario
and prints {"<name>": record}; `rows_result` gives the rows alone. Runs on
the card unless BENCH_DEVICE=cpu; a failed row or scenario raises, so the
run exits nonzero with the error on stderr and prints no result.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ballista_tpu_torch.bench import bench_device, data, taxi, tpch
from ballista_tpu_torch.bench.scenarios.delta import _delta_scenario
from ballista_tpu_torch.bench.scenarios.elastic import _elastic_scenario
from ballista_tpu_torch.bench.scenarios.exchange import _exchange_scenario
from ballista_tpu_torch.bench.scenarios.latency import _latency_scenario
from ballista_tpu_torch.bench.scenarios.multitenant import _multitenant_scenario
from ballista_tpu_torch.bench.scenarios.replica import _replica_scenario
from ballista_tpu_torch.bench.scenarios.routing import _routing_scenario
from ballista_tpu_torch.bench.scenarios.sharedscan import _sharedscan_scenario
from ballista_tpu_torch.bench.scenarios.speculation import _speculation_scenario

# (BENCH_<X>_ONLY, result key, scenario), in the order the full run takes them
SCENARIOS = [
    ("BENCH_MULTITENANT_ONLY", "multitenant", _multitenant_scenario),
    ("BENCH_LATENCY_ONLY", "latency", _latency_scenario),
    ("BENCH_SPECULATION_ONLY", "speculation", _speculation_scenario),
    ("BENCH_SHAREDSCAN_ONLY", "shared_scan", _sharedscan_scenario),
    ("BENCH_ELASTIC_ONLY", "elastic", _elastic_scenario),
    ("BENCH_EXCHANGE_ONLY", "exchange", _exchange_scenario),
    ("BENCH_DELTA_ONLY", "delta", _delta_scenario),
    ("BENCH_ROUTING_ONLY", "routing", _routing_scenario),
    ("BENCH_REPLICA_ONLY", "replica", _replica_scenario),
]


def rows_result(t_start: float | None = None) -> dict:
    """The headline and the config rows (TPC-H, then taxi), with the rows
    skipped and why: past BENCH_MAX_SECONDS, counted from `t_start`, no
    further row starts."""
    import pyarrow.parquet as pq

    t_start = time.monotonic() if t_start is None else t_start
    deadline = tpch.max_seconds()

    def past_deadline() -> bool:
        return time.monotonic() - t_start > deadline

    sf = tpch.bench_sf()
    data.ensure_data(sf)
    files = sorted((data.data_dir(sf) / "lineitem").glob("*.parquet"))
    rows = sum(pq.read_metadata(f).num_rows for f in files)

    # the headline: q1 at BENCH_SF, best of 3 warm runs on each backend
    headline = tpch.bench_config(sf, "q1", iters=3)
    configs, skipped = [], []
    # default list: SF <= 10 first, then taxi, then the slow SF 100 rows, so
    # that the soft deadline can only cut the tail; an explicit BENCH_CONFIGS
    # keeps its order and runs taxi last
    user_configs = bool(os.environ.get("BENCH_CONFIGS"))
    listed = tpch.configs()
    ordered = listed if user_configs else sorted(listed, key=lambda c: c[0] > 10)
    taxi_done = False
    for c_sf, name in ordered:
        if not user_configs and not taxi_done and c_sf > 10:
            if past_deadline():
                skipped.append({"name": "taxi", "reason": "past BENCH_MAX_SECONDS"})
            else:
                configs.extend(taxi._taxi_rows())
            taxi_done = True
        if (c_sf, name) == (sf, "q1"):
            configs.append(headline)
            continue
        if past_deadline():
            print(f"[config] {name} sf={c_sf}: skipped (past {deadline:.0f}s soft deadline)",
                  file=sys.stderr)
            skipped.append({"name": name, "sf": c_sf, "reason": "past BENCH_MAX_SECONDS"})
            continue
        row = tpch.bench_config(c_sf, name, iters=3 if c_sf <= 1 else (2 if c_sf <= 10 else 1))
        if row is None:
            skipped.append({"name": name, "sf": c_sf, "reason": "dataset not on disk"})
        else:
            configs.append(row)
    if not taxi_done:
        if past_deadline():
            skipped.append({"name": "taxi", "reason": "past BENCH_MAX_SECONDS"})
        else:
            configs.extend(taxi._taxi_rows())

    t_s = headline["cuda_ms"] / 1000
    c_s = headline["cpu_ms"] / 1000
    return {
        "metric": f"tpch_q1_sf{sf}_rows_per_sec",
        "value": round(rows / t_s, 1),
        "unit": "rows/s/chip",
        "vs_baseline": round(c_s / t_s, 3),
        "lineitem_rows": rows,
        "device": bench_device(),
        "configs": configs,
        "skipped": skipped,
    }


def main() -> None:
    for env, key, fn in SCENARIOS:
        if os.environ.get(env):
            print(json.dumps({key: fn()}))
            return
    t_start = time.monotonic()
    result = rows_result(t_start)
    for _env, key, fn in SCENARIOS:
        if time.monotonic() - t_start > tpch.max_seconds():
            result["skipped"].append({"name": key, "reason": "past BENCH_MAX_SECONDS"})
            continue
        t0 = time.monotonic()
        result[key] = fn()
        result[key]["scenario_s"] = round(time.monotonic() - t0, 1)
    result["wall_s"] = round(time.monotonic() - t_start, 1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
