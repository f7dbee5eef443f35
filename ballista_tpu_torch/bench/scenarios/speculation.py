"""Straggler-tail scenario (bench.py `_speculation_scenario`): p99 under
seeded task.slow chaos with speculation on and off. One query replays
closed-loop from client processes against a two-executor cluster; the
seed is chosen off the warm run's task coordinates so that exactly one
task straggles per run and its duplicate draws fast. Both modes must
answer bit-equal to the fault-free run. Knobs: BENCH_SPEC_SF (0.01),
BENCH_SPEC_DURATION (8 s per mode), BENCH_SPEC_CLIENTS (2),
BENCH_SPEC_SLOW_MS (1200)."""

from __future__ import annotations

import os
import sys

from ballista_tpu_torch.bench import data, device_arg
from ballista_tpu_torch.bench.scenarios import ScenarioFailed, digest_rows
from ballista_tpu_torch.bench.scenarios.latency import _drive_clients
from ballista_tpu_torch.bench.tpch import AnswerMismatch
from ballista_tpu_torch.utils import counters

RATE = 0.12
SQL = ("select l_returnflag, count(*) as n, sum(l_extendedprice) as s "
       "from lineitem group by l_returnflag order by l_returnflag")


def _spec_seed(coords) -> int | None:
    """The first seed under which exactly one task of `coords` straggles
    at attempt 0 and its attempt 1 does not."""
    from ballista_tpu_torch.utils.chaos import ChaosInjector

    for cand in range(2000):
        inj = ChaosInjector(cand, RATE, sites=("task.slow",))
        slow = [c for c in sorted(coords)
                if inj.should_inject("task.slow", f"{c[0]}/{c[1]}@a0")]
        if len(slow) == 1 and not inj.should_inject("task.slow",
                                                      f"{slow[0][0]}/{slow[0][1]}@a1"):
            return cand
    return None


def _speculation_scenario(device=None) -> dict:
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.ops import costmodel

    sf = float(os.environ.get("BENCH_SPEC_SF", "0.01"))
    duration = float(os.environ.get("BENCH_SPEC_DURATION", "8"))
    clients = int(os.environ.get("BENCH_SPEC_CLIENTS", "2"))
    slow_ms = float(os.environ.get("BENCH_SPEC_SLOW_MS", "1200"))
    dev = device_arg(device)
    d = data.ensure_tpch(f"tpch_lat{sf}", sf, 2)  # the latency scenario's dataset
    # every config pins the in-memory cost store so that no configure()
    # drops the task.run rates between passes
    client_base = {
        "ballista.cache.results": "false",
        "ballista.shuffle.partitions": "2",
        "ballista.tpu.cost_model_dir": "",
        "ballista.tenant.name": "bench",
    }

    def run_mode(spec_on: bool, seed: int | None):
        cluster = StandaloneCluster(
            n_executors=2, device=dev,
            config=BallistaConfig({
                "ballista.tpu.cost_model_dir": "",
                "ballista.speculation": "true" if spec_on else "false",
                "ballista.speculation.min_runtime_ms": "150",
                "ballista.speculation.multiplier": "3",
                "ballista.tenant.slo_ms": f"bench:{max(200.0, slow_ms * 0.8):.0f}",
            }),
        )
        try:
            host, port = cluster.scheduler_addr
            counters.speculation.stats(reset=True)
            ctx = BallistaContext(host, port, settings=client_base, device=dev)
            register_all(ctx, str(d))
            # fault-free warm pass: the task.run rates the monitor predicts from
            baseline = None
            for _ in range(3):
                baseline = ctx.sql(SQL).collect()
            ctx.close()
            base_digest = digest_rows(baseline)
            warm_stats = counters.speculation.stats(reset=True)
            if seed is None:
                st = cluster.scheduler_impl.state
                coords = set()
                for k, _v in st.kv.get_prefix(st._key("tasks")):
                    tail = k.rsplit("/", 3)
                    coords.add((int(tail[2]), int(tail[3])))
                seed = _spec_seed(coords)
                if seed is None:
                    raise ScenarioFailed("speculation: no qualifying chaos seed")
            lats, _ttfbs, qps, digests = _drive_clients(
                host, port, str(d),
                {**client_base,
                 "ballista.chaos.rate": str(RATE),
                 "ballista.chaos.seed": str(seed),
                 "ballista.chaos.sites": "task.slow",
                 "ballista.chaos.slow_ms": str(slow_ms)},
                [SQL], clients, duration, digest=True, device=device,
            )
            stats = counters.speculation.stats(reset=True)
            lats.sort()

            def pct(q):
                return round(1000 * lats[min(len(lats) - 1, int(len(lats) * q))], 1)

            return {
                "queries": len(lats),
                "qps": round(qps, 1),
                "p50_ms": pct(0.50),
                "p99_ms": pct(0.99),
                "bit_identical": digests == {base_digest},
                "warm_launched": int(warm_stats.get("launched", 0)),
                "speculation": {k: (round(v, 4) if k == "wasted_seconds" else int(v))
                                for k, v in stats.items()},
            }, seed
        finally:
            cluster.shutdown()
            costmodel.reset()

    costmodel.reset()
    on, seed = run_mode(True, None)
    off, _ = run_mode(False, seed)
    result = {
        "sf": sf,
        "duration_s": duration,
        "clients": clients,
        "slow_ms": slow_ms,
        "chaos_rate": RATE,
        "chaos_seed": seed,
        "on": on,
        "off": off,
        "bit_identical": on["bit_identical"] and off["bit_identical"],
        "p99_speedup": round(off["p99_ms"] / max(on["p99_ms"], 1e-9), 2),
    }
    print(f"[speculation] ON p99={on['p99_ms']}ms OFF p99={off['p99_ms']}ms "
          f"({result['p99_speedup']}x) bit_identical={result['bit_identical']} "
          f"counters={on['speculation']}", file=sys.stderr)
    if not result["bit_identical"]:
        raise AnswerMismatch(f"speculation: an answer under chaos differs from the "
                             f"fault-free run's: {result}")
    return result
