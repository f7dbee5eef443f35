"""python -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of the benchmark once on the card and prints, as the last
line of standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), `device`, with --trace 1 `breakdown`, and last
`checks`, each number that decided `correct` beside its limit. The same
checks are the last lines of standard error.

A run: generate the cell's TPC-H database from the seed (perfbench/tpch),
start the engine, run the traffic's set-up queries (cold), measure the
window, read the device's peak memory, free the program's state, then hold
every answer of the window against the plain reference
(perfbench/reference, perfbench/compare.py). Set-up (`setup_s`) is
everything from the start of the process to the window.

It exits non-zero and prints no result when the card is missing, when the
cell asks for more cards than there are, or when the process holds a
module of JAX or of the JAX package once the window has closed."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

from perfbench import catalog

FORBIDDEN = ("jax", "jaxlib", "flax", "ballista_tpu", "benchmarks")
FORBIDDEN_MODULES = ("ballista_tpu_torch.bench",)
DATA = catalog.ROOT / ".data"


def forbidden_modules() -> list:
    """Loaded modules the benchmark must never run: JAX, the JAX package,
    the old benchmark's folder and the port's old bench entry, compared by
    whole top-level name (ballista_tpu_torch is not ballista_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN
                  or any(m == f or m.startswith(f + ".") for f in FORBIDDEN_MODULES))


def set_environment() -> None:
    """Every compiler cache at a fixed directory inside the checkout (the
    port's own kernel builds already go to build/kernels there), and
    Arrow's warning on each unaligned buffer of a host join off (it would
    fill the run's standard error)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(DATA / "cache" / sub)
    os.environ["ACERO_ALIGNMENT_HANDLING"] = "ignore"


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not measured"


def seed_rng(seed: int, stream: int):
    import numpy as np

    return np.random.default_rng([seed % (1 << 64), stream])


def check(records: list, data_dir: str, limits: dict, dtype: str = "float64") -> dict:
    """Every answer of the window against the reference's answer to the
    same query; {name: {"value", "limit"}}."""
    from perfbench.compare import compare
    from perfbench.reference.tables import Tables

    tables = Tables(data_dir, dtype)
    want: dict = {}
    bad, gap, first = 0, 0.0, ""
    for r in records:
        if not r["ok"]:
            continue
        q = r["query"]
        ref = catalog.module("reference", q.template)
        if q not in want:
            want[q] = ref.answer(tables, dict(q.params))
        b, g, why = compare(r["answer"], want[q], ref, limits["rel_gap"])
        bad += b
        gap = max(gap, g)
        if why and not first:
            first = f"{q.template} {dict(q.params)}: {why}"
    if first:
        log(f"first mismatch: {first}")
    log(f"reference answered {len(want)} distinct queries")
    return {
        "failed": {"value": sum(not r["ok"] for r in records), "limit": 0},
        "mismatches": {"value": bad, "limit": 0},
        "rel_gap": {"value": gap, "limit": limits["rel_gap"]},
    }


def log_window(records: list, templates: list, window_s: float) -> None:
    """The window on standard error: queries, repeated draws, each
    template's latencies and every failure."""
    seen, repeats = set(), 0
    for r in sorted(records, key=lambda r: r["t0"]):
        repeats += r["query"] in seen
        seen.add(r["query"])
    log(f"window {window_s:.3f} s: {len(records)} queries, {len(seen)} distinct, "
        f"{repeats} repeats of an earlier draw")
    if records and window_s > 0:
        # the rate of each half of the window: how far the window's own
        # sampling, and not the run, moves queries_per_s
        mid = min(r["t0"] for r in records) + window_s / 2
        halves = [sum(r["ok"] and (r["t1"] < mid) == first for r in records)
                  for first in (True, False)]
        log("halves: " + " / ".join(f"{n / (window_s / 2):.4f}" for n in halves)
            + " queries/s")
    for name in templates:
        ms = sorted((r["t1"] - r["t0"]) * 1e3 for r in records
                    if r["ok"] and r["query"].template == name)
        if ms:
            log(f"{name}: {len(ms)} runs, median {ms[len(ms) // 2]:.1f} ms, "
                f"min {ms[0]:.1f}, max {ms[-1]:.1f}")
    for r in records:
        if not r["ok"]:
            log(f"failed {r['query'].template} {dict(r['query'].params)}: {r['error']}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, data_root=DATA, sf: float | None = None,
             spec: dict | None = None, engine_cls=None) -> dict:
    """One run of cell `name`; the result object (see the module docstring).
    `device` is "cuda", or "cpu" where the tests drive a run without a card
    (`sf` then shrinks the database). `spec` stands in for BENCHMARK.json,
    `engine_cls` for the configuration's engine (perfbench/control.py)."""
    from perfbench.counters import delta
    from perfbench.tpch import datagen

    cell = catalog.workload(name)
    cfg = catalog.config(cell["config"])
    sf = cfg["scale_factor"] if sf is None else sf
    data_dir = str(data_root / cell["config"])
    t = time.perf_counter()
    datagen.generate(data_dir, sf, cfg["files_per_table"], seed % (1 << 64),
                     workers=min(os.cpu_count() or 1, 8))
    setup = {"datagen_s": time.perf_counter() - t}
    templates = [catalog.Template(q) for q in cfg["queries"]]
    warmup, streams = catalog.module("traffic", cell["traffic"]).make(
        cell.get("params", {}), templates, seed_rng(seed, 1))
    t = time.perf_counter()
    engine_cls = engine_cls or catalog.module("engines", cfg["engine"]).Engine
    engine = engine_cls(cfg, data_dir, device, len(streams))
    setup["engine_s"] = time.perf_counter() - t
    cuda = device != "cpu"
    try:
        t = time.perf_counter()
        for q in warmup:
            q0 = time.perf_counter()
            engine.run(q)
            log(f"set-up {q.template} {dict(q.params)}: {(time.perf_counter() - q0) * 1e3:.1f} ms")
        setup["warmup_s"] = time.perf_counter() - t
        before = engine.counters()
        if cuda:
            import torch

            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        tracer = None
        if trace:
            from perfbench.trace import DeviceTrace

            tracer = DeviceTrace()
        with tracer or contextlib.nullcontext():
            start, records = engine.window(streams, seconds)
        end = max((r["t1"] for r in records), default=start)
        counters = delta(before, engine.counters())
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        t = time.perf_counter()
        summary = tracer.summary(start, end, records) if tracer else None
        if tracer:
            log(f"trace read in {time.perf_counter() - t:.3f} s")
    finally:
        engine.close()
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()))
    log_window(records, cfg["queries"], end - start)
    t = time.perf_counter()
    checks = check(records, data_dir, cell["limits"])
    log(f"reference {time.perf_counter() - t:.3f} s")
    run = {"records": records, "window_s": end - start, "setup_s": setup_s,
           "counters": counters, "trace": summary}
    metrics = {}
    for metric in catalog.metric_names(name, trace, spec):
        reader = catalog.reader(metric, trace)
        value = reader.read(run)
        if value is not None:
            metrics[metric] = {"value": value, "unit": reader.UNIT}
    correct = (bool(records) and checks["failed"]["value"] == 0
               and checks["mismatches"]["value"] == 0
               and checks["rel_gap"]["value"] <= checks["rel_gap"]["limit"])
    result = {"correct": correct, "attempted": len(records),
              "failed": checks["failed"]["value"], "metrics": metrics}
    if cuda:
        import torch

        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
                            "power_limit": power_limit()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        log(f"trace: {summary['events']} device events, idle by span "
            f"{json.dumps(summary['idle_by_span'])}")
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python -m perfbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    set_environment()
    cell = catalog.workload(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import ballista_tpu_torch  # noqa: F401  (fails here, before any set-up, without the port)

    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        log(f"the process holds modules it must not run: {', '.join(bad)}")
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
