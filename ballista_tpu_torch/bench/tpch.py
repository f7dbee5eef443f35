"""TPC-H rows of the bench (bench.py `_context`, `run_once`, `bench_config`,
`CONFIGS`): each query runs on the port's "cuda" backend (the card, unless
the caller asks for the CPU) and on its "cpu" backend over the same
Parquet files, and the card's answer is held against the host's."""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.bench import data, device_arg, snapshots, synchronize

QUERIES_DIR = data.REPO / "benchmarks" / "tpch" / "queries"
BATCH = "16777216"
# per-config rows (BASELINE.md configs 1-3 at SF 1 and 10, q5/q7/q10/q12 beside
# them; SF 100 only where its dataset is on disk)
CONFIGS = [(1.0, "q1"), (1.0, "q6"), (1.0, "q3"), (1.0, "q5"), (1.0, "q10"),
           (1.0, "q7"), (1.0, "q12"),
           (10.0, "q1"), (10.0, "q6"), (10.0, "q3"), (10.0, "q5"),
           (10.0, "q7"), (10.0, "q12"),
           (100.0, "q1"), (100.0, "q6"), (100.0, "q3"), (100.0, "q5"),
           (100.0, "q12")]
# the tolerance of an f32 sum on the card against the host's f64 (PERF.md §2)
RTOL, ATOL = 1e-4, 2e-3


class AnswerMismatch(AssertionError):
    """The card's answer differs from the "cpu" backend's."""


def bench_sf() -> float:
    return float(os.environ.get("BENCH_SF", "1"))


def no_gen_above_sf() -> float:
    """SF above this runs only when its dataset is already on disk:
    generating SF 100 (about 20 GB of Parquet) takes hours on one core."""
    return float(os.environ.get("BENCH_NO_GEN_ABOVE_SF", "10"))


def max_seconds() -> float:
    """Soft deadline: past it, no further config row starts (each skipped
    row is named in the result)."""
    return float(os.environ.get("BENCH_MAX_SECONDS", "2400"))


def configs() -> list:
    """CONFIGS, or BENCH_CONFIGS ("1.0:q1,10.0:q3") when it is set."""
    raw = os.environ.get("BENCH_CONFIGS")
    if not raw:
        return list(CONFIGS)
    out = []
    for entry in raw.split(","):
        if not entry.strip():
            continue
        sf_s, sep, q = entry.partition(":")
        if not sep or not q:
            raise SystemExit(f"BENCH_CONFIGS entry {entry!r}: expected 'sf:query'")
        out.append((float(sf_s), q.strip()))
    return out


_CTX: dict = {}


def _context(backend: str, sf: float | None, device=None):
    """One session per (backend, SF, device), as a TPC run keeps its
    catalog and caches across queries (sf None: a session with no TPC-H
    catalog). The "cpu" backend runs on the host whatever the device."""
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext

    dev = "cpu" if backend == "cpu" else device_arg(device)
    key = (backend, sf, dev, str(data.CACHE))
    if key not in _CTX:
        ctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": backend,
                                               "ballista.batch.size": BATCH}), device=dev)
        if sf is not None:
            register_all(ctx, str(data.data_dir(sf)))
        _CTX[key] = ctx
    return _CTX[key]


def reset_contexts() -> None:
    """End the bench's sessions: drop them and the port's in-memory cost
    store they warmed, so the work that follows in this process routes as
    in a fresh one (a persisted store stays on disk)."""
    from ballista_tpu_torch.ops import costmodel

    _CTX.clear()
    costmodel.reset()


def timed_collect(ctx, sql: str, device=None):
    """(seconds, table) of one collect; on the card the clock stops after
    the device has finished."""
    t0 = time.perf_counter()
    out = ctx.sql(sql).collect()
    if ctx.config.backend() != "cpu":
        synchronize(device)
    return time.perf_counter() - t0, out


def run_once(backend: str, sql: str, sf: float | None, device=None):
    return timed_collect(_context(backend, sf, device), sql, device)


def _sorted(t: pa.Table) -> pa.Table:
    keys = [f.name for f in t.schema if not pa.types.is_floating(f.type)]
    return t.sort_by([(k, "ascending") for k in keys]) if keys else t


def check_answer(name: str, got: pa.Table, want: pa.Table) -> float:
    """Hold the card's answer to the host's: the same columns and rows;
    keys, counts and integer sums equal; floats within RTOL / ATOL. Rows
    are compared after sorting on the non-float columns (the order of
    float ties may differ). Raises AnswerMismatch; returns the largest
    float difference."""
    if got.column_names != want.column_names:
        raise AnswerMismatch(f"{name}: columns {got.column_names} != {want.column_names}")
    if got.num_rows != want.num_rows:
        raise AnswerMismatch(f"{name}: {got.num_rows} rows, {want.num_rows} on cpu")
    got, want = _sorted(got), _sorted(want)
    err = 0.0
    for c, f in zip(want.column_names, want.schema):
        a = got.column(c).to_numpy(zero_copy_only=False)
        b = want.column(c).to_numpy(zero_copy_only=False)
        if pa.types.is_floating(f.type):
            a, b = a.astype(np.float64), b.astype(np.float64)
            if not np.allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True):
                raise AnswerMismatch(f"{name}: column {c} differs "
                                     f"(max abs err {np.nanmax(np.abs(a - b))})")
            if len(a):
                err = max(err, float(np.nanmax(np.abs(a - b), initial=0.0)))
        elif got.column(c).to_pylist() != want.column(c).to_pylist():
            raise AnswerMismatch(f"{name}: column {c} differs")
    return err


def _summed(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


def measure(name: str, sf: float, sql: str, iters: int, device=None,
            data_ready=None, catalog_sf=None) -> dict:
    """One row: a cold run on the card, `iters` timed runs, then the same on
    the "cpu" backend; the card's cold answer and its last warm one are
    each held against the host's.
    The runs go to the sessions whose TPC-H catalog is `catalog_sf` (None:
    the sessions with no catalog).
    The row carries the blocks of bench.py's rows plus the stage routes
    with decline reasons, kernel launches, residency and the chunked
    upload, all from this row's runs."""
    from ballista_tpu_torch.ops import cuda_kernels

    if data_ready is not None:
        data_ready()
    snapshots.drain_all()
    launches0 = cuda_kernels.launch_counts()
    cold_s, cold = run_once("cuda", sql, catalog_sf, device)
    ingest = snapshots._ingest_snapshot()
    cold_routing = snapshots._routing_snapshot() or {}
    snapshots._readback_snapshot()
    snapshots._join_snapshot()
    snapshots._recovery_snapshot()
    snapshots._speculation_snapshot()
    runs = [run_once("cuda", sql, catalog_sf, device) for _ in range(iters)]
    t = min(s for s, _ in runs)
    got = runs[-1][1]
    readback = snapshots._per_query(snapshots._readback_snapshot(), iters)
    join_paths = snapshots._join_snapshot(iters)
    recovery = snapshots._recovery_snapshot()
    routing = snapshots._routing_snapshot()
    speculation = snapshots._speculation_snapshot()
    residency = snapshots._residency_snapshot()
    launches = snapshots._launch_snapshot(launches0)
    run_once("cpu", sql, catalog_sf, device)
    cpu = [run_once("cpu", sql, catalog_sf, device) for _ in range(iters)]
    c = min(s for s, _ in cpu)
    err = max(check_answer(f"{name} sf={sf} (cold)", cold, cpu[-1][1]),
              check_answer(f"{name} sf={sf}", got, cpu[-1][1]))
    warm_routing = routing or {}
    routes = _summed(cold_routing.get("routes", {}), warm_routing.get("routes", {}))
    declines = _summed(cold_routing.get("reasons", {}), warm_routing.get("reasons", {}))
    row = {
        "name": name, "sf": sf,
        "cuda_ms": round(t * 1000, 1), "cpu_ms": round(c * 1000, 1),
        "speedup": round(c / t, 2), "cold_ms": round(cold_s * 1000, 1),
        "match": True, "max_abs_err": err, "rows": got.num_rows,
        "routes": routes, "declines": declines,
        "kernel_launches": launches, "residency": residency,
        "h2d_chunk_bytes": max(cold_routing.get("h2d_chunk_bytes", 0),
                               warm_routing.get("h2d_chunk_bytes", 0)),
        "h2d_chunked": (cold_routing.get("events", {}).get("h2d_chunked", 0)
                        + warm_routing.get("events", {}).get("h2d_chunked", 0)),
    }
    for key, block in (("ingest", ingest), ("readback", readback), ("join_paths", join_paths),
                       ("recovery", recovery), ("routing", routing),
                       ("speculation", speculation)):
        if block is not None:
            row[key] = block
    # the whole row as it lands, so that a run cut short keeps what it measured
    print(f"[row] {json.dumps(row)}", file=sys.stderr)
    print(f"[config] {name} sf={sf}: cuda={row['cuda_ms']}ms cpu={row['cpu_ms']}ms "
          f"speedup={row['speedup']}x cold={row['cold_ms']}ms routes={routes} "
          f"declines={declines} launches={launches} residency={residency} "
          f"h2d_chunk_bytes={row['h2d_chunk_bytes']} match=True", file=sys.stderr)
    return row


def bench_config(sf: float, name: str, iters: int = 3, device=None) -> dict | None:
    """One TPC-H row; None (with a line on stderr) when the SF is above
    BENCH_NO_GEN_ABOVE_SF and its dataset is not on disk."""
    from benchmarks.tpch.datagen import is_complete

    sql = (QUERIES_DIR / f"{name}.sql").read_text()
    if sf > no_gen_above_sf() and not is_complete(str(data.data_dir(sf))):
        print(f"[config] {name} sf={sf}: skipped (dataset absent or incomplete; "
              f"run benchmarks.tpch.datagen --sf {sf} first)", file=sys.stderr)
        return None
    return measure(name, sf, sql, iters, device, data_ready=lambda: data.ensure_data(sf),
                   catalog_sf=sf)
