"""Smoke run of ballista_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1] [--seed 20260728]

Phases, each of which fails the run (non-zero exit) on any error:

1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles every CUDA kernel of the package (nvcc, sm_90a).
3. path: generates TPC-H at --sf and runs, through the package's
   ExecutionContext on the "cuda" backend: q1 and q6 ("batches" route);
   q15's revenue view and q18's inner aggregate under
   ballista.tpu.sorted_kernel=pallas ("pallas_sorted", the sorted_grouped_sum
   kernel) and under the default configuration ("sorted", the
   chunked-segment layout); and the single-table top-k query TOPK_REVENUE
   (a SINGLE aggregate with the fused top-k epilogue, "sorted", exactly 10
   rows read back per run) beside its unfused twin (order by revenue + 0).
   Each result is held against the package's "cpu" backend on the same data
   (computed once per SQL): keys and counts equal, floats within rtol 1e-4 /
   atol 2e-3 (f32 device columns); the top-k keys equal the unfused device
   run's. Asserts the routes, zero host declines, readbacks recorded, and at
   least two launches of the sorted_grouped_sum kernel. Prints cold and warm
   (median of 5) milliseconds per query. Launch counters are 0 when it
   starts.
4. kernels: runs sorted_grouped_sum against its plain PyTorch version on the
   card at the shapes the path gave it, plus a skewed case; counts must be
   equal, sums within rtol 1e-5 and atol 1e-3 x max|row sum| (atomics
   change the summation order). Times kernel, plain version and a library
   call as device time per call (`ms`: 20 calls back to back between two
   CUDA events, queued behind a device sleep so that host enqueue time is
   not counted, median of 5 such windows; every timed input is > 50 MB, more
   than the L2 holds), the kernel also by PRs 1 and 2's method (`ms_single`:
   one call per event pair) and by torch.profiler (`device_ms`).
5. grouped_aggregate: not on the main path (its launches there are 0); it
   runs from its own entry, grouped_aggregate_arrays, on every batch of the
   q1 stage's resident entries (codes, row_valid AND filters, the f32
   sum inputs as [N, A]), with its launch counter set to 0 before and read
   after. Each batch is held against the plain version and against the
   stage's own f32 group sums for that batch, with the tolerance of phase
   4; then two full-size synthetic cases at the lineitem row count (A = 8,
   ~98 % of rows kept, G = 4 for contention and G = 128 for the cap) are
   checked and timed like phase 4.

6. joins: TPC-H aggregates over joins at --sf, each through the package's
   stage ladder (ops/kernels.py) on the "cuda" backend, the stage cache
   emptied before each query: q3 (FactAggregateStage, "fact_topk"), q5
   ("fact_secondary"), q18 ("fact_select" over a "sorted" inner aggregate),
   and q4, q7, q8, q9, q10, q12, q14, q19 (FusedAggregateStage over a
   MappedScanExec, "batches" or "sorted", the "mapped_rewrite" event). Each
   query must take its stage and route with no host route and no decline
   reason; q10's fused top-k must read back exactly 20 rows per stage
   partition per run (a boundary-tie fallback fails the phase and says so);
   q3's fact step must read back at most its candidate pool per fact
   partition, fewer than its groups. Answers are held against the "cpu"
   backend under the tolerance of phase 3. Prints cold and warm (median of
   5) milliseconds, readbacks, the host prepare and the host dim side
   (`dim_ms`: the spans factagg.dim_side, factagg.secondary_side and
   mappedscan.dim_maps) per query, and the device time inside one more
   warm run (torch.profiler, `warm_device_ms`) with the warm median's idle
   share, and the warm runs' prepares (q18 must have none: its stage key
   is stable). Launch counters are 0 when it starts;
   neither kernel is on this path, and their counts are printed. The dim
   sides join on the card (ops/join.py): each query prints its join paths
   (runtime.join_path_stats, every non-"device" path with its reason),
   q3, q5 and q10 must record at least one "device" join, and the readback
   rules above hold for the stage's own step: the join module's readbacks
   (ops/join.py::readback_stats) are subtracted from the totals, cold and
   warm, whether a warm run joins again or not.
7. tpch: the nine TPC-H queries no other phase runs in full (q2, q11,
   q13, q15, q16, q17, q20, q21, q22) at --sf, one cold and three warm runs
   each, every answer held against the "cpu" backend under the tolerance
   of phase 3. Prints routes, join paths with reasons, the
   device.count_join counter, readbacks and cold / warm ms. q13 must count
   its LEFT join on the card (device.count_join >= 1) and q22 must keep its
   rows off a device membership join ("join.counts:device"). With phases 3
   and 6 this runs all 22 TPC-H queries through the package on the card.
8. join shapes: ops/join.py::device_join_indices on CUDA tensors against
   the host oracle physical/joinutil.py::join_indices(..., "inner"),
   bit-for-bit (indices, order, counts), on four shapes made from --seed,
   their row counts scaled by --sf (SF 1's given here): unique keys (1.5M
   build, 6M probes, tier 1), M:N (a 2M-row build over 200k keys, at most
   16 per key, 2M probes, tier 16), skew (1M unique keys plus 8 hot keys of
   2,000 rows, 2M probes: the cost model, on with a cold store, records
   "split") and extended (400k unique keys plus 1,000 keys of 100..300
   rows, 200k probes, a store seeded so that the gather is cheap and the
   host join dear: width 512, "device" with the extended-tier reason).
   Prints the device ms of the runs step and of the gather, the host ms of
   device_join_indices and device_membership_counts, and the host
   oracle's ms.
9. layout cache (runs before phase 8, over phase 3's data, with its own
   temporary store: ballista.tpu.layout_cache_dir <tmp>/layouts, so the
   port's store is <tmp>/layouts_torch). q1, q6, q3, q15, q17, q18 and q20
   run cold over an empty store (cold ms, prepare_ms, prepares, entries
   and bytes written, the ms inside the store's spans layout_cache.save
   and layout_cache.load, the "cpu" backend's ms, answers held against
   it).
   A directory holding one lineitem file is warmed with q1 (its chunks
   prepared), then the second file is copied in. A second
   cuda_kernels.build() must compile nothing. Then a new process
   (chip_smoke.py --layout-child) prewarms the kernel libraries (from disk:
   compile_hit_disk for both, kernel_built 0), runs the seven queries cold
   over the warm store (cold ms and its store read ms; prepares must be 0;
   answers equal to the empty-store
   run's: non-float columns exact, floats within the tolerance of phase 3,
   bit_equal says whether they are bit-equal too) and q1 over the grown
   directory (chunks_reused = the first file's chunks, chunks_prepared =
   the second's, the answer equal to the "cpu" backend's over both).
   Last, q18-inner and q15-revenue ("sorted" stages) alternate four times
   under an hbm_budget_bytes of the larger stage plus half the smaller:
   the (pins, evictions, streams) of every run (runtime.residency_stats)
   must be residency_sequence(sizes), which tests/test_torch_residency.py
   holds both packages to on the CPU.
   Printed as one {"layout_cache": ...} line.
10. distributed (runs after phase 9, over phase 3's data): the package's
   StandaloneCluster (a scheduler and two executors in this process,
   sharing the card) and a BallistaContext on it, with
   ballista.tpu.cost_model_dir "", a temporary layout_cache_dir and the
   scheduler's result cache off (it would answer a repeated query without
   running a stage); exchange, shared scan and device joins keep their
   defaults (on). All 22 TPC-H queries run once each, the stage cache
   emptied before each, every answer held against the "cpu" backend's
   answer of phases 3, 6 and 7 under phase 3's tolerance; then three warm
   runs each of q1, q3 and q18. A query fails the phase if it records a
   stage decline reason or a non-"device" join path (or its reason) that
   the local engine's run of the same query in phases 3, 6 and 7 did not.
   At least one query must serve a piece from the exchange registry
   (exchange_stats: published > 0 and reupload_skipped or
   served_from_registry > 0). Then q15's revenue view and q18's inner
   aggregate run through the cluster under ballista.tpu.sorted_kernel=
   pallas: every stage run takes "pallas_sorted", sorted_grouped_sum
   launches at least once per scan partition, answers held against phase
   3's. Prints per query the cluster's cold ms (and warm median) beside the
   local engine's, routes and decline reasons, join paths with reasons,
   readback_stats, exchange_stats, shuffle_tier_stats and
   shared_scan_stats, and the phase's seconds, as one {"distributed": ...}
   line. The cluster shuts down in a finally; an error still fails the run.

Every phase runs with ballista.tpu.cost_model_dir "" (an in-memory store,
emptied before each query and shape), so each run starts from the same cold
routing; phase 8 seeds its store where it says so.

With --compare-sources DIR, phases 4 and 5 also build the kernel sources
in DIR (PR 2's C interface, e.g. unpacked with `git show`) and time them on
the same inputs in turns (previous, current, current, previous):
`previous_ms`, `previous_ms_single`.

No Pallas kernel lies on a join path in the JAX package either: both
kernels' launches on phases 6 to 9 are counted and printed (0 expected).

Prints the {"layout_cache": ...} line of phase 9, the {"distributed": ...}
line of phase 10, one {"ptxas": ...,
"sass_atomics": ...} line (each kernel's
registers, shared memory and spills from nvcc -Xptxas -v, and the atomic
SASS opcodes of each library), one {"kernels": [...]} line, then the
nvidia-smi line, and last
{"ok": true, "device": {...}}. It imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and f32
# non-tensor-core rate, for the bound of a memory-bound f32 reduction
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

RTOL_PATH, ATOL_PATH = 1e-4, 2e-3
RTOL_KERNEL, ATOL_KERNEL_REL = 1e-5, 1e-3
# kernel timing (see _time_ms): calls per window, windows per median
TIME_REPS, TIME_WINDOWS = 20, 5

Q15_REVENUE = (
    "select l_suppkey as supplier_no, sum(l_extendedprice * (1 - l_discount)) "
    "as total_revenue from lineitem where l_shipdate >= date '1996-01-01' and "
    "l_shipdate < date '1996-01-01' + interval '3' month group by l_suppkey"
)
Q18_INNER = (
    "select l_orderkey, sum(l_quantity) as sum_qty from lineitem "
    "group by l_orderkey having sum(l_quantity) > 300"
)
TOPK_K = 10
TOPK_REVENUE = (
    "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue "
    "from lineitem group by l_orderkey order by revenue desc limit 10"
)
# a computed sort key defeats the planner's top-k annotation: every group is
# read back and the host Sort+Limit picks the rows
TOPK_REVENUE_UNFUSED = TOPK_REVENUE.replace("order by revenue desc", "order by revenue + 0 desc")
PALLAS = {"ballista.tpu.sorted_kernel": "pallas"}
# name, stage ("fact" or "mapped"), routes the cold run must record (None:
# "batches" or "sorted", whichever the group count picks)
JOIN_QUERIES = [
    ("q3", "fact", ("fact_topk",)),
    ("q4", "mapped", ("batches",)),
    ("q5", "fact", ("fact_secondary",)),
    ("q7", "mapped", ("sorted",)),
    ("q8", "mapped", None),
    ("q9", "mapped", None),
    ("q10", "mapped", ("sorted",)),
    ("q12", "mapped", ("batches",)),
    ("q14", "mapped", ("batches",)),
    ("q18", "fact", ("fact_select", "sorted")),
    ("q19", "mapped", None),
]
Q10_K = 20
# host spans of the join stages' dim sides (ops/factagg.py, ops/mappedscan.py)
DIM_SPANS = ("factagg.dim_side", "factagg.secondary_side", "mappedscan.dim_maps")
# queries whose dim sides must record a device join (as the JAX package's do)
DEVICE_DIM_JOINS = ("q3", "q5", "q10")
# phase 7: the TPC-H queries no other phase runs in full
TPCH_REST = ["q2", "q11", "q13", "q15", "q16", "q17", "q20", "q21", "q22"]
TPCH_WARM = 3
# phase 10: the queries that take warm runs through the cluster, and the one
# setting changed from the defaults (the scheduler's result cache would
# answer a repeated query without running a stage)
DIST_WARM = ["q1", "q3", "q18"]
DIST_SETTINGS = {"ballista.cache.results": "false"}
# every phase: an in-memory cost store, so routing starts cold each run
BASE = {"ballista.executor.backend": "cuda", "ballista.tpu.layout_cache_dir": "",
        "ballista.tpu.cost_model_dir": ""}
# phase 9: the queries run cold over an empty and then a warm layout store
LAYOUT_QUERIES = ["q1", "q6", "q3", "q15", "q17", "q18", "q20"]
# phase 9: q18-inner (A) and q15-revenue (B) alternate four times under a
# budget that holds the larger alone but not both
RESIDENCY_PAIR = (("q18_inner", Q18_INNER), ("q15_revenue", Q15_REVENUE))
# the JAX package's eviction cost ratio (ops/runtime.py::_EVICT_COST_RATIO)
EVICT_COST_RATIO = 4


def residency_sequence(size_a: int, size_b: int):
    """(pins, evictions, streams) per run of A, B, A, B, A, B, A, B under
    the JAX package's LRU policy with a budget that holds either stage
    alone but not both, for stage sizes size_a and size_b. A victim over
    EVICT_COST_RATIO times the request is never evicted: the smaller stage
    then streams from its second run on. Otherwise the first cycle thrashes
    (each pin evicts the other), after which the cooldown keeps A pinned
    and B streams. tests/test_torch_residency.py holds both packages to
    this sequence on the CPU; phase 9 holds the card to it."""
    if size_a > EVICT_COST_RATIO * size_b:
        return [(1, 0, 0)] + [(0, 0, 1), (0, 0, 0)] * 3 + [(0, 0, 1)]
    if size_b > EVICT_COST_RATIO * size_a:
        return [(1, 0, 0), (1, 1, 0)] + [(0, 0, 1), (0, 0, 0)] * 3
    return [(1, 0, 0), (1, 1, 0), (1, 1, 0), (0, 0, 1)] + [(0, 0, 0), (0, 0, 1)] * 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0].strip()


def phase_build():
    from ballista_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    built = cuda_kernels.build()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s ({', '.join(built) or 'no sources'})")
    facts = {name: b["ptxas"] for name, b in built.items()}
    libraries = {name: b["library"] for name, b in built.items()}
    for name, kernels in facts.items():
        for k in kernels:
            if k["spill_stores"] or k["spill_loads"]:
                log(f"build: {name}: {k['function']} spills "
                    f"({k['spill_stores']} B stored, {k['spill_loads']} B loaded)")
    return secs, facts, libraries


def _previous_kernels(src_dir: str):
    """The kernels built from `src_dir` (sorted_grouped_sum.cu and
    grouped_aggregate.cu with PR 2's C interface: out zeroed by the caller,
    no scratch), as callables that do what PR 2's wrappers did (allocate a
    zeroed output, launch), plus their compiler facts. They are timed beside
    the current kernels on the same card."""
    import ctypes

    import torch

    from ballista_tpu_torch.ops import cuda_kernels

    out_dir = cuda_kernels.BUILD_DIR.parent / "previous"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("sorted_grouped_sum", "grouped_aggregate"):
        src = pathlib.Path(src_dir) / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    facts, libs = {}, {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"previous {name} did not build:\n{text}")
        facts[name] = cuda_kernels.parse_ptxas(text)
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sgs = libs["sorted_grouped_sum"].bt_sorted_grouped_sum_f32
    sgs.argtypes, sgs.restype = [vp, vp, vp, ll, i, ll, vp], i
    ga = libs["grouped_aggregate"].bt_grouped_aggregate_f32
    ga.argtypes, ga.restype = [vp, vp, vp, vp, ll, i, i, vp], i

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def sorted_grouped_sum(codes, vals, G):
        nv, n = vals.shape
        out = torch.zeros(nv, G, device=vals.device)
        if sgs(codes.data_ptr(), vals.data_ptr(), out.data_ptr(), n, nv, G, stream()):
            fail("previous sorted_grouped_sum: launch failed")
        return out

    def grouped_aggregate(codes, vals, mask, G):
        n, A = vals.shape
        out = torch.zeros(G, A, device=vals.device)
        if ga(codes.data_ptr(), vals.data_ptr(), mask.data_ptr(), out.data_ptr(),
              n, A, G, stream()):
            fail("previous grouped_aggregate: launch failed")
        return out

    return {"sorted_grouped_sum": sorted_grouped_sum,
            "grouped_aggregate": grouped_aggregate}, facts


def _time_pair(kernel, previous):
    """(ms, ms of the previous kernel, the four windows' medians): in turns
    previous, current, current, previous on the same inputs; each figure
    is the mean of its two turns. Without a previous kernel, one turn."""
    if previous is None:
        return _time_ms(kernel), None, None
    turns = [_time_ms(previous), _time_ms(kernel), _time_ms(kernel), _time_ms(previous)]
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2, turns


def _sass_atomics(libraries: dict):
    """{kernel: {SASS opcode: count}} of the atomic and reduction
    instructions in each built kernel library (cuobjdump -sass), or "not
    measured" where the toolkit has no cuobjdump."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return "not measured"
    out = {}
    for name, lib in sorted(libraries.items()):
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {lib}: {sass.stderr.strip()}")
        ops = {}
        for m in re.finditer(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)", sass.stdout):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        out[name] = ops
    return out


def _sorted_table(t):
    import pyarrow as pa

    keys = [f.name for f in t.schema if not pa.types.is_floating(f.type)]
    return t.sort_by([(k, "ascending") for k in keys]) if keys else t


def _compare(name, dev, host) -> None:
    import numpy as np
    import pyarrow as pa

    if dev.column_names != host.column_names:
        fail(f"{name}: columns {dev.column_names} != {host.column_names}")
    if dev.num_rows != host.num_rows:
        fail(f"{name}: {dev.num_rows} rows on cuda, {host.num_rows} on cpu")
    dev, host = _sorted_table(dev), _sorted_table(host)
    for c, f in zip(host.column_names, host.schema):
        a = dev.column(c).to_numpy(zero_copy_only=False)
        b = host.column(c).to_numpy(zero_copy_only=False)
        if pa.types.is_floating(f.type):
            if not np.allclose(a, b, rtol=RTOL_PATH, atol=ATOL_PATH):
                err = np.max(np.abs(a - b))
                fail(f"{name}: column {c} differs (max abs err {err})")
        elif list(a) != list(b):
            fail(f"{name}: column {c} differs")


def _topk_aggregate(ctx, sql):
    """The plan's aggregate for the top-k query: one SINGLE aggregate that
    carries the planner's top-k annotation."""
    plan = ctx.create_physical_plan(ctx.sql(sql).logical_plan())
    aggs, stack = [], [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashAggregateExec":
            aggs.append(node)
        stack.extend(node.children())
    if [a.mode.value for a in aggs] != ["single"]:
        fail(f"top-k: expected one SINGLE aggregate, got {[a.mode.value for a in aggs]}")
    tk = getattr(aggs[0], "_topk_pushdown", None)
    if tk is None or tk["k"] != TOPK_K:
        fail(f"top-k: the aggregate carries no k={TOPK_K} annotation ({tk})")


def phase_path(sf: float, seed: int, data_dir: str):
    import torch

    from benchmarks.tpch.datagen import generate, register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import cuda_kernels, runtime

    t0 = time.perf_counter()
    generate(data_dir, sf=sf, parts=2, seed=seed)
    log(f"datagen sf={sf}: {time.perf_counter() - t0:.1f} s")
    q1 = (ROOT / "benchmarks/tpch/queries/q1.sql").read_text()
    q6 = (ROOT / "benchmarks/tpch/queries/q6.sql").read_text()
    # name, sql, extra settings, route, rows each run must read back (the
    # fused top-k), or None
    queries = [
        ("q1", q1, {}, "batches", None),
        ("q6", q6, {}, "batches", None),
        ("q15_revenue_pallas", Q15_REVENUE, PALLAS, "pallas_sorted", None),
        ("q18_inner_pallas", Q18_INNER, PALLAS, "pallas_sorted", None),
        ("q15_revenue", Q15_REVENUE, {}, "sorted", None),
        ("q18_inner", Q18_INNER, {}, "sorted", None),
        ("topk_revenue", TOPK_REVENUE, {}, "sorted", TOPK_K),
        ("topk_revenue_unfused", TOPK_REVENUE_UNFUSED, {}, "sorted", None),
    ]
    base = BASE
    host_ctx = ExecutionContext(BallistaConfig({**base, "ballista.executor.backend": "cpu"}))
    register_all(host_ctx, data_dir)
    host_answers = {}
    results = {}
    times = {}
    # the main path: every launch counter starts at 0 here
    cuda_kernels.reset_launch_counts()
    for name, sql, extra, route, fused_rows in queries:
        ctx = ExecutionContext(BallistaConfig({**base, **extra}))
        register_all(ctx, data_dir)
        if fused_rows is not None:
            _topk_aggregate(ctx, sql)
        runtime.routing_stats(reset=True)
        runtime.readback_stats(reset=True)
        runtime.ingest_stats(reset=True)
        t0 = time.perf_counter()
        got = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        routes = runtime.routing_stats()
        reads = runtime.readback_stats(reset=True)
        ingest = runtime.ingest_stats()
        if routes["routes"].get("host") or routes["reasons"]:
            fail(f"{name}: a stage declined to the host: {routes}")
        if routes["routes"].get(route, 0) < 1:
            fail(f"{name}: expected route {route!r}, recorded {routes['routes']}")
        if reads["readbacks"] < 1:
            fail(f"{name}: no readback recorded")
        if fused_rows is not None and reads["rows"] != fused_rows:
            fail(f"{name}: read back {reads['rows']} rows, not {fused_rows}")
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        warm_reads = runtime.readback_stats(reset=True)
        if fused_rows is not None and warm_reads["rows"] != 5 * fused_rows:
            fail(f"{name}: warm runs read back {warm_reads['rows']} rows, "
                 f"not 5 x {fused_rows}")
        if sql not in host_answers:
            host_answers[sql] = host_ctx.sql(sql).collect()
        expect = host_answers[sql]
        if name.startswith("topk"):
            # the top k groups by an f32 device sum: values within the
            # tolerance of the host's, in rank order (a near-tie at the k-th
            # group may pick another key than the f64 host sum)
            for label, t in ((name, got), (name + " (warm)", again)):
                if not np.allclose(t.column("revenue").to_numpy(),
                                   expect.column("revenue").to_numpy(),
                                   rtol=RTOL_PATH, atol=ATOL_PATH):
                    fail(f"{label}: revenue differs from the cpu backend's")
        else:
            _compare(name, got, expect)
            _compare(name + " (warm)", again, expect)
        results[name] = got
        times[name] = {
            "route": route, "rows": got.num_rows, "cold_ms": cold_ms,
            "warm_ms": statistics.median(warm), "readbacks": reads["readbacks"],
            "readback_rows": reads["rows"], "readback_bytes": reads["bytes"],
            # the cold run's host prepare: scan (read + decode + rank),
            # encode (lower + narrow + layout), upload (h2d enqueue), wall
            "prepare_ms": {k: ingest[k] * 1e3 for k in
                           ("scan_s", "encode_s", "upload_s", "wall_s")},
        }
        log(f"{name}: {times[name]}")
    launches = cuda_kernels.launch_counts()
    fused_keys = results["topk_revenue"].column("l_orderkey").to_pylist()
    unfused_keys = results["topk_revenue_unfused"].column("l_orderkey").to_pylist()
    if fused_keys != unfused_keys:
        fail(f"top-k: fused keys {fused_keys} != unfused device keys {unfused_keys}")
    times["topk_revenue"]["keys_equal_cpu"] = (
        fused_keys == host_answers[TOPK_REVENUE].column("l_orderkey").to_pylist()
    )
    if launches["sorted_grouped_sum"] < 2:
        fail(f"sorted_grouped_sum launched {launches['sorted_grouped_sum']} times")
    return times, launches, host_answers


def _join_stage(name: str, kind: str, routes: dict):
    """The query's device stage from the stage cache (emptied before the
    query): a FactAggregateStage for "fact", a FusedAggregateStage over a
    MappedScanExec for "mapped"."""
    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.ops.factagg import FactAggregateStage
    from ballista_tpu_torch.ops.mappedscan import MappedScanExec

    built = [s for s in list(kernels._stage_cache.values()) if s not in (None, False)]
    if kind == "fact":
        found = [s for s in built if isinstance(s, FactAggregateStage)]
    else:
        found = [s for s in built if isinstance(getattr(s, "scan", None), MappedScanExec)]
        if routes["events"].get("mapped_rewrite", 0) < 1:
            fail(f"{name}: no mapped_rewrite event recorded: {routes}")
    if len(found) != 1:
        fail(f"{name}: expected one {kind} stage, found {[type(s).__name__ for s in built]}")
    return found[0]


def _join_readback_rules(name: str, stage, routes: dict, reads: dict, runs: int) -> dict:
    """q10: exactly Q10_K rows per stage partition per run; q3: at most the
    candidate pool per fact partition per run, fewer than the groups. `runs`
    queries recorded `routes` and `reads`. Returns what was checked."""
    if name == "q10":
        n = routes["routes"].get("sorted", 0)  # stage partitions x runs
        if stage.topk is None:
            fail("q10: the mapped stage's fused top-k is not live")
        if n < runs or reads["rows"] != Q10_K * n or reads["readbacks"] != n:
            fail(f"q10: {n} stage partition run(s) read back {reads['rows']} rows "
                 f"in {reads['readbacks']} readbacks, not {Q10_K} rows in one "
                 f"each: the fused top-k fell back (boundary tie) or did not run")
        return {"stage_partitions": n // runs, "rows_per_partition": Q10_K}
    if name == "q3":
        n = routes["routes"].get("fact_topk", 0)  # fact partitions x runs
        groups = [e["n_groups"] for e in stage._prepared.values() if e["kind"] == "sorted"]
        if not groups or len(groups) * runs != n:
            fail(f"q3: {n} fact run(s) over {runs} query run(s) but "
                 f"{len(groups)} resident fact partition(s)")
        pool = sum(stage.pool_size(g) for g in groups)
        if reads["readbacks"] != n or reads["rows"] > pool * runs:
            fail(f"q3: read back {reads['rows']} rows in {reads['readbacks']} "
                 f"readbacks, more than the pool of {pool} per run")
        if pool >= sum(groups):
            fail(f"q3: the pool ({pool}) is not smaller than the groups ({sum(groups)})")
        return {"fact_partitions": len(groups), "pool": pool, "groups": sum(groups)}
    return {}


def _check_join_paths(name: str, paths: dict) -> None:
    """Every join path but "device" must say why the join left the card."""
    for path in paths["paths"]:
        if path != "device" and not any(r.startswith(path + ": ") for r in paths["reasons"]):
            fail(f"{name}: join path {path!r} recorded without a reason: {paths}")


def _stage_reads(reads: dict, join_reads: dict) -> dict:
    """The stage's own readbacks: the totals less the join module's."""
    return {k: reads[k] - join_reads[k] for k in reads}


def _reset_counters() -> None:
    from ballista_tpu_torch.ops import costmodel, runtime
    from ballista_tpu_torch.ops import join as device_join
    from ballista_tpu_torch.utils import tracing

    costmodel.reset()
    runtime.routing_stats(reset=True)
    runtime.readback_stats(reset=True)
    runtime.ingest_stats(reset=True)
    runtime.join_path_stats(reset=True)
    device_join.readback_stats(reset=True)
    tracing.reset()


def phase_joins(data_dir: str):
    """Phase 6 (see the module docstring), over phase 3's data."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime
    from ballista_tpu_torch.ops import join as device_join
    from ballista_tpu_torch.utils import tracing

    base = BASE
    host_ctx = ExecutionContext(BallistaConfig({**base, "ballista.executor.backend": "cpu"}))
    register_all(host_ctx, data_dir)
    times, answers = {}, {}
    # this path's launches: every counter starts at 0 here
    cuda_kernels.reset_launch_counts()
    for name, kind, want_routes in JOIN_QUERIES:
        sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
        kernels.clear_stage_cache()
        ctx = ExecutionContext(BallistaConfig(base))
        register_all(ctx, data_dir)
        _reset_counters()
        t0 = time.perf_counter()
        got = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        routes = runtime.routing_stats()
        reads = runtime.readback_stats(reset=True)
        join_reads = device_join.readback_stats(reset=True)
        joins = runtime.join_path_stats(reset=True)
        ingest = runtime.ingest_stats()
        dim_ms = sum(dt for path, dt, _ in tracing.spans()
                     if path.split("/")[-1] in DIM_SPANS) * 1e3
        if routes["routes"].get("host") or routes["reasons"]:
            fail(f"{name}: a stage declined to the host: {routes}")
        for route in want_routes or ():
            if routes["routes"].get(route, 0) < 1:
                fail(f"{name}: expected route {route!r}, recorded {routes['routes']}")
        if want_routes is None and not (set(routes["routes"]) & {"batches", "sorted"}):
            fail(f"{name}: no batches or sorted route recorded: {routes['routes']}")
        _check_join_paths(name, joins)
        if name in DEVICE_DIM_JOINS and joins["paths"].get("device", 0) < 1:
            fail(f"{name}: its dim side recorded no device join: {joins}")
        stage = _join_stage(name, kind, routes)
        checked = _join_readback_rules(name, stage, routes,
                                       _stage_reads(reads, join_reads), 1)
        warm = []
        runtime.routing_stats(reset=True)
        runtime.ingest_stats(reset=True)
        for _ in range(5):
            t0 = time.perf_counter()
            again = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        warm_prepares = runtime.ingest_stats(reset=True)["prepares"]
        if name == "q18" and warm_prepares:
            # its stage key is stable (ordinal subquery aliases), so the
            # warm runs find the stage and its resident layout again
            fail(f"q18: {warm_prepares} prepares over 5 warm runs")
        warm_routes = runtime.routing_stats(reset=True)
        warm_reads = runtime.readback_stats(reset=True)
        warm_join_reads = device_join.readback_stats(reset=True)
        warm_joins = runtime.join_path_stats(reset=True)
        if warm_routes["routes"].get("host") or warm_routes["reasons"]:
            fail(f"{name}: a warm run declined to the host: {warm_routes}")
        _check_join_paths(name + " (warm)", warm_joins)
        _join_readback_rules(name, stage, warm_routes,
                             _stage_reads(warm_reads, warm_join_reads), 5)
        busy_ms = _device_busy_ms(lambda: ctx.sql(sql).collect())
        runtime.routing_stats(reset=True)
        runtime.readback_stats(reset=True)
        expect = answers[name] = host_ctx.sql(sql).collect()
        _compare(name, got, expect)
        _compare(name + " (warm)", again, expect)
        times[name] = {
            "stage": type(stage).__name__ if kind == "fact" else "FusedAggregateStage/MappedScanExec",
            "routes": routes["routes"], "events": routes["events"],
            "join_paths": joins, "warm_join_paths": warm_joins,
            "rows": got.num_rows, "cold_ms": cold_ms,
            "warm_ms": statistics.median(warm), "warm_runs_ms": warm,
            "warm_prepares": warm_prepares,
            "readbacks": reads["readbacks"], "readback_rows": reads["rows"],
            "readback_bytes": reads["bytes"], "join_readbacks": join_reads,
            "warm_readback_rows_per_run": warm_reads["rows"] / 5,
            "warm_join_readbacks": warm_join_reads,
            # the cold run's host prepare of the fact scan (scan, encode,
            # upload, wall) and the dim side (its joins now on the card)
            "prepare_ms": {k: ingest[k] * 1e3 for k in
                           ("scan_s", "encode_s", "upload_s", "wall_s")},
            "dim_ms": dim_ms,
            # device time inside one more warm run (torch.profiler), and
            # the share of the warm median the card was idle
            "warm_device_ms": busy_ms,
            "warm_idle_share": ("not measured" if busy_ms == "not measured"
                                else 1.0 - busy_ms / statistics.median(warm)),
            **checked,
        }
        log(f"{name}: {times[name]}")
    launches = cuda_kernels.launch_counts()
    kernels.clear_stage_cache()
    return times, launches, answers


def phase_tpch(data_dir: str):
    """Phase 7 (see the module docstring), over phase 3's data."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime
    from ballista_tpu_torch.ops import join as device_join
    from ballista_tpu_torch.utils import tracing

    host_ctx = ExecutionContext(BallistaConfig({**BASE, "ballista.executor.backend": "cpu"}))
    register_all(host_ctx, data_dir)
    times, answers = {}, {}
    cuda_kernels.reset_launch_counts()
    for name in TPCH_REST:
        sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
        kernels.clear_stage_cache()
        ctx = ExecutionContext(BallistaConfig(BASE))
        register_all(ctx, data_dir)
        _reset_counters()
        t0 = time.perf_counter()
        got = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        routes = runtime.routing_stats(reset=True)
        reads = runtime.readback_stats(reset=True)
        join_reads = device_join.readback_stats(reset=True)
        joins = runtime.join_path_stats(reset=True)
        count_joins = tracing.counters().get("device.count_join", 0)
        _check_join_paths(name, joins)
        if name == "q13" and count_joins < 1:
            fail(f"q13: COUNT over its LEFT join did not run on the card: {joins}")
        if name == "q22" and routes["events"].get("join.counts:device", 0) < 1:
            fail(f"q22: no device membership join recorded: {routes['events']}")
        warm = []
        runtime.ingest_stats(reset=True)
        for _ in range(TPCH_WARM):
            t0 = time.perf_counter()
            again = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        warm_prepares = runtime.ingest_stats(reset=True)["prepares"]
        warm_routes = runtime.routing_stats(reset=True)
        warm_joins = runtime.join_path_stats(reset=True)
        warm_reads = runtime.readback_stats(reset=True)
        _check_join_paths(name + " (warm)", warm_joins)
        t0 = time.perf_counter()
        expect = answers[name] = host_ctx.sql(sql).collect()
        host_ms = (time.perf_counter() - t0) * 1e3
        _compare(name, got, expect)
        _compare(name + " (warm)", again, expect)
        times[name] = {
            "rows": got.num_rows, "routes": routes["routes"],
            "reasons": routes["reasons"], "step_asides": routes["step_asides"],
            "events": routes["events"], "join_paths": joins,
            "warm_join_paths": warm_joins, "warm_routes": warm_routes["routes"],
            "count_join": count_joins,
            "readbacks": reads["readbacks"], "readback_rows": reads["rows"],
            "readback_bytes": reads["bytes"], "join_readbacks": join_reads,
            "warm_readbacks_per_run": warm_reads["readbacks"] / TPCH_WARM,
            "cold_ms": cold_ms, "warm_ms": statistics.median(warm),
            "warm_runs_ms": warm, "warm_prepares": warm_prepares,
            "cpu_backend_ms": host_ms,
        }
        log(f"{name}: {times[name]}")
    launches = cuda_kernels.launch_counts()
    kernels.clear_stage_cache()
    return times, launches, answers


def _join_shapes(seed: int, sf: float):
    """(name, build codes, probe codes, expected path, expected width,
    cost-store seeds) of phase 8's four shapes, made from `seed`. Row
    counts scale with `sf` (the sizes below are SF 1's: orders and
    lineitem); the multiplicities, which decide the path, do not."""
    rng = np.random.default_rng(seed)

    def n(rows: int) -> int:
        return max(64, int(rows * sf))

    shapes = []
    # unique keys: orders against lineitem, every probe matches
    build = rng.choice(n(6_000_000), n(1_500_000), replace=False).astype(np.int64)
    probe = build[rng.integers(0, len(build), n(6_000_000))]
    shapes.append(("unique", build, probe, "device", 1, ()))
    # M:N: keys of 4..16 rows each (10 on average), probes with misses
    n_keys = n(200_000) // 2 * 2
    counts = np.full(n_keys, 10, dtype=np.int64)
    perm = rng.permutation(n_keys)
    delta = rng.integers(0, 7, n_keys // 2)
    counts[perm[: n_keys // 2]] += delta
    counts[perm[n_keys // 2:]] -= delta
    counts[perm[0]] = 16
    keys = rng.choice(2 * n_keys, n_keys, replace=False).astype(np.int64)
    build = np.repeat(keys, counts)
    rng.shuffle(build)
    probe = rng.integers(0, 2 * n_keys, n(2_000_000)).astype(np.int64)
    shapes.append(("mn", build, probe, "device", 16, ()))
    # skew: unique keys and 8 hot keys of 2,000 rows each
    n_unique = n(1_000_000)
    hot = np.arange(n_unique, n_unique + 8, dtype=np.int64)
    build = np.concatenate([np.arange(n_unique, dtype=np.int64), np.repeat(hot, 2_000)])
    rng.shuffle(build)
    probe = rng.integers(0, n_unique + 8, n(2_000_000)).astype(np.int64)
    probe[:8] = hot  # every hot key is probed
    shapes.append(("skew", build, probe, "split", 1, ()))
    # extended: unique keys and keys of 100..300 rows; the store says the
    # width-512 gather is cheap and the host join dear
    n_unique, n_multi = n(400_000), max(8, n(1_000))
    mult = rng.integers(100, 301, n_multi)
    mult[0] = 300
    build = np.concatenate([
        np.arange(n_unique, dtype=np.int64),
        np.repeat(np.arange(n_unique, n_unique + n_multi, dtype=np.int64), mult)])
    rng.shuffle(build)
    probe = rng.integers(0, n_unique + n_multi, n(200_000)).astype(np.int64)
    probe[0] = n_unique  # the multiplicity-300 key is probed
    from ballista_tpu_torch.ops.runtime import bucket_rows

    slots = bucket_rows(len(probe), 16)
    seeds = (("join.gather", slots * 512, 1e-3, "device"),
             ("join.host", len(build) + len(probe), 10.0, "host"))
    shapes.append(("extended", build, probe, "device", 512, seeds))
    return shapes


def _host_ms(fn, reps: int = 3) -> float:
    """Median host milliseconds of fn() ending in a device synchronise."""
    import torch

    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def phase_join_shapes(seed: int, sf: float):
    """Phase 8 (see the module docstring)."""
    import torch

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops import costmodel, cuda_kernels, runtime
    from ballista_tpu_torch.ops import join as device_join
    from ballista_tpu_torch.physical.joinutil import join_indices

    dev = torch.device("cuda")
    config = BallistaConfig({**BASE, "ballista.tpu.cost_model": "true"})
    cuda_kernels.reset_launch_counts()
    results = {}
    for name, build, probe, want_path, want_tier, seeds in _join_shapes(seed, sf):
        costmodel.reset()
        costmodel.configure(config)
        for op, units, secs, engine in seeds:
            costmodel.seed(op, units, secs, engine=engine)
        runtime.join_path_stats(reset=True)
        device_join.readback_stats(reset=True)
        t0 = time.perf_counter()
        got = device_join.device_join_indices(build, probe, dev, config)
        first_ms = (time.perf_counter() - t0) * 1e3
        paths = runtime.join_path_stats(reset=True)
        reads = device_join.readback_stats(reset=True)
        if got is None:
            fail(f"join shape {name}: the device declined: {paths}")
        t0 = time.perf_counter()
        bi, pi = join_indices(build, probe, "inner")
        host_ms = (time.perf_counter() - t0) * 1e3
        want_counts = np.bincount(pi, minlength=len(probe))
        for label, a, b in (("build indices", got[0], bi), ("probe indices", got[1], pi),
                            ("counts", got[2], want_counts)):
            if a.dtype != np.int64 or not np.array_equal(a, b):
                fail(f"join shape {name}: {label} differ from the host oracle")
        if set(paths["paths"]) != {want_path} or paths["paths"][want_path] != 1:
            fail(f"join shape {name}: recorded {paths}, expected one {want_path!r}")
        _check_join_paths(name, paths)
        slots = runtime.bucket_rows(len(probe), 16)
        # two readbacks: the counts plane (one int32 per slot), the gather
        tier = (reads["bytes"] - 4 * slots) // (4 * slots)
        if reads["readbacks"] != 2 or tier != want_tier:
            fail(f"join shape {name}: gathered at width {tier} in {reads['readbacks']} "
                 f"readbacks, expected width {want_tier}")
        if want_tier == 512 and "device: extended tier past the static ladder" not in paths["reasons"]:
            fail(f"join shape {name}: no extended-tier reason: {paths}")
        b = runtime.upload(runtime.pad_to(build.astype(np.int32),
                                          runtime.bucket_rows(len(build), 16),
                                          device_join._PAD_CODE), dev)
        p = runtime.upload(runtime.pad_to(probe.astype(np.int32), slots, -1), dev)
        order, starts, counts = device_join.join_runs(b, p)
        runs_ms = _time_ms(lambda: device_join.join_runs(b, p))
        gather_ms = _time_ms(lambda: device_join.gather_matches(order, starts, counts, tier))
        membership_ms = _host_ms(
            lambda: device_join.device_membership_counts(build, probe, dev))
        runtime.join_path_stats(reset=True)
        device_join.readback_stats(reset=True)
        results[name] = {
            "build_rows": int(len(build)), "probe_rows": int(len(probe)),
            "probe_slots": slots, "max_multiplicity": int(want_counts.max()),
            "matches": int(len(bi)), "path": paths, "tier": int(tier),
            "readback_bytes": reads["bytes"],
            # device_join_indices end to end (upload, runs, both readbacks,
            # host flatten; the split's host remainder), first call
            "device_join_indices_ms": first_ms,
            # device ms per call (_time_ms) of the runs step and the gather
            # at the recorded width; host ms of the counts-only entry
            "runs_ms": runs_ms, "gather_ms": gather_ms,
            "membership_counts_ms": membership_ms,
            "host_oracle_ms": host_ms,
        }
        log(f"join shape {name}: {results[name]}")
        del order, starts, counts, b, p
    return results, cuda_kernels.launch_counts()


def _captured_kernel_inputs():
    """(name, codes, values, num_groups) of every sorted_grouped_sum call the
    path made, rebuilt from the resident stage entries."""
    import numpy as np

    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.ops.runtime import upload

    out = []
    for stage in list(kernels._stage_cache.values()):
        if stage in (None, False):
            continue
        for ent in stage._device_cache.values():
            if ent["kind"] != "pallas_sorted":
                continue
            aux = [upload(np.asarray(a), stage.device) for a in stage.compiler.build_aux()]
            vals = stage._masked_rows(ent["cols"], aux, ent["row_valid"])
            out.append((ent["codes"], vals.contiguous(), ent["n_groups"]))
    return out


def _skewed_case(seed: int, device):
    """One group spanning many kernel tiles, runs of random length, and
    single-row groups, with a mask row and two value rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lens = np.concatenate([
        [3_000_000],
        rng.integers(1, 40, 200_000),
        np.ones(500_000, dtype=np.int64),
        [70_000],
    ])
    rng.shuffle(lens)
    codes = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    n = len(codes)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    v = rng.normal(size=(2, n)).astype(np.float32) * mask
    vals = np.concatenate([mask[None, :], v])
    return (
        torch.from_numpy(codes).to(device),
        torch.from_numpy(vals).to(device).contiguous(),
        len(lens),
    )


def _sleep_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per device millisecond, measured once."""
    import torch

    global _SLEEP_RATE
    if _SLEEP_RATE is None:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_RATE = cycles / start.elapsed_time(end)
    return _SLEEP_RATE


_SLEEP_RATE = None


def _time_ms(fn, reps: int = TIME_REPS, windows: int = TIME_WINDOWS,
             warmup: int = 3) -> float:
    """Device milliseconds per call: `reps` calls back to back between two
    CUDA events, median over `windows` windows of elapsed / reps. Each window
    is queued behind a device sleep longer than the host takes to enqueue
    it, so the host's time per call (wrapper, allocation, ctypes) is not
    counted while the device runs faster than the host. A call that
    synchronises the host (torch.bincount) is timed at its own pace."""
    import torch

    host = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    ahead_ms = min(500.0, 1.0 + 2e3 * reps * max(host))
    cycles = int(ahead_ms * _sleep_cycles_per_ms())
    samples = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def _time_single_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """PRs 1 and 2's method, kept as `ms_single`: one call between two CUDA
    events after the host waited for the device, median of `reps` (host
    enqueue time included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def _device_ms(fn, kernel_names, reps: int = TIME_REPS):
    """Device time per call of the kernels whose names hold one of
    `kernel_names`, from torch.profiler's key_averages over `reps` calls;
    "not measured" when the profiler records no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if any(k in ev.key for k in kernel_names):
            total_us += float(getattr(ev, "device_time_total", None)
                              or getattr(ev, "cuda_time_total", 0.0) or 0.0)
    return total_us / reps / 1e3 if total_us > 0 else "not measured"


def _device_busy_ms(fn):
    """Device milliseconds inside one call of fn: the union of the intervals
    of every kernel and copy torch.profiler records on the card ("not
    measured" when it records none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy_us, end_us = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end_us:
            busy_us += stop - max(start, end_us)
            end_us = stop
    return busy_us / 1e3 if busy_us > 0 else "not measured"


def _previous_fields(prev, prev_ms, turns) -> dict:
    """The previous kernel's numbers for a case's record (none without it)."""
    if prev is None:
        return {}
    return {"previous_ms": prev_ms, "previous_ms_single": _time_single_ms(prev),
            "turns_ms": turns}


def _within(got, want, scale_dim: int):
    """(ok, max abs err): |got - want| <= RTOL_KERNEL |want| + ATOL_KERNEL_REL
    x the largest |want| along scale_dim (one output row or column)."""
    err = (got - want).abs()
    scale = want.abs().amax(dim=scale_dim, keepdim=True)
    tol = RTOL_KERNEL * want.abs() + ATOL_KERNEL_REL * scale
    return not bool((err > tol).any()), (float(err.max()) if err.numel() else 0.0)


def phase_kernels(seed: int, launches: dict, previous=None):
    import torch

    from ballista_tpu_torch.ops import cuda_kernels as ck

    cases = [(f"path_{i}", *c) for i, c in enumerate(_captured_kernel_inputs())]
    if len(cases) < 2:
        fail(f"expected the kernel inputs of q15 and q18, found {len(cases)}")
    cases.append(("skewed", *_skewed_case(seed, torch.device("cuda"))))
    results = []
    for name, codes, vals, G in cases:
        got = ck.sorted_grouped_sum(codes, vals, G)
        want = ck.sorted_grouped_sum_plain(codes, vals, G)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            fail(f"sorted_grouped_sum {name}: counts differ")
        ok, err = _within(got, want, 1)
        if not ok:
            fail(f"sorted_grouped_sum {name}: sums differ (max abs err {err})")
        nv, n = vals.shape
        lib_vals = vals.t().contiguous()
        def kernel():
            return ck.sorted_grouped_sum(codes, vals, G)

        prev = None
        if previous is not None:
            def prev():
                return previous(codes, vals, G)

            ok, prev_err = _within(prev(), want, 1)
            if not ok:
                fail(f"previous sorted_grouped_sum {name}: sums differ ({prev_err})")
        kernel_ms, prev_ms, turns = _time_pair(kernel, prev)
        kernel_ms_single = _time_single_ms(kernel)
        device_ms = _device_ms(kernel, ["sorted_grouped_sum"])
        plain_ms = _time_ms(lambda: ck.sorted_grouped_sum_plain(codes, vals, G))
        library_ms = _time_ms(lambda: torch.segment_reduce(
            lib_vals, "sum", lengths=torch.bincount(codes, minlength=G), axis=0
        ))
        lib = torch.segment_reduce(
            lib_vals, "sum", lengths=torch.bincount(codes, minlength=G), axis=0
        ).t()
        if not torch.allclose(lib, want, rtol=1e-4, atol=1e-3 * float(want.abs().max())):
            fail(f"library call disagrees with the plain version on {name}")
        nbytes = n * 4 + nv * n * 4 + nv * G * 4
        ops = nv * n
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / F32_FLOPS * 1e3
        results.append({
            "case": name, "n": n, "nv": nv, "groups": G,
            "max_abs_err": err, "ms": kernel_ms, "ms_single": kernel_ms_single,
            "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **_previous_fields(prev, prev_ms, turns),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        })
        log(f"sorted_grouped_sum {name}: {results[-1]}")
    # the headline is the largest path case (q18's inner aggregate)
    head = max((r for r in results if r["case"].startswith("path_")),
               key=lambda r: r["groups"])
    return [{
        "name": "sorted_grouped_sum",
        "route": "cuda",
        "source": "ballista_tpu_torch/csrc/sorted_grouped_sum.cu",
        "replaces": "ballista_tpu/ops/pallas_kernels.py:178",
        "launches": launches["sorted_grouped_sum"],
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": head["ms"],
        "ms_single": head["ms_single"],
        "device_ms": head["device_ms"],
        **{k: head[k] for k in ("previous_ms", "previous_ms_single") if k in head},
        "plain_ms": head["plain_ms"],
        "library_ms": head["library_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "cases": results,
    }]


def _q1_batches():
    """Per batch entry of the q1 stage (the path's one grouped "batches"
    stage): (codes int32 [N], f32 sum inputs [N, A], mask = row_valid AND
    the filters [N], group count, the stage's own f32 group sums [G, A]),
    and the stage's row count."""
    import torch

    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.ops.runtime import upload, widen_cols
    from ballista_tpu_torch.ops.stage import _rows_like

    stages = [
        s for s in list(kernels._stage_cache.values())
        if s not in (None, False) and s.group_exprs
        and any(e["kind"] == "batches" for e in s._device_cache.values())
    ]
    if len(stages) != 1:
        fail(f"expected one grouped batches stage (q1), found {len(stages)}")
    stage = stages[0]
    aux = [upload(np.asarray(a), stage.device) for a in stage.compiler.build_aux()]
    out, n_rows = [], 0
    for prepared in stage._device_cache.values():
        for b in prepared["entries"]:
            cols = widen_cols(b["cols"])
            mask = b["row_valid"]
            for fm in stage.filter_masks:
                mask = torch.logical_and(mask, fm(cols, aux))
            vals = torch.stack([
                _rows_like(vf.fn(cols, aux), mask).to(torch.float32)
                for a, vf, ix in zip(stage.aggs, stage.value_fns, stage.int_exact)
                if vf is not None and not ix and a.fn in ("sum", "avg")
            ], dim=1).contiguous()
            _, floats = stage._batch_step(
                b["seg_bucket"], b["cols"], aux, b["codes"], b["row_valid"]
            )
            if floats is None or floats.shape[0] != vals.shape[1]:
                fail("q1 stage: its f32 rows are not exactly its sum inputs")
            G = b["n_groups"]
            out.append((b["codes"].to(torch.int32).contiguous(), vals,
                        mask.contiguous(), G, floats[:, :G].t()))
            n_rows += int(b["row_valid"].sum())
    return out, n_rows


def phase_grouped_aggregate(seed: int, launches: dict, previous=None):
    import torch

    from ballista_tpu_torch.ops import cuda_kernels as ck

    batches, n_rows = _q1_batches()
    # its own entry, the one a user calls: counted from 0 across its runs
    ck.reset_launch_counts()
    q1_err = q1_stage_err = 0.0
    for codes, vals, mask, G, stage_sums in batches:
        got = ck.grouped_aggregate_arrays(
            codes.cpu().numpy(), vals.cpu().numpy(), mask.cpu().numpy(), G
        )
        got = torch.from_numpy(got).to(vals.device)
        ok, err = _within(got, ck.grouped_aggregate_plain(codes, vals, mask, G), 0)
        if not ok:
            fail(f"grouped_aggregate q1 batch: differs from the plain version ({err})")
        ok, stage_err = _within(got, stage_sums, 0)
        if not ok:
            fail(f"grouped_aggregate q1 batch: differs from the stage's sums ({stage_err})")
        q1_err, q1_stage_err = max(q1_err, err), max(q1_stage_err, stage_err)
    entry_launches = ck.launch_counts()["grouped_aggregate"]
    if entry_launches != len(batches):
        fail(f"grouped_aggregate: {entry_launches} launches for {len(batches)} batches")
    results = [{
        "case": "q1_batches", "batches": len(batches), "n": n_rows,
        "groups": batches[0][3], "values": batches[0][1].shape[1],
        "max_abs_err": q1_err, "max_abs_err_vs_stage": q1_stage_err,
    }]
    log(f"grouped_aggregate q1: {results[-1]}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = 8
    for G in (4, 128):
        codes = torch.randint(0, G, (n_rows,), generator=gen, device=dev,
                              dtype=torch.int32)
        vals = torch.rand(n_rows, A, generator=gen, device=dev) * 200 - 100
        mask = torch.rand(n_rows, generator=gen, device=dev) < 0.98
        got = ck.grouped_aggregate(codes, vals, mask, G)
        want = ck.grouped_aggregate_plain(codes, vals, mask, G)
        torch.cuda.synchronize()
        ok, err = _within(got, want, 0)
        if not ok:
            fail(f"grouped_aggregate G={G}: differs from the plain version ({err})")

        def library():
            return torch.zeros(G, A, device=dev).index_add_(0, codes, vals * mask[:, None])

        if not torch.allclose(library(), want, rtol=1e-4,
                              atol=1e-3 * float(want.abs().max())):
            fail(f"grouped_aggregate G={G}: the library call disagrees")
        def kernel():
            return ck.grouped_aggregate(codes, vals, mask, G)

        prev = None
        if previous is not None:
            def prev():
                return previous(codes, vals, mask, G)

            ok, prev_err = _within(prev(), want, 0)
            if not ok:
                fail(f"previous grouped_aggregate G={G}: differs ({prev_err})")
        kernel_ms, prev_ms, turns = _time_pair(kernel, prev)
        kernel_ms_single = _time_single_ms(kernel)
        device_ms = _device_ms(kernel, ["grouped_aggregate"])
        plain_ms = _time_ms(lambda: ck.grouped_aggregate_plain(codes, vals, mask, G))
        library_ms = _time_ms(library)
        bound_bytes_ms = (n_rows * (4 + 1 + 4 * A) + G * A * 4) / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = n_rows * A / F32_FLOPS * 1e3
        results.append({
            "case": f"synthetic_g{G}", "n": n_rows, "values": A, "groups": G,
            "kept": float(mask.float().mean()), "max_abs_err": err,
            "ms": kernel_ms, "ms_single": kernel_ms_single, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **_previous_fields(prev, prev_ms, turns),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        })
        log(f"grouped_aggregate G={G}: {results[-1]}")
        del codes, vals, mask
    # the headline is q1's contention at full size: G = 4
    head = results[1]
    return {
        "name": "grouped_aggregate",
        "route": "cuda",
        "source": "ballista_tpu_torch/csrc/grouped_aggregate.cu",
        "replaces": "ballista_tpu/ops/pallas_kernels.py:211",
        # not on the main path: it runs only from its entry point
        "launches": launches["grouped_aggregate"],
        "on_main_path": False,
        "entry": "ballista_tpu_torch.ops.cuda_kernels.grouped_aggregate_arrays",
        "entry_launches": entry_launches,
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": head["ms"],
        "ms_single": head["ms_single"],
        "device_ms": head["device_ms"],
        **{k: head[k] for k in ("previous_ms", "previous_ms_single") if k in head},
        "plain_ms": head["plain_ms"],
        "library_ms": head["library_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "cases": results,
    }


# -- phase 9: the persisted layout cache ----------------------------------------

def _write_answer(path: pathlib.Path, table) -> None:
    import pyarrow as pa

    with pa.OSFile(str(path), "wb") as sink, pa.ipc.new_file(sink, table.schema) as w:
        w.write_table(table)


def _read_answer(path: pathlib.Path):
    import pyarrow as pa

    with pa.memory_map(str(path)) as src:
        return pa.ipc.open_file(src).read_all()


def _same_answer(name: str, got, want) -> bool:
    """Hold an answer over a warm store to the empty-store run's: columns,
    rows, keys, counts and integer sums exact; floats within the path's
    tolerance. Returns whether every float column is bit-equal too."""
    import pyarrow as pa

    if got.column_names != want.column_names or got.num_rows != want.num_rows:
        fail(f"{name}: {got.num_rows} rows {got.column_names} over the warm store, "
             f"{want.num_rows} rows {want.column_names} over the empty store")
    bit_equal = True
    for c, f in zip(want.column_names, want.schema):
        a = got.column(c).to_numpy(zero_copy_only=False)
        b = want.column(c).to_numpy(zero_copy_only=False)
        if pa.types.is_floating(f.type):
            if not np.allclose(a, b, rtol=RTOL_PATH, atol=ATOL_PATH):
                fail(f"{name}: column {c} over the warm store differs "
                     f"(max abs err {np.max(np.abs(a - b))})")
            bit_equal = bit_equal and a.tobytes() == b.tobytes()
        elif list(a) != list(b):
            fail(f"{name}: column {c} over the warm store differs")
    return bit_equal


def _chunks_of(lineitem_file: pathlib.Path, batch_size: int) -> int:
    import pyarrow.parquet as pq

    return -(-pq.ParquetFile(str(lineitem_file)).metadata.num_rows // batch_size)


def residency_runs(make_ctx):
    """Phase 9's residency part: RESIDENCY_PAIR's "sorted" stage queries
    (A, B) run A, B, A, B, A, B, A, B under a budget of the larger stage
    plus half the smaller (so it holds one, not both), each stage sized by
    one unconstrained run first. `make_ctx(settings)` gives a context with
    the TPC-H tables registered. Returns per run (query, pins, evictions,
    streams) from runtime.residency_stats, the stage sizes in pair order,
    and the budget."""
    from ballista_tpu_torch.ops import kernels, runtime

    sizes = []
    for _name, sql in RESIDENCY_PAIR:
        kernels.clear_stage_cache()
        runtime.reset_residency()
        make_ctx(BASE).sql(sql).collect()
        sizes.append(runtime.resident_bytes())
    budget = max(sizes) + min(sizes) // 2
    kernels.clear_stage_cache()
    runtime.reset_residency()
    ctx = make_ctx({**BASE, "ballista.tpu.hbm_budget_bytes": str(budget)})
    runs = []
    for _cycle in range(4):
        for name, sql in RESIDENCY_PAIR:
            runtime.routing_stats(reset=True)
            ctx.sql(sql).collect()
            c = runtime.residency_stats(reset=True)
            routes = runtime.routing_stats(reset=True)["routes"]
            if set(routes) != {"sorted"}:
                raise AssertionError(f"residency {name}: expected the sorted route, "
                                     f"recorded {routes}")
            runs.append((name, c["pins"], c["evictions"], c["streams"]))
    kernels.clear_stage_cache()
    runtime.reset_residency()
    return runs, sizes, budget


def _store_span_ms() -> dict:
    """Milliseconds in the store's spans since the last tracing reset:
    {"layout_cache.load": reads (and misses), "layout_cache.save": writes}."""
    from ballista_tpu_torch.utils import tracing

    out = {"layout_cache.load": 0.0, "layout_cache.save": 0.0}
    for path, dt, _ in tracing.spans():
        name = path.split("/")[-1]
        if name in out:
            out[name] += dt * 1e3
    return out


def phase_layout_cache(data_dir: str):
    """Phase 9 (see the module docstring), over phase 3's data."""
    import os

    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime
    from ballista_tpu_torch.ops import layout_cache as lc

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_layouts_"))
    try:
        base = work / "layouts"
        settings = {**BASE, "ballista.tpu.layout_cache_dir": str(base)}
        store = lc.store_dir(BallistaConfig(settings))
        host_ctx = ExecutionContext(BallistaConfig({**BASE, "ballista.executor.backend": "cpu"}))
        register_all(host_ctx, data_dir)
        answers = work / "answers"
        answers.mkdir()
        result = {"store": "<tmp>/layouts_torch", "queries": {}}
        # 1. cold over an empty store
        for name in LAYOUT_QUERIES:
            sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
            kernels.clear_stage_cache()
            ctx = ExecutionContext(BallistaConfig(settings))
            register_all(ctx, data_dir)
            _reset_counters()
            entries0, bytes0 = lc.entry_count(store), lc.store_bytes(store)
            t0 = time.perf_counter()
            got = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
            ingest = runtime.ingest_stats(reset=True)
            store_ms = _store_span_ms()
            t0 = time.perf_counter()
            expect = host_ctx.sql(sql).collect()
            cpu_ms = (time.perf_counter() - t0) * 1e3
            _compare(name, got, expect)
            _write_answer(answers / f"{name}.arrow", got)
            result["queries"][name] = {
                "empty_store_cold_ms": cold_ms, "cpu_backend_ms": cpu_ms,
                "empty_store_prepares": ingest["prepares"],
                "empty_store_prepare_ms": {k: ingest[k] * 1e3 for k in
                                           ("scan_s", "encode_s", "upload_s", "wall_s")},
                "entries_written": lc.entry_count(store) - entries0,
                "bytes_written": lc.store_bytes(store) - bytes0,
                "store_write_ms": store_ms["layout_cache.save"],
                "store_probe_ms": store_ms["layout_cache.load"],
            }
            if result["queries"][name]["entries_written"] < 1:
                fail(f"{name}: the cold run persisted nothing")
            log(f"layout cache {name} (empty store): {result['queries'][name]}")
        kernels.clear_stage_cache()
        # 2. the append directory: one lineitem file, warmed, then the second
        files = sorted((pathlib.Path(data_dir) / "lineitem").glob("*.parquet"))
        if len(files) < 2:
            fail(f"append: expected two lineitem files, found {len(files)}")
        append_dir = work / "append" / "lineitem"
        append_dir.mkdir(parents=True)
        shutil.copy(files[0], append_dir / files[0].name)
        q1 = (ROOT / "benchmarks/tpch/queries/q1.sql").read_text()
        ctx = ExecutionContext(BallistaConfig(settings))
        ctx.register_parquet("lineitem", str(append_dir))
        runtime.delta_stats(reset=True)
        ctx.sql(q1).collect()
        warmed = runtime.delta_stats(reset=True)
        bs = ctx.config.batch_size()
        want_first, want_second = _chunks_of(files[0], bs), _chunks_of(files[1], bs)
        if warmed != {"chunks_prepared": want_first}:
            fail(f"append: warming one file recorded {warmed}, not {want_first} chunks")
        shutil.copy(files[1], append_dir / files[1].name)
        host_append = ExecutionContext(BallistaConfig({**BASE, "ballista.executor.backend": "cpu"}))
        host_append.register_parquet("lineitem", str(append_dir))
        append_expect = host_append.sql(q1).collect()
        kernels.clear_stage_cache()
        # 3. the kernel cache: a second build runs no nvcc
        runtime.serving_stats(reset=True)
        rebuilt = cuda_kernels.build()
        second_build = runtime.serving_stats(reset=True)
        if any(b["seconds"] is not None for b in rebuilt.values()) or \
                second_build != {"compile_hit_disk": len(rebuilt)}:
            fail(f"kernel cache: a second build compiled: {second_build}")
        # 4. a new process: the same queries cold over the warm store, the
        # append, and the kernel libraries from disk
        torch.cuda.empty_cache()
        spec = {"data_dir": data_dir, "append_dir": str(append_dir.parent),
                "settings": settings, "queries": LAYOUT_QUERIES, "out": str(work)}
        (work / "spec.json").write_text(json.dumps(spec))
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                                "--layout-child", str(work / "spec.json")],
                               capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            fail(f"layout cache child process failed (rc {child.returncode}):\n"
                 f"{child.stderr[-4000:]}")
        warm = json.loads((work / "child.json").read_text())
        for name in LAYOUT_QUERIES:
            row = result["queries"][name]
            w = warm["queries"][name]
            if w["prepares"] != 0:
                fail(f"{name}: {w['prepares']} prepares over the warm store")
            row["bit_equal"] = _same_answer(
                name, _read_answer(work / f"warm_{name}.arrow"),
                _read_answer(answers / f"{name}.arrow"))
            row.update({"warm_store_cold_ms": w["cold_ms"], "warm_store_prepares": 0,
                        "warm_store_read_ms": w["store_read_ms"],
                        "warm_store_routes": w["routes"]})
            log(f"layout cache {name} (warm store, new process): {row}")
        app = warm["append"]
        if app["delta"].get("chunks_reused") != want_first or \
                app["delta"].get("chunks_prepared") != want_second:
            fail(f"append: {app['delta']}, expected {want_first} chunks reused and "
                 f"{want_second} prepared")
        _compare("append q1", _read_answer(work / "warm_append_q1.arrow"), append_expect)
        kc = warm["kernels"]
        if kc.get("compile_hit_disk") != len(rebuilt) or kc.get("kernel_built", 0) != 0:
            fail(f"kernel cache: the new process recorded {kc}")
        result.update({
            "store_bytes": lc.store_bytes(store), "store_entries": lc.entry_count(store),
            "append": {"first_file_chunks": want_first, "second_file_chunks": want_second,
                       "warming": warmed, "child": app},
            "kernel_cache": {"second_build": second_build, "child": kc,
                             "child_prewarm_ms": warm["prewarm_ms"]},
            "child_process_s": child_s,
        })
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # 5. residency: two sorted stages alternating under a budget for one
    def make_ctx(settings):
        ctx = ExecutionContext(BallistaConfig(settings))
        register_all(ctx, data_dir)
        return ctx

    runs, sizes, budget = residency_runs(make_ctx)
    counts = [tuple(r[1:]) for r in runs]
    expected = residency_sequence(*sizes)
    if counts != expected:
        fail(f"residency: (pins, evictions, streams) per run {counts}, "
             f"expected {expected} for stage sizes {sizes}")
    result["residency"] = {"runs": runs, "stage_bytes": sizes, "budget": budget}
    log(f"layout cache residency: {result['residency']}")
    return result


def layout_child(spec_path: str) -> int:
    """The new process of phase 9: the kernel libraries from disk, every
    query cold over the warm store, then q1 over the grown append
    directory. Writes child.json and the answers beside the spec."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime
    from ballista_tpu_torch.utils import tracing

    spec = json.loads(pathlib.Path(spec_path).read_text())
    out = pathlib.Path(spec["out"])
    settings = spec["settings"]
    runtime.serving_stats(reset=True)
    t0 = time.perf_counter()
    cuda_kernels.prewarm(BallistaConfig(settings))
    result = {"kernels": runtime.serving_stats(reset=True),
              "prewarm_ms": (time.perf_counter() - t0) * 1e3, "queries": {}}
    for name in spec["queries"]:
        sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
        kernels.clear_stage_cache()
        ctx = ExecutionContext(BallistaConfig(settings))
        register_all(ctx, spec["data_dir"])
        runtime.ingest_stats(reset=True)
        runtime.routing_stats(reset=True)
        tracing.reset()
        t0 = time.perf_counter()
        got = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        result["queries"][name] = {
            "cold_ms": (time.perf_counter() - t0) * 1e3,
            "store_read_ms": _store_span_ms()["layout_cache.load"],
            "prepares": runtime.ingest_stats(reset=True)["prepares"],
            "routes": runtime.routing_stats(reset=True)["routes"],
        }
        _write_answer(out / f"warm_{name}.arrow", got)
    kernels.clear_stage_cache()
    q1 = (ROOT / "benchmarks/tpch/queries/q1.sql").read_text()
    ctx = ExecutionContext(BallistaConfig(settings))
    ctx.register_parquet("lineitem", str(pathlib.Path(spec["append_dir"]) / "lineitem"))
    runtime.delta_stats(reset=True)
    runtime.ingest_stats(reset=True)
    t0 = time.perf_counter()
    got = ctx.sql(q1).collect()
    torch.cuda.synchronize()
    result["append"] = {"cold_ms": (time.perf_counter() - t0) * 1e3,
                        "delta": runtime.delta_stats(reset=True),
                        "prepares": runtime.ingest_stats(reset=True)["prepares"]}
    _write_answer(out / "warm_append_q1.arrow", got)
    result["kernels_after"] = runtime.serving_stats(reset=True)
    (out / "child.json").write_text(json.dumps(result))
    return 0


# -- phase 10: the distributed path -----------------------------------------------

def _host_declines(routes: dict, joins: dict) -> set:
    """What of a run left the card: its stage decline reasons and every
    non-"device" join path with its reasons."""
    out = {f"reason: {r}" for r in routes.get("reasons", {})}
    out |= {f"join: {p}" for p in joins.get("paths", {}) if p != "device"}
    out |= {f"join: {r}" for r in joins.get("reasons", {})}
    return out


def _cluster_run(ctx, sql):
    """One query through the cluster: (answer, ms, counters of the run)."""
    import torch

    from ballista_tpu_torch.ops import runtime

    for stats in (runtime.routing_stats, runtime.join_path_stats, runtime.readback_stats,
                  runtime.exchange_stats, runtime.shuffle_tier_stats,
                  runtime.shared_scan_stats):
        stats(reset=True)
    t0 = time.perf_counter()
    got = ctx.sql(sql).collect()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    routes = runtime.routing_stats(reset=True)
    return got, ms, {
        "routes": routes["routes"], "reasons": routes["reasons"],
        "join_paths": runtime.join_path_stats(reset=True),
        "readbacks": runtime.readback_stats(reset=True),
        "exchange": runtime.exchange_stats(reset=True),
        "shuffle_tier": runtime.shuffle_tier_stats(reset=True),
        "shared_scan": runtime.shared_scan_stats(reset=True),
    }


def phase_distributed(data_dir: str, local: dict, local_answers: dict,
                      kernel_answers: dict):
    """Phase 10 (see the module docstring), over phase 3's data. `local`
    maps each query to its local-engine record from phases 3, 6 and 7,
    `local_answers` to the "cpu" backend's answer they computed, and
    `kernel_answers` holds phase 3's answers of Q15_REVENUE and
    Q18_INNER."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    settings = {**BASE, "ballista.tpu.layout_cache_dir": str(pathlib.Path(work) / "layouts"),
                **DIST_SETTINGS}
    device = torch.device("cuda")
    kernels.clear_stage_cache()
    runtime.reset_residency()
    cluster = StandaloneCluster(n_executors=2, config=BallistaConfig(settings), device=device)
    result = {"queries": {}, "kernel": {}}
    try:
        def client(extra=None):
            ctx = BallistaContext(*cluster.scheduler_addr,
                                  settings={**settings, **(extra or {})}, device=device)
            register_all(ctx, data_dir)
            return ctx

        ctx = client()
        served = []
        # the main path: every launch counter starts at 0 here
        cuda_kernels.reset_launch_counts()
        for i in range(1, 23):
            name = f"q{i}"
            sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
            kernels.clear_stage_cache()
            got, cold_ms, run = _cluster_run(ctx, sql)
            _compare(f"{name} (cluster)", got, local_answers[name])
            new = _host_declines(run, run["join_paths"]) - local[name]["declines"]
            if new:
                fail(f"{name}: the cluster left the card where the local engine did not: "
                     f"{sorted(new)}")
            ex = run["exchange"]
            if ex.get("published", 0) > 0 and (ex.get("reupload_skipped", 0)
                                               or ex.get("served_from_registry", 0)):
                served.append(name)
            result["queries"][name] = {"rows": got.num_rows, "cold_ms": cold_ms,
                                       "local_cold_ms": local[name]["cold_ms"], **run}
            log(f"{name} (cluster): {result['queries'][name]}")
        for name in DIST_WARM:
            sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
            warm = []
            for _ in range(TPCH_WARM):
                again, ms, _run = _cluster_run(ctx, sql)
                warm.append(ms)
            _compare(f"{name} (cluster, warm)", again, local_answers[name])
            result["queries"][name].update(
                warm_ms=statistics.median(warm), warm_runs_ms=warm,
                local_warm_ms=local[name]["warm_ms"])
        ctx.close()
        launches = cuda_kernels.launch_counts()
        if not served:
            fail("no query served a piece from the exchange registry")
        result["served_from_registry"] = served

        # the kernel: every PARTIAL stage run of the two aggregates takes
        # "pallas_sorted" and launches sorted_grouped_sum
        ctx = client(PALLAS)
        for name, sql in (("q15_revenue", Q15_REVENUE), ("q18_inner", Q18_INNER)):
            kernels.clear_stage_cache()
            cuda_kernels.reset_launch_counts()
            got, ms, run = _cluster_run(ctx, sql)
            n = cuda_kernels.launch_counts()["sorted_grouped_sum"]
            if set(run["routes"]) != {"pallas_sorted"} or run["reasons"]:
                fail(f"{name} (cluster, pallas): routes {run['routes']} {run['reasons']}")
            parts = run["routes"]["pallas_sorted"]
            if parts < 2 or n < parts:
                fail(f"{name} (cluster, pallas): {parts} stage runs, {n} kernel launches")
            _compare(f"{name} (cluster, pallas)", got, kernel_answers[sql])
            launches["sorted_grouped_sum"] += n
            result["kernel"][name] = {"stage_runs": parts, "launches": n, "ms": ms,
                                      "rows": got.num_rows}
            log(f"{name} (cluster, pallas): {result['kernel'][name]}")
        ctx.close()
    finally:
        cluster.shutdown()
        kernels.clear_stage_cache()
        shutil.rmtree(work, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 (distributed): {result['seconds']:.1f} s")
    return result, launches


def _local_record(times: dict) -> dict:
    """A local-engine query record of phases 3, 6 and 7, for phase 10."""
    return {"declines": _host_declines(times, times.get("join_paths", {})),
            "cold_ms": times["cold_ms"], "warm_ms": times["warm_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=20260728)
    ap.add_argument("--compare-sources", default=None, metavar="DIR",
                    help="also build the kernel sources in DIR (PR 2's C "
                         "interface) and time them beside the current ones")
    ap.add_argument("--layout-child", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)  # phase 9's new process
    args = ap.parse_args()

    smi_line = phase_device()
    log(smi_line)
    sys.path.insert(0, str(ROOT))
    import torch

    import ballista_tpu_torch  # noqa: F401  (fails outside a checkout)
    from ballista_tpu_torch.ops import cuda_kernels

    if args.layout_child:
        return layout_child(args.layout_child)

    build_s, ptxas, libraries = phase_build()
    sass = _sass_atomics(libraries)
    previous = {}
    if args.compare_sources:
        previous, prev_facts = _previous_kernels(args.compare_sources)
        ptxas = {**ptxas, "previous": prev_facts}
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_tpch_")
    try:
        times, launches, path_answers = phase_path(args.sf, args.seed, data_dir)
        kernels = phase_kernels(args.seed, launches,
                                previous.get("sorted_grouped_sum"))
        kernels.append(phase_grouped_aggregate(args.seed, launches,
                                               previous.get("grouped_aggregate")))
        join_times, join_launches, join_answers = phase_joins(data_dir)
        tpch_times, tpch_launches, tpch_answers = phase_tpch(data_dir)
        cuda_kernels.reset_launch_counts()
        layout_times = phase_layout_cache(data_dir)
        layout_launches = cuda_kernels.launch_counts()
        # phase 10 holds the cluster to the local engine's records of
        # phases 3, 6 and 7, and reuses their "cpu" answers
        local = {name: _local_record(t) for name, t in
                 [*((n, times[n]) for n in ("q1", "q6")), *join_times.items(),
                  *tpch_times.items()]}
        local_answers = {**join_answers, **tpch_answers}
        for name in ("q1", "q6"):
            local_answers[name] = path_answers[
                (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()]
        dist_times, dist_launches = phase_distributed(data_dir, local, local_answers,
                                                      path_answers)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    shape_times, shape_launches = phase_join_shapes(args.seed, args.sf)
    for k in kernels:
        k["launches_by_path"] = {"aggregates": k["launches"],
                                 "joins": join_launches[k["name"]],
                                 "tpch": tpch_launches[k["name"]],
                                 "layout_cache": layout_launches[k["name"]],
                                 "join_shapes": shape_launches[k["name"]],
                                 "distributed": dist_launches[k["name"]]}
    print(json.dumps({"queries": times, "joins": join_times, "tpch": tpch_times,
                      "join_shapes": shape_times, "build_s": build_s,
                      "sf": args.sf, "seconds": time.perf_counter() - T0}))
    print(json.dumps({"layout_cache": layout_times}))
    print(json.dumps({"distributed": dist_times}))
    print(json.dumps({"ptxas": ptxas, "sass_atomics": sass}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
