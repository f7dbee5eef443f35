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
   (the "join.*" keys of utils/counters.py's readback set) are subtracted
   from the totals, cold and warm, whether a warm run joins again or not.
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

11. shared scan, mesh stages and the span export (runs after phase 10,
   over phase 3's data). Shared scan: the four SHARED_QUERIES (distinct
   "batches"-route aggregates over lineitem: three with only counts,
   integer sums and min / max, one with an f32 sum) run one at a time
   through the package's cluster (device residency and the layout store
   off), then together: submitted while the cluster has no executor, so
   their scan stages co-pend, then one executor starts. Every member must
   be bit-equal to its solo run, with batches_formed, uploads_saved and
   launches_saved >= 1 and at least two members spliced (routing event
   "stage:batch"); prints the solo and batched wall ms of the set. Mesh
   stages: under ballista.tpu.spmd_stages all 22 TPC-H queries and q18's
   inner aggregate run through a cluster on the card's own mesh (one
   shard), each held to the "cpu" backend's answer of phases 3, 6 and 7
   under phase 3's tolerance; prints per query the path (mesh / host /
   unfused, from the spmd.* tracing counters), the counters, the cold ms
   beside phase 10's unfused cold ms; q1, q18-inner and q3 must take the
   mesh. Then q1, q18-inner (the sorted program) and q3 (SpmdJoinExec) on
   a four-shard mesh of the one card (the device list repeated) must take
   the mesh and equal the one-shard answers (non-float columns exactly,
   floats under phase 3's tolerance). The demos of parallel/spmd.py (q1's
   step and the all_to_all exchange) run over lineitem's columns on the
   four-shard mesh against a float64 numpy reference. Last, a q6 run with
   span recording on, exported as BALLISTA_TRACE_DIR's Chrome trace, must
   hold the run's stage.run and readback spans. Each device program of the slice
   (the shared-scan combined step, the unrolled, sorted and join mesh
   programs, the two demos) is timed warm on its last captured call
   (device ms as in phase 4) beside its byte bound and the number of
   times the phase ran it. Printed as one {"shared_mesh": ...} line. The
   multi-process mesh path cannot show here (one card, world size 1);
   tests/test_torch_multihost.py runs it over gloo on the CPU.

12. serving (runs after phase 11, over phase 3's data): one
   StandaloneCluster of two executors on the card, push dispatch and the
   result cache on (their defaults), speculation armed (min_runtime_ms 100,
   multiplier 2). (a) Tenants: q1, q3, q6, q12, q18 and q18's inner
   aggregate (under ballista.tpu.sorted_kernel=pallas) run cold and warm
   with the result cache off, then four client threads, each its own
   tenant, replay 12 submissions drawn Zipf(1.6) from a fixed seed with the
   cache on, then each query once more (a hit). Every answer is held to the
   "cpu" answer of phases 3, 6 and 7 under phase 3's tolerance; the replay
   must hit the cache and dispatch by push only; the executors must launch
   sorted_grouped_sum. Prints cold, warm and hit ms per query, p50 and p99
   per tenant, tenancy_stats and pushes against polls. (b) Streaming: q3
   and q18 through collect_stream, bit-equal to collect; ms to the first
   batch beside the whole. (c) Advancement: the two lineitem files
   hard-linked into a new directory, ADVANCE_SQL (which scheduler/delta.py
   must accept) run cold, a seeded slice of lineitem appended as a third
   file: the rerun must advance (advance_hits 1) and equal a cache-off full
   run on "cuda" and on "cpu" bit for bit; prints the advanced run's ms
   beside the full runs'. (d) Speculation: q1, q6 and q12 clean, then
   under task.slow chaos (rate 0.2, slow_ms 2000): at least one duplicate
   launches and every answer is bit-equal to its clean pass. (e) Executor
   loss: on the shared shuffle tier q3 and q18 run while one executor
   stops (while it runs one of their tasks): answers bit-equal to clean runs,
   recovery_stats counts the recovery and the stopped executor leaves no
   entry in the exchange registry. Printed as one {"serving": ...} line.

13. daemons (runs after phase 12, over phase 3's data): the deployment of
   deployment/docker-compose.yaml on one card, through the package's own
   daemons as processes (started by tests/torch_daemon_cluster.py):
   `python -m ballista_tpu_torch.scheduler --config-backend sqlite` and two
   `python -m ballista_tpu_torch.executor --shuffle-tier shared` (default
   settings: the card is their device, four task slots, every kernel
   library loaded before they serve), started at once from a copy of the
   package with no build/ directory, and a BallistaContext in this process.
   (c) Both executors build the kernel libraries at once and both load
   both; prints each process's seconds to its start line and its compile
   seconds. (a) DAEMON_QUERIES run cold and
   twice warm, each held to the "cpu" answer of phases 3, 6 and 7 under
   phase 3's tolerance, beside phase 10's ms. (b) nvidia-smi
   --query-compute-apps must list both executor pids with memory (where it
   lists no pid of this pid namespace, each executor's own allocator must
   show reserved memory); each executor's stop line (SIGINT) must show the
   route pallas_sorted and both libraries, and together at least one
   sorted_grouped_sum launch per scan partition and run of q18-inner. (d)
   Two new executors start on the now warm build directory; DAEMON_KILL runs
   clean, then with one map task slowed by seeded task.slow chaos, and the
   other executor is SIGKILLed once its map output is on the shared tier
   and it holds no task: the answer must be bit-equal to the clean run, the
   final stage must run on the survivor, and the seconds from the kill to
   the answer (and any wait for the 60 s executor lease) are printed;
   SIGINT stops the survivor, which must have read pieces from the shared
   tier. Two more executors start; DAEMON_KILL runs with the same task
   slowed, and the executor that runs it is SIGKILLed while it does: the
   scheduler must forget the dead process and put the task back, and the
   answer must be bit-equal and come within half the lease; the seconds
   from the kill to each are printed. (e) SIGINT stops the last survivor
   and the scheduler; every daemon still alive is killed in a finally,
   which then fails the run. Printed as one {"daemons": ...} line;
   the executors' launches count in the kernels line.

14. bench (runs after phase 13, over phase 3's data): the port's benchmark
   entry, each part in a fresh process on the card with its dataset root
   (BENCH_CACHE_DIR) in a temporary directory that links phase 3's data:
   `python -m ballista_tpu_torch.bench` with BENCH_CONFIGS q1, q3 and q6
   at --sf and no scenario (the rows, then both taxi shapes at 10 M trips
   generated there); BENCH_ELASTIC_ONLY (60,000 rows) and
   BENCH_REPLICA_ONLY (40,000 rows, two clients, 4 s per leg); the TPC-H
   runner's `benchmark --query 1 --iterations 2 --backend cuda`; and the
   comparison (`bench.compare`) on q1, q3, q5, q6, q10 and q12
   against the "cpu" backend and the pyarrow code (the pandas oracles,
   about 80 s at SF 1, are held to all 22 queries in
   tests/test_torch_bench.py instead).
   Every row must report "match": true, a device route with no decline,
   its kernel launches, residency and h2d_chunk_bytes; the fleet must scale
   up and down with zero task retries and equal answers; the replica run
   must kill one of its two schedulers and keep its answers; the runner
   must answer q1's 4 rows; the comparison must find no mismatch. Printed
   as one {"bench": ...} line with each part's seconds; the rows' kernel
   launches count in the kernels line.

15. witness (runs after phase 14, over phase 3's data): the lock witness
   of ballista_tpu_torch/utils/locks.py armed in this process
   (locks.enable_witness()) around a StandaloneCluster of two executors on
   the card, shared scan on, with one seeded executor.death (local-0 dies
   at one of its first polls): four client threads run q1, q3, q6 and q18,
   then each q18's inner aggregate under PALLAS (sorted_grouped_sum must
   launch); then restart_scheduler() on the same store and the same round
   again. Then the daemons of phase 13 (from this checkout, its kernel
   libraries already built) start as processes with BALLISTA_LOCK_WITNESS=1
   and BALLISTA_LOCK_WITNESS_OUT set before import, run q1, q3 and q18's
   inner aggregate, and stop on SIGINT (each leaves <OUT>.<pid>). Every
   answer is held to the "cpu" one; the dumps (this process's and one per
   daemon) merge in `python -m ballista_tpu_torch.analysis --check-witness`.
   The phase fails if an answer differs, a process saw no edge, a
   violation was recorded, a runtime edge is missing from the static graph,
   sorted_grouped_sum launched no time in this process, or the death or the
   restart was not counted. Printed as one {"witness": ...} line: edges per
   process, violations, missed and stale declared edges, the number of
   declared edges no process took, launches (this process's and the
   daemons'), seconds.

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
line of phase 10, the {"shared_mesh": ...} line of phase 11, the
{"serving": ...} line of phase 12, the {"daemons": ...} line of phase 13,
the {"bench": ...} line of phase 14, the {"witness": ...} line of phase 15,
one {"ptxas": ...,
"sass_atomics": ...} line (each kernel's
registers, shared memory and spills from nvcc -Xptxas -v, and the atomic
SASS opcodes of each library), one {"kernels": [...]} line, then the
nvidia-smi line, and last
{"ok": true, "device": {...}}. It imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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


def _readbacks(reset: bool = True) -> tuple:
    """(every readback, the device join's share) in one read: the plain
    keys of counters.readback and its "join.*" keys (ops/join.py tags its
    readbacks with the site "join")."""
    from ballista_tpu_torch.utils import counters

    out = counters.readback.stats(reset)
    keys = ("rows", "bytes", "readbacks")
    return {k: out[k] for k in keys}, {k: out.get(f"join.{k}", 0) for k in keys}


def _reset_counters() -> None:
    from ballista_tpu_torch.ops import costmodel, runtime
    from ballista_tpu_torch.utils import tracing

    costmodel.reset()
    runtime.routing_stats(reset=True)
    runtime.readback_stats(reset=True)  # the join's share with it
    runtime.ingest_stats(reset=True)
    runtime.join_path_stats(reset=True)
    tracing.reset()


def phase_joins(data_dir: str):
    """Phase 6 (see the module docstring), over phase 3's data."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime
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
        reads, join_reads = _readbacks()
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
        warm_reads, warm_join_reads = _readbacks()
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
        reads, join_reads = _readbacks()
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
        _readbacks()
        t0 = time.perf_counter()
        got = device_join.device_join_indices(build, probe, dev, config)
        first_ms = (time.perf_counter() - t0) * 1e3
        paths = runtime.join_path_stats(reset=True)
        _, reads = _readbacks()
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
        _readbacks()
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


@contextlib.contextmanager
def _spans_on():
    """Span recording on over the body (it is off by default): for the
    phases that read tracing.spans()."""
    from ballista_tpu_torch.utils import tracing

    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)


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


# -- phase 11: shared scan, the mesh stages and the span export --------------

# distinct "batches"-route aggregates over lineitem for one shared-scan batch:
# the first three have only counts, integer sums and min / max (the combined
# step), the last an f32 sum (its own step over the shared upload)
SHARED_QUERIES = [
    "select l_returnflag, count(*) as c, min(l_shipdate) as mn, max(l_shipdate) as mx "
    "from lineitem group by l_returnflag",
    "select l_linestatus, count(*) as c, sum(l_linenumber) as sl from lineitem "
    "where l_shipdate <= date '1998-09-02' group by l_linestatus",
    "select l_linenumber, max(l_suppkey) as ms, min(l_partkey) as mp from lineitem "
    "group by l_linenumber",
    "select l_returnflag, sum(l_extendedprice) as s, count(*) as c from lineitem "
    "where l_discount > 0.05 group by l_returnflag",
]
# the scan-per-query regime shared scan serves: no residency, no layout store
SHARED_SETTINGS = {"ballista.cache.results": "false", "ballista.tpu.device_cache": "false"}
SPMD_SETTINGS = {"ballista.cache.results": "false", "ballista.tpu.spmd_stages": "true"}
# the four-shard mesh on the one card: q1 (unrolled), q18's inner aggregate
# (sorted) and q3 (an inner join through SpmdJoinExec)
MESH4_SHARDS = 4
MESH4_QUERIES = ("q1", "q18_inner", "q3")
SPMD_COUNTERS = ("spmd.mesh", "spmd.host_fallback", "spmd.host_declined", "spmd.join_mesh",
                 "spmd.join_host_inline", "spmd.join_host_fallback")
# a window of _time_ms for one program stays under this many ms of calls
PROGRAM_WINDOW_MS = 2000.0
# device programs of this slice: name -> (module, factory, the reference)
PROGRAMS = {
    "combined_step": ("ballista_tpu_torch.ops.sharedscan", "_combined_step",
                      "ballista_tpu/ops/sharedscan.py:749"),
    "mesh_unrolled": ("ballista_tpu_torch.parallel.spmd_stage", "unrolled_program",
                      "ballista_tpu/parallel/spmd_stage.py:781"),
    "mesh_sorted": ("ballista_tpu_torch.parallel.spmd_stage", "sorted_program",
                    "ballista_tpu/parallel/spmd_stage.py:838"),
    "mesh_join": ("ballista_tpu_torch.parallel.spmd_join", "join_program",
                  "ballista_tpu/parallel/spmd_join.py:401"),
    "q1_style_step": ("ballista_tpu_torch.parallel.spmd", "build_q1_style_step",
                      "ballista_tpu/parallel/spmd.py:128 (over :25)"),
    "all_to_all_exchange": ("ballista_tpu_torch.parallel.spmd",
                            "build_all_to_all_exchange_aggregate",
                            "ballista_tpu/parallel/spmd.py:71"),
}


def _capture_programs(store: dict):
    """Wrap each device program's factory so every program it builds records
    its runs and its last call's arguments in `store` (for timing after the
    phase). Returns the function that undoes the wrapping."""
    import importlib

    undo = []
    for name, (mod_name, attr, _ref) in PROGRAMS.items():
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def factory(*a, _orig=orig, _name=name, **k):
            prog = _orig(*a, **k)

            def run(*args):
                rec = store.setdefault(_name, {"runs": 0})
                rec["runs"] += 1
                rec["call"] = (prog, args)
                return prog(*args)

            return run

        setattr(mod, attr, factory)
        undo.append((mod, attr, orig))

    def restore():
        for mod, attr, orig in undo:
            setattr(mod, attr, orig)

    return restore


def _tensors(obj, out: dict) -> dict:
    """Every distinct tensor in a nested argument structure, by storage."""
    import torch

    if isinstance(obj, torch.Tensor):
        out[(obj.data_ptr(), obj.nbytes)] = obj
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    return out


def _program_record(name: str, rec: dict) -> dict:
    """Warm device ms of one captured program call (queued calls between
    CUDA events, _time_ms) and its byte bound: each distinct input tensor
    read once and the output written once, over the HBM rate. A program
    slower than PROGRAM_WINDOW_MS per call is timed over fewer calls (one
    per window, three windows)."""
    import torch

    prog, args = rec["call"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = prog(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    in_bytes = sum(t.nbytes for t in _tensors(args, {}).values())
    out_bytes = sum(t.nbytes for t in _tensors(out, {}).values())
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    if first_ms * TIME_REPS > PROGRAM_WINDOW_MS:
        ms = _time_ms(lambda: prog(*args), reps=1, windows=3, warmup=1)
    else:
        ms = _time_ms(lambda: prog(*args))
    return {"name": name, "replaces": PROGRAMS[name][2], "runs": rec["runs"], "ms": ms,
            "bytes": in_bytes + out_bytes, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / ms if ms else None}


def _spmd_counts(before: dict) -> dict:
    from ballista_tpu_torch.utils import tracing

    now = tracing.counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in SPMD_COUNTERS
            if now.get(k, 0) != before.get(k, 0)}


def _shared_scan_part(data_dir: str) -> dict:
    """The shared-scan batch through the port's cluster: the queries solo
    (one at a time), then submitted together before an executor starts, so
    their scan stages co-pend and batch; every member bit-equal to solo."""
    import threading

    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import BallistaExecutor, StandaloneCluster
    from ballista_tpu_torch.ops import kernels, runtime

    device = torch.device("cuda")
    settings = {**BASE, **SHARED_SETTINGS}
    kernels.clear_stage_cache()
    cluster = StandaloneCluster(n_executors=1, config=BallistaConfig(settings), device=device)
    try:
        ctx = BallistaContext(*cluster.scheduler_addr, settings=settings, device=device)
        register_all(ctx, data_dir)
        t0 = time.perf_counter()
        solo = [ctx.sql(q).collect() for q in SHARED_QUERIES]
        torch.cuda.synchronize()
        solo_ms = (time.perf_counter() - t0) * 1e3
        ctx.close()
    finally:
        cluster.shutdown()

    for stats in (runtime.shared_scan_stats, runtime.routing_stats):
        stats(reset=True)
    results = [None] * len(SHARED_QUERIES)
    errors = []
    cluster = StandaloneCluster(n_executors=0, config=BallistaConfig(settings), device=device)
    try:
        def submit(i):
            try:
                c = BallistaContext(*cluster.scheduler_addr, settings=settings, device=device)
                register_all(c, data_dir)
                results[i] = c.sql(SHARED_QUERIES[i]).collect()
                c.close()
            except Exception as e:  # reported below, failing the phase
                errors.append(f"query {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(SHARED_QUERIES))]
        for th in threads:
            th.start()
        time.sleep(3.0)  # every job plans while no executor can take work
        t0 = time.perf_counter()
        ex = BallistaExecutor("127.0.0.1", cluster.port, config=cluster.config,
                              executor_id="late-0", device=device)
        ex.start()
        cluster.executors.append(ex)
        for th in threads:
            th.join(300)
        torch.cuda.synchronize()
        batched_ms = (time.perf_counter() - t0) * 1e3
        if any(th.is_alive() for th in threads):
            fail("shared scan: a client did not finish within 300 s")
    finally:
        cluster.shutdown()
    if errors:
        fail(f"shared scan: {errors}")
    for i, (got, want) in enumerate(zip(results, solo)):
        if got.to_pydict() != want.to_pydict():
            fail(f"shared scan: query {i} batched differs from its solo run")
    stats = runtime.shared_scan_stats(reset=True)
    batch_events = runtime.routing_stats(reset=True)["events"].get("stage:batch", 0)
    for key in ("batches_formed", "uploads_saved", "launches_saved"):
        if stats.get(key, 0) < 1:
            fail(f"shared scan: {key} < 1 ({stats})")
    if batch_events < 2:
        fail(f"shared scan: {batch_events} members spliced (stage:batch), want >= 2")
    out = {"queries": len(SHARED_QUERIES), "solo_ms": solo_ms, "batched_ms": batched_ms,
           "stats": stats, "stage_batch_events": batch_events, "bit_equal_to_solo": True}
    log(f"phase 11 shared scan: {out}")
    return out


def _spmd_cluster(settings: dict, mesh_devices=None):
    import torch

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster

    return StandaloneCluster(n_executors=1, config=BallistaConfig(settings),
                             device=torch.device("cuda"), mesh_devices=mesh_devices)


def _spmd_run(ctx, name: str, sql: str) -> tuple:
    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.utils import tracing

    kernels.clear_stage_cache()
    before = tracing.counters()
    got, ms, run = _cluster_run(ctx, sql)
    counts = _spmd_counts(before)
    path = ("mesh" if counts.get("spmd.mesh") or counts.get("spmd.join_mesh")
            else "host" if any(k.startswith("spmd.") for k in counts) else "unfused")
    return got, {"rows": got.num_rows, "cold_ms": ms, "last_path": path, "spmd": counts,
                 "reasons": run["reasons"], "join_paths": run["join_paths"]["paths"]}


def _spmd_part(data_dir: str, local_answers: dict, dist: dict) -> tuple:
    """All 22 TPC-H queries (and q18's inner aggregate) through the port's
    cluster under ballista.tpu.spmd_stages on the card's own mesh (one
    shard), each held to the "cpu" backend's answer."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext

    settings = {**BASE, **SPMD_SETTINGS}
    cluster = _spmd_cluster(settings)
    answers, out = {}, {}
    try:
        ctx = BallistaContext(*cluster.scheduler_addr, settings=settings,
                              device=torch.device("cuda"))
        register_all(ctx, data_dir)
        for name, sql in [*((f"q{i}", (ROOT / f"benchmarks/tpch/queries/q{i}.sql").read_text())
                            for i in range(1, 23)), ("q18_inner", Q18_INNER)]:
            got, rec = _spmd_run(ctx, name, sql)
            _compare(f"{name} (spmd)", got, local_answers[name])
            rec["unfused_cold_ms"] = dist["queries"].get(name, {}).get("cold_ms")
            answers[name], out[name] = got, rec
            log(f"{name} (spmd): {rec}")
        ctx.close()
    finally:
        cluster.shutdown()
    mesh = [n for n, r in out.items() if r["last_path"] == "mesh"]
    if not {"q1", "q18_inner", "q3"} <= set(mesh):
        fail(f"spmd: q1, q18_inner and q3 must take the mesh path (mesh: {mesh})")
    return {"queries": out, "mesh": mesh}, answers


def _mesh4_part(data_dir: str, one_shard: dict) -> dict:
    """q1, q18's inner aggregate and q3 on a four-shard mesh of the one card
    (the device list repeated), each equal to the one-shard run: non-float
    columns exactly, floats within phase 3's tolerance."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext

    settings = {**BASE, **SPMD_SETTINGS}
    cluster = _spmd_cluster(settings, mesh_devices=[torch.device("cuda")] * MESH4_SHARDS)
    out = {}
    try:
        ctx = BallistaContext(*cluster.scheduler_addr, settings=settings,
                              device=torch.device("cuda"))
        register_all(ctx, data_dir)
        for name in MESH4_QUERIES:
            sql = Q18_INNER if name == "q18_inner" else (
                ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
            got, rec = _spmd_run(ctx, name, sql)
            if rec["last_path"] != "mesh":
                fail(f"{name} (mesh x{MESH4_SHARDS}): took {rec['last_path']} ({rec})")
            _compare(f"{name} (mesh x{MESH4_SHARDS} vs x1)", got, one_shard[name])
            out[name] = rec
            log(f"{name} (mesh x{MESH4_SHARDS}): {rec}")
        ctx.close()
    finally:
        cluster.shutdown()
    return out


def _f32_sums_close(name: str, got, want, counts, abs_sums) -> None:
    """f32 sums (any order, inputs and products rounded to f32) against a
    float64 reference: |got - want| <= (count + 3) * 2^-24 * sum |x|, the
    rounding bound of recursive summation plus three roundings per term."""
    import numpy as np

    tol = (counts + 3) * 2.0 ** -24 * abs_sums
    err = np.abs(got - want)
    if (err > tol).any():
        fail(f"{name}: f32 sums differ past the rounding bound "
             f"(max abs err {float(err.max())}, max err / bound {float((err / tol).max())})")


def _demos_part(data_dir: str) -> dict:
    """The mesh demos of parallel/spmd.py over lineitem's columns on a
    four-shard mesh of the card: q1's step (group = returnflag x
    linestatus) and the all_to_all exchange keyed on l_suppkey, each held
    to a float64 numpy reference."""
    import numpy as np
    import pyarrow.compute as pc
    import pyarrow.dataset as ds
    import torch

    from ballista_tpu_torch.parallel import spmd
    from ballista_tpu_torch.parallel.mesh import build_mesh

    t = ds.dataset(str(pathlib.Path(data_dir) / "lineitem")).to_table(columns=[
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
        "l_tax", "l_shipdate", "l_suppkey"])
    n = (t.num_rows // MESH4_SHARDS) * MESH4_SHARDS
    t = t.slice(0, n)
    mesh = build_mesh({"data": MESH4_SHARDS}, [torch.device("cuda")] * MESH4_SHARDS)
    key = pc.binary_join_element_wise(t["l_returnflag"], t["l_linestatus"], "")
    enc = pc.dictionary_encode(key).combine_chunks()
    codes = enc.indices.to_numpy().astype(np.int32)
    G = len(enc.dictionary)
    cols = [t[c].to_numpy().astype(np.float32) for c in
            ("l_quantity", "l_extendedprice", "l_discount", "l_tax")]
    ship = t["l_shipdate"].cast("int32").to_numpy()
    cutoff = 10_471  # date '1998-09-02' in days
    dev = [torch.from_numpy(a).cuda() for a in (codes, *cols, ship)]
    got = spmd.build_q1_style_step(mesh, G, cutoff)(*dev).double().cpu().numpy()
    m = ship <= cutoff
    qty, price, disc, tax = (c.astype(np.float64) for c in cols)
    refs = [np.ones(n), qty, price, price * (1 - disc), price * (1 - disc) * (1 + tax), disc]
    want = np.stack([np.bincount(codes[m], weights=r[m], minlength=G) for r in refs])
    counts = want[0]
    if not np.array_equal(got[0], counts):
        fail("q1-style mesh step: counts differ")
    _f32_sums_close("q1-style mesh step", got[1:], want[1:], counts,
                    np.stack([np.bincount(codes[m], weights=np.abs(r[m]), minlength=G)
                              for r in refs[1:]]))

    keys = t["l_suppkey"].to_numpy().astype(np.int32)
    gps = -(-(int(keys.max()) + 1) // MESH4_SHARDS)
    sums = spmd.build_all_to_all_exchange_aggregate(mesh)(
        torch.from_numpy(keys).cuda(), dev[2], gps).double().cpu().numpy()
    width = gps * MESH4_SHARDS
    got_g = sums.reshape(MESH4_SHARDS, gps).T.reshape(-1)
    _f32_sums_close("all_to_all exchange", got_g, np.bincount(keys, weights=price, minlength=width),
                    np.bincount(keys, minlength=width),
                    np.bincount(keys, weights=np.abs(price), minlength=width))
    out = {"rows": n, "q1_groups": G, "exchange_keys": int(keys.max()) + 1}
    log(f"phase 11 demos: {out}")
    return out


def _span_export_part(data_dir: str) -> dict:
    """A q6 run on the card with span recording on, exported as the Chrome
    trace that BALLISTA_TRACE_DIR names: it must hold the run's stage.run
    and readback spans, under the query id of its execute span."""
    import os

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.utils import tracing

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    prev = os.environ.get("BALLISTA_TRACE_DIR")
    os.environ["BALLISTA_TRACE_DIR"] = trace_dir
    try:
        ctx = ExecutionContext(BallistaConfig(BASE))
        register_all(ctx, data_dir)
        tracing.reset()
        with _spans_on():
            ctx.sql((ROOT / "benchmarks/tpch/queries/q6.sql").read_text()).collect()
        path = pathlib.Path(tracing.export())
        events = json.loads(path.read_text()).get("traceEvents", [])
        (query,) = {e["args"]["query"] for e in events if e["name"] == "execute"} or {None}
        names = sorted({e["name"] for e in events if e["args"]["query"] == query})
        for want in ("stage.run", "readback"):
            if query is None or want not in names:
                fail(f"span export: the q6 run's {want} span is not in {path.name}: {names}")
        out = {"trace_bytes": path.stat().st_size, "spans": len(events), "names": names}
    finally:
        if prev is None:
            os.environ.pop("BALLISTA_TRACE_DIR", None)
        else:
            os.environ["BALLISTA_TRACE_DIR"] = prev
        shutil.rmtree(trace_dir, ignore_errors=True)
        tracing.reset()
    log(f"phase 11 span export: {out}")
    return out


def phase_shared_mesh(data_dir: str, local_answers: dict, dist: dict):
    """Phase 11 (see the module docstring), over phase 3's data. Returns
    its record and the kernels' launch counts during it."""
    from ballista_tpu_torch.ops import cuda_kernels, kernels

    t_phase = time.perf_counter()
    store: dict = {}
    restore = _capture_programs(store)
    cuda_kernels.reset_launch_counts()
    try:
        result = {"shared_scan": _shared_scan_part(data_dir)}
        result["spmd"], one_shard = _spmd_part(data_dir, local_answers, dist)
        result["mesh4"] = _mesh4_part(data_dir, one_shard)
        result["demos"] = _demos_part(data_dir)
        launches = cuda_kernels.launch_counts()
        result["span_export"] = _span_export_part(data_dir)
    finally:
        restore()
        kernels.clear_stage_cache()
    missing = [n for n in PROGRAMS if n not in store]
    if missing:
        fail(f"phase 11 never ran the device programs {missing}")
    result["programs"] = [_program_record(n, store[n]) for n in PROGRAMS]
    store.clear()
    for rec in result["programs"]:
        log(f"phase 11 program: {rec}")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 (shared scan, mesh stages, span export): {result['seconds']:.1f} s")
    return result, launches


# -- phase 12: the serving tier ------------------------------------------------

# the tenants' mix (benchmarks/tpch/queries/ and Q18_INNER): q18's inner
# aggregate runs under PALLAS, so the executors launch sorted_grouped_sum
SERVING_MIX = ["q1", "q3", "q6", "q12", "q18", "q18_inner"]
SERVING_TENANTS, SERVING_SUBMISSIONS, SERVING_ZIPF, SERVING_SEED = 4, 12, 1.6, 20261017
SERVING_STREAMED = ["q3", "q18"]
# one cluster for the phase: speculation armed as tests/test_fuzz_device.py
# arms it (the in-memory cost store of BASE holds the task.run rates), and
# heartbeats that do not decay past 0.25 s, so (e)'s 1 s lease holds for a
# live executor
SERVING_CLUSTER = {"ballista.speculation.min_runtime_ms": "100",
                   "ballista.speculation.multiplier": "2",
                   "ballista.executor.idle_poll_max_s": "0.25"}
SPEC_RATE = 0.2
SPEC_CHAOS = {"ballista.chaos.rate": str(SPEC_RATE), "ballista.chaos.sites": "task.slow",
              "ballista.chaos.slow_ms": "2000"}
SPEC_QUERIES = ["q1", "q6", "q12"]
# (c): an exact aggregate over lineitem whose cached state advances on append
ADVANCE_SQL = ("select l_returnflag, l_linestatus, count(*) as c, sum(l_linenumber) as sl, "
               "min(l_orderkey) as mn from lineitem where l_shipdate <= date '1998-09-02' "
               "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
ADVANCE_ROWS = 200_000
# (e): the queries running when an executor is lost, and the lease that
# lets the scheduler notice the loss within the phase
LOSS_QUERIES = ["q3", "q18"]
LOSS_LEASE_S = 1.0


def _serving_sql(name: str) -> tuple:
    if name == "q18_inner":
        return Q18_INNER, PALLAS
    return (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text(), {}


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=float), q))


def _timed_collect(ctx, sql: str):
    import torch

    t0 = time.perf_counter()
    got = ctx.sql(sql).collect()
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) * 1e3


def _tenants_part(client, answers: dict) -> dict:
    """(a): cold and warm runs of the mix (result cache off), then four
    tenants replaying seeded Zipf schedules concurrently with the cache on."""
    import threading

    from ballista_tpu_torch.ops import kernels, runtime

    per_query = {}
    for name in SERVING_MIX:
        sql, extra = _serving_sql(name)
        ctx = client({"ballista.cache.results": "false", **extra})
        kernels.clear_stage_cache()
        got, cold_ms = _timed_collect(ctx, sql)
        _compare(f"{name} (serving, cold)", got, answers[name])
        got, warm_ms = _timed_collect(ctx, sql)
        _compare(f"{name} (serving, warm)", got, answers[name])
        ctx.close()
        per_query[name] = {"cold_ms": cold_ms, "warm_ms": warm_ms}
    rng = np.random.default_rng(SERVING_SEED)
    schedules = [[SERVING_MIX[(int(z) - 1) % len(SERVING_MIX)]
                  for z in rng.zipf(SERVING_ZIPF, size=SERVING_SUBMISSIONS)]
                 for _ in range(SERVING_TENANTS)]
    for stats in (runtime.tenancy_stats, runtime.serving_stats):
        stats(reset=True)
    runs = [[] for _ in range(SERVING_TENANTS)]
    errors = []

    def replay(i):
        try:
            ctxs = {}
            for name in schedules[i]:
                sql, extra = _serving_sql(name)
                key = tuple(sorted(extra.items()))
                if key not in ctxs:
                    ctxs[key] = client({"ballista.tenant.name": f"tenant{i}", **extra})
                got, ms = _timed_collect(ctxs[key], sql)
                runs[i].append((name, got, ms))
            for ctx in ctxs.values():
                ctx.close()
        except Exception as e:  # reported below, failing the phase
            errors.append(f"tenant{i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=replay, args=(i,)) for i in range(SERVING_TENANTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if any(th.is_alive() for th in threads):
        fail("serving tenants: a tenant did not finish within 600 s")
    if errors:
        fail(f"serving tenants: {errors}")
    tenancy = runtime.tenancy_stats(reset=True)
    serving = runtime.serving_stats(reset=True)
    tenants = {}
    for i, rs in enumerate(runs):
        for name, got, _ms in rs:
            _compare(f"{name} (tenant{i})", got, answers[name])
        ms = [r[2] for r in rs]
        tenants[f"tenant{i}"] = {"submissions": len(rs), "p50_ms": _percentile(ms, 50),
                                 "p99_ms": _percentile(ms, 99),
                                 "schedule": schedules[i]}
    hits = tenancy.get("cache_hit", 0)
    if hits < 1 or hits + tenancy.get("cache_miss", 0) < SERVING_TENANTS * SERVING_SUBMISSIONS:
        fail(f"serving tenants: cache_hit / cache_miss {tenancy}")
    if serving.get("dispatch_push", 0) < 1 or serving.get("dispatch_poll", 0):
        fail(f"serving tenants: pushes / polls {serving}")
    # one more submission of each query: a hit on the entry the replay left
    for name in SERVING_MIX:
        sql, extra = _serving_sql(name)
        ctx = client(extra)
        got, per_query[name]["hit_ms"] = _timed_collect(ctx, sql)
        ctx.close()
        _compare(f"{name} (serving, hit)", got, answers[name])
    if runtime.tenancy_stats(reset=True).get("cache_hit", 0) != len(SERVING_MIX):
        fail("serving tenants: a repeat after the replay was not a cache hit")
    return {"queries": per_query, "tenants": tenants, "wall_ms": wall_ms,
            "tenancy": tenancy,
            "pushes": serving.get("dispatch_push", 0), "polls": serving.get("dispatch_poll", 0),
            "push_stats": {k: v for k, v in serving.items()
                           if k.startswith(("dispatch_", "task_pushed", "push_", "status_push"))}}


def _streaming_part(client) -> dict:
    """(b): q3 and q18 through collect_stream, bit-equal to collect."""
    import pyarrow as pa
    import torch

    out = {}
    ctx = client({"ballista.cache.results": "false"})
    for name in SERVING_STREAMED:
        sql, _ = _serving_sql(name)
        want, whole_ms = _timed_collect(ctx, sql)
        t0 = time.perf_counter()
        first_ms, batches = None, []
        for batch in ctx.collect_stream(ctx.sql(sql).logical_plan()):
            if first_ms is None:
                first_ms = (time.perf_counter() - t0) * 1e3
            batches.append(batch)
        torch.cuda.synchronize()
        stream_ms = (time.perf_counter() - t0) * 1e3
        if not batches:
            fail(f"{name} (streamed): no batch")
        got = pa.Table.from_batches(batches, schema=batches[0].schema).cast(want.schema)
        if not got.equals(want):
            fail(f"{name} (streamed): not bit-equal to collect")
        out[name] = {"first_batch_ms": first_ms, "stream_ms": stream_ms,
                     "collect_ms": whole_ms, "batches": len(batches), "rows": got.num_rows}
    ctx.close()
    return out


def _advance_part(client, data_dir: str, work: str) -> dict:
    """(c): an exact aggregate over a copy of lineitem advances when a third
    file is appended; the answer equals a cache-off full run on the "cpu"
    backend, bit for bit."""
    import os

    import pyarrow.parquet as pq

    from ballista_tpu_torch.ops import runtime
    from ballista_tpu_torch.scheduler import delta

    grow = pathlib.Path(work) / "grow"
    li = grow / "lineitem"
    li.mkdir(parents=True)
    files = sorted((pathlib.Path(data_dir) / "lineitem").glob("*.parquet"))
    for f in files:
        os.link(f, li / f.name)
    ctx = client({"ballista.cache.advance": "true"})
    ctx.register_parquet("lineitem", str(li))
    if delta.fold_spec(ctx.sql(ADVANCE_SQL).logical_plan()) is None:
        fail("advance: scheduler/delta.py declines the advancement query")
    runtime.delta_stats(reset=True)
    cold, cold_ms = _timed_collect(ctx, ADVANCE_SQL)
    # the appended file: a seeded slice of lineitem's rows
    rng = np.random.default_rng(SERVING_SEED)
    src = pq.read_table(files[0])
    pick = np.sort(rng.choice(src.num_rows, size=min(ADVANCE_ROWS, src.num_rows),
                              replace=False))
    pq.write_table(src.take(pick), li / "part-appended.parquet")
    ctx.register_parquet("lineitem", str(li))
    advanced, advanced_ms = _timed_collect(ctx, ADVANCE_SQL)
    stats = runtime.delta_stats(reset=True)
    if stats.get("advance_hits", 0) != 1:
        fail(f"advance: advance_hits != 1 ({stats})")
    ctx.close()
    full_ms = {}
    for backend in ("cuda", "cpu"):
        c = client({"ballista.cache.results": "false",
                    "ballista.executor.backend": backend})
        c.register_parquet("lineitem", str(li))
        truth, full_ms[backend] = _timed_collect(c, ADVANCE_SQL)
        c.close()
        if not advanced.equals(truth):
            fail(f"advance: the advanced answer differs from a full run on {backend}")
    if advanced.equals(cold):
        fail("advance: the appended rows did not change the answer")
    return {"cold_ms": cold_ms, "advanced_ms": advanced_ms, "full_cuda_ms": full_ms["cuda"],
            "full_cpu_ms": full_ms["cpu"], "appended_rows": int(len(pick)),
            "delta_stats": stats, "bit_equal_to_cpu_full_run": True}


def _job_ids(state) -> set:
    return {k.rsplit("/", 1)[1] for k, _v in state.kv.get_prefix(state._key("jobs"))}


def _task_coords(state, jobs: set) -> list:
    """(stage, partition) of every task of `jobs` (keys tasks/job/stage/p)."""
    out = set()
    for k, _v in state.kv.get_prefix(state._key("tasks")):
        _, job, stage, part = k.rsplit("/", 3)
        if job in jobs:
            out.add((int(stage), int(part)))
    return sorted(out)


def _spec_seed(coords) -> int:
    """The first chaos seed that slows a task of `coords` at attempt 0 and
    not its duplicate (attempt 1): task.slow verdicts hash (stage,
    partition, attempt), not the job, so the clean pass's tasks predict the
    chaos pass's."""
    from ballista_tpu_torch.utils.chaos import ChaosInjector

    for seed in range(2000):
        inj = ChaosInjector(seed, SPEC_RATE, sites=("task.slow",))
        if any(inj.should_inject("task.slow", f"{s}/{p}@a0")
               and not inj.should_inject("task.slow", f"{s}/{p}@a1") for s, p in coords):
            return seed
    fail("speculation: no chaos seed slows a task")


def _speculation_part(cluster, client) -> dict:
    """(d): a clean warm pass, then the same queries under seeded task.slow
    stragglers: at least one duplicate launches, answers bit-equal."""
    from ballista_tpu_torch.ops import runtime

    state = cluster.scheduler_impl.state
    base = {"ballista.cache.results": "false"}
    before = _job_ids(state)
    ctx = client(base)
    clean = {name: _timed_collect(ctx, _serving_sql(name)[0]) for name in SPEC_QUERIES}
    ctx.close()
    coords = _task_coords(state, _job_ids(state) - before)
    if not coords:
        fail("speculation: the clean pass left no task in the scheduler's store")
    seed = _spec_seed(coords)
    runtime.speculation_stats(reset=True)
    runtime.recovery_stats(reset=True)
    ctx = client({**base, **SPEC_CHAOS, "ballista.chaos.seed": str(seed)})
    chaotic = {name: _timed_collect(ctx, _serving_sql(name)[0]) for name in SPEC_QUERIES}
    ctx.close()
    spec = runtime.speculation_stats(reset=True)
    rec = runtime.recovery_stats(reset=True)
    for name in SPEC_QUERIES:
        if not chaotic[name][0].equals(clean[name][0]):
            fail(f"speculation: {name} under task.slow differs from its clean pass")
    if rec.get("chaos_slow_injected", 0) < 1 or spec.get("launched", 0) < 1:
        fail(f"speculation: no duplicate launched ({spec}, {rec})")
    return {"clean_ms": {n: v[1] for n, v in clean.items()},
            "chaos_ms": {n: v[1] for n, v in chaotic.items()},
            "chaos_seed": seed, "speculation_stats": spec,
            "slowed": rec.get("chaos_slow_injected", 0),
            "bit_equal": True}


def _loss_part(cluster, client, work: str) -> dict:
    """(e): on the shared shuffle tier, the first executor seen running a
    task of q3 or q18 stops; the answers equal the clean runs,
    recovery_stats counts the recovery, and the stopped executor leaves no
    exchange entry."""
    import ballista_tpu_torch.scheduler.state as state_mod
    from ballista_tpu_torch.ops import exchange, runtime

    shared = {"ballista.cache.results": "false", "ballista.shuffle.tier": "shared",
              "ballista.shuffle.dir": str(pathlib.Path(work) / "shuffle")}
    ctx = client(shared)
    clean = {name: ctx.sql(_serving_sql(name)[0]).collect() for name in LOSS_QUERIES}
    plans = {name: ctx.sql(_serving_sql(name)[0]).logical_plan() for name in LOSS_QUERIES}
    state = cluster.scheduler_impl.state
    old_lease = state_mod.EXECUTOR_LEASE_SECS
    state_mod.EXECUTOR_LEASE_SECS = LOSS_LEASE_S
    cluster.scheduler_impl.lost_task_check_interval = 0.3
    # a speculative duplicate would finish the stopped executor's task before
    # its lease lapses; (e) holds the lease path, so no task speculates here
    old_floor = state._spec_floor_s
    state._spec_floor_s = float("inf")
    # every executor's next heartbeat writes its lease with LOSS_LEASE_S
    polls = [ex.poll_loop._poll_n for ex in cluster.executors]
    while any(ex.poll_loop._poll_n < n + 2 for ex, n in zip(cluster.executors, polls)):
        time.sleep(0.05)
    runtime.recovery_stats(reset=True)
    runtime.shuffle_tier_stats(reset=True)
    try:
        t0 = time.perf_counter()
        jobs = {name: ctx.submit(plan) for name, plan in plans.items()}

        def running_executor():
            """The first executor that holds a task of the two jobs."""
            for ex in cluster.executors:
                with ex.poll_loop._inflight_mu:
                    if any(key[0] in jobs.values() for key in ex.poll_loop._inflight):
                        return ex
            return None

        def jobs_done() -> bool:
            return all(state.get_job_metadata(j).WhichOneof("status") == "completed"
                       for j in jobs.values())

        victim = running_executor()
        while victim is None:
            if jobs_done():
                fail("executor loss: both jobs ended before an executor was seen "
                     "running one of their tasks")
            time.sleep(0.002)
            victim = running_executor()
        running = [n for n, j in jobs.items()
                   if state.get_job_metadata(j).WhichOneof("status") != "completed"]
        victim.stop()
        stop_ms = (time.perf_counter() - t0) * 1e3
        got = {name: ctx._collect_results(job, plans[name].schema(), timeout=300)
               for name, job in jobs.items()}
        loss_ms = (time.perf_counter() - t0) * 1e3
    finally:
        state_mod.EXECUTOR_LEASE_SECS = old_lease
        state._spec_floor_s = old_floor
    ctx.close()
    rec = runtime.recovery_stats(reset=True)
    tier = runtime.shuffle_tier_stats(reset=True)
    for name in LOSS_QUERIES:
        if not got[name].equals(clean[name]):
            fail(f"executor loss: {name} differs from its clean run")
    if not running:
        fail("executor loss: both jobs had finished before the executor stopped")
    recovered = {k: v for k, v in rec.items()
                 if k in ("task_retry", "lost_task_reset", "orphan_reassigned",
                          "result_partition_restarted", "fetch_failed", "map_recomputed")}
    if not recovered:
        fail(f"executor loss: recovery_stats counts no recovery ({rec})")
    with exchange._reg_lock:
        left = [k for k in exchange._entries if k[0] == victim.id]
    if left:
        fail(f"executor loss: {len(left)} exchange entries of {victim.id} remain")
    return {"victim": victim.id, "running_at_loss": running, "stop_after_ms": stop_ms,
            "wall_ms": loss_ms, "recovery_stats": rec, "shuffle_tier": tier,
            "registry_entries_left": 0, "bit_equal": True}


def phase_serving(data_dir: str, answers: dict):
    """Phase 12 (see the module docstring), over phase 3's data. `answers`
    maps each query of SERVING_MIX to the "cpu" backend's answer of phases
    3, 6 and 7. Returns its record and the kernels' launch counts in it."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    settings = {**BASE, "ballista.tpu.layout_cache_dir": str(pathlib.Path(work) / "layouts")}
    device = torch.device("cuda")
    kernels.clear_stage_cache()
    runtime.reset_residency()
    cuda_kernels.reset_launch_counts()
    cluster = StandaloneCluster(n_executors=2, device=device,
                                config=BallistaConfig({**settings, **SERVING_CLUSTER}))
    result = {}
    try:
        def client(extra=None):
            ctx = BallistaContext(*cluster.scheduler_addr,
                                  settings={**settings, **(extra or {})}, device=device)
            register_all(ctx, data_dir)
            return ctx

        parts = (("tenants", lambda: _tenants_part(client, answers)),
                 ("streaming", lambda: _streaming_part(client)),
                 ("advance", lambda: _advance_part(client, data_dir, work)),
                 ("speculation", lambda: _speculation_part(cluster, client)),
                 ("executor_loss", lambda: _loss_part(cluster, client, work)))
        for name, part in parts:
            t0 = time.perf_counter()
            result[name] = part()
            result[name]["seconds"] = time.perf_counter() - t0
            log(f"phase 12 {name}: {result[name]}")
        launches = cuda_kernels.launch_counts()
        if launches["sorted_grouped_sum"] < 1:
            fail("serving: the executors never launched sorted_grouped_sum")
    finally:
        cluster.shutdown()
        kernels.clear_stage_cache()
        shutil.rmtree(work, ignore_errors=True)
    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12 (serving): {result['seconds']:.1f} s")
    return result, launches


# -- phase 13: the daemons ----------------------------------------------------

# (a): the queries through the daemons, cold then warm DAEMON_WARM times; q18's
# inner aggregate under PALLAS runs the kernel inside the executors
DAEMON_QUERIES = ["q1", "q3", "q5", "q6", "q12", "q18", "q18_inner"]
DAEMON_WARM = 2
# (d): the query whose map stage outlives one executor, and the seeded
# straggler that holds the stage open while the other executor dies
DAEMON_KILL = "q3"
DAEMON_SLOW_RATE, DAEMON_SLOW_MS = 0.3, 2000
EXECUTOR_LEASE_S = 60.0  # scheduler/state.py EXECUTOR_LEASE_SECS


def _compute_apps() -> dict:
    """{pid: MiB} of the card's compute processes, from nvidia-smi."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi --query-compute-apps failed: {smi.stderr.strip()}")
    apps = {}
    for line in smi.stdout.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = float(mib.strip() or 0)
    return apps


def _daemon_run(ctx, sql):
    import torch

    t0 = time.perf_counter()
    got = ctx.sql(sql).collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) * 1e3


def _daemon_queries(client, answers: dict, dist: dict) -> dict:
    """(a): cold and warm runs through the daemons, each held to the "cpu"
    answer, beside phase 10's ms for the same query."""
    out = {}
    for name in DAEMON_QUERIES:
        sql, extra = _serving_sql(name)
        ctx = client(extra)
        got, cold_ms = _daemon_run(ctx, sql)
        _compare(f"{name} (daemons, cold)", got, answers[name])
        warm = []
        for _ in range(DAEMON_WARM):
            got, ms = _daemon_run(ctx, sql)
            _compare(f"{name} (daemons, warm)", got, answers[name])
            warm.append(ms)
        ctx.close()
        ref = (dist.get("kernel", {}) if name == "q18_inner" else dist.get("queries", {}))
        ref = ref.get(name, {})
        out[name] = {"cold_ms": cold_ms, "warm_ms": statistics.median(warm), "warm_runs_ms": warm,
                     "phase10_cold_ms": ref.get("cold_ms", ref.get("ms")),
                     "phase10_warm_ms": ref.get("warm_ms")}
        log(f"{name} (daemons): {out[name]}")
    return out


def _kill_part(cluster, client, answers: dict) -> tuple:
    """(d), the first kill: SIGKILL an executor between the stages of
    DAEMON_KILL, on the shared tier: the answer is bit-equal to a clean run
    on the same two executors and no task waits for the executor lease.
    Returns its record and (plan, clean answer, chaos settings, slowed
    task) for the second kill."""
    from torch_daemon_cluster import kill_between_stages, straggler_seed

    sql, _ = _serving_sql(DAEMON_KILL)
    ctx = client()
    plan = ctx.sql(sql).logical_plan()
    before = {t["job"] for t in cluster.tasks()}
    clean = ctx.collect(plan)
    ctx.close()
    _compare(f"{DAEMON_KILL} (daemons, before the kill)", clean, answers[DAEMON_KILL])
    coords = sorted({(t["stage"], t["partition"]) for t in cluster.tasks()
                     if t["job"] not in before})
    final = max(s for s, _p in coords)
    slowed = max(c for c in coords if c[0] < final)
    seed = straggler_seed(coords, slowed, DAEMON_SLOW_RATE)
    slow = {"ballista.chaos.rate": str(DAEMON_SLOW_RATE),
            "ballista.chaos.sites": "task.slow",
            "ballista.chaos.slow_ms": str(DAEMON_SLOW_MS),
            "ballista.chaos.seed": str(seed)}
    chaos = client(slow)
    t0 = time.time()
    job = chaos.submit(plan)
    kill = kill_between_stages(cluster, job, slowed, timeout=120)
    got = chaos._collect_results(job, plan.schema(), timeout=300)
    answered = time.time()
    chaos.close()
    if not got.equals(clean):
        fail(f"{DAEMON_KILL}: the answer after the SIGKILL differs from the clean run")
    if kill["victim"].alive():
        fail("the killed executor is still alive")
    tasks = [t for t in cluster.tasks() if t["job"] == job]
    victim, survivor = kill["victim"].executor_id, kill["survivor"].executor_id
    later = {t["executor"] for t in tasks if t["stage"] == final}
    # a task put back after the kill shows as a later attempt
    reset = [t for t in tasks if t["attempt"] > 0]
    lease_wait_s = (answered - kill["killed_at"]) if reset else 0.0
    if later != {survivor}:
        fail(f"{DAEMON_KILL}: the final stage ran on {later}, not on the survivor {survivor}")
    record = {"query": DAEMON_KILL, "slowed_task": list(slowed), "chaos_seed": seed,
              "victim_pid": kill["victim"].pid, "victim_map_outputs": len(kill["victim_outputs"]),
              "kill_after_submit_s": kill["killed_at"] - t0,
              "kill_to_answer_s": answered - kill["killed_at"],
              "lease_wait_s": lease_wait_s, "reset_tasks": len(reset),
              "executor_lease_s": EXECUTOR_LEASE_S, "bit_equal": True,
              "survivor": survivor, "victim": victim}
    return record, (plan, clean, slow, slowed)


def _kill_running_part(cluster, client, run: tuple) -> dict:
    """(d), the second kill: SIGKILL the executor that runs the slowed task
    of DAEMON_KILL while it runs it. The scheduler must forget the dead
    process and put the task back without waiting for the executor lease,
    and the answer must be bit-equal to the clean run."""
    from torch_daemon_cluster import kill_while_running

    plan, clean, slow, slowed = run
    chaos = client(slow)
    t0 = time.time()
    job = chaos.submit(plan)
    kill = kill_while_running(cluster, job, slowed, timeout=EXECUTOR_LEASE_S / 2)
    got = chaos._collect_results(job, plan.schema(), timeout=300)
    answered = time.time()
    chaos.close()
    if not got.equals(clean):
        fail(f"{DAEMON_KILL}: the answer after the SIGKILL of a running task differs")
    kill_to_answer = answered - kill["killed_at"]
    if kill_to_answer >= EXECUTOR_LEASE_S / 2:
        fail(f"{DAEMON_KILL}: the answer came {kill_to_answer:.1f} s after the kill")
    tasks = [t for t in cluster.tasks() if t["job"] == job]
    return {"query": DAEMON_KILL, "slowed_task": list(slowed), "victim_pid": kill["victim"].pid,
            "kill_after_submit_s": kill["killed_at"] - t0,
            "kill_to_forget_s": kill["kill_to_forget_s"],
            "kill_to_reset_s": kill["kill_to_reset_s"], "kill_to_answer_s": kill_to_answer,
            "reset_tasks": len([t for t in tasks if t["attempt"] > 0]),
            "executor_lease_s": EXECUTOR_LEASE_S, "bit_equal": True}


def phase_daemons(data_dir: str, answers: dict, dist: dict):
    """Phase 13 (see the module docstring), over phase 3's data. `answers`
    maps each query of DAEMON_QUERIES to the "cpu" backend's answer, `dist`
    is phase 10's record. Returns its record and the kernels' launch counts
    in the executor processes."""
    import torch

    from benchmarks.tpch.datagen import register_all

    from ballista_tpu_torch.client import BallistaContext

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_daemon_cluster import DaemonCluster

    t_phase = time.perf_counter()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_daemons_"))
    # (c): the package copied without build/, so both executors find no
    # kernel library and build them at once
    tree = work / "tree"
    shutil.copytree(ROOT / "ballista_tpu_torch", tree / "ballista_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    cluster = DaemonCluster(str(work / "cluster"), root=str(tree), timeout=300)
    settings = {**BASE, **DIST_SETTINGS,
                "ballista.tpu.layout_cache_dir": str(work / "layouts"),
                "ballista.tpu.cost_model_dir": str(work / "costs")}
    result = {}
    launches = {"sorted_grouped_sum": 0, "grouped_aggregate": 0}

    def client(extra=None):
        ctx = BallistaContext(*cluster.scheduler_addr, settings={**settings, **(extra or {})},
                              device=torch.device("cuda"))
        register_all(ctx, data_dir)
        return ctx

    def stop(ex) -> dict:
        record = cluster.stop_executor(ex)
        for k, v in record["launch_counts"].items():
            launches[k] += v
        return record

    try:
        t0 = time.perf_counter()
        first = cluster.start().executors
        result["start_s"] = time.perf_counter() - t0
        result["executors_up_s"] = [ex.up_at - ex.started for ex in first]
        for ex in first:
            if ex.backend != "cuda" or not ex.device.startswith("cuda"):
                fail(f"{ex.name}: started on backend {ex.backend}, device {ex.device}")
        t0 = time.perf_counter()
        result["queries"] = _daemon_queries(client, answers, dist)
        result["queries_s"] = time.perf_counter() - t0
        # (b): each executor process holds memory on the card
        apps = _compute_apps()
        result["compute_apps_mib"] = {str(ex.pid): apps.get(ex.pid) for ex in first}
        result["all_compute_apps_mib"] = {str(k): v for k, v in apps.items()}
        t0 = time.perf_counter()
        records = [stop(ex) for ex in first]
        result["stop_s"] = time.perf_counter() - t0
        result["executors"] = [{
            "pid": r["pid"], "launch_counts": r["launch_counts"],
            "kernel_libraries": r["kernel_libraries"],
            "routes": r["routing_stats"]["routes"], "reasons": r["routing_stats"]["reasons"],
            "shuffle_tier": r["shuffle_tier_stats"], "exchange": r["exchange_stats"],
            "max_memory_reserved_mib": r["max_memory_reserved"] / 2**20} for r in records]
        for r in records:
            if r["routing_stats"]["routes"].get("pallas_sorted", 0) < 1:
                fail(f"executor {r['pid']} never took the pallas_sorted route")
        q18_parts = len(list((pathlib.Path(data_dir) / "lineitem").glob("*.parquet")))
        q18_runs = 1 + DAEMON_WARM
        if launches["sorted_grouped_sum"] < q18_parts * q18_runs:
            fail(f"the executors launched sorted_grouped_sum {launches} times, "
                 f"under {q18_parts} per run of q18-inner")
        for r in records:
            if set(r["kernel_libraries"]) != {"sorted_grouped_sum", "grouped_aggregate"}:
                fail(f"executor {r['pid']} loaded {sorted(r['kernel_libraries'])}")
        listed = [mib for mib in result["compute_apps_mib"].values() if mib]
        if any(ex.pid in apps for ex in first):
            if len(listed) != len(first):
                fail(f"nvidia-smi lists {result['compute_apps_mib']} for the executors")
        elif not all(r["max_memory_reserved"] > 0 for r in records):
            # nvidia-smi in another pid namespace lists other pids: the
            # executors' own allocators must then show the memory
            fail(f"no executor pid in nvidia-smi's {apps}, and an executor "
                 "reserved no device memory")
        # (d): two new executors (the build directory now warm); one dies
        # between the stages of DAEMON_KILL, and the survivor stops
        t0 = time.perf_counter()
        cluster.start_executors()
        result["restart_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["kill"], run = _kill_part(cluster, client, answers)
        (survivor,) = cluster.live_executors()
        record = stop(survivor)
        if record["shuffle_tier_stats"].get("storage_fetch", 0) < 1:
            fail(f"the survivor read no piece from the shared tier: {record}")
        result["kill"]["survivor_shuffle_tier"] = record["shuffle_tier_stats"]
        result["kill"]["survivor_pid"] = survivor.pid
        result["kill"]["seconds"] = time.perf_counter() - t0
        # two more; the one that runs the slowed task dies while it runs it
        t0 = time.perf_counter()
        cluster.start_executors()
        result["kill_running"] = _kill_running_part(cluster, client, run)
        result["kill_running"]["seconds"] = time.perf_counter() - t0
        # (e): SIGINT the last survivor and the scheduler
        (survivor,) = cluster.live_executors()
        result["kill_running"]["survivor_pid"] = survivor.pid
        stop(survivor)
        cluster.scheduler.interrupt(60)
        if cluster.scheduler.proc.returncode != 0:
            fail(f"the scheduler exited with {cluster.scheduler.proc.returncode}")
    finally:
        left = [d.name for d in [cluster.scheduler, *cluster.executors] if d and d.alive()]
        cluster.close()
        shutil.rmtree(work, ignore_errors=True)
    if left:
        fail(f"daemons left running after phase 13: {left}")
    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 (daemons): {result['seconds']:.1f} s")
    return result, launches


# phase 14: the port's benchmark entry in fresh processes over phase 3's data
BENCH_ROWS = ["q1", "q3", "q6"]
BENCH_COMPARE = ["q1", "q3", "q5", "q6", "q10", "q12"]
BENCH_TAXI = ["taxi_10M_265groups", "taxi_10M_10kgroups"]
# the stage routes that run on the card (ops/runtime.py::record_route)
DEVICE_ROUTES = {"batches", "sorted", "pallas_sorted", "fact_topk", "fact_select",
                 "fact_secondary"}
BENCH_KNOBS = {"BENCH_ELASTIC_ROWS": "60000", "BENCH_REPLICA_ROWS": "40000",
               "BENCH_REPLICA_DURATION": "4", "BENCH_REPLICA_CLIENTS": "2"}


def _bench_process(args: list, env: dict, timeout: float):
    """Run `python <args>` from the checkout in its own session (its
    client processes included), killed whole on timeout; returns (exit
    code, stdout, stderr, seconds)."""
    import os
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *args], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"bench: {' '.join(args)} still running after {timeout:.0f} s; killed\n{err[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    return proc.returncode, out, err, time.perf_counter() - t0


def _bench_json(args: list, env: dict, timeout: float) -> tuple:
    rc, out, err, secs = _bench_process(args, env, timeout)
    if rc != 0:
        fail(f"bench: {' '.join(args)} exited {rc}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1]), secs


def _check_bench_row(row: dict) -> None:
    name = f"{row['name']} sf={row['sf']}"
    if row.get("match") is not True:
        fail(f"bench: {name} does not hold its answer against the cpu backend")
    routes = set(row["routes"])
    if not routes or not routes <= DEVICE_ROUTES or row["declines"]:
        fail(f"bench: {name} left the card: routes {row['routes']}, declines {row['declines']}")
    for key in ("kernel_launches", "residency", "h2d_chunk_bytes"):
        if key not in row:
            fail(f"bench: {name} reports no {key}")


def phase_bench(data_dir: str, sf: float):
    """Phase 14: `python -m ballista_tpu_torch.bench` (q1, q3 and q6 over
    phase 3's TPC-H, both taxi shapes at 10 M trips), its elastic and
    replica scenarios, the TPC-H runner and the cross-engine comparison,
    each in a fresh process on the card. Every row must hold its answer
    against the "cpu" backend and stay on a device route with no decline;
    the fleet must grow and drain with no task retry; the replica run must
    fail over with the same answers; the runner must answer q1 and the
    comparison must find no mismatch. Returns its record."""
    import os

    t_phase = time.perf_counter()
    cache = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_bench_"))
    try:
        (cache / f"tpch_sf{float(sf)}").symlink_to(pathlib.Path(data_dir).resolve())
        base = {k: v for k, v in os.environ.items()
                if not (k.startswith("BENCH_") and k.endswith("_ONLY"))}
        base.update(BENCH_CACHE_DIR=str(cache), **BENCH_KNOBS)
        rows_env = {**base, "BENCH_SF": str(float(sf)),
                    "BENCH_CONFIGS": ",".join(f"{float(sf)}:{q}" for q in BENCH_ROWS)}
        # the entry's rows without its scenarios, which run alone below
        result, rows_s = _bench_json(
            ["-c", "import json; from ballista_tpu_torch.bench.__main__ import rows_result; "
                   "print(json.dumps(rows_result()))"], rows_env, 600)
        names = [r["name"] for r in result["configs"]]
        if names != BENCH_ROWS + BENCH_TAXI:
            fail(f"bench: rows {names}, expected {BENCH_ROWS + BENCH_TAXI}")
        for row in result["configs"]:
            _check_bench_row(row)
        elastic, elastic_s = _bench_json(["-m", "ballista_tpu_torch.bench"],
                                         {**base, "BENCH_ELASTIC_ONLY": "1"}, 300)
        elastic = elastic["elastic"]
        fleet = elastic["fleet"]
        if (fleet.get("scale_up", 0) < 1 or fleet.get("scale_down", 0) < 1
                or elastic["task_retries"] != 0 or not elastic["bit_identical"]):
            fail(f"bench: the elastic fleet did not grow and drain cleanly: {elastic}")
        replica, replica_s = _bench_json(["-m", "ballista_tpu_torch.bench"],
                                         {**base, "BENCH_REPLICA_ONLY": "1"}, 400)
        replica = replica["replica"]
        if not replica["failover"]["killed"] or not replica["digests_identical"]:
            fail(f"bench: the replica run did not fail over with equal answers: {replica}")
        runner, runner_s = _bench_json(
            ["-m", "ballista_tpu_torch.bench.runner", "benchmark", "--path", data_dir,
             "--query", "1", "--iterations", "2", "--backend", "cuda"], base, 300)
        if runner.get("q1", {}).get("rows") != 4:
            fail(f"bench: the runner's q1 gave {runner}")
        rc, out, err, compare_s = _bench_process(
            ["-m", "ballista_tpu_torch.bench.compare", "--data", data_dir,
             "--queries", *BENCH_COMPARE, "--iterations", "1",
             "--engines", "cuda", "cpu", "pyarrow"], base, 400)
        if rc != 0 or "0 cross-engine mismatches" not in err:
            fail(f"bench: compare exited {rc}\n{err[-4000:]}")
        table = [ln for ln in out.splitlines() if ln.startswith("| q") and "query" not in ln]
        if [ln.split(" | ")[0][2:] for ln in table] != BENCH_COMPARE:
            fail(f"bench: compare answered {table}")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    record = {
        "rows": result["configs"], "headline": {k: result[k] for k in ("metric", "value",
                                                                       "vs_baseline")},
        "elastic": elastic, "replica": replica, "runner": runner, "compare": table,
        "seconds": {"rows": rows_s, "elastic": elastic_s, "replica": replica_s,
                    "runner": runner_s, "compare": compare_s,
                    "phase": time.perf_counter() - t_phase},
    }
    log(f"bench: {len(result['configs'])} rows matched on device routes, elastic "
        f"{fleet}, replica {replica['failover']}, phase {record['seconds']['phase']:.1f} s")
    return record


# -- phase 15: the lock witness on the card ------------------------------------

# four concurrent clients, one query each, then each runs q18's inner
# aggregate (the sorted_grouped_sum route under PALLAS); two rounds, an
# executor death in the first and a scheduler restart before the second
WITNESS_QUERIES = ["q1", "q3", "q6", "q18"]
# the daemons' part: stages of two tasks each, so both executors take work
WITNESS_DAEMON_QUERIES = ["q1", "q3", "q18_inner"]
WITNESS_LEASE_S = 5.0
WITNESS_CLUSTER = {"ballista.debug.lock_witness": "1",
                   "ballista.shared_scan": "true",
                   "ballista.chaos.rate": "0.005",
                   "ballista.chaos.sites": "executor.death",
                   "ballista.rpc.retries": "20",
                   "ballista.executor.idle_poll_max_s": "0.25"}


def _witness_death_seed() -> int:
    """A seed at which local-0 dies at one of its polls 4-16 and local-1
    lives (the scan of tests/test_torch_lockorder.py)."""
    from ballista_tpu_torch.utils.chaos import ChaosInjector

    for seed in range(2000):
        inj = ChaosInjector(seed, rate=0.005, sites={"executor.death"})

        def death_poll(eid, horizon):
            for n in range(1, horizon):
                if inj.should_inject("executor.death", f"{eid}/poll{n}"):
                    return n
            return None

        d0 = death_poll("local-0", 17)
        if d0 is not None and 4 <= d0 and death_poll("local-1", 400) is None:
            return seed
    fail("no executor-death seed in 0..1999")


def _witness_rounds(client, answers: dict, errors: list) -> float:
    """One round: WITNESS_QUERIES from four threads, each client then
    running q18's inner aggregate, every answer held to the "cpu" one.
    Returns the round's seconds."""
    import threading

    def run(name: str) -> None:
        try:
            ctx = client()
            for q in (name, "q18_inner"):
                sql, extra = _serving_sql(q)
                if extra:
                    ctx.close()
                    ctx = client(extra)
                _compare(f"{q} (witness)", ctx.sql(sql).collect(), answers[q])
            ctx.close()
        except (Exception, SystemExit) as e:  # a failed _compare exits; reported by the phase
            errors.append(f"{name}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(q,)) for q in WITNESS_QUERIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        errors.append("a witness client is still running after 600 s")
    return time.perf_counter() - t0


def _check_witness(dumps: list) -> dict:
    """`python -m ballista_tpu_torch.analysis --check-witness` over the
    merged dumps; returns its JSON report with its exit code."""
    args = [sys.executable, "-m", "ballista_tpu_torch.analysis", "--json"]
    for d in dumps:
        args += ["--check-witness", str(d)]
    proc = subprocess.run(args, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        fail(f"--check-witness printed no report (rc {proc.returncode}): "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    report["rc"] = proc.returncode
    return report


def phase_witness(data_dir: str, answers: dict):
    """Phase 15 (see the module docstring), over phase 3's data. `answers`
    maps WITNESS_QUERIES, q18_inner and WITNESS_DAEMON_QUERIES to the "cpu"
    backend's answer. Returns its record and the kernels' launch counts in
    this process."""
    import torch

    from benchmarks.tpch.datagen import register_all

    import ballista_tpu_torch.scheduler.state as state_mod
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.ops import cuda_kernels, kernels, runtime
    from ballista_tpu_torch.utils import locks

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_daemon_cluster import DaemonCluster

    t_phase = time.perf_counter()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_witness_"))
    settings = {**BASE, **DIST_SETTINGS,
                "ballista.tpu.layout_cache_dir": str(work / "layouts")}
    device = torch.device("cuda")
    result = {}
    errors: list = []
    kernels.clear_stage_cache()
    runtime.reset_residency()
    cuda_kernels.reset_launch_counts()
    runtime.recovery_stats(reset=True)
    locks.reset_witness()
    locks.enable_witness()
    old_lease = state_mod.EXECUTOR_LEASE_SECS
    state_mod.EXECUTOR_LEASE_SECS = WITNESS_LEASE_S
    seed = _witness_death_seed()
    cluster = StandaloneCluster(n_executors=2, device=device, config=BallistaConfig(
        {**settings, **WITNESS_CLUSTER, "ballista.chaos.seed": str(seed)}))
    cluster.scheduler_impl.lost_task_check_interval = 0.3
    try:
        def client(extra=None):
            ctx = BallistaContext(*cluster.scheduler_addr,
                                  settings={**settings, **(extra or {})}, device=device)
            register_all(ctx, data_dir)
            return ctx

        result["round1_s"] = _witness_rounds(client, answers, errors)
        deadline = time.time() + 15
        while time.time() < deadline and not runtime.recovery_stats().get(
                "chaos_executor_death"):
            time.sleep(0.1)
        t0 = time.perf_counter()
        cluster.restart_scheduler()
        result["restart_s"] = time.perf_counter() - t0
        result["round2_s"] = _witness_rounds(client, answers, errors)
    finally:
        state_mod.EXECUTOR_LEASE_SECS = old_lease
        cluster.shutdown()
        locks.disable_witness()
        kernels.clear_stage_cache()
    launches = cuda_kernels.launch_counts()
    recovery = runtime.recovery_stats(reset=True)
    violations = locks.witness_violations()
    record = locks.dump(str(work / "witness.json.in_process"))
    locks.reset_witness()
    result.update({"death_seed": seed, "recovery": recovery, "launches": launches,
                   "in_process_violations": len(violations)})
    if errors:
        fail(f"witness: {errors}")
    if recovery.get("chaos_executor_death", 0) < 1:
        fail(f"witness: the seeded executor death was not counted: {recovery}")
    if recovery.get("scheduler_restart", 0) < 1:
        fail(f"witness: the scheduler restart was not counted: {recovery}")
    if launches["sorted_grouped_sum"] < 1:
        fail(f"witness: sorted_grouped_sum never launched: {launches}")
    edges = {"in_process": len(record["edges"])}

    # the daemons as processes, armed by the environment before import;
    # SIGINT stops each, and its atexit dump lands at <OUT>.<pid>
    out = work / "witness.json"
    daemons = DaemonCluster(str(work / "cluster"), timeout=300)
    daemons.env.update({"BALLISTA_LOCK_WITNESS": "1",
                        "BALLISTA_LOCK_WITNESS_OUT": str(out)})
    daemon_launches = {"sorted_grouped_sum": 0, "grouped_aggregate": 0}
    try:
        t0 = time.perf_counter()
        daemons.start()
        for name in WITNESS_DAEMON_QUERIES:
            sql, extra = _serving_sql(name)
            ctx = BallistaContext(*daemons.scheduler_addr,
                                  settings={**settings, **extra}, device=device)
            register_all(ctx, data_dir)
            _compare(f"{name} (witness daemons)", ctx.sql(sql).collect(), answers[name])
            ctx.close()
        for rec in daemons.stop():
            for k, v in rec["launch_counts"].items():
                daemon_launches[k] += v
        pids = {"scheduler": daemons.scheduler.pid,
                **{ex.name: ex.pid for ex in daemons.executors}}
        if daemons.scheduler.proc.returncode != 0:
            fail(f"witness: the scheduler exited with {daemons.scheduler.proc.returncode}")
        result["daemons_s"] = time.perf_counter() - t0
    finally:
        left = [d.name for d in [daemons.scheduler, *daemons.executors] if d and d.alive()]
        daemons.close()
    if left:
        fail(f"witness: daemons left running: {left}")
    dumps = [work / "witness.json.in_process"]
    for name, pid in pids.items():
        path = pathlib.Path(f"{out}.{pid}")
        if not path.exists():
            fail(f"witness: {name} (pid {pid}) left no dump at {path}")
        edges[name] = len(json.loads(path.read_text())["edges"])
        dumps.append(path)
    empty = [name for name, n in edges.items() if n == 0]
    if empty:
        fail(f"witness: no edges seen in {empty}: {edges}")
    report = _check_witness(dumps)
    result.update({
        "edges": edges, "runtime_edges": report["runtime_edges"],
        "static_edges": report["static_edges"],
        "violations": report["violations"], "missed": report["missed"],
        "stale": report["stale"], "never_witnessed": len(report["never_witnessed"]),
        "daemon_launches": daemon_launches,
    })
    shutil.rmtree(work, ignore_errors=True)
    if report["violations"]:
        fail(f"witness: lock-order violations: {report['violations']}")
    if report["missed"]:
        fail(f"witness: runtime edges the static graph lacks: {report['missed']}")
    if report["rc"] != 0 or not report["ok"]:
        fail(f"witness: --check-witness exited {report['rc']}: {report}")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 (witness): {result['seconds']:.1f} s")
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
        with _spans_on():
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
        with _spans_on():  # phase 6 reads the dim side's spans
            join_times, join_launches, join_answers = phase_joins(data_dir)
        tpch_times, tpch_launches, tpch_answers = phase_tpch(data_dir)
        cuda_kernels.reset_launch_counts()
        with _spans_on():  # phase 9 reads the store's spans
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
        local_answers["q18_inner"] = path_answers[Q18_INNER]
        shared_mesh_times, shared_mesh_launches = phase_shared_mesh(data_dir, local_answers,
                                                                    dist_times)
        serving_times, serving_launches = phase_serving(
            data_dir, {name: local_answers[name] for name in SERVING_MIX})
        daemon_times, daemon_launches = phase_daemons(
            data_dir, {name: local_answers[name] for name in DAEMON_QUERIES}, dist_times)
        bench_times = phase_bench(data_dir, args.sf)
        witness_times, witness_launches = phase_witness(data_dir, {
            name: local_answers[name]
            for name in {*WITNESS_QUERIES, *WITNESS_DAEMON_QUERIES, "q18_inner"}})
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    shape_times, shape_launches = phase_join_shapes(args.seed, args.sf)
    for k in kernels:
        k["launches_by_path"] = {"aggregates": k["launches"],
                                 "joins": join_launches[k["name"]],
                                 "tpch": tpch_launches[k["name"]],
                                 "layout_cache": layout_launches[k["name"]],
                                 "join_shapes": shape_launches[k["name"]],
                                 "distributed": dist_launches[k["name"]],
                                 "shared_mesh": shared_mesh_launches[k["name"]],
                                 "serving": serving_launches[k["name"]],
                                 "daemons": daemon_launches[k["name"]],
                                 "bench": sum(r["kernel_launches"][k["name"]]
                                              for r in bench_times["rows"]),
                                 "witness": witness_launches[k["name"]]}
    print(json.dumps({"queries": times, "joins": join_times, "tpch": tpch_times,
                      "join_shapes": shape_times, "build_s": build_s,
                      "sf": args.sf, "seconds": time.perf_counter() - T0}))
    print(json.dumps({"layout_cache": layout_times}))
    print(json.dumps({"distributed": dist_times}))
    print(json.dumps({"shared_mesh": shared_mesh_times}))
    print(json.dumps({"serving": serving_times}))
    print(json.dumps({"daemons": daemon_times}))
    print(json.dumps({"bench": bench_times}))
    print(json.dumps({"witness": witness_times}))
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
