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

With --compare-sources DIR, phases 4 and 5 also build the kernel sources
in DIR (PR 2's C interface, e.g. unpacked with `git show`) and time them on
the same inputs in turns (previous, current, current, previous):
`previous_ms`, `previous_ms_single`.

Prints one {"ptxas": ..., "sass_atomics": ...} line (each kernel's
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
    for name, kernels in facts.items():
        for k in kernels:
            if k["spill_stores"] or k["spill_loads"]:
                log(f"build: {name}: {k['function']} spills "
                    f"({k['spill_stores']} B stored, {k['spill_loads']} B loaded)")
    return secs, facts


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


def _sass_atomics():
    """{library: {SASS opcode: count}} of the atomic and reduction
    instructions in each built kernel library (cuobjdump -sass), or "not
    measured" where the toolkit has no cuobjdump."""
    import re

    from ballista_tpu_torch.ops import cuda_kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return "not measured"
    out = {}
    for lib in sorted(cuda_kernels.BUILD_DIR.glob("lib*.so")):
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {lib.name}: {sass.stderr.strip()}")
        ops = {}
        for m in re.finditer(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)", sass.stdout):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        out[lib.stem[3:]] = ops
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
    base = {"ballista.executor.backend": "cuda", "ballista.tpu.layout_cache_dir": ""}
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
    return times, launches


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=20260728)
    ap.add_argument("--compare-sources", default=None, metavar="DIR",
                    help="also build the kernel sources in DIR (PR 2's C "
                         "interface) and time them beside the current ones")
    args = ap.parse_args()

    smi_line = phase_device()
    sys.path.insert(0, str(ROOT))
    import torch

    import ballista_tpu_torch  # noqa: F401  (fails outside a checkout)

    build_s, ptxas = phase_build()
    sass = _sass_atomics()
    previous = {}
    if args.compare_sources:
        previous, prev_facts = _previous_kernels(args.compare_sources)
        ptxas = {**ptxas, "previous": prev_facts}
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_tpch_")
    try:
        times, launches = phase_path(args.sf, args.seed, data_dir)
        kernels = phase_kernels(args.seed, launches,
                                previous.get("sorted_grouped_sum"))
        kernels.append(phase_grouped_aggregate(args.seed, launches,
                                               previous.get("grouped_aggregate")))
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    print(json.dumps({"queries": times, "build_s": build_s, "sf": args.sf}))
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
