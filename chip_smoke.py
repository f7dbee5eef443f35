"""Smoke run of ballista_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1] [--seed 20260728]

Phases, each of which fails the run (non-zero exit) on any error:

1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles every CUDA kernel of the package (nvcc, sm_90a).
3. path: generates TPC-H at --sf and runs q1, q6, q15's revenue view and
   q18's inner aggregate through the package's ExecutionContext on the
   "cuda" backend (q15/q18 with ballista.tpu.sorted_kernel=pallas). Each
   result is held against the package's "cpu" backend on the same data:
   keys and counts equal, floats within rtol 1e-4 / atol 2e-3 (f32 device
   columns). Asserts the routes ("batches" for q1/q6, "pallas_sorted" for
   q15/q18), zero host declines, readbacks recorded, and at least two
   launches of the sorted_grouped_sum kernel. Prints cold and warm
   (median of 5) milliseconds per query.
4. kernels: runs each kernel against its plain PyTorch version on the card
   at the shapes the path gave it, plus a skewed case; counts must be
   equal, sums within rtol 1e-5 and atol 1e-3 x max|row sum| (atomics
   change the summation order). Times kernel, plain version and a library
   call with CUDA events (median of 20 after warm-up).

Prints one {"kernels": [...]} line, then the nvidia-smi line, and last
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

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and f32
# non-tensor-core rate, for the bound of a memory-bound f32 reduction
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

RTOL_PATH, ATOL_PATH = 1e-4, 2e-3
RTOL_KERNEL, ATOL_KERNEL_REL = 1e-5, 1e-3

Q15_REVENUE = (
    "select l_suppkey as supplier_no, sum(l_extendedprice * (1 - l_discount)) "
    "as total_revenue from lineitem where l_shipdate >= date '1996-01-01' and "
    "l_shipdate < date '1996-01-01' + interval '3' month group by l_suppkey"
)
Q18_INNER = (
    "select l_orderkey, sum(l_quantity) as sum_qty from lineitem "
    "group by l_orderkey having sum(l_quantity) > 300"
)


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
    log(f"build: {secs:.2f} s ({', '.join(built) or 'up to date'})")
    return secs


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


def phase_path(sf: float, seed: int, data_dir: str):
    import torch

    from benchmarks.tpch.datagen import generate, register_all

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import cuda_kernels, runtime

    t0 = time.perf_counter()
    generate(data_dir, sf=sf, parts=2, seed=seed)
    log(f"datagen sf={sf}: {time.perf_counter() - t0:.1f} s")
    queries = [
        ("q1", (ROOT / "benchmarks/tpch/queries/q1.sql").read_text(), False, "batches"),
        ("q6", (ROOT / "benchmarks/tpch/queries/q6.sql").read_text(), False, "batches"),
        ("q15_revenue", Q15_REVENUE, True, "pallas_sorted"),
        ("q18_inner", Q18_INNER, True, "pallas_sorted"),
    ]
    times = {}
    # the main path: every launch counter starts at 0 here
    cuda_kernels.reset_launch_counts()
    for name, sql, pallas, route in queries:
        settings = {
            "ballista.executor.backend": "cuda",
            "ballista.tpu.layout_cache_dir": "",
        }
        if pallas:
            settings["ballista.tpu.sorted_kernel"] = "pallas"
        ctx = ExecutionContext(BallistaConfig(settings))
        register_all(ctx, data_dir)
        runtime.routing_stats(reset=True)
        runtime.readback_stats(reset=True)
        runtime.ingest_stats(reset=True)
        t0 = time.perf_counter()
        got = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        routes = runtime.routing_stats()
        reads = runtime.readback_stats()
        ingest = runtime.ingest_stats()
        if routes["routes"].get("host") or routes["reasons"]:
            fail(f"{name}: a stage declined to the host: {routes}")
        if routes["routes"].get(route, 0) < 1:
            fail(f"{name}: expected route {route!r}, recorded {routes['routes']}")
        if reads["readbacks"] < 1:
            fail(f"{name}: no readback recorded")
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        host_ctx = ExecutionContext(
            BallistaConfig({**settings, "ballista.executor.backend": "cpu"})
        )
        register_all(host_ctx, data_dir)
        expect = host_ctx.sql(sql).collect()
        _compare(name, got, expect)
        _compare(name + " (warm)", again, expect)
        times[name] = {
            "route": route, "rows": got.num_rows, "cold_ms": cold_ms,
            "warm_ms": statistics.median(warm), "readbacks": reads["readbacks"],
            "readback_bytes": reads["bytes"],
            # the cold run's host prepare: scan (read + decode + rank),
            # encode (lower + narrow), upload (h2d enqueue), wall
            "prepare_ms": {k: ingest[k] * 1e3 for k in
                           ("scan_s", "encode_s", "upload_s", "wall_s")},
        }
        log(f"{name}: {times[name]}")
    launches = cuda_kernels.launch_counts()
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


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def phase_kernels(seed: int, launches: dict):
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
        err = (got - want).abs()
        scale = want.abs().amax(dim=1, keepdim=True)
        tol = RTOL_KERNEL * want.abs() + ATOL_KERNEL_REL * scale
        if bool((err > tol).any()):
            fail(f"sorted_grouped_sum {name}: sums differ (max abs err {err.max().item()})")
        nv, n = vals.shape
        lib_vals = vals.t().contiguous()
        kernel_ms = _time_ms(lambda: ck.sorted_grouped_sum(codes, vals, G))
        plain_ms = _time_ms(lambda: ck.sorted_grouped_sum_plain(codes, vals, G))
        library_ms = _time_ms(lambda: torch.segment_reduce(
            lib_vals, "sum", lengths=torch.bincount(codes, minlength=G), axis=0
        ))
        lib = torch.segment_reduce(
            lib_vals, "sum", lengths=torch.bincount(codes, minlength=G), axis=0
        ).t()
        if not torch.allclose(lib, want, rtol=1e-4, atol=1e-3 * float(scale.max())):
            fail(f"library call disagrees with the plain version on {name}")
        nbytes = n * 4 + nv * n * 4 + nv * G * 4
        ops = nv * n
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / F32_FLOPS * 1e3
        results.append({
            "case": name, "n": n, "nv": nv, "groups": G,
            "max_abs_err": float(err.max()), "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
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
        "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "library_ms": head["library_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "cases": results,
    }]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=20260728)
    args = ap.parse_args()

    smi_line = phase_device()
    sys.path.insert(0, str(ROOT))
    import torch

    import ballista_tpu_torch  # noqa: F401  (fails outside a checkout)

    build_s = phase_build()
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_tpch_")
    try:
        times, launches = phase_path(args.sf, args.seed, data_dir)
        kernels = phase_kernels(args.seed, launches)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    print(json.dumps({"queries": times, "build_s": build_s, "sf": args.sf}))
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
