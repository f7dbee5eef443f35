"""TPC-H benchmark CLI of the port (benchmarks/tpch/runner.py's counterpart,
after the upstream's rust/benchmarks/tpch):

  benchmark: register the 8 tables (tbl | csv | parquet), run queries on a
             local context (--backend cuda, the card; cpu, the host Arrow
             backend) or through the port's scheduler daemon (--host /
             --port), and time the iterations
  convert:   tbl -> csv / parquet with partitioning
  datagen:   the built-in TPC-H generator

Examples:
  python -m ballista_tpu_torch.bench.runner benchmark --path /data/tpch \\
      --query 1 --iterations 3 --backend cuda
  python -m ballista_tpu_torch.bench.runner benchmark --path /data/tpch \\
      --host localhost --port 50050
  python -m ballista_tpu_torch.bench.runner convert --input /data/tbl \\
      --output /data/parquet --format parquet --partitions 8

BENCH_DEVICE=cpu runs the "cuda" backend's device path on CPU tensors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmarks.tpch.schema import TPCH_TABLES, get_tpch_schema

from ballista_tpu_torch.bench import device_arg, synchronize
from ballista_tpu_torch.bench.tpch import QUERIES_DIR


def register_tables(ctx, path: str, fmt: str) -> None:
    for t in TPCH_TABLES:
        tpath = os.path.join(path, t)
        if fmt == "parquet":
            ctx.register_parquet(t, tpath)
        elif fmt == "csv":
            ctx.register_csv(t, tpath, schema=get_tpch_schema(t), has_header=True)
        elif fmt == "tbl":
            # dbgen .tbl: '|'-delimited, no header
            ctx.register_csv(t, tpath, schema=get_tpch_schema(t), has_header=False,
                             delimiter="|", file_extension=".tbl")
        else:
            raise SystemExit(f"unknown format {fmt!r}")


def cmd_benchmark(args) -> None:
    from ballista_tpu_torch.config import BallistaConfig

    settings = {"ballista.batch.size": str(args.batch_size),
                "ballista.executor.backend": args.backend}
    # the host backend needs no card; the device backend takes BENCH_DEVICE
    device = "cpu" if args.backend == "cpu" else device_arg()
    if args.host:
        from ballista_tpu_torch.client import BallistaContext

        ctx = BallistaContext(args.host, args.port, settings, device=device)
    else:
        from ballista_tpu_torch.engine import ExecutionContext

        ctx = ExecutionContext(BallistaConfig(settings), device=device)
    register_tables(ctx, args.path, args.format)

    queries = [args.query] if args.query else list(range(1, 23))
    results = {}
    for q in queries:
        sql = (QUERIES_DIR / f"q{q}.sql").read_text()
        times = []
        rows = 0
        for i in range(args.iterations):
            t0 = time.perf_counter()
            out = ctx.sql(sql).collect()
            if args.backend == "cuda":
                synchronize("cpu" if device == "cpu" else "cuda")
            dt = time.perf_counter() - t0
            rows = out.num_rows
            times.append(dt)
            print(f"q{q} iteration {i} took {dt*1000:.1f} ms ({rows} rows)", file=sys.stderr)
            if args.debug:
                print(out.to_pandas().to_string(), file=sys.stderr)
        results[f"q{q}"] = {"min_ms": round(min(times) * 1000, 1), "rows": rows}
    print(json.dumps(results))


def cmd_convert(args) -> None:
    import pyarrow.csv as pcsv
    import pyarrow.parquet as pq

    os.makedirs(args.output, exist_ok=True)
    for t in TPCH_TABLES:
        src = os.path.join(args.input, f"{t}.tbl")
        if not os.path.exists(src):
            src = os.path.join(args.input, t)
        schema = get_tpch_schema(t)
        # dbgen rows end with a trailing '|' -> one ghost column
        names = schema.names + ["__dummy"]
        table = pcsv.read_csv(
            src,
            read_options=pcsv.ReadOptions(column_names=names),
            parse_options=pcsv.ParseOptions(delimiter="|"),
            convert_options=pcsv.ConvertOptions(
                column_types={f.name: f.type for f in schema},
                include_columns=schema.names,
            ),
        ).cast(schema)
        out_dir = os.path.join(args.output, t)
        os.makedirs(out_dir, exist_ok=True)
        n = max(1, args.partitions)
        step = (table.num_rows + n - 1) // n
        for p in range(n):
            chunk = table.slice(p * step, step)
            if args.format == "parquet":
                pq.write_table(chunk, os.path.join(out_dir, f"part-{p:03d}.parquet"))
            else:
                pcsv.write_csv(chunk, os.path.join(out_dir, f"part-{p:03d}.csv"))
        print(f"converted {t}: {table.num_rows} rows -> {n} {args.format} files",
              file=sys.stderr)


def cmd_datagen(args) -> None:
    from benchmarks.tpch.datagen import generate

    generate(args.out, args.sf, args.parts, args.seed)
    print(f"TPC-H sf={args.sf} written to {args.out}", file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tpch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("benchmark")
    b.add_argument("--path", required=True)
    b.add_argument("--format", default="parquet", choices=["parquet", "csv", "tbl"])
    b.add_argument("--query", type=int)
    b.add_argument("--iterations", type=int, default=3)
    b.add_argument("--batch-size", type=int, default=32768)
    b.add_argument("--backend", default="cuda", choices=["cuda", "cpu"])
    b.add_argument("--host", help="the port's scheduler daemon (distributed mode)")
    b.add_argument("--port", type=int, default=50050)
    b.add_argument("--debug", action="store_true", help="print query results")
    b.set_defaults(fn=cmd_benchmark)

    c = sub.add_parser("convert")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--format", default="parquet", choices=["parquet", "csv"])
    c.add_argument("--partitions", type=int, default=1)
    c.set_defaults(fn=cmd_convert)

    d = sub.add_parser("datagen")
    d.add_argument("--sf", type=float, default=0.01)
    d.add_argument("--out", required=True)
    d.add_argument("--parts", type=int, default=2)
    d.add_argument("--seed", type=int, default=20260728)
    d.set_defaults(fn=cmd_datagen)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
