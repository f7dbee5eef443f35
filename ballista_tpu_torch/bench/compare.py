"""Cross-engine comparison of the port (benchmarks/compare.py's
counterpart): the same TPC-H queries over the same Parquet files through
the port's ExecutionContext on the "cuda" backend (the card, unless
BENCH_DEVICE=cpu) and on its "cpu" backend, beside the pandas oracles of
benchmarks/tpch/oracles.py and hand-written pyarrow code.

Every engine's answer is cross-checked against the first engine's (row
count and the sorted first measure column, as benchmarks/compare.py does),
and each of the port's answers is held whole against the pandas oracle:
the same columns and rows, non-float columns equal and floats within
ORACLE_RTOL of the engine, rows compared in the order of their non-float
columns. A mismatch makes the run exit nonzero (benchmarks/compare.py
does so only under --strict).

Usage:
    python -m ballista_tpu_torch.bench.compare --data .bench_cache/tpch_sf1.0 \\
        --queries q1 q3 q6 [--iterations 3] [--engines cuda cpu pyarrow pandas]

Prints a markdown table of per-query best times and relative speed.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time
from typing import Dict, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from ballista_tpu_torch.bench import data, device_arg, synchronize
from ballista_tpu_torch.bench.tpch import BATCH, QUERIES_DIR

# the oracle's f64 against each of the port's backends: the host computes
# in f64; the card sums in f32 (tests/test_tpch.py's device tolerance)
ORACLE_RTOL = {"cuda": 5e-4, "cpu": 1e-9}
# one-value queries whose SQL NULL is the oracle's NaN
SCALAR_QUERIES = {"q6", "q14", "q17", "q19"}


class BallistaEngine:
    """The port's ExecutionContext on one backend ("cuda" or "cpu")."""

    def __init__(self, data_path: str, backend: str, device=None) -> None:
        from benchmarks.tpch.datagen import register_all

        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.engine import ExecutionContext

        self.backend = backend
        self.device = device
        self.ctx = ExecutionContext(
            BallistaConfig({"ballista.executor.backend": backend, "ballista.batch.size": BATCH}),
            device="cpu" if backend == "cpu" else device_arg(device),
        )
        register_all(self.ctx, data_path)

    def run(self, name: str) -> pa.Table:
        sql = (QUERIES_DIR / f"{name}.sql").read_text()
        out = self.ctx.sql(sql).collect()
        if self.backend != "cpu":
            synchronize(self.device)
        return out


class PandasOracleEngine:
    """The pandas oracles of all 22 queries."""

    def __init__(self, data_path: str) -> None:
        self.dir = pathlib.Path(data_path)
        self._tables = None

    def tables(self):
        if self._tables is None:
            names = ["lineitem", "orders", "customer", "supplier", "nation", "region",
                     "part", "partsupp"]
            self._tables = {
                n: pa.concat_tables(pq.read_table(f) for f in sorted((self.dir / n).glob(
                    "*.parquet"))).to_pandas()
                for n in names
            }
        return self._tables

    def frame(self, name: str):
        from benchmarks.tpch.oracles import ORACLES

        fn = ORACLES.get(name)
        return None if fn is None else fn(self.tables())

    def run(self, name: str) -> Optional[pa.Table]:
        f = self.frame(name)
        return None if f is None else pa.Table.from_pandas(f, preserve_index=False)


class PyArrowEngine:
    """Hand-written pyarrow versions of q1, q3, q5, q6, q10 and q12,
    independent of the port's planner and operators."""

    def __init__(self, data_path: str) -> None:
        self.dir = pathlib.Path(data_path)
        self._cache: Dict[str, pa.Table] = {}

    def _t(self, name: str) -> pa.Table:
        if name not in self._cache:
            files = sorted((self.dir / name).glob("*.parquet"))
            self._cache[name] = pa.concat_tables(pq.read_table(f) for f in files)
        return self._cache[name]

    def run(self, name: str) -> Optional[pa.Table]:
        fn = getattr(self, f"_{name}", None)
        return fn() if fn else None

    def _q1(self) -> pa.Table:
        import datetime

        li = self._t("lineitem")
        li = li.filter(pc.less_equal(li.column("l_shipdate"),
                                     pa.scalar(datetime.date(1998, 9, 2))))
        disc_price = pc.multiply(li.column("l_extendedprice"),
                                 pc.subtract(pa.scalar(1.0), li.column("l_discount")))
        charge = pc.multiply(disc_price, pc.add(pa.scalar(1.0), li.column("l_tax")))
        t = li.append_column("disc_price", disc_price).append_column("charge", charge)
        out = t.group_by(["l_returnflag", "l_linestatus"]).aggregate([
            ("l_quantity", "sum"), ("l_extendedprice", "sum"), ("disc_price", "sum"),
            ("charge", "sum"), ("l_quantity", "mean"), ("l_extendedprice", "mean"),
            ("l_discount", "mean"), ("l_quantity", "count"),
        ])
        return out.sort_by([("l_returnflag", "ascending"), ("l_linestatus", "ascending")])

    def _q6(self) -> pa.Table:
        import datetime

        li = self._t("lineitem")
        m = pc.and_(
            pc.and_(
                pc.greater_equal(li.column("l_shipdate"), pa.scalar(datetime.date(1994, 1, 1))),
                pc.less(li.column("l_shipdate"), pa.scalar(datetime.date(1995, 1, 1))),
            ),
            pc.and_(
                pc.and_(pc.greater_equal(li.column("l_discount"), pa.scalar(0.05)),
                        pc.less_equal(li.column("l_discount"), pa.scalar(0.07))),
                pc.less(li.column("l_quantity"), pa.scalar(24.0)),
            ),
        )
        li = li.filter(m)
        rev = pc.sum(pc.multiply(li.column("l_extendedprice"), li.column("l_discount")))
        return pa.table({"revenue": pa.array([rev.as_py()])})

    def _q3(self) -> pa.Table:
        import datetime

        cutoff = datetime.date(1995, 3, 15)
        cust = self._t("customer")
        cust = cust.filter(pc.equal(cust.column("c_mktsegment"),
                                    pa.scalar("BUILDING"))).select(["c_custkey"])
        orders = self._t("orders")
        orders = orders.filter(pc.less(orders.column("o_orderdate"), pa.scalar(cutoff))).select(
            ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
        li = self._t("lineitem")
        li = li.filter(pc.greater(li.column("l_shipdate"), pa.scalar(cutoff))).select(
            ["l_orderkey", "l_extendedprice", "l_discount"])
        j = orders.join(cust, keys="o_custkey", right_keys="c_custkey", join_type="inner")
        j = li.join(j, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
        rev = pc.multiply(j.column("l_extendedprice"),
                          pc.subtract(pa.scalar(1.0), j.column("l_discount")))
        out = j.append_column("rev", rev).group_by(
            ["l_orderkey", "o_orderdate", "o_shippriority"]).aggregate([("rev", "sum")])
        out = out.sort_by([("rev_sum", "descending"), ("o_orderdate", "ascending")])
        return out.slice(0, 10)

    def _q5(self) -> pa.Table:
        import datetime

        lo, hi = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
        orders = self._t("orders")
        orders = orders.filter(pc.and_(
            pc.greater_equal(orders.column("o_orderdate"), pa.scalar(lo)),
            pc.less(orders.column("o_orderdate"), pa.scalar(hi)),
        )).select(["o_orderkey", "o_custkey"])
        cust = self._t("customer").select(["c_custkey", "c_nationkey"])
        li = self._t("lineitem").select(["l_orderkey", "l_suppkey", "l_extendedprice",
                                         "l_discount"])
        supp = self._t("supplier").select(["s_suppkey", "s_nationkey"])
        nat = self._t("nation").select(["n_nationkey", "n_name", "n_regionkey"])
        reg = self._t("region")
        reg = reg.filter(pc.equal(reg.column("r_name"), pa.scalar("ASIA"))).select(
            ["r_regionkey"])
        j = orders.join(cust, keys="o_custkey", right_keys="c_custkey", join_type="inner")
        j = li.join(j, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
        j = j.join(supp, keys="l_suppkey", right_keys="s_suppkey", join_type="inner")
        j = j.filter(pc.equal(j.column("c_nationkey"), j.column("s_nationkey")))
        j = j.join(nat, keys="s_nationkey", right_keys="n_nationkey", join_type="inner")
        j = j.join(reg, keys="n_regionkey", right_keys="r_regionkey", join_type="inner")
        rev = pc.multiply(j.column("l_extendedprice"),
                          pc.subtract(pa.scalar(1.0), j.column("l_discount")))
        out = j.append_column("rev", rev).group_by(["n_name"]).aggregate([("rev", "sum")])
        return out.sort_by([("rev_sum", "descending")])

    def _q10(self) -> pa.Table:
        import datetime

        lo, hi = datetime.date(1993, 10, 1), datetime.date(1994, 1, 1)
        orders = self._t("orders")
        orders = orders.filter(pc.and_(
            pc.greater_equal(orders.column("o_orderdate"), pa.scalar(lo)),
            pc.less(orders.column("o_orderdate"), pa.scalar(hi)),
        )).select(["o_orderkey", "o_custkey"])
        li = self._t("lineitem")
        li = li.filter(pc.equal(li.column("l_returnflag"), pa.scalar("R"))).select(
            ["l_orderkey", "l_extendedprice", "l_discount"])
        cust = self._t("customer").select(["c_custkey", "c_name", "c_acctbal", "c_phone",
                                           "c_nationkey", "c_address", "c_comment"])
        nat = self._t("nation").select(["n_nationkey", "n_name"])
        j = li.join(orders, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
        j = j.join(cust, keys="o_custkey", right_keys="c_custkey", join_type="inner")
        j = j.join(nat, keys="c_nationkey", right_keys="n_nationkey", join_type="inner")
        rev = pc.multiply(j.column("l_extendedprice"),
                          pc.subtract(pa.scalar(1.0), j.column("l_discount")))
        out = j.append_column("rev", rev).group_by(
            ["o_custkey", "c_name", "c_acctbal", "c_phone", "n_name", "c_address",
             "c_comment"]).aggregate([("rev", "sum")])
        out = out.sort_by([("rev_sum", "descending")]).slice(0, 20)
        # the query's column order (revenue third), so that the cross-check's
        # first float column is revenue on every engine
        return out.select(["o_custkey", "c_name", "rev_sum", "c_acctbal", "n_name",
                           "c_address", "c_phone", "c_comment"])

    def _q12(self) -> pa.Table:
        import datetime

        lo, hi = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
        li = self._t("lineitem")
        li = li.filter(pc.and_(
            pc.and_(
                pc.is_in(li.column("l_shipmode"), value_set=pa.array(["MAIL", "SHIP"])),
                pc.less(li.column("l_commitdate"), li.column("l_receiptdate")),
            ),
            pc.and_(
                pc.less(li.column("l_shipdate"), li.column("l_commitdate")),
                pc.and_(pc.greater_equal(li.column("l_receiptdate"), pa.scalar(lo)),
                        pc.less(li.column("l_receiptdate"), pa.scalar(hi))),
            ),
        )).select(["l_orderkey", "l_shipmode"])
        orders = self._t("orders").select(["o_orderkey", "o_orderpriority"])
        j = li.join(orders, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
        high = pc.is_in(j.column("o_orderpriority"), value_set=pa.array(["1-URGENT", "2-HIGH"]))
        highf = pc.cast(high, pa.float64())
        j = j.append_column("high", highf).append_column(
            "low", pc.subtract(pa.scalar(1.0), highf))
        out = j.group_by(["l_shipmode"]).aggregate([("high", "sum"), ("low", "sum")])
        return out.sort_by([("l_shipmode", "ascending")])


def oracle_mismatch(name: str, got: pa.Table, want, rtol: float) -> Optional[str]:
    """Why `got` (a port answer) differs from the pandas oracle's frame
    `want`, or None when it agrees."""
    import pandas as pd

    g = got.to_pandas()
    if list(g.columns) != list(want.columns):
        return f"columns {list(g.columns)} != {list(want.columns)}"
    if len(g) != len(want):
        return f"{len(g)} rows, the oracle {len(want)}"
    if name in SCALAR_QUERIES:
        gv, wv = g.iloc[0, 0], want.iloc[0, 0]
        if pd.isna(wv) or gv is None:
            return None if (gv is None or pd.isna(gv)) and pd.isna(wv) else f"{gv} != {wv}"
        return None if np.isclose(float(gv), float(wv), rtol=rtol, atol=rtol) else f"{gv} != {wv}"
    floats = {c for c in want.columns if pd.api.types.is_float_dtype(want[c].dtype)}
    keys = [c for c in want.columns if c not in floats]
    if keys:
        # float ties may order differently: compare in the order of the keys
        g = g.sort_values(keys, kind="stable").reset_index(drop=True)
        want = want.sort_values(keys, kind="stable").reset_index(drop=True)
    for c in want.columns:
        a, b = g[c].to_numpy(), want[c].to_numpy()
        if c in floats:
            if not np.allclose(a.astype(float), b.astype(float), rtol=rtol, atol=rtol,
                               equal_nan=True):
                return f"column {c} differs beyond rtol {rtol}"
        elif list(a) != list(b):
            return f"column {c} differs"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=str(data.data_dir(1.0)))
    ap.add_argument("--queries", nargs="+", default=["q1", "q3", "q5", "q6", "q10", "q12"],
                    help="query names, or 'all' for the full 22-query list")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--engines", nargs="+", default=["cuda", "cpu", "pyarrow", "pandas"])
    args = ap.parse_args(argv)
    if args.queries == ["all"]:
        args.queries = [f"q{i}" for i in range(1, 23)]
    mismatches = 0

    engines: Dict[str, object] = {}
    for e in args.engines:
        if e in ("cuda", "cpu"):
            engines[e] = BallistaEngine(args.data, e)
        elif e == "pyarrow":
            engines[e] = PyArrowEngine(args.data)
        elif e == "pandas":
            engines[e] = PandasOracleEngine(args.data)
        else:
            raise SystemExit(f"unknown engine {e!r}")
    oracle = engines.get("pandas")

    rows = []
    for q in args.queries:
        results, times = {}, {}
        for name, eng in engines.items():
            out = eng.run(q)
            if out is None:
                continue
            best = float("inf")
            for _ in range(args.iterations):
                t0 = time.perf_counter()
                out = eng.run(q)
                best = min(best, time.perf_counter() - t0)
            results[name], times[name] = out, best
        if not times:
            print(f"{q}: no engine produced a result; skipped", file=sys.stderr)
            continue
        # the port against the oracle, whole
        if oracle is not None:
            want = oracle.frame(q)
            for name in ("cuda", "cpu"):
                if name in results and want is not None:
                    why = oracle_mismatch(q, results[name], want, ORACLE_RTOL[name])
                    if why is not None:
                        mismatches += 1
                        print(f"MISMATCH: {q}: {name} against the pandas oracle: {why}",
                              file=sys.stderr)
        # every engine against the first: rows and the first measure column
        base_name = base_rows = base_vals = None
        for name, out in results.items():
            vals = None
            idx = next(
                (i for i, f in enumerate(out.schema) if pa.types.is_floating(f.type)),
                next((i for i, f in enumerate(out.schema) if pa.types.is_integer(f.type)),
                     None),
            )
            if idx is not None:
                vals = np.sort(np.array(out.column(idx).to_pylist(), dtype=float))
            if base_name is None:
                base_name, base_rows, base_vals = name, out.num_rows, vals
                continue
            if out.num_rows != base_rows:
                mismatches += 1
                print(f"MISMATCH: {q}: {name} rows={out.num_rows} != {base_name} "
                      f"rows={base_rows}", file=sys.stderr)
            elif (vals is not None and base_vals is not None
                  and not np.allclose(vals, base_vals, rtol=1e-3, equal_nan=True)):
                mismatches += 1
                print(f"MISMATCH: {q}: {name} values disagree with {base_name}",
                      file=sys.stderr)
        ref = times.get("cpu") or next(iter(times.values()))
        rows.append((q, times, ref))

    names = list(engines)
    print("| query | " + " | ".join(f"{n} (ms)" for n in names) + " | best vs cpu |")
    print("|" + "---|" * (len(names) + 2))
    for q, times, ref in rows:
        cells = [f"{times[n] * 1e3:.0f}" if n in times else "—" for n in names]
        fastest = min(times, key=times.get)
        print(f"| {q} | " + " | ".join(cells) + f" | {fastest} {ref / times[fastest]:.2f}x |")
    print(f"{mismatches} cross-engine mismatches", file=sys.stderr)
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
