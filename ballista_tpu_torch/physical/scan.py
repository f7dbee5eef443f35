"""Scan operators: CSV / Parquet / in-memory.

One partition per input file, as the reference's DataFusion scans do
(CsvExec/ParquetExec, referenced from rust/core/src/serde/physical_plan/from_proto.rs:85-131).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import pyarrow as pa
import pyarrow.csv
import pyarrow.parquet

# host decoded-table cache (parquet), capped by total bytes, FIFO-evicted.
# Keys are (path, mtime, cols); a rewritten file gets a new key and the old
# entry for the same (path, cols) is dropped eagerly.
import threading

_TABLE_CACHE: Dict[tuple, pa.Table] = {}  # guarded-by: _TABLE_CACHE_MU
_TABLE_CACHE_BYTES = [0]  # guarded-by: _TABLE_CACHE_MU
_TABLE_CACHE_MU = threading.Lock()


def _cache_get(key: tuple) -> Optional[pa.Table]:
    with _TABLE_CACHE_MU:
        return _TABLE_CACHE.get(key)


def _maybe_cache(key: tuple, table: pa.Table, cap: int) -> None:
    nbytes = table.nbytes
    if nbytes > cap:
        return
    with _TABLE_CACHE_MU:
        # drop stale entries for the same (path, cols) with older mtimes
        path, _mtime, cols = key
        for k in [k for k in _TABLE_CACHE if k[0] == path and k[2] == cols and k != key]:
            _TABLE_CACHE_BYTES[0] -= _TABLE_CACHE[k].nbytes
            del _TABLE_CACHE[k]
        # FIFO eviction to fit
        while _TABLE_CACHE_BYTES[0] + nbytes > cap and _TABLE_CACHE:
            k = next(iter(_TABLE_CACHE))
            _TABLE_CACHE_BYTES[0] -= _TABLE_CACHE[k].nbytes
            del _TABLE_CACHE[k]
        _TABLE_CACHE[key] = table
        _TABLE_CACHE_BYTES[0] += nbytes

from ballista_tpu_torch.datasource import CsvTableSource, MemoryTableSource, ParquetTableSource
from ballista_tpu_torch.physical.plan import ExecutionPlan, Partitioning, TaskContext, batch_table


class CsvScanExec(ExecutionPlan):
    def __init__(self, source: CsvTableSource, projection: Optional[List[int]] = None) -> None:
        self.source = source
        self.projection = projection
        full = source.schema()
        if projection is None:
            self._schema = full
        else:
            self._schema = pa.schema([full.field(i) for i in projection])

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(len(self.source.files))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        path = self.source.files[partition]
        full = self.source.schema()
        read_opts = pa.csv.ReadOptions(
            column_names=None if self.source.has_header else full.names,
            block_size=1 << 24,
        )
        convert_opts = pa.csv.ConvertOptions(
            column_types={f.name: f.type for f in full},
            include_columns=[f.name for f in self._schema] if self.projection is not None else None,
        )
        parse_opts = pa.csv.ParseOptions(delimiter=self.source.delimiter)
        table = pa.csv.read_csv(
            path, read_options=read_opts, parse_options=parse_opts,
            convert_options=convert_opts,
        )
        table = table.select(self._schema.names).cast(self._schema)
        yield from batch_table(table, ctx.batch_size)

    def fmt(self) -> str:
        return f"CsvScanExec: {self.source.path} projection={self.projection}"


class ParquetScanExec(ExecutionPlan):
    def __init__(
        self, source: ParquetTableSource, projection: Optional[List[int]] = None,
        batch_size: int = 32768,
    ) -> None:
        self.source = source
        self.projection = projection
        full = source.schema()
        if projection is None:
            self._schema = full
        else:
            self._schema = pa.schema([full.field(i) for i in projection])
        # best-effort predicate hint set by the physical planner when a
        # FilterExec sits directly above: row groups whose min/max statistics
        # prove no row can match are skipped on the streaming path. The
        # filter above still runs, so this is purely an IO reduction.
        self.prune_predicate = None

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(len(self.source.files))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        path = self.source.files[partition]
        cols = self._schema.names if self.projection is not None else None
        # decoded-table cache: repeated queries skip parquet decode (the
        # host-side analog of the device column cache). Files too large to
        # ever fit stream instead of materializing.
        cap = ctx.config.scan_cache_cap()
        if ctx.config.scan_cache() and os.path.getsize(path) * 4 <= cap:
            key = (path, os.path.getmtime(path), tuple(cols) if cols else None)
            table = _cache_get(key)
            if table is None:
                table = pa.parquet.read_table(path, columns=cols)
                _maybe_cache(key, table, cap)
            yield from table.to_batches(max_chunksize=ctx.batch_size)
            return
        pf = pa.parquet.ParquetFile(path)
        row_groups = prune_row_groups(pf, self.prune_predicate)
        if not row_groups:
            return
        for batch in pf.iter_batches(
            batch_size=ctx.batch_size, columns=cols, row_groups=row_groups
        ):
            yield batch

    def fmt(self) -> str:
        return f"ParquetScanExec: {self.source.path} projection={self.projection}"


def _stat_conjuncts(predicate) -> List[tuple]:
    """Extract (column name, op, literal) conjuncts usable against row-group
    statistics; unrecognized parts are ignored (conservative)."""
    from ballista_tpu_torch.physical import expr as px

    out: List[tuple] = []

    def walk(e) -> None:
        if isinstance(e, px.BinaryPhysicalExpr):
            if e.op == "and":
                walk(e.left)
                walk(e.right)
                return
            flipped = {"lt": "gt", "lteq": "gteq", "gt": "lt", "gteq": "lteq",
                       "eq": "eq"}
            if e.op in flipped:
                l, r = e.left, e.right
                if isinstance(l, px.ColumnExpr) and isinstance(r, px.LiteralExpr):
                    out.append((l.name, e.op, r.value))
                elif isinstance(l, px.LiteralExpr) and isinstance(r, px.ColumnExpr):
                    out.append((r.name, flipped[e.op], l.value))
        elif isinstance(e, px.BetweenExpr) and not e.negated:
            if (
                isinstance(e.expr, px.ColumnExpr)
                and isinstance(e.low, px.LiteralExpr)
                and isinstance(e.high, px.LiteralExpr)
            ):
                out.append((e.expr.name, "gteq", e.low.value))
                out.append((e.expr.name, "lteq", e.high.value))

    walk(predicate)
    return out


def prune_row_groups(pf, predicate) -> List[int]:
    """Row groups that might contain matching rows (all of them when the
    predicate is absent or statistics are unusable). Mirrors the reference
    engine's parquet row-group filtering role; the proof obligation is
    one-sided — a group is skipped only when its min/max make a conjunct
    unsatisfiable."""
    md = pf.metadata
    n = md.num_row_groups
    if predicate is None or n == 0:
        return list(range(n))
    conjuncts = _stat_conjuncts(predicate)
    if not conjuncts:
        return list(range(n))
    # metadata columns are flattened parquet LEAVES, not arrow fields —
    # indexing by arrow-schema position shifts under nested columns and
    # would consult the wrong statistics. Map by leaf path instead; only
    # top-level primitive columns (path == name) participate.
    rg0 = md.row_group(0)
    file_cols = {}
    for i in range(md.num_columns):
        p = rg0.column(i).path_in_schema
        if "." not in p:
            file_cols[p] = i
    keep: List[int] = []
    for g in range(n):
        rg = md.row_group(g)
        dead = False
        for name, op, lit in conjuncts:
            ci = file_cols.get(name)
            if ci is None or lit is None:
                continue
            col = rg.column(ci)
            st = col.statistics
            if st is None or not st.has_min_max:
                continue
            try:
                if op == "lt" and not (st.min < lit):
                    dead = True
                elif op == "lteq" and not (st.min <= lit):
                    dead = True
                elif op == "gt" and not (st.max > lit):
                    dead = True
                elif op == "gteq" and not (st.max >= lit):
                    dead = True
                elif op == "eq" and not (st.min <= lit <= st.max):
                    dead = True
            except TypeError:
                continue  # incomparable stats (e.g. binary vs py value)
            if dead:
                break
        if not dead:
            keep.append(g)
    return keep


class MemoryScanExec(ExecutionPlan):
    def __init__(self, source: MemoryTableSource, projection: Optional[List[int]] = None) -> None:
        self.source = source
        self.projection = projection
        full = source.schema()
        if projection is None:
            self._schema = full
        else:
            self._schema = pa.schema([full.field(i) for i in projection])

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(self.source.num_partitions())

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        for batch in self.source.partitions[partition]:
            if self.projection is not None:
                batch = batch.select(self._schema.names)
            yield batch

    def fmt(self) -> str:
        return f"MemoryScanExec: projection={self.projection}"
