"""Hash aggregation with Partial / Final / Single modes.

Mirrors the reference's HashAggregateExec two-phase split
(rust/core/proto/ballista.proto:370-384; the distributed planner cuts stages
at Final-mode aggregates, rust/scheduler/src/planner.rs:149-171):

- Partial: per-partition group-by producing *state* columns
  (sum -> sum; avg -> sum+count; count -> count; min/max -> min/max)
- Final: re-groups partial states by key and merges them
- Single: both phases fused (used when the input is one partition or for
  DISTINCT aggregates)

Host kernels use pyarrow's C++ hash group-by; the "cuda" backend lowers the
partial phase into a fused device stage (ballista_tpu_torch.ops.stage).
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Tuple

import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.physical.expr import PhysicalExpr, _as_array
from ballista_tpu_torch.physical.plan import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    batch_table,
    collect_partition,
)


class AggregateMode(enum.Enum):
    PARTIAL = "partial"
    FINAL = "final"
    SINGLE = "single"


class AggregateFunc:
    """One aggregate: fn in {sum, min, max, avg, count, count_distinct}."""

    def __init__(self, fn: str, expr: PhysicalExpr, name: str, dtype: pa.DataType,
                 input_type: pa.DataType) -> None:
        self.fn = fn
        self.expr = expr
        self.name = name
        self.dtype = dtype  # final output type
        self.input_type = input_type

    def state_fields(self) -> List[pa.Field]:
        if self.fn == "sum":
            return [pa.field(f"{self.name}[sum]", self.dtype)]
        if self.fn == "min":
            return [pa.field(f"{self.name}[min]", self.dtype)]
        if self.fn == "max":
            return [pa.field(f"{self.name}[max]", self.dtype)]
        if self.fn == "count":
            return [pa.field(f"{self.name}[count]", pa.int64())]
        if self.fn == "avg":
            return [
                pa.field(f"{self.name}[sum]", pa.float64()),
                pa.field(f"{self.name}[count]", pa.int64()),
            ]
        raise PlanError(f"no partial state for {self.fn!r}")

    def __repr__(self) -> str:
        return f"{self.fn.upper()}({self.expr}) AS {self.name}"


def needs_exact_float_minmax(agg) -> bool:
    """True when this aggregate's result is equality-consumed (decorrelated
    scalar subquery) AND it computes float MIN/MAX — the f32 device paths
    would round the value so it matches nothing; they must decline."""
    return getattr(agg, "exact_floats", False) and any(
        a.fn in ("min", "max") and pa.types.is_floating(a.input_type)
        for a in agg.aggr_funcs
    )


def _sum_type(dt: pa.DataType) -> pa.DataType:
    if pa.types.is_integer(dt):
        return pa.int64()
    return pa.float64()


def _cast_to_schema(columns, schema: pa.Schema) -> pa.Table:
    """Assemble output columns under a schema, casting where types differ."""
    arrays = []
    for col, field in zip(columns, schema):
        arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        if arr.type != field.type:
            arr = pc.cast(arr, field.type)
        arrays.append(arr)
    return pa.table(arrays, schema=schema)


class HashAggregateExec(ExecutionPlan):
    def __init__(
        self,
        mode: AggregateMode,
        input: ExecutionPlan,
        group_exprs: List[Tuple[PhysicalExpr, str]],
        aggr_funcs: List[AggregateFunc],
        exact_floats: bool = False,
    ) -> None:
        self.mode = mode
        self.input = input
        self.group_exprs = group_exprs
        self.aggr_funcs = aggr_funcs
        # float MIN/MAX results are equality-consumed (decorrelated scalar
        # subquery, q2): the f32 device paths must decline
        self.exact_floats = exact_floats
        in_schema = input.schema()

        group_fields = []
        if mode == AggregateMode.FINAL:
            # positional: keys arrive as the first k input columns
            for i, (_, name) in enumerate(group_exprs):
                f = in_schema.field(i)
                group_fields.append(pa.field(name, f.type))
        else:
            for e, name in group_exprs:
                group_fields.append(pa.field(name, e.data_type(in_schema)))

        if mode == AggregateMode.PARTIAL:
            agg_fields = [f for a in aggr_funcs for f in a.state_fields()]
        else:
            agg_fields = [pa.field(a.name, a.dtype) for a in aggr_funcs]
        self._schema = pa.schema(group_fields + agg_fields)

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        if self.mode == AggregateMode.PARTIAL:
            return self.input.output_partitioning()
        if self.mode == AggregateMode.FINAL:
            # final aggregation runs per input partition (the planner ensures
            # keys are hash-disjoint across partitions, or input is merged)
            return Partitioning.unknown(
                self.input.output_partitioning().partition_count()
            )
        return Partitioning.unknown(1)

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "HashAggregateExec":
        return HashAggregateExec(
            self.mode, children[0], self.group_exprs, self.aggr_funcs,
            exact_floats=self.exact_floats,
        )

    # ------------------------------------------------------------------
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        if ctx.backend == "cuda" and self.mode in (AggregateMode.PARTIAL, AggregateMode.SINGLE):
            from ballista_tpu_torch.ops.dispatch import device_hash_aggregate
            out = device_hash_aggregate(self, partition, ctx)
            if out is not None:
                if self.mode == AggregateMode.SINGLE:
                    # the fused stage produces partial states; merge them to
                    # final values with the host merge (tiny input)
                    out = self._final(out)
                yield from batch_table(out, ctx.batch_size)
                return
        table = collect_partition(self.input, partition, ctx)
        if self.mode == AggregateMode.PARTIAL:
            out = self._partial(table)
        elif self.mode == AggregateMode.FINAL:
            out = self._final(table)
        else:
            out = self._single(table)
        yield from batch_table(out, ctx.batch_size)

    # -- phase implementations -----------------------------------------
    def _eval_inputs(self, table: pa.Table) -> Tuple[pa.Table, List[str], List[List[str]]]:
        """Materialize key columns and aggregate input columns."""
        if table.num_rows == 0:
            batch = pa.RecordBatch.from_arrays(
                [pa.array([], type=f.type) for f in table.schema], schema=table.schema
            )
        else:
            batch = table.combine_chunks().to_batches()[0]
        n = batch.num_rows
        cols = {}
        key_names = []
        for i, (e, _name) in enumerate(self.group_exprs):
            kn = f"__g{i}"
            cols[kn] = _as_array(e.evaluate(batch), n) if n else pa.array([], type=e.data_type(table.schema))
            key_names.append(kn)
        agg_in_names: List[List[str]] = []
        for j, a in enumerate(self.aggr_funcs):
            an = f"__a{j}"
            cols[an] = (
                _as_array(a.expr.evaluate(batch), n)
                if n
                else pa.array([], type=a.input_type)
            )
            agg_in_names.append([an])
        return pa.table(cols), key_names, agg_in_names

    def _partial(self, table: pa.Table) -> pa.Table:
        t, keys, agg_ins = self._eval_inputs(table)
        specs = []  # (col, fn, options, out_name_in_result)
        for a, (an,) in zip(self.aggr_funcs, agg_ins):
            if a.fn == "sum":
                specs.append((an, "sum", None))
            elif a.fn == "min":
                specs.append((an, "min", None))
            elif a.fn == "max":
                specs.append((an, "max", None))
            elif a.fn == "count":
                specs.append((an, "count", pc.CountOptions(mode="only_valid")))
            elif a.fn == "avg":
                specs.append((an, "sum", None))
                specs.append((an, "count", pc.CountOptions(mode="only_valid")))
            else:
                raise PlanError(f"partial mode cannot handle {a.fn}")
        result = self._group_aggregate(t, keys, specs)
        out_cols = [result[0].column(k) for k in range(len(keys))]
        out_cols += [result[1][i] for i in range(len(specs))]
        return _cast_to_schema(out_cols, self._schema)

    def _final(self, table: pa.Table) -> pa.Table:
        k = len(self.group_exprs)
        keys = [f"__g{i}" for i in range(k)]
        cols = {keys[i]: table.column(i) for i in range(k)}
        specs = []
        col_idx = k
        # merge state columns
        merged_names: List[List[int]] = []
        for a in self.aggr_funcs:
            state_n = len(a.state_fields())
            idxs = []
            for s in range(state_n):
                cn = f"__s{col_idx}"
                cols[cn] = table.column(col_idx)
                f = a.state_fields()[s]
                if a.fn in ("sum", "count", "avg"):
                    specs.append((cn, "sum", None))
                elif a.fn == "min":
                    specs.append((cn, "min", None))
                elif a.fn == "max":
                    specs.append((cn, "max", None))
                idxs.append(len(specs) - 1)
                col_idx += 1
            merged_names.append(idxs)
        t = pa.table(cols)
        key_tbl, agg_arrays = self._group_aggregate(t, keys, specs)
        out_arrays = [key_tbl.column(i) for i in range(k)]
        for a, idxs in zip(self.aggr_funcs, merged_names):
            if a.fn == "avg":
                s = agg_arrays[idxs[0]]
                c = agg_arrays[idxs[1]]
                out_arrays.append(pc.divide(pc.cast(s, pa.float64()), pc.cast(c, pa.float64())))
            elif a.fn == "count":
                # COUNT is never NULL: merging zero partial states (a global
                # aggregate whose input had no rows) must finalize to 0, but
                # pc.sum over an empty state column yields null
                out_arrays.append(pc.fill_null(agg_arrays[idxs[0]], 0))
            else:
                out_arrays.append(agg_arrays[idxs[0]])
        return _cast_to_schema(out_arrays, self._schema)

    def _single(self, table: pa.Table) -> pa.Table:
        t, keys, agg_ins = self._eval_inputs(table)
        specs = []
        for a, (an,) in zip(self.aggr_funcs, agg_ins):
            if a.fn == "avg":
                specs.append((an, "mean", None))
            elif a.fn == "count":
                specs.append((an, "count", pc.CountOptions(mode="only_valid")))
            elif a.fn == "count_distinct":
                specs.append((an, "count_distinct", None))
            else:
                specs.append((an, a.fn, None))
        key_tbl, agg_arrays = self._group_aggregate(t, keys, specs)
        out_arrays = [key_tbl.column(i) for i in range(len(keys))]
        out_arrays += agg_arrays
        return _cast_to_schema(out_arrays, self._schema)

    @staticmethod
    def _group_aggregate(t: pa.Table, keys: List[str], specs) -> Tuple[pa.Table, List[pa.ChunkedArray]]:
        """Run pyarrow hash group-by; return (key table, agg arrays in spec order).

        With no keys, produces the scalar-aggregate single row.
        """
        aggregations = [
            (col, fn) if opts is None else (col, fn, opts) for col, fn, opts in specs
        ]
        if keys:
            gb = t.group_by(keys, use_threads=False)
            res = gb.aggregate(aggregations)
            key_tbl = res.select(keys)
            agg_arrays = []
            for (col, fn, _opts) in specs:
                agg_arrays.append(res.column(f"{col}_{fn}"))
            return key_tbl, agg_arrays
        # scalar aggregation (no GROUP BY): aggregate over whole table
        agg_arrays = []
        for (col, fn, opts) in specs:
            arr = t.column(col)
            if fn == "sum":
                v = pc.sum(arr)
            elif fn == "min":
                v = pc.min(arr)
            elif fn == "max":
                v = pc.max(arr)
            elif fn == "mean":
                v = pc.mean(arr)
            elif fn == "count":
                v = pc.count(arr, mode="only_valid")
            elif fn == "count_distinct":
                v = pc.count_distinct(arr)
            else:
                raise PlanError(f"unknown scalar agg {fn}")
            agg_arrays.append(pa.chunked_array([pa.array([v.as_py()], type=v.type)]))
        return pa.table({}), agg_arrays

    def fmt(self) -> str:
        g = ", ".join(f"{e} AS {n}" for e, n in self.group_exprs)
        a = ", ".join(repr(x) for x in self.aggr_funcs)
        return f"HashAggregateExec: mode={self.mode.value}, gby=[{g}], aggr=[{a}]"
