"""Row-preserving / reshaping operators: projection, filter, limits, coalesce,
merge, sort, empty, distinct.

Mirrors the reference's physical node set (PhysicalPlanNode variants,
rust/core/proto/ballista.proto:294-312): ProjectionExec, FilterExec,
GlobalLimitExec, LocalLimitExec, CoalesceBatchesExec, MergeExec, SortExec,
EmptyExec.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

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


class ProjectionExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, exprs: List[Tuple[PhysicalExpr, str]]) -> None:
        self.input = input
        self.exprs = exprs
        in_schema = input.schema()
        self._schema = pa.schema(
            [pa.field(name, e.data_type(in_schema)) for e, name in exprs]
        )

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "ProjectionExec":
        return ProjectionExec(children[0], self.exprs)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        # always the host Arrow path: a stand-alone device projection pays
        # h2d + d2h per batch with nothing fused around it; projections that
        # matter fuse into FusedAggregateStage / FactAggregateStage instead
        for batch in self.input.execute(partition, ctx):
            arrays = []
            for (e, _name), field in zip(self.exprs, self._schema):
                arr = _as_array(e.evaluate(batch), batch.num_rows)
                if arr.type != field.type:
                    arr = pc.cast(arr, field.type)
                arrays.append(arr)
            yield pa.RecordBatch.from_arrays(arrays, schema=self._schema)

    def fmt(self) -> str:
        return "ProjectionExec: " + ", ".join(f"{e} AS {n}" for e, n in self.exprs)


class FilterExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, predicate: PhysicalExpr) -> None:
        self.input = input
        self.predicate = predicate

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "FilterExec":
        return FilterExec(children[0], self.predicate)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        # per-operator device filter (ballista.tpu.per_op_dispatch); filters
        # under an aggregate reach the device fused into its stage instead
        on_device = ctx.backend == "cuda" and ctx.config.tpu_per_op()
        if on_device:
            from ballista_tpu_torch.ops.dispatch import device_filter
        for batch in self.input.execute(partition, ctx):
            if on_device:
                out = device_filter(batch, self.predicate, ctx)
                if out is not None:
                    if out.num_rows:
                        yield out
                    continue
            mask = _as_array(self.predicate.evaluate(batch), batch.num_rows)
            mask = pc.fill_null(mask, False)
            out = batch.filter(mask)
            if out.num_rows:
                yield out

    def fmt(self) -> str:
        return f"FilterExec: {self.predicate}"


class LocalLimitExec(ExecutionPlan):
    """Limit applied per partition (reference LocalLimitExecNode)."""

    def __init__(self, input: ExecutionPlan, limit: int) -> None:
        self.input = input
        self.limit = limit

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "LocalLimitExec":
        return LocalLimitExec(children[0], self.limit)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        remaining = self.limit
        for batch in self.input.execute(partition, ctx):
            if remaining <= 0:
                return
            if batch.num_rows > remaining:
                yield batch.slice(0, remaining)
                return
            remaining -= batch.num_rows
            yield batch

    def fmt(self) -> str:
        return f"LocalLimitExec: {self.limit}"


class GlobalLimitExec(ExecutionPlan):
    """Limit over a single input partition (reference GlobalLimitExecNode)."""

    def __init__(self, input: ExecutionPlan, limit: int, skip: int = 0) -> None:
        self.input = input
        self.limit = limit
        self.skip = skip

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "GlobalLimitExec":
        return GlobalLimitExec(children[0], self.limit, self.skip)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        assert partition == 0
        to_skip = self.skip
        remaining = self.limit
        for batch in self.input.execute(0, ctx):
            if to_skip >= batch.num_rows:
                to_skip -= batch.num_rows
                continue
            if to_skip:
                batch = batch.slice(to_skip)
                to_skip = 0
            if remaining <= 0:
                return
            if batch.num_rows > remaining:
                yield batch.slice(0, remaining)
                return
            remaining -= batch.num_rows
            yield batch

    def fmt(self) -> str:
        return f"GlobalLimitExec: {self.limit}"


class CoalesceBatchesExec(ExecutionPlan):
    """Re-chunk small batches up to a target size (reference
    CoalesceBatchesExecNode)."""

    def __init__(self, input: ExecutionPlan, target_batch_size: int) -> None:
        self.input = input
        self.target_batch_size = target_batch_size

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "CoalesceBatchesExec":
        return CoalesceBatchesExec(children[0], self.target_batch_size)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        yield from coalesce_batches(self.input.execute(partition, ctx), self.target_batch_size)

    def fmt(self) -> str:
        return f"CoalesceBatchesExec: target={self.target_batch_size}"


def coalesce_batches(
    batches: Iterator[pa.RecordBatch], target: int
) -> Iterator[pa.RecordBatch]:
    """Re-chunk a stream into batches of exactly `target` rows and one last,
    shorter batch: the rows past a full batch carry into the next, so n rows
    come out as ceil(n / target) batches. Empty batches are dropped; a batch
    of exactly `target` rows that meets an empty buffer passes through."""
    buf: List[pa.RecordBatch] = []
    rows = 0
    for batch in batches:
        if not batch.num_rows:
            continue
        buf.append(batch)
        rows += batch.num_rows
        if rows < target:
            continue
        merged = pa.Table.from_batches(buf)
        off = 0
        while rows - off >= target:
            # combine_chunks leaves a column of one chunk as it is
            yield from merged.slice(off, target).combine_chunks().to_batches()
            off += target
        buf = [b for b in merged.slice(off).to_batches() if b.num_rows]
        rows -= off
    if buf:
        yield from pa.Table.from_batches(buf).combine_chunks().to_batches()


class MergeExec(ExecutionPlan):
    """N -> 1 partition merge (reference MergeExecNode / CollectExec)."""

    def __init__(self, input: ExecutionPlan) -> None:
        self.input = input

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "MergeExec":
        return MergeExec(children[0])

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        assert partition == 0
        for p in range(self.input.output_partitioning().partition_count()):
            yield from self.input.execute(p, ctx)

    def fmt(self) -> str:
        return "MergeExec"


class SortExec(ExecutionPlan):
    """Full sort of one input partition (reference SortExecNode; the planner
    merges partitions first)."""

    def __init__(
        self,
        input: ExecutionPlan,
        sort_keys: List[Tuple[PhysicalExpr, bool, bool]],  # (expr, ascending, nulls_first)
        fetch: Optional[int] = None,
    ) -> None:
        self.input = input
        self.sort_keys = sort_keys
        self.fetch = fetch

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "SortExec":
        return SortExec(children[0], self.sort_keys, self.fetch)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        assert partition == 0
        table = collect_partition(self.input, 0, ctx)
        if table.num_rows == 0:
            yield from table.to_batches()
            return
        n = table.num_rows
        key_arrays = []
        names = []
        batch = table.combine_chunks().to_batches()[0]
        for i, (expr, asc, nulls_first) in enumerate(self.sort_keys):
            key_arrays.append(_as_array(expr.evaluate(batch), n))
            names.append(f"__sort_{i}")
        # pyarrow's sort_keys are (name, order) pairs with one GLOBAL
        # null_placement — per-key nulls_first is expressed by leading each
        # nullable key with its validity column (no nulls), so the key's own
        # nulls only ever compare against other nulls and the global
        # placement is irrelevant
        columns: Dict[str, pa.Array] = {}
        sort_opts = []
        for i, ((_, asc, nf), arr) in enumerate(zip(self.sort_keys, key_arrays)):
            if arr.null_count:
                columns[f"__nv_{i}"] = pc.is_null(arr)
                # True (null) first <=> descending on the bool validity key
                sort_opts.append((f"__nv_{i}", "descending" if nf else "ascending"))
            columns[names[i]] = arr
            sort_opts.append((names[i], "ascending" if asc else "descending"))
        key_table = pa.table(columns)
        indices = pc.sort_indices(key_table, sort_keys=sort_opts)
        if self.fetch is not None:
            indices = indices.slice(0, self.fetch)
        sorted_table = table.take(indices)
        yield from batch_table(sorted_table, ctx.batch_size)

    def fmt(self) -> str:
        keys = ", ".join(
            f"{e} {'ASC' if asc else 'DESC'}" for e, asc, _ in self.sort_keys
        )
        return f"SortExec: [{keys}]" + (f" fetch={self.fetch}" if self.fetch else "")


class EmptyExec(ExecutionPlan):
    """Empty relation, optionally one null-filled row (reference EmptyExecNode)."""

    def __init__(self, produce_one_row: bool, schema: pa.Schema) -> None:
        self.produce_one_row = produce_one_row
        self._schema = schema

    def schema(self) -> pa.Schema:
        if self.produce_one_row and len(self._schema) == 0:
            # a zero-column batch cannot carry a row count in Arrow; the
            # one-row case declares (and emits) a placeholder null column so
            # FROM-less SELECTs see num_rows == 1 AND consumers that trust
            # the declared schema (e.g. shuffle writers opening IPC files)
            # match the emitted batches
            return pa.schema([pa.field("__placeholder", pa.null())])
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        if self.produce_one_row:
            schema = self.schema()
            arrays = [pa.nulls(1, type=f.type) for f in schema]
            yield pa.RecordBatch.from_arrays(arrays, schema=schema)

    def fmt(self) -> str:
        return f"EmptyExec: produce_one_row={self.produce_one_row}"
