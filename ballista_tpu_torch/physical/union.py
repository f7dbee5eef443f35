"""UnionExec: concatenates child partitions (UNION ALL)."""

from __future__ import annotations

from typing import Iterator, List

import pyarrow as pa

from ballista_tpu_torch.physical.plan import ExecutionPlan, Partitioning, TaskContext


class UnionExec(ExecutionPlan):
    def __init__(self, inputs: List[ExecutionPlan]) -> None:
        self.inputs = inputs
        self._schema = inputs[0].schema()

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        total = sum(i.output_partitioning().partition_count() for i in self.inputs)
        return Partitioning.unknown(total)

    def children(self) -> List[ExecutionPlan]:
        return list(self.inputs)

    def with_children(self, children: List[ExecutionPlan]) -> "UnionExec":
        return UnionExec(children)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        offset = partition
        for child in self.inputs:
            n = child.output_partitioning().partition_count()
            if offset < n:
                for batch in child.execute(offset, ctx):
                    # normalize field names across union branches
                    yield pa.RecordBatch.from_arrays(
                        list(batch.columns), schema=self._schema
                    )
                return
            offset -= n
        raise IndexError(f"partition {partition} out of range")

    def fmt(self) -> str:
        return "UnionExec"
