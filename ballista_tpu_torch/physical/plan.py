"""Physical plan base classes.

An ExecutionPlan mirrors the reference's (DataFusion's) trait: a schema, an
output partitioning, children, and ``execute(partition)`` yielding Arrow
record batches (reference rust/core/src/execution_plans/query_stage.rs:59-85
shows the passthrough pattern). ``TaskContext`` carries session config, the
kernel backend (cpu Arrow oracle vs. cuda device lowering) and the device — the executor-selection
boundary from BASELINE's north star.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import pyarrow as pa

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.utils import tracing


class Partitioning:
    """Output partitioning declaration (reference PhysicalHashRepartition /
    output_partitioning())."""

    def __init__(self, scheme: str, n: int, exprs: Optional[list] = None) -> None:
        assert scheme in ("unknown", "round_robin", "hash")
        self.scheme = scheme
        self.n = n
        self.exprs = exprs or []

    @classmethod
    def unknown(cls, n: int) -> "Partitioning":
        return cls("unknown", n)

    @classmethod
    def round_robin(cls, n: int) -> "Partitioning":
        return cls("round_robin", n)

    @classmethod
    def hash(cls, exprs: list, n: int) -> "Partitioning":
        return cls("hash", n, exprs)

    def partition_count(self) -> int:
        return self.n

    def __repr__(self) -> str:
        if self.scheme == "hash":
            return f"Hash([{', '.join(str(e) for e in self.exprs)}], {self.n})"
        return f"{self.scheme}({self.n})"


class TaskContext:
    """Per-task runtime context: config, kernel backend, shuffle fetcher."""

    def __init__(
        self,
        config: Optional[BallistaConfig] = None,
        shuffle_fetcher=None,
        work_dir: Optional[str] = None,
        job_id: str = "",
        attempt: int = 0,
        executor_id: str = "",
        device=None,
        mesh_devices=None,
    ) -> None:
        self.config = config or BallistaConfig()
        # torch.device the "cuda" backend's device stages run on (None:
        # host-only context; a device stage then refuses to run)
        self.device = device
        # the devices a mesh stage (parallel/) spans, repeats allowed, e.g.
        # [cuda] * 4 for four shards on one card; None: every CUDA device
        self.mesh_devices = list(mesh_devices) if mesh_devices else None
        # shuffle_fetcher: callable(PartitionLocation) -> Iterator[RecordBatch];
        # bound by the executor runtime for ShuffleReaderExec.
        self.shuffle_fetcher = shuffle_fetcher
        self.work_dir = work_dir
        self.job_id = job_id
        # which attempt of the task this context serves: part of the chaos
        # injection key so a retried attempt draws a fresh fault verdict
        self.attempt = attempt
        # which executor runs this task: the HBM-resident exchange registry
        # (ops/exchange.py, ISSUE 16) keys entries per executor, so a
        # StandaloneCluster's co-resident executors never see false "local"
        # hits. Empty (the in-process/local-engine default) disables the
        # exchange tier for this context.
        self.executor_id = executor_id

    @property
    def batch_size(self) -> int:
        return self.config.batch_size()

    @property
    def backend(self) -> str:
        return self.config.backend()


class ExecutionPlan:
    """Base physical operator."""

    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> List["ExecutionPlan"]:
        return []

    def with_children(self, children: List["ExecutionPlan"]) -> "ExecutionPlan":
        if children:
            raise PlanError(f"{type(self).__name__} takes no children")
        return self

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        raise NotImplementedError

    # -- display -----------------------------------------------------------
    def fmt(self) -> str:
        return type(self).__name__

    def display_indent(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.fmt()]
        for c in self.children():
            lines.append(c.display_indent(indent + 1))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.display_indent()


def collect_partition(
    plan: ExecutionPlan, partition: int, ctx: TaskContext
) -> pa.Table:
    """Drain one partition into a Table (reference utils.rs collect_stream).
    Timed as the span `op.<class>`: the self time of a drained operator is
    its own host work and that of the generators it pulls through."""
    with tracing.span(f"op.{type(plan).__name__}"):
        batches = list(plan.execute(partition, ctx))
    if not batches:
        return pa.table(
            {f.name: pa.array([], type=f.type) for f in plan.schema()},
            schema=plan.schema(),
        )
    return pa.Table.from_batches(batches, schema=plan.schema())


def collect_all(plan: ExecutionPlan, ctx: TaskContext) -> pa.Table:
    """Drain every partition (reference executor CollectExec select_all,
    rust/executor/src/collect.rs:70-101)."""
    tables = [
        collect_partition(plan, p, ctx)
        for p in range(plan.output_partitioning().partition_count())
    ]
    return pa.concat_tables(tables)


def batch_table(table: pa.Table, batch_size: int) -> Iterator[pa.RecordBatch]:
    """Re-chunk a table into batches of at most batch_size rows."""
    if table.num_rows == 0:
        yield from table.to_batches()
        return
    for b in table.combine_chunks().to_batches(max_chunksize=batch_size):
        yield b
