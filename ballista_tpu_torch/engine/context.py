"""Single-process execution context + DataFrame.

This is the engine's "DataFusion role": table registry, SQL entry point,
logical building, optimization, physical planning, and local execution.
The distributed client (ballista_tpu_torch.client) presents the same surface but
submits plans to a scheduler instead (reference rust/client/src/context.rs).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.datasource import (
    CsvTableSource,
    MemoryTableSource,
    ParquetTableSource,
    TableSource,
)
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.logical import plan as lp
from ballista_tpu_torch.logical.builder import LogicalPlanBuilder
from ballista_tpu_torch.physical.plan import ExecutionPlan, TaskContext, collect_all
from ballista_tpu_torch.physical.planner import PhysicalPlanner
from ballista_tpu_torch.utils import tracing


def resolve_device(device=None):
    """The torch.device device stages run on. None means the GPU: it raises
    when CUDA is missing rather than picking the CPU on its own. Pass
    ``device="cpu"`` explicitly to run the device path on CPU tensors (the
    tests do, where the kernels' plain PyTorch versions stand in)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ExecutionContext: CUDA is not available; pass device='cpu' "
                "to run the device path on CPU tensors"
            )
        return torch.device("cuda")
    return torch.device(device)


class ExecutionContext:
    def __init__(self, config: Optional[BallistaConfig] = None,
                 device=None) -> None:
        self.config = config or BallistaConfig()
        self.device = resolve_device(device)
        self.tables: Dict[str, TableSource] = {}
        if self.config.tpu_prewarm() and self.config.backend() == "cuda":
            # ballista.tpu.prewarm: load every kernel library now, before the
            # first query (a no-op on CPU tensors; on a card a kernel that
            # does not build or load raises here)
            from ballista_tpu_torch.ops import cuda_kernels

            cuda_kernels.prewarm(self.config, self.device)

    # -- registration ------------------------------------------------------
    def register_table(self, name: str, source: TableSource) -> None:
        self.tables[name.lower()] = source

    def register_csv(self, name: str, path: str, schema: Optional[pa.Schema] = None,
                     has_header: bool = True, delimiter: str = ",",
                     file_extension: str = ".csv") -> None:
        self.register_table(
            name,
            CsvTableSource(path, schema=schema, has_header=has_header,
                           delimiter=delimiter, file_extension=file_extension),
        )

    def register_parquet(self, name: str, path: str) -> None:
        self.register_table(name, ParquetTableSource(path))

    def register_record_batches(self, name: str, table: pa.Table,
                                n_partitions: int = 1) -> None:
        self.register_table(name, MemoryTableSource.from_table(table, n_partitions))

    # -- frames ------------------------------------------------------------
    def table(self, name: str) -> "DataFrame":
        src = self.tables.get(name.lower())
        if src is None:
            raise PlanError(f"no table registered as {name!r}")
        return DataFrame(self, LogicalPlanBuilder.scan(name, src))

    def read_csv(self, path: str, **kwargs) -> "DataFrame":
        src = CsvTableSource(path, **kwargs)
        return DataFrame(self, LogicalPlanBuilder.scan(path, src))

    def read_parquet(self, path: str) -> "DataFrame":
        src = ParquetTableSource(path)
        return DataFrame(self, LogicalPlanBuilder.scan(path, src))

    def sql(self, query: str) -> "DataFrame":
        from ballista_tpu_torch.sql.planner import plan_sql

        with tracing.span("sql"):
            plan = plan_sql(query, self)
        if isinstance(plan, lp.CreateExternalTable):
            self._create_external_table(plan)
            return DataFrame(self, LogicalPlanBuilder.empty(False))
        return DataFrame(self, LogicalPlanBuilder(plan))

    def _create_external_table(self, node: lp.CreateExternalTable) -> None:
        ft = node.file_type.lower()
        if ft == "csv":
            self.register_csv(node.name, node.location, schema=node.table_schema,
                              has_header=node.has_header)
        elif ft == "parquet":
            self.register_parquet(node.name, node.location)
        else:
            raise PlanError(f"unsupported external table file type {node.file_type!r}")

    # -- execution ---------------------------------------------------------
    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        from ballista_tpu_torch.optimizer.rules import optimize_plan

        return optimize_plan(plan)

    def create_physical_plan(self, plan: lp.LogicalPlan) -> ExecutionPlan:
        planner = PhysicalPlanner(
            batch_size=self.config.batch_size(),
            coalesce_aggregates=self.config.tpu_coalesce_aggregates(),
            coalesce_max_bytes=self.config.tpu_coalesce_max_bytes(),
            spmd_joins=self.config.tpu_spmd(),
        )
        return planner.create_physical_plan(self.optimize(plan))

    def collect(self, plan: lp.LogicalPlan) -> pa.Table:
        # one query id for the query's spans (a nested collect keeps its
        # caller's), and no root span: `plan` stays the path `plan`
        with tracing.query_scope():
            with tracing.span("plan"):
                physical = self.create_physical_plan(plan)
            ctx = TaskContext(config=self.config, device=self.device)
            with tracing.span("execute"):
                return collect_all(physical, ctx)


class DataFrame:
    """Relational-verb DataFrame over a logical plan (reference
    BallistaDataFrame, rust/client/src/context.rs:149-315)."""

    def __init__(self, ctx: ExecutionContext, builder: LogicalPlanBuilder) -> None:
        self._ctx = ctx
        self._builder = builder

    # verbs ---------------------------------------------------------------
    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*[lx.col(n) for n in names])

    def select(self, *exprs: lx.Expr) -> "DataFrame":
        return DataFrame(self._ctx, self._builder.project(list(exprs)))

    def filter(self, predicate: lx.Expr) -> "DataFrame":
        return DataFrame(self._ctx, self._builder.filter(predicate))

    def aggregate(self, group_by: Sequence[lx.Expr], aggs: Sequence[lx.Expr]) -> "DataFrame":
        return DataFrame(self._ctx, self._builder.aggregate(group_by, aggs))

    def sort(self, *exprs: lx.SortExpr) -> "DataFrame":
        return DataFrame(self._ctx, self._builder.sort(list(exprs)))

    def limit(self, n: int, skip: int = 0) -> "DataFrame":
        return DataFrame(self._ctx, self._builder.limit(n, skip))

    def join(self, right: "DataFrame", left_cols: Sequence[str],
             right_cols: Sequence[str], how: str = "inner") -> "DataFrame":
        on = [
            (lx.col(l), lx.col(r)) for l, r in zip(left_cols, right_cols)
        ]
        jt = lp.JoinType(how)
        return DataFrame(self._ctx, self._builder.join(right._builder, on, jt))

    def repartition(self, n: int, *hash_exprs: lx.Expr) -> "DataFrame":
        if hash_exprs:
            return DataFrame(self._ctx, self._builder.repartition_hash(list(hash_exprs), n))
        return DataFrame(self._ctx, self._builder.repartition_round_robin(n))

    def distinct(self) -> "DataFrame":
        return DataFrame(self._ctx, self._builder.distinct())

    def alias(self, name: str) -> "DataFrame":
        return DataFrame(self._ctx, self._builder.alias(name))

    def union(self, *others: "DataFrame", all: bool = True) -> "DataFrame":
        return DataFrame(
            self._ctx, self._builder.union([o._builder for o in others], all=all)
        )

    # terminal ------------------------------------------------------------
    def logical_plan(self) -> lp.LogicalPlan:
        return self._builder.build()

    def schema(self) -> pa.Schema:
        return self.logical_plan().schema()

    def explain(self) -> str:
        logical = self.logical_plan()
        optimized = self._ctx.optimize(logical)
        physical = self._ctx.create_physical_plan(logical)
        return (
            "== Logical Plan ==\n" + str(logical)
            + "\n== Optimized Logical Plan ==\n" + str(optimized)
            + "\n== Physical Plan ==\n" + str(physical)
        )

    def collect(self) -> pa.Table:
        return self._ctx.collect(self.logical_plan())

    def to_pandas(self):
        return self.collect().to_pandas()
