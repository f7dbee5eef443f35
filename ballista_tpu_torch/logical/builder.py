"""LogicalPlanBuilder + DataFrame verbs.

The relational-verb surface of the reference client DataFrame
(BallistaDataFrame::{select, filter, aggregate, sort, limit, join,
repartition, explain}, reference rust/client/src/context.rs:241-314).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.logical import plan as lp


class LogicalPlanBuilder:
    def __init__(self, plan: lp.LogicalPlan) -> None:
        self.plan = plan

    @classmethod
    def scan(cls, table_name: str, source, projection=None) -> "LogicalPlanBuilder":
        return cls(lp.TableScan(table_name, source, projection))

    @classmethod
    def empty(cls, produce_one_row: bool = False) -> "LogicalPlanBuilder":
        return cls(lp.EmptyRelation(produce_one_row))

    def project(self, exprs: Sequence[lx.Expr]) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Projection(self.plan, list(exprs)))

    def filter(self, predicate: lx.Expr) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Filter(self.plan, predicate))

    def aggregate(
        self, group_exprs: Sequence[lx.Expr], aggr_exprs: Sequence[lx.Expr]
    ) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(
            lp.Aggregate(self.plan, list(group_exprs), list(aggr_exprs))
        )

    def sort(self, sort_exprs: Sequence[lx.SortExpr]) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Sort(self.plan, list(sort_exprs)))

    def limit(self, n: int, skip: int = 0) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Limit(self.plan, n, skip))

    def join(
        self,
        right: "LogicalPlanBuilder",
        on: List[Tuple[lx.Column, lx.Column]],
        join_type: lp.JoinType = lp.JoinType.INNER,
        filter: Optional[lx.Expr] = None,
    ) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(
            lp.Join(self.plan, right.plan, on, join_type, filter)
        )

    def cross_join(self, right: "LogicalPlanBuilder") -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.CrossJoin(self.plan, right.plan))

    def repartition_hash(self, exprs: Sequence[lx.Expr], n: int) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(
            lp.Repartition(self.plan, lp.PartitionScheme.HASH, n, list(exprs))
        )

    def repartition_round_robin(self, n: int) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(
            lp.Repartition(self.plan, lp.PartitionScheme.ROUND_ROBIN, n)
        )

    def alias(self, name: str) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.SubqueryAlias(self.plan, name))

    def distinct(self) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Distinct(self.plan))

    def union(self, others: Sequence["LogicalPlanBuilder"], all: bool = True) -> "LogicalPlanBuilder":
        plans = [self.plan] + [o.plan for o in others]
        u: lp.LogicalPlan = lp.Union(plans, all)
        if not all:
            u = lp.Distinct(u)
        return LogicalPlanBuilder(u)

    def build(self) -> lp.LogicalPlan:
        return self.plan
