"""Distributed planner: split a physical plan into a DAG of query stages.

Generalizes the reference's rule set (rust/scheduler/src/planner.rs:114-198:
split at MergeExec / final HashAggregate / partition-count change) to one
rule: every exchange operator (RepartitionExec, MergeExec) becomes a stage
boundary — the child pipeline ends in a ShuffleWriterExec, the parent reads
it through UnresolvedShuffleExec until the scheduler substitutes concrete
locations (ref remove_unresolved_shuffles, planner.rs:236-269).

Parallel final aggregation arrives via the physical planner emitting
Partial -> Repartition(hash keys) -> Final, so here the exchange rule covers
the reference's aggregate rule too.
"""

from __future__ import annotations

from typing import Dict, List

from ballista_tpu_torch.distributed.stages import (
    ShuffleLocation,
    ShuffleReaderExec,
    ShuffleWriterExec,
    UnresolvedShuffleExec,
)
from ballista_tpu_torch.physical.basic import MergeExec
from ballista_tpu_torch.physical.plan import ExecutionPlan
from ballista_tpu_torch.physical.repartition import RepartitionExec


class DistributedPlanner:
    def __init__(self, config=None) -> None:
        self._next_stage_id = 0
        self._config = config

    def _new_stage_id(self) -> int:
        self._next_stage_id += 1
        return self._next_stage_id

    def plan_query_stages(
        self, job_id: str, plan: ExecutionPlan
    ) -> List[ShuffleWriterExec]:
        """Returns stages in dependency order; the last is the job's root
        (its shuffle output is the query result, one piece per partition)."""
        if self._config is not None and self._config.tpu_spmd():
            plan = self._fuse_spmd_aggregates(plan)
        stages: List[ShuffleWriterExec] = []
        root = self._visit(plan, job_id, stages)
        final = ShuffleWriterExec(job_id, self._new_stage_id(), root, None)
        stages.append(final)
        return stages

    def _fuse_spmd_aggregates(self, node: ExecutionPlan) -> ExecutionPlan:
        """Config-gated mesh restructuring (ballista.tpu.spmd_stages):

        - a HashAggregate(Final) <- Repartition(hash) <- HashAggregate(
          Partial) subtree, which the exchange rule below would split into
          two stages plus a materialized shuffle, becomes ONE
          SpmdAggregateExec stage whose exchange is a psum over the mesh;
        - a co-partitionable HashJoin (INNER/LEFT, no residual filter)
          becomes ONE SpmdJoinExec stage whose hash exchange is an
          all_to_all over the mesh instead of two materialized shuffles.

        Both keep the untouched subtree inside for serde and the host path."""
        from ballista_tpu_torch.logical.plan import JoinType
        from ballista_tpu_torch.parallel.spmd_join import SpmdJoinExec
        from ballista_tpu_torch.parallel.spmd_stage import SpmdAggregateExec
        from ballista_tpu_torch.physical.aggregate import AggregateMode, HashAggregateExec
        from ballista_tpu_torch.physical.join import HashJoinExec

        children = [self._fuse_spmd_aggregates(c) for c in node.children()]
        if children:
            node = node.with_children(children)
        if (
            isinstance(node, HashAggregateExec)
            and node.mode == AggregateMode.FINAL
            and isinstance(node.input, RepartitionExec)
            and isinstance(node.input.input, HashAggregateExec)
            and node.input.input.mode == AggregateMode.PARTIAL
        ):
            return SpmdAggregateExec(node)
        if (
            isinstance(node, HashJoinExec)
            and node.partitioned  # only fuse when there IS an exchange pair
            and node.join_type in (JoinType.INNER, JoinType.LEFT)
            and node.filter is None
        ):
            return SpmdJoinExec(node)
        return node

    def _visit(
        self, node: ExecutionPlan, job_id: str, stages: List[ShuffleWriterExec]
    ) -> ExecutionPlan:
        children = [self._visit(c, job_id, stages) for c in node.children()]
        if isinstance(node, RepartitionExec):
            child = children[0]
            stage = ShuffleWriterExec(
                job_id, self._new_stage_id(), child, node.partitioning
            )
            stages.append(stage)
            return UnresolvedShuffleExec(
                stage.stage_id, node.schema(), node.partitioning.partition_count()
            )
        if isinstance(node, MergeExec):
            child = children[0]
            stage = ShuffleWriterExec(job_id, self._new_stage_id(), child, None)
            stages.append(stage)
            reader = UnresolvedShuffleExec(
                stage.stage_id,
                node.schema(),
                child.output_partitioning().partition_count(),
                identity=True,
            )
            return MergeExec(reader)
        if children:
            return node.with_children(children)
        return node


def find_unresolved_shuffles(plan: ExecutionPlan) -> List[UnresolvedShuffleExec]:
    out: List[UnresolvedShuffleExec] = []
    if isinstance(plan, UnresolvedShuffleExec):
        out.append(plan)
    for c in plan.children():
        out.extend(find_unresolved_shuffles(c))
    return out


def remove_unresolved_shuffles(
    plan: ExecutionPlan, locations_by_stage: Dict[int, List[ShuffleLocation]]
) -> ExecutionPlan:
    """Substitute concrete ShuffleReaderExec for each placeholder
    (ref planner.rs:236-269)."""
    if isinstance(plan, UnresolvedShuffleExec):
        locs = locations_by_stage.get(plan.stage_id)
        if locs is None:
            raise KeyError(f"no locations for stage {plan.stage_id}")
        return ShuffleReaderExec(
            locs, plan.schema(), plan.partition_count, identity=plan.identity
        )
    children = [
        remove_unresolved_shuffles(c, locations_by_stage) for c in plan.children()
    ]
    if children:
        return plan.with_children(children)
    return plan
