"""Physical planner: logical plan -> execution plan.

Plays the role DataFusion's DefaultPhysicalPlanner plays for the reference
(invoked at rust/scheduler/src/lib.rs:325-331). Key structural choices match
the reference engine's:

- aggregates plan as Partial (per partition) -> Merge -> Final, the shape the
  distributed planner later cuts into stages (rust/scheduler/src/planner.rs:149-171)
- sorts and global limits merge partitions first (MergeExec)
- hash joins collect-left build; LEFT/FULL joins merge the probe side
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import pyarrow as pa

from ballista_tpu_torch.datasource import (
    CsvTableSource,
    MemoryTableSource,
    ParquetTableSource,
)
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.logical import plan as lp
from ballista_tpu_torch.physical.aggregate import AggregateFunc, AggregateMode, HashAggregateExec
from ballista_tpu_torch.physical.basic import (
    CoalesceBatchesExec,
    EmptyExec,
    FilterExec,
    GlobalLimitExec,
    LocalLimitExec,
    MergeExec,
    ProjectionExec,
    SortExec,
)
from ballista_tpu_torch.physical.expr import ColumnExpr, LiteralExpr, create_physical_expr
from ballista_tpu_torch.physical.join import CrossJoinExec, HashJoinExec
from ballista_tpu_torch.physical.plan import ExecutionPlan, Partitioning
from ballista_tpu_torch.physical.repartition import RepartitionExec
from ballista_tpu_torch.physical.scan import CsvScanExec, MemoryScanExec, ParquetScanExec
from ballista_tpu_torch.physical.union import UnionExec


class PhysicalPlanner:
    def __init__(
        self,
        batch_size: int = 32768,
        coalesce_aggregates: bool = False,
        coalesce_max_bytes: int = 24 << 30,
        spmd_joins: bool = False,
    ) -> None:
        self.batch_size = batch_size
        # single-chip device execution: plan aggregations SINGLE over merged
        # input so the device stage runs once with the top-k pushdown
        # applicable, instead of a per-partition Partial each paying a d2h
        # readback of its full partial state (config.BALLISTA_TPU_COALESCE_AGG)
        self.coalesce_aggregates = coalesce_aggregates
        self.coalesce_max_bytes = coalesce_max_bytes
        # SPMD stage fusion on (config.BALLISTA_TPU_SPMD): co-partition
        # INNER joins too, so the DistributedPlanner can collapse the
        # exchange pair into one SpmdJoinExec mesh program — broadcast
        # joins carry no exchange to eliminate and stay per-partition
        self.spmd_joins = spmd_joins

    @staticmethod
    def _leaf_scan_bytes(node: ExecutionPlan) -> int:
        """On-disk bytes of the file-backed leaf scans under a subtree
        (compressed parquet under-counts the decoded size, so the coalesce
        cap should stay well below physical memory limits)."""
        import os

        if isinstance(node, (ParquetScanExec, CsvScanExec)):
            try:
                return sum(
                    os.path.getsize(f) for f in node.source.files
                    if os.path.exists(f)
                )
            except OSError:
                return 0
        if isinstance(node, MemoryScanExec):
            return sum(
                b.nbytes for part in node.source.partitions for b in part
            )
        return sum(PhysicalPlanner._leaf_scan_bytes(c) for c in node.children())

    def create_physical_plan(self, plan: lp.LogicalPlan) -> ExecutionPlan:
        p = self._plan(plan)
        # schema parity check: physical output must match logical
        lnames = plan.schema().names
        pnames = p.schema().names
        if lnames != pnames:
            raise PlanError(
                f"physical schema {pnames} != logical schema {lnames}\n{plan}\n{p}"
            )
        self._annotate_topk(p)
        return p

    @staticmethod
    def _annotate_topk(root: ExecutionPlan) -> None:
        """Mark Limit(Sort(Projection?(Aggregate))) chains on the aggregate:
        the device aggregate stages (ops/factagg.py candidate pool,
        ops/stage.py fused lexicographic top-k epilogue) use the annotation
        to read back only ~k rows instead of every group. Host execution
        ignores it: the aggregate still emits every group unless a device
        stage honors the hint, and the Sort/Limit above always re-applies
        the full ordering, so the annotation can only ever shrink the set of
        rows the aggregate returns — never reorder or widen it.

        The annotation resolves the LONGEST PREFIX of sort keys that are
        aggregate outputs into ``keys`` (ops/stage.py lowers each to
        order-preserving int lanes and sorts lexicographically).
        ``covered`` is True when that prefix is the whole ORDER BY — the
        device selection is then exactly the host selection; otherwise the
        consumer must detect boundary ties on the fused lanes and fall back
        (un-fused trailing tie-breakers could admit a different row).
        ``agg_index``/``descending``/``strict`` mirror the first key for
        the single-score consumers (factagg's block-max candidate pool)."""
        from ballista_tpu_torch.physical import expr as px
        from ballista_tpu_torch.physical.aggregate import AggregateMode, HashAggregateExec
        from ballista_tpu_torch.physical.basic import GlobalLimitExec, ProjectionExec, SortExec

        def walk(node: ExecutionPlan) -> None:
            for c in node.children():
                walk(c)
            if not isinstance(node, GlobalLimitExec) or not node.limit:
                return
            s = node.children()[0]
            if not isinstance(s, SortExec) or not s.sort_keys:
                return
            p = s.input
            proj = None
            if isinstance(p, ProjectionExec):
                proj, p = p, p.input
            if not isinstance(p, HashAggregateExec) or p.mode != AggregateMode.SINGLE:
                return
            ngroup = len(p.group_exprs)
            keys = []
            for expr, asc, _nulls in s.sort_keys:
                if not isinstance(expr, px.ColumnExpr):
                    break
                idx = expr.index
                if proj is not None:
                    e = proj.exprs[idx][0]
                    if not isinstance(e, px.ColumnExpr):
                        break
                    idx = e.index
                if idx < ngroup:
                    break  # a group key, not an aggregate value
                keys.append({"agg_index": idx - ngroup, "descending": not asc})
            if not keys:
                return
            p._topk_pushdown = {
                "agg_index": keys[0]["agg_index"],
                "descending": keys[0]["descending"],
                "k": int(node.limit) + int(getattr(node, "skip", 0) or 0),
                "keys": keys,
                "covered": len(keys) == len(s.sort_keys),
                # sort keys beyond the first make tie order deterministic;
                # single-score consumers must detect boundary ties then
                "strict": len(s.sort_keys) > 1,
            }

        walk(root)

    # ------------------------------------------------------------------
    def _plan(self, plan: lp.LogicalPlan) -> ExecutionPlan:
        if isinstance(plan, lp.TableScan):
            return self._plan_scan(plan)
        if isinstance(plan, lp.Projection):
            input = self._plan(plan.input)
            in_schema = input.schema()
            exprs = [
                (create_physical_expr(e, in_schema), e.output_name())
                for e in plan.exprs
            ]
            return ProjectionExec(input, exprs)
        if isinstance(plan, lp.Filter):
            input = self._plan(plan.input)
            pred = create_physical_expr(plan.predicate, input.schema())
            # hint the scan so provably-empty parquet row groups are
            # skipped (statistics pruning; the filter itself still runs)
            target = input
            if isinstance(target, ProjectionExec) and all(
                isinstance(e, ColumnExpr) for e, _ in target.exprs
            ):
                target = target.input
            if isinstance(target, ParquetScanExec) and target.prune_predicate is None:
                from ballista_tpu_torch.ops.stage import substitute_columns

                try:
                    if target is input:
                        target.prune_predicate = pred
                    else:
                        # rebase through the rename-only projection
                        mapping = [e for e, _ in input.exprs]
                        target.prune_predicate = substitute_columns(pred, mapping)
                except Exception:
                    pass  # pruning is best-effort; the filter is authoritative
            return FilterExec(input, pred)
        if isinstance(plan, lp.Aggregate):
            return self._plan_aggregate(plan)
        if isinstance(plan, lp.Distinct):
            # DISTINCT = group by all columns with no aggregates; alias each
            # key to its full (possibly qualified) field name so the output
            # schema matches the logical Distinct exactly
            group_exprs = []
            for f in plan.input.schema():
                bare = f.name.split(".")[-1]
                rel = f.name.split(".")[0] if "." in f.name else None
                group_exprs.append(lx.Alias(lx.Column(bare, rel), f.name))
            agg = lp.Aggregate(plan.input, group_exprs, [])
            return self._plan_aggregate(agg)
        if isinstance(plan, lp.Sort):
            input = self._plan(plan.input)
            if input.output_partitioning().partition_count() > 1:
                input = MergeExec(input)
            keys = [
                (
                    create_physical_expr(se.expr, input.schema()),
                    se.ascending,
                    se.nulls_first,
                )
                for se in plan.sort_exprs
            ]
            return SortExec(input, keys)
        if isinstance(plan, lp.Limit):
            input = self._plan(plan.input)
            if input.output_partitioning().partition_count() > 1:
                input = MergeExec(LocalLimitExec(input, plan.skip + plan.n))
            return GlobalLimitExec(input, plan.n, plan.skip)
        if isinstance(plan, lp.Join):
            return self._plan_join(plan)
        if isinstance(plan, lp.CrossJoin):
            return CrossJoinExec(self._plan(plan.left), self._plan(plan.right))
        if isinstance(plan, lp.Repartition):
            input = self._plan(plan.input)
            if plan.scheme == lp.PartitionScheme.HASH:
                exprs = [create_physical_expr(e, input.schema()) for e in plan.hash_exprs]
                return RepartitionExec(input, Partitioning.hash(exprs, plan.n))
            return RepartitionExec(input, Partitioning.round_robin(plan.n))
        if isinstance(plan, lp.EmptyRelation):
            return EmptyExec(plan.produce_one_row, plan.schema())
        if isinstance(plan, lp.SubqueryAlias):
            input = self._plan(plan.input)
            # zero-copy rename projection to the qualified names
            exprs = [
                (ColumnExpr(f.name, i), plan.schema().field(i).name)
                for i, f in enumerate(input.schema())
            ]
            return ProjectionExec(input, exprs)
        if isinstance(plan, lp.Union):
            return UnionExec([self._plan(c) for c in plan.inputs])
        if isinstance(plan, lp.Window):
            return self._plan_window(plan)
        raise PlanError(f"no physical plan for {type(plan).__name__}")

    def _plan_window(self, plan: lp.LogicalPlan) -> ExecutionPlan:
        from ballista_tpu_torch.physical.window import WindowExec, WindowFuncDesc

        input = self._plan(plan.input)
        if input.output_partitioning().partition_count() > 1:
            input = MergeExec(input)
        in_schema = input.schema()
        funcs = []
        for e in plan.window_exprs:
            w = e.expr if isinstance(e, lx.Alias) else e
            if not isinstance(w, lx.WindowExpr):
                raise PlanError(f"window list entry is not a window expr: {e}")
            arg = (
                create_physical_expr(w.arg, in_schema) if w.arg is not None else None
            )
            funcs.append(
                WindowFuncDesc(
                    w.fn,
                    arg,
                    [create_physical_expr(p, in_schema) for p in w.partition_by],
                    [
                        (create_physical_expr(o.expr, in_schema), o.ascending)
                        for o in w.order_by
                    ],
                    e.output_name(),
                    e.data_type(in_schema),
                    w.frame,
                )
            )
        return WindowExec(input, funcs)

    # ------------------------------------------------------------------
    def _plan_scan(self, plan: lp.TableScan) -> ExecutionPlan:
        src = plan.source
        if isinstance(src, CsvTableSource):
            return CsvScanExec(src, plan.projection)
        if isinstance(src, ParquetTableSource):
            return ParquetScanExec(src, plan.projection)
        if isinstance(src, MemoryTableSource):
            return MemoryScanExec(src, plan.projection)
        raise PlanError(f"unknown table source {type(src).__name__}")

    # ------------------------------------------------------------------
    def _plan_aggregate(self, plan: lp.Aggregate) -> ExecutionPlan:
        input = self._plan(plan.input)
        exact_floats = getattr(plan, "exact_floats", False)
        in_schema = input.schema()
        group_exprs = [
            (create_physical_expr(e, in_schema), e.output_name())
            for e in plan.group_exprs
        ]
        funcs: List[AggregateFunc] = []
        any_distinct = False
        for e in plan.aggr_exprs:
            agg = e
            if isinstance(agg, lx.Alias):
                agg = agg.expr
            if not isinstance(agg, lx.AggregateExpr):
                raise PlanError(f"aggregate list entry is not an aggregate: {e}")
            if agg.distinct:
                if agg.fn != "count":
                    raise PlanError(
                        f"DISTINCT is only supported for COUNT, not {agg.fn.upper()}"
                    )
                any_distinct = True
            if isinstance(agg.expr, lx.Wildcard):
                pexpr = LiteralExpr(1, pa.int64())
                input_type = pa.int64()
            else:
                pexpr = create_physical_expr(agg.expr, in_schema)
                input_type = agg.expr.data_type(in_schema)
            fn = agg.fn if not agg.distinct else f"{agg.fn}_distinct"
            funcs.append(
                AggregateFunc(fn, pexpr, e.output_name(), e.data_type(in_schema), input_type)
            )

        single_partition = input.output_partitioning().partition_count() == 1
        coalesce = self.coalesce_aggregates and (
            self._leaf_scan_bytes(input) <= self.coalesce_max_bytes
        )
        if any_distinct or single_partition or coalesce:
            # DISTINCT aggregates need global visibility; single-partition
            # inputs skip the pointless partial/final split; coalesced mode
            # (single-chip TPU) trades the split for one device dispatch.
            # Coalescing is size-guarded: one driven partition materializes
            # the whole input chain, so past the byte cap the Partial/Final
            # split stays (streams file-by-file within the HBM budget —
            # how SF=100 fits a 16GB chip).
            merged = input if single_partition else MergeExec(input)
            return HashAggregateExec(AggregateMode.SINGLE, merged, group_exprs,
                                     funcs, exact_floats=exact_floats)

        partial = HashAggregateExec(AggregateMode.PARTIAL, input, group_exprs,
                                    funcs, exact_floats=exact_floats)
        if group_exprs:
            # parallel final: hash-exchange partial states on the group keys,
            # then finalize per partition (keys are disjoint across
            # partitions). The reference merges to one partition instead
            # (rust/scheduler/src/planner.rs:149-171 + MergeExec).
            n = partial.output_partitioning().partition_count()
            key_cols = [
                ColumnExpr(name, i) for i, (_, name) in enumerate(group_exprs)
            ]
            exchange = RepartitionExec(partial, Partitioning.hash(key_cols, n))
            return HashAggregateExec(AggregateMode.FINAL, exchange, group_exprs, funcs)
        merged = MergeExec(partial)
        return HashAggregateExec(AggregateMode.FINAL, merged, group_exprs, funcs)

    # ------------------------------------------------------------------
    def _plan_join(self, plan: lp.Join) -> ExecutionPlan:
        left = self._plan(plan.left)
        right = self._plan(plan.right)
        on: List[Tuple[str, str]] = []
        for lcol, rcol in plan.on:
            on.append(
                (
                    left.schema().field(lcol.index_in(left.schema())).name,
                    right.schema().field(rcol.index_in(right.schema())).name,
                )
            )
        partitioned = False
        copartition = plan.join_type in (lp.JoinType.LEFT, lp.JoinType.FULL)
        if (
            self.spmd_joins
            and plan.join_type == lp.JoinType.INNER
            and plan.filter is None
        ):
            # SPMD: give inner joins the same co-partitioned shape so the
            # distributed planner can fuse the exchange into a mesh program
            copartition = True
        if copartition:
            nl = left.output_partitioning().partition_count()
            nr = right.output_partitioning().partition_count()
            if nr > 1 or nl > 1:
                # co-partition BOTH sides on the join keys so every key
                # lands in one partition and each pair joins independently
                # — outer rows stay correct with no single-partition merge
                # (the old MergeExec scalability wall). A side already
                # hash-partitioned on exactly its join keys keeps its
                # existing exchange (no redundant shuffle).
                def hashed_on(side, names):
                    part = side.output_partitioning()
                    return (
                        part.scheme == "hash"
                        and len(part.exprs) == len(names)
                        and all(
                            isinstance(e, ColumnExpr) and e.name == k
                            for e, k in zip(part.exprs, names)
                        )
                    )

                lnames = [l for l, _ in on]
                rnames = [r for _, r in on]
                l_ok = hashed_on(left, lnames)
                r_ok = hashed_on(right, rnames)
                if l_ok and (not r_ok or nl >= nr):
                    n = nl
                elif r_ok:
                    n = nr
                else:
                    n = max(nl, nr)
                if not (l_ok and nl == n):
                    lexprs = [
                        ColumnExpr(lname, left.schema().names.index(lname))
                        for lname in lnames
                    ]
                    left = RepartitionExec(left, Partitioning.hash(lexprs, n))
                if not (r_ok and nr == n):
                    rexprs = [
                        ColumnExpr(rname, right.schema().names.index(rname))
                        for rname in rnames
                    ]
                    right = RepartitionExec(right, Partitioning.hash(rexprs, n))
                partitioned = True
        if plan.join_type in (lp.JoinType.SEMI, lp.JoinType.ANTI):
            # residual predicates evaluate over concat(left, right) during
            # the join itself (the right side is absent from the output)
            pfilter = None
            if plan.filter is not None:
                concat_schema = pa.schema(
                    list(left.schema()) + list(right.schema())
                )
                pfilter = create_physical_expr(plan.filter, concat_schema)
            return HashJoinExec(left, right, on, plan.join_type, filter=pfilter)
        join: ExecutionPlan = HashJoinExec(
            left, right, on, plan.join_type, partitioned=partitioned
        )
        if plan.filter is not None:
            join = FilterExec(join, create_physical_expr(plan.filter, join.schema()))
        return join
