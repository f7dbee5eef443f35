"""Physical plan <-> protobuf.

Like the reference (rust/core/src/serde/physical_plan/), physical expressions
travel as *logical* expression nodes and are re-compiled against the child's
schema on deserialization (ref from_proto.rs:348-365 uses DataFusion's
planner the same way). uncompile_expr is the inverse: physical -> logical.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from ballista_tpu_torch.datasource import CsvTableSource, MemoryTableSource, ParquetTableSource
from ballista_tpu_torch.distributed.stages import (
    ShuffleLocation,
    ShuffleReaderExec,
    ShuffleWriterExec,
    UnresolvedShuffleExec,
)
from ballista_tpu_torch.errors import SerdeError
from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.logical.plan import JoinType
from ballista_tpu_torch.parallel.spmd_join import SpmdJoinExec
from ballista_tpu_torch.parallel.spmd_stage import SpmdAggregateExec
from ballista_tpu_torch.physical import expr as px
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
from ballista_tpu_torch.physical.expr import create_physical_expr
from ballista_tpu_torch.physical.join import CrossJoinExec, HashJoinExec
from ballista_tpu_torch.physical.plan import ExecutionPlan, Partitioning
from ballista_tpu_torch.physical.repartition import RepartitionExec
from ballista_tpu_torch.physical.scan import CsvScanExec, MemoryScanExec, ParquetScanExec
from ballista_tpu_torch.physical.union import UnionExec
from ballista_tpu_torch.physical.window import WindowExec
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.serde.logical import (
    expr_from_proto,
    expr_to_proto,
    frame_from_proto,
    frame_to_proto,
    scalar_from_proto,
    scalar_to_proto,
    source_from_proto,
    source_to_proto,
)
from ballista_tpu_torch.serde.arrow import dtype_from_ipc, dtype_to_ipc, schema_from_ipc, schema_to_ipc


# ---------------------------------------------------------------------------
# physical expr -> logical expr (for the wire)
# ---------------------------------------------------------------------------


def uncompile_expr(e: px.PhysicalExpr) -> lx.Expr:
    if isinstance(e, px.ColumnExpr):
        if "." in e.name:
            rel, _, bare = e.name.partition(".")
            return lx.Column(bare, rel)
        return lx.Column(e.name)
    if isinstance(e, px.LiteralExpr):
        return lx.Literal(e.value, e.dtype)
    if isinstance(e, px.BinaryPhysicalExpr):
        return lx.BinaryExpr(uncompile_expr(e.left), e.op, uncompile_expr(e.right))
    if isinstance(e, px.NotExpr):
        return lx.Not(uncompile_expr(e.expr))
    if isinstance(e, px.NegativeExpr):
        return lx.Negative(uncompile_expr(e.expr))
    if isinstance(e, px.IsNullExpr):
        inner = uncompile_expr(e.expr)
        return lx.IsNotNull(inner) if e.negated else lx.IsNull(inner)
    if isinstance(e, px.BetweenExpr):
        return lx.Between(
            uncompile_expr(e.expr),
            uncompile_expr(e.low),
            uncompile_expr(e.high),
            e.negated,
        )
    if isinstance(e, px.InListExpr):
        members = (
            [uncompile_expr(v) for v in e.value_exprs]
            if e.value_exprs is not None
            else [lx.Literal(v) for v in e.values]
        )
        return lx.InList(uncompile_expr(e.expr), members, e.negated)
    if isinstance(e, px.CaseExpr):
        return lx.Case(
            None if e.base is None else uncompile_expr(e.base),
            [(uncompile_expr(w), uncompile_expr(t)) for w, t in e.when_then],
            None if e.else_expr is None else uncompile_expr(e.else_expr),
        )
    if isinstance(e, px.CastExpr):
        if e.safe:
            return lx.TryCast(uncompile_expr(e.expr), e.dtype)
        return lx.Cast(uncompile_expr(e.expr), e.dtype)
    if isinstance(e, px.ScalarFunctionExpr):
        return lx.ScalarFunction(e.fn, [uncompile_expr(a) for a in e.args])
    raise SerdeError(f"cannot uncompile {type(e).__name__}")


# ---------------------------------------------------------------------------
# to proto
# ---------------------------------------------------------------------------


def phys_plan_to_proto(plan: ExecutionPlan) -> pb.PhysicalPlanNode:
    n = pb.PhysicalPlanNode()
    if isinstance(plan, (CsvScanExec, ParquetScanExec, MemoryScanExec)):
        n.scan.scan.table_name = ""
        n.scan.scan.source.CopyFrom(source_to_proto(plan.source))
        if plan.projection is not None:
            n.scan.scan.has_projection = True
            n.scan.scan.projection.extend(plan.projection)
        prune = getattr(plan, "prune_predicate", None)
        if prune is not None:
            n.scan.prune_predicate.CopyFrom(expr_to_proto(uncompile_expr(prune)))
    elif isinstance(plan, ProjectionExec):
        n.projection.input.CopyFrom(phys_plan_to_proto(plan.input))
        for e, name in plan.exprs:
            n.projection.exprs.append(expr_to_proto(uncompile_expr(e)))
            n.projection.names.append(name)
    elif isinstance(plan, FilterExec):
        n.filter.input.CopyFrom(phys_plan_to_proto(plan.input))
        n.filter.predicate.CopyFrom(expr_to_proto(uncompile_expr(plan.predicate)))
    elif isinstance(plan, HashAggregateExec):
        n.aggregate.input.CopyFrom(phys_plan_to_proto(plan.input))
        n.aggregate.mode = plan.mode.value
        for e, name in plan.group_exprs:
            n.aggregate.group_exprs.append(expr_to_proto(uncompile_expr(e)))
            n.aggregate.group_names.append(name)
        for a in plan.aggr_funcs:
            fn = a.fn
            distinct = False
            if fn.endswith("_distinct"):
                fn, distinct = fn[: -len("_distinct")], True
            an = pb.AggregateExprNode(fn=fn, distinct=distinct)
            an.expr.CopyFrom(expr_to_proto(uncompile_expr(a.expr)))
            n.aggregate.aggr_funcs.append(an)
            n.aggregate.aggr_names.append(a.name)
            n.aggregate.aggr_dtype_ipc.append(dtype_to_ipc(a.dtype))
            n.aggregate.aggr_input_type_ipc.append(dtype_to_ipc(a.input_type))
        n.aggregate.exact_floats = getattr(plan, "exact_floats", False)
    elif isinstance(plan, HashJoinExec):
        n.join.left.CopyFrom(phys_plan_to_proto(plan.left))
        n.join.right.CopyFrom(phys_plan_to_proto(plan.right))
        for l, r in plan.on:
            n.join.left_keys.append(l)
            n.join.right_keys.append(r)
        n.join.join_type = plan.join_type.value
        n.join.partitioned = plan.partitioned
        if plan.filter is not None:
            n.join.filter.CopyFrom(expr_to_proto(uncompile_expr(plan.filter)))
    elif isinstance(plan, CrossJoinExec):
        n.cross_join.left.CopyFrom(phys_plan_to_proto(plan.left))
        n.cross_join.right.CopyFrom(phys_plan_to_proto(plan.right))
    elif isinstance(plan, SortExec):
        n.sort.input.CopyFrom(phys_plan_to_proto(plan.input))
        for e, asc, nf in plan.sort_keys:
            se = lx.SortExpr(uncompile_expr(e), asc, nf)
            n.sort.sort_exprs.append(expr_to_proto(se))
        if plan.fetch is not None:
            n.sort.has_fetch = True
            n.sort.fetch = plan.fetch
    elif isinstance(plan, GlobalLimitExec):
        n.limit.input.CopyFrom(phys_plan_to_proto(plan.input))
        n.limit.limit = plan.limit
        n.limit.skip = plan.skip
        setattr(n.limit, "global", True)  # `global` is a Python keyword
    elif isinstance(plan, LocalLimitExec):
        n.limit.input.CopyFrom(phys_plan_to_proto(plan.input))
        n.limit.limit = plan.limit
        setattr(n.limit, "global", False)
    elif isinstance(plan, CoalesceBatchesExec):
        n.coalesce_batches.input.CopyFrom(phys_plan_to_proto(plan.input))
        n.coalesce_batches.target_batch_size = plan.target_batch_size
    elif isinstance(plan, MergeExec):
        n.merge.input.CopyFrom(phys_plan_to_proto(plan.input))
    elif isinstance(plan, EmptyExec):
        n.empty.produce_one_row = plan.produce_one_row
        n.empty.schema_ipc = schema_to_ipc(plan.schema())
    elif isinstance(plan, UnionExec):
        for i in plan.inputs:
            n.union.inputs.append(phys_plan_to_proto(i))
    elif isinstance(plan, RepartitionExec):
        n.repartition.input.CopyFrom(phys_plan_to_proto(plan.input))
        n.repartition.scheme = plan.partitioning.scheme
        n.repartition.n = plan.partitioning.partition_count()
        for e in plan.partitioning.exprs:
            n.repartition.hash_exprs.append(expr_to_proto(uncompile_expr(e)))
    elif isinstance(plan, ShuffleWriterExec):
        n.shuffle_writer.input.CopyFrom(phys_plan_to_proto(plan.input))
        n.shuffle_writer.job_id = plan.job_id
        n.shuffle_writer.stage_id = plan.stage_id
        p = plan.shuffle_output_partitioning
        if p is None:
            n.shuffle_writer.scheme = "none"
        else:
            n.shuffle_writer.scheme = p.scheme
            n.shuffle_writer.n = p.partition_count()
            for e in p.exprs:
                n.shuffle_writer.hash_exprs.append(expr_to_proto(uncompile_expr(e)))
    elif isinstance(plan, ShuffleReaderExec):
        for loc in plan.locations:
            pl = n.shuffle_reader.partition_locations.add()
            pl.executor_meta.id = loc.executor_id
            pl.executor_meta.host = loc.host
            pl.executor_meta.port = loc.port
            pl.path = loc.path
            # lineage of the producing map task, so a failed fetch can name
            # exactly what the scheduler must recompute
            pl.partition_id.stage_id = loc.stage_id
            pl.partition_id.partition_id = loc.map_partition
            # disaggregated tier (ISSUE 15): the path-home rides the wire so
            # the executing reader resolves storage-first
            pl.storage_uri = loc.storage_uri
            # HBM-resident exchange hint + piece size (ISSUE 16): the size
            # lets the consumer-side cost model price the transfer the
            # resident hit would skip
            pl.resident = loc.resident
            pl.partition_stats.num_bytes = loc.nbytes
        n.shuffle_reader.schema_ipc = schema_to_ipc(plan.schema())
        n.shuffle_reader.num_partitions = plan.num_partitions
        n.shuffle_reader.identity = plan.identity
    elif isinstance(plan, WindowExec):
        n.window.input.CopyFrom(phys_plan_to_proto(plan.input))
        for f in plan.funcs:
            wf = n.window.funcs.add()
            wf.fn = f.fn
            if f.arg is not None:
                wf.arg.CopyFrom(expr_to_proto(uncompile_expr(f.arg)))
            for p_ in f.partition_by:
                wf.partition_by.append(expr_to_proto(uncompile_expr(p_)))
            for oe, asc in f.order_by:
                wf.order_by.append(
                    expr_to_proto(lx.SortExpr(uncompile_expr(oe), asc, False))
                )
            wf.name = f.name
            wf.dtype_ipc = dtype_to_ipc(f.dtype)
            if f.frame is not None:
                frame_to_proto(wf.frame, f.frame)
    elif isinstance(plan, UnresolvedShuffleExec):
        n.unresolved_shuffle.stage_id = plan.stage_id
        n.unresolved_shuffle.schema_ipc = schema_to_ipc(plan.schema())
        n.unresolved_shuffle.partition_count = plan.partition_count
        n.unresolved_shuffle.identity = plan.identity
    elif isinstance(plan, SpmdAggregateExec):
        n.spmd_aggregate.subplan.CopyFrom(phys_plan_to_proto(plan.subplan))
    elif isinstance(plan, SpmdJoinExec):
        n.spmd_join.subplan.CopyFrom(phys_plan_to_proto(plan.subplan))
    else:
        raise SerdeError(f"cannot serialize physical plan {type(plan).__name__}")
    return n


# ---------------------------------------------------------------------------
# from proto
# ---------------------------------------------------------------------------


def phys_plan_from_proto(n: pb.PhysicalPlanNode) -> ExecutionPlan:
    which = n.WhichOneof("plan_type")
    if which == "scan":
        src = source_from_proto(n.scan.scan.source)
        projection = list(n.scan.scan.projection) if n.scan.scan.has_projection else None
        if isinstance(src, CsvTableSource):
            return CsvScanExec(src, projection)
        if isinstance(src, ParquetTableSource):
            scan = ParquetScanExec(src, projection)
            if n.scan.HasField("prune_predicate"):
                scan.prune_predicate = create_physical_expr(
                    expr_from_proto(n.scan.prune_predicate), scan.schema()
                )
            return scan
        return MemoryScanExec(src, projection)
    if which == "spmd_aggregate":
        return SpmdAggregateExec(phys_plan_from_proto(n.spmd_aggregate.subplan))
    if which == "spmd_join":
        return SpmdJoinExec(phys_plan_from_proto(n.spmd_join.subplan))
    if which == "projection":
        input = phys_plan_from_proto(n.projection.input)
        schema = input.schema()
        exprs = [
            (create_physical_expr(expr_from_proto(e), schema), name)
            for e, name in zip(n.projection.exprs, n.projection.names)
        ]
        return ProjectionExec(input, exprs)
    if which == "filter":
        input = phys_plan_from_proto(n.filter.input)
        return FilterExec(
            input, create_physical_expr(expr_from_proto(n.filter.predicate), input.schema())
        )
    if which == "aggregate":
        input = phys_plan_from_proto(n.aggregate.input)
        mode = AggregateMode(n.aggregate.mode)
        # FINAL consumes partial state positionally: expressions are never
        # re-evaluated, so compile placeholders and use the shipped types
        is_final = mode == AggregateMode.FINAL
        in_schema = input.schema()
        group_exprs = []
        for i, (e, name) in enumerate(
            zip(n.aggregate.group_exprs, n.aggregate.group_names)
        ):
            if is_final:
                group_exprs.append((px.ColumnExpr(name, i), name))
            else:
                group_exprs.append(
                    (create_physical_expr(expr_from_proto(e), in_schema), name)
                )
        funcs = []
        for j, (an, name) in enumerate(
            zip(n.aggregate.aggr_funcs, n.aggregate.aggr_names)
        ):
            dtype = dtype_from_ipc(n.aggregate.aggr_dtype_ipc[j])
            input_type = dtype_from_ipc(n.aggregate.aggr_input_type_ipc[j])
            if is_final:
                pe: px.PhysicalExpr = px.ColumnExpr(name, j)
            else:
                pe = create_physical_expr(expr_from_proto(an.expr), in_schema)
            fn = an.fn if not an.distinct else f"{an.fn}_distinct"
            funcs.append(AggregateFunc(fn, pe, name, dtype, input_type))
        return HashAggregateExec(mode, input, group_exprs, funcs,
                                 exact_floats=n.aggregate.exact_floats)
    if which == "join":
        left = phys_plan_from_proto(n.join.left)
        right = phys_plan_from_proto(n.join.right)
        on = list(zip(n.join.left_keys, n.join.right_keys))
        jt = JoinType(n.join.join_type)
        filt = None
        if n.join.HasField("filter"):
            concat = pa.schema(list(left.schema()) + list(right.schema()))
            filt = create_physical_expr(expr_from_proto(n.join.filter), concat)
        return HashJoinExec(
            left, right, on, jt, filter=filt, partitioned=n.join.partitioned
        )
    if which == "cross_join":
        return CrossJoinExec(
            phys_plan_from_proto(n.cross_join.left),
            phys_plan_from_proto(n.cross_join.right),
        )
    if which == "sort":
        input = phys_plan_from_proto(n.sort.input)
        keys = []
        for se in n.sort.sort_exprs:
            e = expr_from_proto(se)
            assert isinstance(e, lx.SortExpr)
            keys.append(
                (
                    create_physical_expr(e.expr, input.schema()),
                    e.ascending,
                    e.nulls_first,
                )
            )
        fetch = n.sort.fetch if n.sort.has_fetch else None
        return SortExec(input, keys, fetch)
    if which == "limit":
        input = phys_plan_from_proto(n.limit.input)
        if getattr(n.limit, "global"):
            return GlobalLimitExec(input, n.limit.limit, n.limit.skip)
        return LocalLimitExec(input, n.limit.limit)
    if which == "coalesce_batches":
        return CoalesceBatchesExec(
            phys_plan_from_proto(n.coalesce_batches.input),
            n.coalesce_batches.target_batch_size,
        )
    if which == "merge":
        return MergeExec(phys_plan_from_proto(n.merge.input))
    if which == "empty":
        return EmptyExec(n.empty.produce_one_row, schema_from_ipc(n.empty.schema_ipc))
    if which == "union":
        return UnionExec([phys_plan_from_proto(i) for i in n.union.inputs])
    if which == "repartition":
        input = phys_plan_from_proto(n.repartition.input)
        if n.repartition.scheme == "hash":
            exprs = [
                create_physical_expr(expr_from_proto(e), input.schema())
                for e in n.repartition.hash_exprs
            ]
            part = Partitioning.hash(exprs, n.repartition.n)
        elif n.repartition.scheme == "round_robin":
            part = Partitioning.round_robin(n.repartition.n)
        else:
            part = Partitioning.unknown(n.repartition.n)
        return RepartitionExec(input, part)
    if which == "shuffle_writer":
        input = phys_plan_from_proto(n.shuffle_writer.input)
        sw = n.shuffle_writer
        if sw.scheme == "none":
            part = None
        elif sw.scheme == "hash":
            exprs = [
                create_physical_expr(expr_from_proto(e), input.schema())
                for e in sw.hash_exprs
            ]
            part = Partitioning.hash(exprs, sw.n)
        else:
            part = Partitioning.round_robin(sw.n)
        return ShuffleWriterExec(sw.job_id, sw.stage_id, input, part)
    if which == "shuffle_reader":
        locs = [
            ShuffleLocation(
                pl.executor_meta.id,
                pl.executor_meta.host,
                pl.executor_meta.port,
                pl.path,
                stage_id=pl.partition_id.stage_id,
                map_partition=pl.partition_id.partition_id,
                storage_uri=pl.storage_uri,
                resident=pl.resident,
                nbytes=pl.partition_stats.num_bytes,
            )
            for pl in n.shuffle_reader.partition_locations
        ]
        return ShuffleReaderExec(
            locs,
            schema_from_ipc(n.shuffle_reader.schema_ipc),
            n.shuffle_reader.num_partitions,
            identity=n.shuffle_reader.identity,
        )
    if which == "window":
        from ballista_tpu_torch.physical.window import WindowExec, WindowFuncDesc

        input = phys_plan_from_proto(n.window.input)
        schema = input.schema()
        funcs = []
        for wf in n.window.funcs:
            arg = (
                create_physical_expr(expr_from_proto(wf.arg), schema)
                if wf.HasField("arg")
                else None
            )
            order = []
            for oe in wf.order_by:
                se = expr_from_proto(oe)
                order.append((create_physical_expr(se.expr, schema), se.ascending))
            funcs.append(
                WindowFuncDesc(
                    wf.fn,
                    arg,
                    [
                        create_physical_expr(expr_from_proto(pe), schema)
                        for pe in wf.partition_by
                    ],
                    order,
                    wf.name,
                    dtype_from_ipc(wf.dtype_ipc),
                    frame_from_proto(wf.frame) if wf.HasField("frame") else None,
                )
            )
        return WindowExec(input, funcs)
    if which == "unresolved_shuffle":
        return UnresolvedShuffleExec(
            n.unresolved_shuffle.stage_id,
            schema_from_ipc(n.unresolved_shuffle.schema_ipc),
            n.unresolved_shuffle.partition_count,
            identity=n.unresolved_shuffle.identity,
        )
    raise SerdeError(f"empty physical plan node: {n}")
