"""Logical plan / expression <-> protobuf.

The bidirectional converter pair the reference keeps in
rust/core/src/serde/logical_plan/{to,from}_proto.rs; roundtrip tests mirror
its largest test asset (serde/logical_plan/mod.rs:36-920).
"""

from __future__ import annotations

import datetime
from typing import Any, List

import pyarrow as pa

from ballista_tpu_torch.datasource import (
    CsvTableSource,
    MemoryTableSource,
    ParquetTableSource,
    TableSource,
)
from ballista_tpu_torch.errors import SerdeError
from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.logical import plan as lp
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.serde.arrow import (
    batches_from_ipc,
    batches_to_ipc,
    dtype_from_ipc,
    dtype_to_ipc,
    schema_from_ipc,
    schema_to_ipc,
)

# ---------------------------------------------------------------------------
# scalar values
# ---------------------------------------------------------------------------


def scalar_to_proto(value: Any, dtype: pa.DataType) -> pb.ScalarValue:
    out = pb.ScalarValue(type_ipc=dtype_to_ipc(dtype))
    if value is None:
        out.null_value = True
    elif isinstance(value, bool):
        out.bool_value = value
    elif isinstance(value, int):
        out.int64_value = value
    elif isinstance(value, float):
        out.float64_value = value
    elif isinstance(value, str):
        out.utf8_value = value
    elif isinstance(value, bytes):
        out.binary_value = value
    elif isinstance(value, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1)
        out.ts_micros_value = int((value - epoch).total_seconds() * 1_000_000)
    elif isinstance(value, datetime.date):
        out.date32_value = (value - datetime.date(1970, 1, 1)).days
    else:
        raise SerdeError(f"unsupported scalar {value!r}")
    return out


def scalar_from_proto(s: pb.ScalarValue):
    dtype = dtype_from_ipc(s.type_ipc)
    which = s.WhichOneof("value")
    if which == "null_value":
        return None, dtype
    if which == "bool_value":
        return s.bool_value, dtype
    if which == "int64_value":
        return s.int64_value, dtype
    if which == "float64_value":
        return s.float64_value, dtype
    if which == "utf8_value":
        return s.utf8_value, dtype
    if which == "binary_value":
        return s.binary_value, dtype
    if which == "date32_value":
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=s.date32_value), dtype
    if which == "ts_micros_value":
        return (
            datetime.datetime(1970, 1, 1)
            + datetime.timedelta(microseconds=s.ts_micros_value)
        ), dtype
    raise SerdeError(f"empty scalar value {s}")


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


def frame_to_proto(msg: "pb.WindowFrameNode", frame) -> None:
    """One encode/decode pair for WindowFrameNode, shared by the logical and
    physical serde (the frame tuple semantics live in lx.WindowExpr)."""
    mode, start, end = frame
    msg.SetInParent()
    msg.range_mode = mode == "range"
    if start is None:
        msg.start_unbounded = True
    else:
        msg.start_value = start
    if end is None:
        msg.end_unbounded = True
    else:
        msg.end_value = end


def frame_from_proto(msg: "pb.WindowFrameNode"):
    mode = "range" if msg.range_mode else "rows"

    def bound(unbounded: bool, v: float):
        if unbounded:
            return None
        # ROWS offsets are row counts: restore int (exact in double)
        return v if mode == "range" else int(v)

    return (
        mode,
        bound(msg.start_unbounded, msg.start_value),
        bound(msg.end_unbounded, msg.end_value),
    )


def expr_to_proto(e: lx.Expr) -> pb.LogicalExprNode:
    n = pb.LogicalExprNode()
    if isinstance(e, lx.Column):
        n.column.name = e.name
        if e.relation:
            n.column.relation = e.relation
    elif isinstance(e, lx.Literal):
        n.literal.CopyFrom(scalar_to_proto(e.value, e.dtype))
    elif isinstance(e, lx.Alias):
        n.alias.expr.CopyFrom(expr_to_proto(e.expr))
        n.alias.name = e.name
    elif isinstance(e, lx.BinaryExpr):
        n.binary_expr.l.CopyFrom(expr_to_proto(e.left))
        n.binary_expr.op = e.op
        n.binary_expr.r.CopyFrom(expr_to_proto(e.right))
    elif isinstance(e, lx.Not):
        n.not_expr.expr.CopyFrom(expr_to_proto(e.expr))
    elif isinstance(e, lx.Negative):
        n.negative.expr.CopyFrom(expr_to_proto(e.expr))
    elif isinstance(e, lx.IsNull):
        n.is_null.expr.CopyFrom(expr_to_proto(e.expr))
        n.is_null.negated = False
    elif isinstance(e, lx.IsNotNull):
        n.is_null.expr.CopyFrom(expr_to_proto(e.expr))
        n.is_null.negated = True
    elif isinstance(e, lx.Between):
        n.between.expr.CopyFrom(expr_to_proto(e.expr))
        n.between.low.CopyFrom(expr_to_proto(e.low))
        n.between.high.CopyFrom(expr_to_proto(e.high))
        n.between.negated = e.negated
    elif isinstance(e, lx.InList):
        n.in_list.expr.CopyFrom(expr_to_proto(e.expr))
        for v in e.values:
            n.in_list.values.append(expr_to_proto(v))
        n.in_list.negated = e.negated
    elif isinstance(e, lx.Like):
        n.like.expr.CopyFrom(expr_to_proto(e.expr))
        n.like.pattern.CopyFrom(expr_to_proto(e.pattern))
        n.like.negated = e.negated
        if e.escape:
            n.like.escape = e.escape
    elif isinstance(e, lx.Case):
        if e.expr is not None:
            n.case_expr.base.CopyFrom(expr_to_proto(e.expr))
        for w, t in e.when_then:
            wt = n.case_expr.when_then.add()
            wt.when.CopyFrom(expr_to_proto(w))
            wt.then.CopyFrom(expr_to_proto(t))
        if e.else_expr is not None:
            n.case_expr.else_expr.CopyFrom(expr_to_proto(e.else_expr))
    elif isinstance(e, lx.TryCast):
        n.try_cast.expr.CopyFrom(expr_to_proto(e.expr))
        n.try_cast.dtype_ipc = dtype_to_ipc(e.dtype)
        n.try_cast.safe = True
    elif isinstance(e, lx.Cast):
        n.cast.expr.CopyFrom(expr_to_proto(e.expr))
        n.cast.dtype_ipc = dtype_to_ipc(e.dtype)
    elif isinstance(e, lx.ScalarFunction):
        n.scalar_function.fn = e.fn
        for a in e.args:
            n.scalar_function.args.append(expr_to_proto(a))
    elif isinstance(e, lx.AggregateExpr):
        n.aggregate_expr.fn = e.fn
        n.aggregate_expr.expr.CopyFrom(expr_to_proto(e.expr))
        n.aggregate_expr.distinct = e.distinct
    elif isinstance(e, lx.WindowExpr):
        n.window_expr.fn = e.fn
        if e.arg is not None:
            n.window_expr.arg.CopyFrom(expr_to_proto(e.arg))
        for pe in e.partition_by:
            n.window_expr.partition_by.append(expr_to_proto(pe))
        for oe in e.order_by:
            n.window_expr.order_by.append(expr_to_proto(oe))
        if e.frame is not None:
            frame_to_proto(n.window_expr.frame, e.frame)
    elif isinstance(e, lx.SortExpr):
        n.sort_expr.expr.CopyFrom(expr_to_proto(e.expr))
        n.sort_expr.ascending = e.ascending
        n.sort_expr.nulls_first = e.nulls_first
    elif isinstance(e, lx.Wildcard):
        n.wildcard.SetInParent()
    else:
        raise SerdeError(f"cannot serialize expr {type(e).__name__}")
    return n


def expr_from_proto(n: pb.LogicalExprNode) -> lx.Expr:
    which = n.WhichOneof("expr_type")
    if which == "column":
        return lx.Column(n.column.name, n.column.relation or None)
    if which == "literal":
        value, dtype = scalar_from_proto(n.literal)
        return lx.Literal(value, dtype)
    if which == "alias":
        return lx.Alias(expr_from_proto(n.alias.expr), n.alias.name)
    if which == "binary_expr":
        return lx.BinaryExpr(
            expr_from_proto(n.binary_expr.l),
            n.binary_expr.op,
            expr_from_proto(n.binary_expr.r),
        )
    if which == "not_expr":
        return lx.Not(expr_from_proto(n.not_expr.expr))
    if which == "negative":
        return lx.Negative(expr_from_proto(n.negative.expr))
    if which == "is_null":
        inner = expr_from_proto(n.is_null.expr)
        return lx.IsNotNull(inner) if n.is_null.negated else lx.IsNull(inner)
    if which == "between":
        return lx.Between(
            expr_from_proto(n.between.expr),
            expr_from_proto(n.between.low),
            expr_from_proto(n.between.high),
            n.between.negated,
        )
    if which == "in_list":
        return lx.InList(
            expr_from_proto(n.in_list.expr),
            [expr_from_proto(v) for v in n.in_list.values],
            n.in_list.negated,
        )
    if which == "like":
        return lx.Like(
            expr_from_proto(n.like.expr),
            expr_from_proto(n.like.pattern),
            n.like.negated,
            n.like.escape or None,
        )
    if which == "case_expr":
        base = (
            expr_from_proto(n.case_expr.base)
            if n.case_expr.HasField("base")
            else None
        )
        else_e = (
            expr_from_proto(n.case_expr.else_expr)
            if n.case_expr.HasField("else_expr")
            else None
        )
        return lx.Case(
            base,
            [
                (expr_from_proto(wt.when), expr_from_proto(wt.then))
                for wt in n.case_expr.when_then
            ],
            else_e,
        )
    if which == "cast":
        return lx.Cast(expr_from_proto(n.cast.expr), dtype_from_ipc(n.cast.dtype_ipc))
    if which == "try_cast":
        return lx.TryCast(
            expr_from_proto(n.try_cast.expr), dtype_from_ipc(n.try_cast.dtype_ipc)
        )
    if which == "scalar_function":
        return lx.ScalarFunction(
            n.scalar_function.fn,
            [expr_from_proto(a) for a in n.scalar_function.args],
        )
    if which == "aggregate_expr":
        return lx.AggregateExpr(
            n.aggregate_expr.fn,
            expr_from_proto(n.aggregate_expr.expr),
            n.aggregate_expr.distinct,
        )
    if which == "sort_expr":
        return lx.SortExpr(
            expr_from_proto(n.sort_expr.expr),
            n.sort_expr.ascending,
            n.sort_expr.nulls_first,
        )
    if which == "wildcard":
        return lx.Wildcard()
    if which == "window_expr":
        w = n.window_expr
        arg = expr_from_proto(w.arg) if w.HasField("arg") else None
        order = []
        for oe in w.order_by:
            se = expr_from_proto(oe)
            assert isinstance(se, lx.SortExpr)
            order.append(se)
        frame = frame_from_proto(w.frame) if w.HasField("frame") else None
        return lx.WindowExpr(
            w.fn, arg, [expr_from_proto(pe) for pe in w.partition_by], order,
            frame,
        )
    raise SerdeError(f"empty expr node {n}")


# ---------------------------------------------------------------------------
# table sources
# ---------------------------------------------------------------------------


def source_to_proto(src: TableSource) -> pb.TableSourceDesc:
    d = pb.TableSourceDesc(table_type=src.table_type())
    d.schema_ipc = schema_to_ipc(src.schema())
    if isinstance(src, CsvTableSource):
        d.path = src.path
        d.has_header = src.has_header
        d.delimiter = src.delimiter
        d.file_extension = src.file_extension
    elif isinstance(src, ParquetTableSource):
        d.path = src.path
    elif isinstance(src, MemoryTableSource):
        for part in src.partitions:
            d.partitions_ipc.append(batches_to_ipc(part, src.schema()))
    else:
        raise SerdeError(f"cannot serialize source {type(src).__name__}")
    return d


def source_from_proto(d: pb.TableSourceDesc) -> TableSource:
    if d.table_type == "csv":
        return CsvTableSource(
            d.path,
            schema=schema_from_ipc(d.schema_ipc),
            has_header=d.has_header,
            delimiter=d.delimiter or ",",
            file_extension=d.file_extension or ".csv",
        )
    if d.table_type == "parquet":
        return ParquetTableSource(d.path)
    if d.table_type == "memory":
        schema = schema_from_ipc(d.schema_ipc)
        parts = [batches_from_ipc(p) for p in d.partitions_ipc]
        return MemoryTableSource(schema, parts)
    raise SerdeError(f"unknown table type {d.table_type!r}")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def plan_to_proto(plan: lp.LogicalPlan) -> pb.LogicalPlanNode:
    n = pb.LogicalPlanNode()
    if isinstance(plan, lp.TableScan):
        n.scan.table_name = plan.table_name
        n.scan.source.CopyFrom(source_to_proto(plan.source))
        if plan.projection is not None:
            n.scan.has_projection = True
            n.scan.projection.extend(plan.projection)
    elif isinstance(plan, lp.Projection):
        n.projection.input.CopyFrom(plan_to_proto(plan.input))
        for e in plan.exprs:
            n.projection.exprs.append(expr_to_proto(e))
    elif isinstance(plan, lp.Filter):
        n.filter.input.CopyFrom(plan_to_proto(plan.input))
        n.filter.predicate.CopyFrom(expr_to_proto(plan.predicate))
    elif isinstance(plan, lp.Aggregate):
        n.aggregate.input.CopyFrom(plan_to_proto(plan.input))
        for e in plan.group_exprs:
            n.aggregate.group_exprs.append(expr_to_proto(e))
        for e in plan.aggr_exprs:
            n.aggregate.aggr_exprs.append(expr_to_proto(e))
        n.aggregate.exact_floats = getattr(plan, "exact_floats", False)
    elif isinstance(plan, lp.Sort):
        n.sort.input.CopyFrom(plan_to_proto(plan.input))
        for e in plan.sort_exprs:
            n.sort.sort_exprs.append(expr_to_proto(e))
    elif isinstance(plan, lp.Limit):
        n.limit.input.CopyFrom(plan_to_proto(plan.input))
        n.limit.n = plan.n
        n.limit.skip = plan.skip
    elif isinstance(plan, lp.Join):
        n.join.left.CopyFrom(plan_to_proto(plan.left))
        n.join.right.CopyFrom(plan_to_proto(plan.right))
        for l, r in plan.on:
            n.join.left_keys.append(expr_to_proto(l))
            n.join.right_keys.append(expr_to_proto(r))
        n.join.join_type = plan.join_type.value
        if plan.filter is not None:
            n.join.filter.CopyFrom(expr_to_proto(plan.filter))
    elif isinstance(plan, lp.CrossJoin):
        n.cross_join.left.CopyFrom(plan_to_proto(plan.left))
        n.cross_join.right.CopyFrom(plan_to_proto(plan.right))
    elif isinstance(plan, lp.Repartition):
        n.repartition.input.CopyFrom(plan_to_proto(plan.input))
        n.repartition.scheme = plan.scheme.value
        n.repartition.n = plan.n
        for e in plan.hash_exprs:
            n.repartition.hash_exprs.append(expr_to_proto(e))
    elif isinstance(plan, lp.EmptyRelation):
        n.empty.produce_one_row = plan.produce_one_row
        n.empty.schema_ipc = schema_to_ipc(plan.schema())
    elif isinstance(plan, lp.SubqueryAlias):
        n.subquery_alias.input.CopyFrom(plan_to_proto(plan.input))
        n.subquery_alias.alias = plan.alias
    elif isinstance(plan, lp.Distinct):
        n.distinct.input.CopyFrom(plan_to_proto(plan.input))
    elif isinstance(plan, lp.Union):
        for i in plan.inputs:
            n.union.inputs.append(plan_to_proto(i))
        n.union.all = plan.all
    elif isinstance(plan, lp.Explain):
        n.explain.input.CopyFrom(plan_to_proto(plan.input))
        n.explain.verbose = plan.verbose
    elif isinstance(plan, lp.CreateExternalTable):
        n.create_external_table.name = plan.name
        n.create_external_table.location = plan.location
        n.create_external_table.file_type = plan.file_type
        n.create_external_table.has_header = plan.has_header
        if plan.table_schema is not None:
            n.create_external_table.schema_ipc = schema_to_ipc(plan.table_schema)
    elif isinstance(plan, lp.Window):
        n.window.input.CopyFrom(plan_to_proto(plan.input))
        for e in plan.window_exprs:
            n.window.window_exprs.append(expr_to_proto(e))
    else:
        raise SerdeError(f"cannot serialize plan {type(plan).__name__}")
    return n


def plan_from_proto(n: pb.LogicalPlanNode) -> lp.LogicalPlan:
    which = n.WhichOneof("plan_type")
    if which == "scan":
        src = source_from_proto(n.scan.source)
        projection = list(n.scan.projection) if n.scan.has_projection else None
        return lp.TableScan(n.scan.table_name, src, projection)
    if which == "projection":
        return lp.Projection(
            plan_from_proto(n.projection.input),
            [expr_from_proto(e) for e in n.projection.exprs],
        )
    if which == "filter":
        return lp.Filter(
            plan_from_proto(n.filter.input), expr_from_proto(n.filter.predicate)
        )
    if which == "aggregate":
        return lp.Aggregate(
            plan_from_proto(n.aggregate.input),
            [expr_from_proto(e) for e in n.aggregate.group_exprs],
            [expr_from_proto(e) for e in n.aggregate.aggr_exprs],
            exact_floats=n.aggregate.exact_floats,
        )
    if which == "sort":
        return lp.Sort(
            plan_from_proto(n.sort.input),
            [expr_from_proto(e) for e in n.sort.sort_exprs],
        )
    if which == "limit":
        return lp.Limit(plan_from_proto(n.limit.input), n.limit.n, n.limit.skip)
    if which == "join":
        on = [
            (expr_from_proto(l), expr_from_proto(r))
            for l, r in zip(n.join.left_keys, n.join.right_keys)
        ]
        filt = expr_from_proto(n.join.filter) if n.join.HasField("filter") else None
        return lp.Join(
            plan_from_proto(n.join.left),
            plan_from_proto(n.join.right),
            on,
            lp.JoinType(n.join.join_type),
            filt,
        )
    if which == "cross_join":
        return lp.CrossJoin(
            plan_from_proto(n.cross_join.left), plan_from_proto(n.cross_join.right)
        )
    if which == "repartition":
        return lp.Repartition(
            plan_from_proto(n.repartition.input),
            lp.PartitionScheme(n.repartition.scheme),
            n.repartition.n,
            [expr_from_proto(e) for e in n.repartition.hash_exprs],
        )
    if which == "empty":
        return lp.EmptyRelation(
            n.empty.produce_one_row, schema_from_ipc(n.empty.schema_ipc)
        )
    if which == "subquery_alias":
        return lp.SubqueryAlias(
            plan_from_proto(n.subquery_alias.input), n.subquery_alias.alias
        )
    if which == "distinct":
        return lp.Distinct(plan_from_proto(n.distinct.input))
    if which == "union":
        return lp.Union([plan_from_proto(i) for i in n.union.inputs], n.union.all)
    if which == "explain":
        return lp.Explain(plan_from_proto(n.explain.input), n.explain.verbose)
    if which == "create_external_table":
        c = n.create_external_table
        schema = schema_from_ipc(c.schema_ipc) if c.schema_ipc else None
        return lp.CreateExternalTable(c.name, c.location, c.file_type, c.has_header, schema)
    if which == "window":
        return lp.Window(
            plan_from_proto(n.window.input),
            [expr_from_proto(e) for e in n.window.window_exprs],
        )
    raise SerdeError(f"empty plan node: {n}")
