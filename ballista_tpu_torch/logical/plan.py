"""Logical plan nodes.

Mirrors the reference wire contract's 12 LogicalPlanNode variants
(reference rust/core/proto/ballista.proto:164-179: projection, selection,
aggregate, sort, limit, csv/parquet scan, empty relation, create external
table, explain, analyze, join, repartition) plus the nodes full TPC-H planning
needs (cross join, subquery alias, distinct, union, window).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from ballista_tpu_torch.datasource import TableSource
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.logical.expr import (
    AggregateExpr,
    Column,
    Expr,
    SortExpr,
)


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    SEMI = "semi"
    ANTI = "anti"


class PartitionScheme(enum.Enum):
    # reference logical Repartition (proto:219-230): round-robin | hash
    ROUND_ROBIN = "round_robin"
    HASH = "hash"


class LogicalPlan:
    """Base logical plan node."""

    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def children(self) -> List["LogicalPlan"]:
        return []

    def with_children(self, children: List["LogicalPlan"]) -> "LogicalPlan":
        """Rebuild this node with new children (optimizer rewrites)."""
        if children:
            raise PlanError(f"{type(self).__name__} takes no children")
        return self

    def expressions(self) -> List[Expr]:
        return []

    # -- display -----------------------------------------------------------
    def fmt(self) -> str:
        raise NotImplementedError

    def display_indent(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.fmt()]
        for c in self.children():
            lines.append(c.display_indent(indent + 1))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.display_indent()


class TableScan(LogicalPlan):
    def __init__(
        self,
        table_name: str,
        source: TableSource,
        projection: Optional[List[int]] = None,
        filters: Optional[List[Expr]] = None,
    ) -> None:
        self.table_name = table_name
        self.source = source
        self.projection = projection
        self.filters = filters or []

    def schema(self) -> pa.Schema:
        full = self.source.schema()
        if self.projection is None:
            return full
        return pa.schema([full.field(i) for i in self.projection])

    def fmt(self) -> str:
        proj = "" if self.projection is None else f" projection={self.projection}"
        return f"TableScan: {self.table_name}{proj}"


class EmptyRelation(LogicalPlan):
    def __init__(self, produce_one_row: bool = False, schema: Optional[pa.Schema] = None) -> None:
        self.produce_one_row = produce_one_row
        self._schema = schema if schema is not None else pa.schema([])

    def schema(self) -> pa.Schema:
        return self._schema

    def fmt(self) -> str:
        return f"EmptyRelation: produce_one_row={self.produce_one_row}"


class Projection(LogicalPlan):
    def __init__(self, input: LogicalPlan, exprs: List[Expr]) -> None:
        self.input = input
        self.exprs = exprs
        in_schema = input.schema()
        self._schema = pa.schema([e.to_field(in_schema) for e in exprs])

    def schema(self) -> pa.Schema:
        return self._schema

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Projection":
        return Projection(children[0], self.exprs)

    def expressions(self) -> List[Expr]:
        return list(self.exprs)

    def fmt(self) -> str:
        return "Projection: " + ", ".join(str(e) for e in self.exprs)


class Filter(LogicalPlan):
    def __init__(self, input: LogicalPlan, predicate: Expr) -> None:
        self.input = input
        self.predicate = predicate

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Filter":
        return Filter(children[0], self.predicate)

    def expressions(self) -> List[Expr]:
        return [self.predicate]

    def fmt(self) -> str:
        return f"Filter: {self.predicate}"


class Aggregate(LogicalPlan):
    def __init__(
        self,
        input: LogicalPlan,
        group_exprs: List[Expr],
        aggr_exprs: List[Expr],
        exact_floats: bool = False,
    ) -> None:
        self.input = input
        self.group_exprs = group_exprs
        self.aggr_exprs = aggr_exprs
        # a decorrelated scalar subquery's result is compared against
        # source values (q2: ps_supplycost = MIN(ps_supplycost)); float
        # MIN/MAX must then return the bit-exact stored value, which the
        # f32 device paths cannot — they decline when this is set
        self.exact_floats = exact_floats
        in_schema = input.schema()
        fields = [e.to_field(in_schema) for e in group_exprs]
        fields += [e.to_field(in_schema) for e in aggr_exprs]
        self._schema = pa.schema(fields)

    def schema(self) -> pa.Schema:
        return self._schema

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Aggregate":
        return Aggregate(children[0], self.group_exprs, self.aggr_exprs,
                         exact_floats=self.exact_floats)

    def expressions(self) -> List[Expr]:
        return list(self.group_exprs) + list(self.aggr_exprs)

    def fmt(self) -> str:
        return (
            "Aggregate: groupBy=["
            + ", ".join(str(e) for e in self.group_exprs)
            + "], aggr=["
            + ", ".join(str(e) for e in self.aggr_exprs)
            + "]"
        )


class Sort(LogicalPlan):
    def __init__(self, input: LogicalPlan, sort_exprs: List[SortExpr]) -> None:
        self.input = input
        self.sort_exprs = sort_exprs

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Sort":
        return Sort(children[0], self.sort_exprs)

    def expressions(self) -> List[Expr]:
        return list(self.sort_exprs)

    def fmt(self) -> str:
        return "Sort: " + ", ".join(str(e) for e in self.sort_exprs)


class Limit(LogicalPlan):
    def __init__(self, input: LogicalPlan, n: int, skip: int = 0) -> None:
        self.input = input
        self.n = n
        self.skip = skip

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Limit":
        return Limit(children[0], self.n, self.skip)

    def fmt(self) -> str:
        return f"Limit: {self.n}"


def _qualify(schema: pa.Schema, qualifier: Optional[str]) -> pa.Schema:
    if qualifier is None:
        return schema
    return pa.schema(
        [
            pa.field(
                f.name if "." in f.name else f"{qualifier}.{f.name}",
                f.type,
                f.nullable,
            )
            for f in schema
        ]
    )


class Join(LogicalPlan):
    def __init__(
        self,
        left: LogicalPlan,
        right: LogicalPlan,
        on: List[Tuple[Column, Column]],
        join_type: JoinType = JoinType.INNER,
        filter: Optional[Expr] = None,
    ) -> None:
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        self.filter = filter
        if join_type in (JoinType.SEMI, JoinType.ANTI):
            self._schema = left.schema()
        else:
            left_fields = list(left.schema())
            right_fields = list(right.schema())
            names = {f.name for f in left_fields}
            for f in right_fields:
                if f.name in names:
                    raise PlanError(
                        f"duplicate field {f.name!r} in join output; "
                        "qualify inputs with SubqueryAlias"
                    )
            self._schema = pa.schema(left_fields + right_fields)

    def schema(self) -> pa.Schema:
        return self._schema

    def children(self) -> List[LogicalPlan]:
        return [self.left, self.right]

    def with_children(self, children: List[LogicalPlan]) -> "Join":
        return Join(children[0], children[1], self.on, self.join_type, self.filter)

    def expressions(self) -> List[Expr]:
        out: List[Expr] = []
        for l, r in self.on:
            out.extend([l, r])
        if self.filter is not None:
            out.append(self.filter)
        return out

    def fmt(self) -> str:
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        return f"Join: type={self.join_type.value}, on=[{on}]"


class CrossJoin(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan) -> None:
        self.left = left
        self.right = right
        left_fields = list(left.schema())
        right_fields = list(right.schema())
        names = {f.name for f in left_fields}
        for f in right_fields:
            if f.name in names:
                raise PlanError(
                    f"duplicate field {f.name!r} in cross join output; "
                    "qualify inputs with SubqueryAlias"
                )
        self._schema = pa.schema(left_fields + right_fields)

    def schema(self) -> pa.Schema:
        return self._schema

    def children(self) -> List[LogicalPlan]:
        return [self.left, self.right]

    def with_children(self, children: List[LogicalPlan]) -> "CrossJoin":
        return CrossJoin(children[0], children[1])

    def fmt(self) -> str:
        return "CrossJoin"


class Repartition(LogicalPlan):
    def __init__(
        self,
        input: LogicalPlan,
        scheme: PartitionScheme,
        n: int,
        hash_exprs: Optional[List[Expr]] = None,
    ) -> None:
        self.input = input
        self.scheme = scheme
        self.n = n
        self.hash_exprs = hash_exprs or []

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Repartition":
        return Repartition(children[0], self.scheme, self.n, self.hash_exprs)

    def fmt(self) -> str:
        if self.scheme == PartitionScheme.HASH:
            return f"Repartition: hash({', '.join(str(e) for e in self.hash_exprs)}) n={self.n}"
        return f"Repartition: round_robin n={self.n}"


class SubqueryAlias(LogicalPlan):
    """Renames/qualifies an input relation (FROM (…) AS t / table aliases)."""

    def __init__(self, input: LogicalPlan, alias: str) -> None:
        self.input = input
        self.alias = alias
        base = input.schema()
        fields = []
        for f in base:
            bare = f.name.split(".")[-1]
            fields.append(pa.field(f"{alias}.{bare}", f.type, f.nullable))
        self._schema = pa.schema(fields)

    def schema(self) -> pa.Schema:
        return self._schema

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "SubqueryAlias":
        return SubqueryAlias(children[0], self.alias)

    def fmt(self) -> str:
        return f"SubqueryAlias: {self.alias}"


class Distinct(LogicalPlan):
    def __init__(self, input: LogicalPlan) -> None:
        self.input = input

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Distinct":
        return Distinct(children[0])

    def fmt(self) -> str:
        return "Distinct"


class Union(LogicalPlan):
    def __init__(self, inputs: List[LogicalPlan], all: bool = True) -> None:
        if not inputs:
            raise PlanError("UNION of zero inputs")
        self.inputs = inputs
        self.all = all

    def schema(self) -> pa.Schema:
        return self.inputs[0].schema()

    def children(self) -> List[LogicalPlan]:
        return list(self.inputs)

    def with_children(self, children: List[LogicalPlan]) -> "Union":
        return Union(children, self.all)

    def fmt(self) -> str:
        return "Union" + ("" if self.all else " Distinct")


class Window(LogicalPlan):
    """Window functions (OVER clauses). Minimal surface for suite parity."""

    def __init__(self, input: LogicalPlan, window_exprs: List[Expr]) -> None:
        self.input = input
        self.window_exprs = window_exprs
        in_schema = input.schema()
        fields = list(in_schema)
        fields += [e.to_field(in_schema) for e in window_exprs]
        self._schema = pa.schema(fields)

    def schema(self) -> pa.Schema:
        return self._schema

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Window":
        return Window(children[0], self.window_exprs)

    def fmt(self) -> str:
        return "Window: " + ", ".join(str(e) for e in self.window_exprs)


class Explain(LogicalPlan):
    def __init__(self, input: LogicalPlan, verbose: bool = False) -> None:
        self.input = input
        self.verbose = verbose
        self._schema = pa.schema(
            [pa.field("plan_type", pa.string()), pa.field("plan", pa.string())]
        )

    def schema(self) -> pa.Schema:
        return self._schema

    def children(self) -> List[LogicalPlan]:
        return [self.input]

    def with_children(self, children: List[LogicalPlan]) -> "Explain":
        return Explain(children[0], self.verbose)

    def fmt(self) -> str:
        return "Explain"


class CreateExternalTable(LogicalPlan):
    """CREATE EXTERNAL TABLE (reference proto CreateExternalTableNode)."""

    def __init__(
        self,
        name: str,
        location: str,
        file_type: str,
        has_header: bool = True,
        schema: Optional[pa.Schema] = None,
    ) -> None:
        self.name = name
        self.location = location
        self.file_type = file_type
        self.has_header = has_header
        self.table_schema = schema

    def schema(self) -> pa.Schema:
        return pa.schema([])

    def fmt(self) -> str:
        return f"CreateExternalTable: {self.name} @ {self.location} ({self.file_type})"
