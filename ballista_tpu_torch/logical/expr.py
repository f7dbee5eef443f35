"""Logical expression tree.

Covers the reference wire contract's expression surface: 17 LogicalExprNode
variants (reference rust/core/proto/ballista.proto:14-45), the scalar function
library (proto:80-114) and the five aggregate functions MIN/MAX/SUM/AVG/COUNT
(proto:121-127), plus subquery expressions needed for full TPC-H.

Arrow types are pyarrow DataTypes throughout — pyarrow is this build's Arrow
substrate, the role arrow-rs plays for the reference.
"""

from __future__ import annotations

import datetime
import decimal
from typing import Any, List, Optional, Sequence, Tuple, TYPE_CHECKING

import pyarrow as pa

from ballista_tpu_torch.errors import PlanError, SchemaError

if TYPE_CHECKING:  # avoid import cycle; LogicalPlan only used in subquery exprs
    from ballista_tpu_torch.logical.plan import LogicalPlan


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

COMPARISON_OPS = {"eq", "neq", "lt", "lteq", "gt", "gteq"}
BOOLEAN_OPS = {"and", "or"}
ARITHMETIC_OPS = {"plus", "minus", "multiply", "divide", "modulo"}
STRING_OPS = {"like", "not_like"}

_OP_SYMBOL = {
    "eq": "=",
    "neq": "!=",
    "lt": "<",
    "lteq": "<=",
    "gt": ">",
    "gteq": ">=",
    "and": "AND",
    "or": "OR",
    "plus": "+",
    "minus": "-",
    "multiply": "*",
    "divide": "/",
    "modulo": "%",
    "like": "LIKE",
    "not_like": "NOT LIKE",
}


def _is_numeric(dt: pa.DataType) -> bool:
    return (
        pa.types.is_integer(dt)
        or pa.types.is_floating(dt)
        or pa.types.is_decimal(dt)
    )


_INT_RANK = {
    pa.int8(): 1,
    pa.int16(): 2,
    pa.int32(): 3,
    pa.int64(): 4,
    pa.uint8(): 1,
    pa.uint16(): 2,
    pa.uint32(): 3,
    pa.uint64(): 4,
}


def coerce_numeric(lhs: pa.DataType, rhs: pa.DataType) -> pa.DataType:
    """Numeric type coercion for binary arithmetic/comparison."""
    if lhs == rhs:
        return lhs
    if pa.types.is_decimal(lhs) or pa.types.is_decimal(rhs):
        return pa.float64()
    if pa.types.is_floating(lhs) or pa.types.is_floating(rhs):
        if lhs == pa.float64() or rhs == pa.float64():
            return pa.float64()
        if pa.types.is_integer(lhs) or pa.types.is_integer(rhs):
            return pa.float64()
        return pa.float32()
    if pa.types.is_integer(lhs) and pa.types.is_integer(rhs):
        rank_l = _INT_RANK.get(lhs, 4)
        rank_r = _INT_RANK.get(rhs, 4)
        return lhs if rank_l >= rank_r else rhs
    raise PlanError(f"cannot coerce {lhs} and {rhs}")


# ---------------------------------------------------------------------------
# Expr base
# ---------------------------------------------------------------------------


class Expr:
    """Base logical expression.

    Supports Python operator overloading for DataFrame ergonomics, mirroring
    the reference Python bindings' Expression overloads
    (reference python/src/expression.rs).
    """

    # -- schema-dependent metadata ----------------------------------------
    def data_type(self, schema: pa.Schema) -> pa.DataType:
        raise NotImplementedError(type(self).__name__)

    def nullable(self, schema: pa.Schema) -> bool:
        return True

    def to_field(self, schema: pa.Schema) -> pa.Field:
        return pa.field(self.output_name(), self.data_type(schema), self.nullable(schema))

    def output_name(self) -> str:
        """Column name this expression produces in an output schema."""
        return str(self)

    def children(self) -> List["Expr"]:
        return []

    # -- operator overloads ------------------------------------------------
    def __add__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "plus", _expr(other))

    def __radd__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(_expr(other), "plus", self)

    def __sub__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "minus", _expr(other))

    def __rsub__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(_expr(other), "minus", self)

    def __mul__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "multiply", _expr(other))

    def __rmul__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(_expr(other), "multiply", self)

    def __truediv__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "divide", _expr(other))

    def __mod__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "modulo", _expr(other))

    def __eq__(self, other: Any) -> "BinaryExpr":  # type: ignore[override]
        return BinaryExpr(self, "eq", _expr(other))

    def __ne__(self, other: Any) -> "BinaryExpr":  # type: ignore[override]
        return BinaryExpr(self, "neq", _expr(other))

    def __lt__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "lt", _expr(other))

    def __le__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "lteq", _expr(other))

    def __gt__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "gt", _expr(other))

    def __ge__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "gteq", _expr(other))

    def __and__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "and", _expr(other))

    def __or__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "or", _expr(other))

    def __invert__(self) -> "Not":
        return Not(self)

    def __neg__(self) -> "Negative":
        return Negative(self)

    def __hash__(self) -> int:
        return hash(str(self))

    # -- fluent helpers ----------------------------------------------------
    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, dtype: pa.DataType) -> "Cast":
        return Cast(self, dtype)

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "IsNotNull":
        return IsNotNull(self)

    def between(self, low: Any, high: Any, negated: bool = False) -> "Between":
        return Between(self, _expr(low), _expr(high), negated)

    def isin(self, values: Sequence[Any], negated: bool = False) -> "InList":
        return InList(self, [_expr(v) for v in values], negated)

    def like(self, pattern: str) -> "BinaryExpr":
        return BinaryExpr(self, "like", Literal(pattern))

    def not_like(self, pattern: str) -> "BinaryExpr":
        return BinaryExpr(self, "not_like", Literal(pattern))

    def sort(self, ascending: bool = True, nulls_first: bool = False) -> "SortExpr":
        return SortExpr(self, ascending, nulls_first)

    def equals(self, other: "Expr") -> bool:
        """Structural equality (``==`` is overloaded to build BinaryExpr)."""
        return type(self) is type(other) and str(self) == str(other)


def _expr(value: Any) -> Expr:
    return value if isinstance(value, Expr) else Literal(value)


# ---------------------------------------------------------------------------
# Leaf expressions
# ---------------------------------------------------------------------------


class Column(Expr):
    """Column reference, optionally qualified (``l.l_quantity``)."""

    def __init__(self, name: str, relation: Optional[str] = None) -> None:
        self.name = name
        self.relation = relation

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.field(schema).type

    def nullable(self, schema: pa.Schema) -> bool:
        return self.field(schema).nullable

    def field(self, schema: pa.Schema) -> pa.Field:
        idx = self.index_in(schema)
        return schema.field(idx)

    def index_in(self, schema: pa.Schema) -> int:
        # Qualified-name resolution: schemas from joins store fields under
        # "relation.name" flat names; try qualified, then bare.
        candidates = []
        if self.relation is not None:
            candidates.append(f"{self.relation}.{self.name}")
        candidates.append(self.name)
        names = schema.names
        for cand in candidates:
            if cand in names:
                i = names.index(cand)
                if names.count(cand) > 1:
                    raise SchemaError(f"ambiguous column {cand!r}")
                return i
        # unqualified reference to a qualified field, e.g. name "a" matching
        # exactly one "t.a"
        if self.relation is None:
            matches = [i for i, n in enumerate(names) if n.endswith("." + self.name)]
            if len(matches) == 1:
                return matches[0]
            if len(matches) > 1:
                raise SchemaError(f"ambiguous column {self.name!r}")
        raise SchemaError(f"no column named {self.flat_name()!r} in {names}")

    def flat_name(self) -> str:
        return f"{self.relation}.{self.name}" if self.relation else self.name

    def output_name(self) -> str:
        return self.name

    def __str__(self) -> str:
        return f"#{self.flat_name()}"


def infer_literal_type(value: Any) -> pa.DataType:
    if value is None:
        return pa.null()
    if isinstance(value, bool):
        return pa.bool_()
    if isinstance(value, int):
        return pa.int64()
    if isinstance(value, float):
        return pa.float64()
    if isinstance(value, str):
        return pa.string()
    if isinstance(value, bytes):
        return pa.binary()
    if isinstance(value, datetime.datetime):
        return pa.timestamp("us")
    if isinstance(value, datetime.date):
        return pa.date32()
    if isinstance(value, decimal.Decimal):
        return pa.float64()
    raise PlanError(f"unsupported literal {value!r}")


class Literal(Expr):
    def __init__(self, value: Any, dtype: Optional[pa.DataType] = None) -> None:
        self.value = value
        self.dtype = dtype if dtype is not None else infer_literal_type(value)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.dtype

    def nullable(self, schema: pa.Schema) -> bool:
        return self.value is None

    def __str__(self) -> str:
        if isinstance(self.value, str):
            return f"'{self.value}'"
        return str(self.value)


class Wildcard(Expr):
    """``*`` in ``COUNT(*)`` / ``SELECT *`` (reference proto:44 wildcard)."""

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.int64()

    def __str__(self) -> str:
        return "*"


# ---------------------------------------------------------------------------
# Compound expressions
# ---------------------------------------------------------------------------


class Alias(Expr):
    def __init__(self, expr: Expr, name: str) -> None:
        self.expr = expr
        self.name = name

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.expr.data_type(schema)

    def nullable(self, schema: pa.Schema) -> bool:
        return self.expr.nullable(schema)

    def children(self) -> List[Expr]:
        return [self.expr]

    def output_name(self) -> str:
        return self.name

    def __str__(self) -> str:
        return f"{self.expr} AS {self.name}"


class BinaryExpr(Expr):
    def __init__(self, left: Expr, op: str, right: Expr) -> None:
        if op not in _OP_SYMBOL:
            raise PlanError(f"unknown binary operator {op!r}")
        self.left = left
        self.op = op
        self.right = right

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        if self.op in COMPARISON_OPS or self.op in BOOLEAN_OPS or self.op in STRING_OPS:
            return pa.bool_()
        lt = self.left.data_type(schema)
        rt = self.right.data_type(schema)
        if pa.types.is_temporal(lt) or pa.types.is_temporal(rt):
            # date +/- interval stays a date; date - date is days
            if pa.types.is_temporal(lt) and pa.types.is_temporal(rt):
                return pa.int32()
            return lt if pa.types.is_temporal(lt) else rt
        if self.op == "divide" and not (
            pa.types.is_floating(lt) or pa.types.is_floating(rt)
        ):
            # integer division keeps integer semantics
            return coerce_numeric(lt, rt)
        return coerce_numeric(lt, rt)

    def nullable(self, schema: pa.Schema) -> bool:
        return self.left.nullable(schema) or self.right.nullable(schema)

    def children(self) -> List[Expr]:
        return [self.left, self.right]

    def __str__(self) -> str:
        return f"({self.left} {_OP_SYMBOL[self.op]} {self.right})"


class Not(Expr):
    def __init__(self, expr: Expr) -> None:
        self.expr = expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> List[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"NOT {self.expr}"


class Negative(Expr):
    def __init__(self, expr: Expr) -> None:
        self.expr = expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.expr.data_type(schema)

    def children(self) -> List[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"(- {self.expr})"


class IsNull(Expr):
    def __init__(self, expr: Expr) -> None:
        self.expr = expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def nullable(self, schema: pa.Schema) -> bool:
        return False

    def children(self) -> List[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"{self.expr} IS NULL"


class IsNotNull(Expr):
    def __init__(self, expr: Expr) -> None:
        self.expr = expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def nullable(self, schema: pa.Schema) -> bool:
        return False

    def children(self) -> List[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"{self.expr} IS NOT NULL"


class Between(Expr):
    def __init__(self, expr: Expr, low: Expr, high: Expr, negated: bool = False) -> None:
        self.expr = expr
        self.low = low
        self.high = high
        self.negated = negated

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> List[Expr]:
        return [self.expr, self.low, self.high]

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr} {neg}BETWEEN {self.low} AND {self.high}"


class InList(Expr):
    def __init__(self, expr: Expr, values: List[Expr], negated: bool = False) -> None:
        self.expr = expr
        self.values = values
        self.negated = negated

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> List[Expr]:
        return [self.expr, *self.values]

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        vals = ", ".join(str(v) for v in self.values)
        return f"{self.expr} {neg}IN ({vals})"


# Like exists as a dedicated class for SQL ESCAPE support; plain LIKE uses
# BinaryExpr(op="like") as the reference does.
class Like(Expr):
    def __init__(self, expr: Expr, pattern: Expr, negated: bool = False,
                 escape: Optional[str] = None) -> None:
        self.expr = expr
        self.pattern = pattern
        self.negated = negated
        self.escape = escape

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> List[Expr]:
        return [self.expr, self.pattern]

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr} {neg}LIKE {self.pattern}"


class Case(Expr):
    """CASE [expr] WHEN .. THEN .. [ELSE ..] END (reference proto CaseNode)."""

    def __init__(
        self,
        expr: Optional[Expr],
        when_then: List[Tuple[Expr, Expr]],
        else_expr: Optional[Expr] = None,
    ) -> None:
        if not when_then:
            raise PlanError("CASE requires at least one WHEN arm")
        self.expr = expr
        self.when_then = when_then
        self.else_expr = else_expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.when_then[0][1].data_type(schema)

    def children(self) -> List[Expr]:
        out: List[Expr] = []
        if self.expr is not None:
            out.append(self.expr)
        for w, t in self.when_then:
            out.extend([w, t])
        if self.else_expr is not None:
            out.append(self.else_expr)
        return out

    def __str__(self) -> str:
        parts = ["CASE"]
        if self.expr is not None:
            parts.append(str(self.expr))
        for w, t in self.when_then:
            parts.append(f"WHEN {w} THEN {t}")
        if self.else_expr is not None:
            parts.append(f"ELSE {self.else_expr}")
        parts.append("END")
        return " ".join(parts)


class Cast(Expr):
    def __init__(self, expr: Expr, dtype: pa.DataType) -> None:
        self.expr = expr
        self.dtype = dtype

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.dtype

    def nullable(self, schema: pa.Schema) -> bool:
        return self.expr.nullable(schema)

    def children(self) -> List[Expr]:
        return [self.expr]

    def output_name(self) -> str:
        return self.expr.output_name()

    def __str__(self) -> str:
        return f"CAST({self.expr} AS {self.dtype})"


class TryCast(Cast):
    """Cast returning null on failure instead of raising."""

    def __str__(self) -> str:
        return f"TRY_CAST({self.expr} AS {self.dtype})"


# ---------------------------------------------------------------------------
# Function calls
# ---------------------------------------------------------------------------

# Scalar function library: name -> return-type rule.
# "same" = type of first arg; "float" = float64; "string" = utf8; "int" = int64;
# "bool" = boolean.  Mirrors the reference's 33-function enum (proto:80-114).
SCALAR_FUNCTIONS = {
    "sqrt": "float",
    "sin": "float",
    "cos": "float",
    "tan": "float",
    "asin": "float",
    "acos": "float",
    "atan": "float",
    "exp": "float",
    "log": "float",
    "log2": "float",
    "log10": "float",
    "ln": "float",
    "floor": "float",
    "ceil": "float",
    "round": "float",
    "trunc": "float",
    "abs": "same",
    "signum": "same",
    "octet_length": "int",
    # super-aggregate marker; resolved to 0/1 literals by the grouping-sets
    # planner (only valid with ROLLUP/CUBE/GROUPING SETS)
    "grouping": "int",
    "concat": "string",
    "lower": "string",
    "upper": "string",
    "trim": "string",
    "ltrim": "string",
    "rtrim": "string",
    "btrim": "string",
    "length": "int",
    "char_length": "int",
    "substr": "string",
    "substring": "string",
    "replace": "string",
    "strpos": "int",
    "starts_with": "bool",
    "to_timestamp": "timestamp",
    "array": "same",
    "now": "timestamp",
    "md5": "string",
    "sha224": "string",
    "sha256": "string",
    "sha384": "string",
    "sha512": "string",
    "date_part": "int",
    "date_trunc": "same",
    "extract": "int",
    "coalesce": "same",
    "nullif": "same",
}

_FN_RETURN = {
    "float": pa.float64(),
    "int": pa.int64(),
    "string": pa.string(),
    "bool": pa.bool_(),
    "timestamp": pa.timestamp("us"),
}


class ScalarFunction(Expr):
    def __init__(self, fn: str, args: List[Expr]) -> None:
        fn = fn.lower()
        if fn not in SCALAR_FUNCTIONS:
            raise PlanError(f"unknown scalar function {fn!r}")
        self.fn = fn
        self.args = args

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        rule = SCALAR_FUNCTIONS[self.fn]
        if rule == "same":
            if self.fn in ("date_trunc",):
                return self.args[1].data_type(schema)
            if self.fn in ("coalesce", "nullif"):
                return self.args[0].data_type(schema)
            return self.args[0].data_type(schema)
        return _FN_RETURN[rule]

    def children(self) -> List[Expr]:
        return list(self.args)

    def output_name(self) -> str:
        return str(self)

    def __str__(self) -> str:
        return f"{self.fn}({', '.join(str(a) for a in self.args)})"


AGGREGATE_FUNCTIONS = ("min", "max", "sum", "avg", "count")


class AggregateExpr(Expr):
    """MIN/MAX/SUM/AVG/COUNT (reference proto:121-127), plus COUNT(DISTINCT)."""

    def __init__(self, fn: str, expr: Expr, distinct: bool = False) -> None:
        fn = fn.lower()
        if fn not in AGGREGATE_FUNCTIONS:
            raise PlanError(f"unknown aggregate function {fn!r}")
        self.fn = fn
        self.expr = expr
        self.distinct = distinct

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        if self.fn == "count":
            return pa.int64()
        if self.fn == "avg":
            return pa.float64()
        inner = self.expr.data_type(schema)
        if self.fn == "sum":
            if pa.types.is_integer(inner):
                return pa.int64()
            if pa.types.is_floating(inner) or pa.types.is_decimal(inner):
                return pa.float64()
        return inner

    def children(self) -> List[Expr]:
        return [self.expr]

    def output_name(self) -> str:
        return str(self)

    def __str__(self) -> str:
        d = "DISTINCT " if self.distinct else ""
        return f"{self.fn.upper()}({d}{self.expr})"


WINDOW_FUNCTIONS = ("row_number", "rank", "dense_rank") + AGGREGATE_FUNCTIONS


class WindowExpr(Expr):
    """fn(...) OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE frame]).

    frame: None = the SQL default (whole partition without ORDER BY;
    RANGE UNBOUNDED PRECEDING..CURRENT ROW with it), else a
    (mode, start, end) triple. mode is "rows" (offsets count rows) or
    "range" (offsets are order-key value deltas; requires one numeric
    order key). None = unbounded on that side, negative = PRECEDING,
    0 = CURRENT ROW, positive = FOLLOWING."""

    def __init__(
        self,
        fn: str,
        arg: Optional["Expr"],
        partition_by: List["Expr"],
        order_by: List["SortExpr"],
        frame: Optional[Tuple[str, Optional[float], Optional[float]]] = None,
    ) -> None:
        fn = fn.lower()
        if fn not in WINDOW_FUNCTIONS:
            raise PlanError(f"unknown window function {fn!r}")
        if frame is not None:
            mode, start, end = frame
            if mode not in ("rows", "range"):
                raise PlanError(f"unknown frame mode {mode!r}")
            if fn in ("row_number", "rank", "dense_rank"):
                raise PlanError(f"{fn} does not accept a frame clause")
            if start is not None and end is not None and start > end:
                raise PlanError("window frame start is after its end")
            if mode == "range" and len(order_by) != 1:
                raise PlanError("RANGE frames require exactly one ORDER BY key")
        self.fn = fn
        self.arg = arg
        self.partition_by = partition_by
        self.order_by = order_by
        self.frame = frame

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        if self.fn in ("row_number", "rank", "dense_rank", "count"):
            return pa.int64()
        if self.fn == "avg":
            return pa.float64()
        assert self.arg is not None
        inner = self.arg.data_type(schema)
        if self.fn == "sum":
            if pa.types.is_integer(inner):
                return pa.int64()
            if pa.types.is_floating(inner) or pa.types.is_decimal(inner):
                return pa.float64()
        return inner

    def children(self) -> List["Expr"]:
        out: List[Expr] = []
        if self.arg is not None:
            out.append(self.arg)
        out.extend(self.partition_by)
        out.extend(self.order_by)
        return out

    def output_name(self) -> str:
        return str(self)

    def __str__(self) -> str:
        arg = str(self.arg) if self.arg is not None else ""
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY " + ", ".join(str(e) for e in self.partition_by))
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(str(e) for e in self.order_by))
        if self.frame is not None:
            mode, start, end = self.frame
            parts.append(f"{mode.upper()} BETWEEN {_bound(start, True)} "
                         f"AND {_bound(end, False)}")
        return f"{self.fn.upper()}({arg}) OVER ({' '.join(parts)})"


def _bound(b, is_start: bool) -> str:
    if b is None:
        return "UNBOUNDED PRECEDING" if is_start else "UNBOUNDED FOLLOWING"
    if b == 0:
        return "CURRENT ROW"
    return f"{-b} PRECEDING" if b < 0 else f"{b} FOLLOWING"


class SortExpr(Expr):
    """Sort key wrapper — only valid inside Sort/TopK nodes (proto sort node)."""

    def __init__(self, expr: Expr, ascending: bool = True, nulls_first: bool = False) -> None:
        self.expr = expr
        self.ascending = ascending
        self.nulls_first = nulls_first

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.expr.data_type(schema)

    def children(self) -> List[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        direction = "ASC" if self.ascending else "DESC"
        nf = " NULLS FIRST" if self.nulls_first else ""
        return f"{self.expr} {direction}{nf}"


# ---------------------------------------------------------------------------
# Subquery expressions (beyond the reference wire contract; needed for the
# full TPC-H suite: q2/q4/q15/q16/q17/q18/q20/q21/q22)
# ---------------------------------------------------------------------------


class ScalarSubquery(Expr):
    def __init__(self, plan: "LogicalPlan") -> None:
        self.plan = plan

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.plan.schema().field(0).type

    def __str__(self) -> str:
        return "(<subquery>)"


class InSubquery(Expr):
    def __init__(self, expr: Expr, plan: "LogicalPlan", negated: bool = False) -> None:
        self.expr = expr
        self.plan = plan
        self.negated = negated

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> List[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr} {neg}IN (<subquery>)"


class Exists(Expr):
    def __init__(self, plan: "LogicalPlan", negated: bool = False) -> None:
        self.plan = plan
        self.negated = negated

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{neg}EXISTS (<subquery>)"


# ---------------------------------------------------------------------------
# Public constructors (fn library, reference python/src/functions.rs role)
# ---------------------------------------------------------------------------


def col(name: str) -> Column:
    if "." in name:
        relation, _, bare = name.partition(".")
        return Column(bare, relation)
    return Column(name)


def lit(value: Any) -> Literal:
    return Literal(value)


def binary_op(left: Expr, op: str, right: Expr) -> BinaryExpr:
    return BinaryExpr(left, op, right)


class _Functions:
    """``functions.sum(col(...))``-style library."""

    @staticmethod
    def sum(e: Expr) -> AggregateExpr:
        return AggregateExpr("sum", e)

    @staticmethod
    def avg(e: Expr) -> AggregateExpr:
        return AggregateExpr("avg", e)

    @staticmethod
    def min(e: Expr) -> AggregateExpr:
        return AggregateExpr("min", e)

    @staticmethod
    def max(e: Expr) -> AggregateExpr:
        return AggregateExpr("max", e)

    @staticmethod
    def count(e: Optional[Expr] = None, distinct: bool = False) -> AggregateExpr:
        return AggregateExpr("count", e if e is not None else Wildcard(), distinct)

    def __getattr__(self, name: str):
        if name in SCALAR_FUNCTIONS:
            def make(*args: Any) -> ScalarFunction:
                return ScalarFunction(name, [_expr(a) for a in args])
            return make
        raise AttributeError(name)


functions = _Functions()
