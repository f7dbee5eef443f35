"""Physical expressions: evaluated against Arrow RecordBatches.

The host (CPU) kernel path uses pyarrow.compute — the correctness oracle and
default executor backend, playing the role DataFusion's physical expressions
play in the reference (compiled there via DefaultPhysicalPlanner,
rust/core/src/serde/physical_plan/from_proto.rs:348-365). The TPU backend
(ballista_tpu_torch.ops) lowers whole operator pipelines instead of single exprs.
"""

from __future__ import annotations

import datetime
from typing import Any, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.errors import ExecutionError, PlanError
from ballista_tpu_torch.logical import expr as lx


class PhysicalExpr:
    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        raise NotImplementedError

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        raise NotImplementedError

    def children(self) -> List["PhysicalExpr"]:
        return []

    def __str__(self) -> str:
        raise NotImplementedError


def _as_array(value: Any, length: int, dtype: Optional[pa.DataType] = None) -> pa.Array:
    """Broadcast a scalar result to an array of the batch length."""
    if isinstance(value, (pa.Array, pa.ChunkedArray)):
        if isinstance(value, pa.ChunkedArray):
            return value.combine_chunks()
        return value
    if isinstance(value, pa.Scalar):
        return pa.repeat(value, length)
    return pa.repeat(pa.scalar(value, type=dtype), length)


class ColumnExpr(PhysicalExpr):
    def __init__(self, name: str, index: int) -> None:
        self.name = name
        self.index = index

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return batch.column(self.index)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return schema.field(self.index).type

    def __str__(self) -> str:
        return f"{self.name}@{self.index}"


class LiteralExpr(PhysicalExpr):
    def __init__(self, value: Any, dtype: pa.DataType) -> None:
        self.value = value
        self.dtype = dtype

    def scalar(self) -> pa.Scalar:
        return pa.scalar(self.value, type=self.dtype)

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pa.repeat(self.scalar(), batch.num_rows)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.dtype

    def __str__(self) -> str:
        return repr(self.value)


_CMP_FN = {
    "eq": pc.equal,
    "neq": pc.not_equal,
    "lt": pc.less,
    "lteq": pc.less_equal,
    "gt": pc.greater,
    "gteq": pc.greater_equal,
}

_ARITH_FN = {
    "plus": pc.add,
    "minus": pc.subtract,
    "multiply": pc.multiply,
}


def _modulo(left: pa.Array, right: pa.Array) -> pa.Array:
    l = left.to_numpy(zero_copy_only=False)
    r = right.to_numpy(zero_copy_only=False)
    return pa.array(np.mod(l, r))


class BinaryPhysicalExpr(PhysicalExpr):
    def __init__(self, left: PhysicalExpr, op: str, right: PhysicalExpr) -> None:
        self.left = left
        self.op = op
        self.right = right

    def children(self) -> List[PhysicalExpr]:
        return [self.left, self.right]

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        n = batch.num_rows
        lv = _as_array(self.left.evaluate(batch), n)
        rv = _as_array(self.right.evaluate(batch), n)
        op = self.op
        if op in _CMP_FN:
            return _CMP_FN[op](lv, rv)
        if op == "and":
            return pc.and_kleene(lv, rv)
        if op == "or":
            return pc.or_kleene(lv, rv)
        if op == "like":
            return pc.match_like(lv, self._pattern())
        if op == "not_like":
            return pc.invert(pc.match_like(lv, self._pattern()))
        if op in _ARITH_FN:
            return _ARITH_FN[op](lv, rv)
        if op == "divide":
            return pc.divide(lv, rv)
        if op == "modulo":
            return _modulo(lv, rv)
        raise ExecutionError(f"unsupported binary op {op!r}")

    def _pattern(self) -> str:
        if not isinstance(self.right, LiteralExpr):
            raise ExecutionError("LIKE pattern must be a literal")
        return str(self.right.value)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        if self.op in _CMP_FN or self.op in ("and", "or", "like", "not_like"):
            return pa.bool_()
        return lx.coerce_numeric(
            self.left.data_type(schema), self.right.data_type(schema)
        )

    def __str__(self) -> str:
        return f"({self.left} {self.op} {self.right})"


class NotExpr(PhysicalExpr):
    def __init__(self, expr: PhysicalExpr) -> None:
        self.expr = expr

    def children(self) -> List[PhysicalExpr]:
        return [self.expr]

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pc.invert(_as_array(self.expr.evaluate(batch), batch.num_rows))

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        return f"NOT {self.expr}"


class NegativeExpr(PhysicalExpr):
    def __init__(self, expr: PhysicalExpr) -> None:
        self.expr = expr

    def children(self) -> List[PhysicalExpr]:
        return [self.expr]

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pc.negate(_as_array(self.expr.evaluate(batch), batch.num_rows))

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.expr.data_type(schema)

    def __str__(self) -> str:
        return f"(- {self.expr})"


class IsNullExpr(PhysicalExpr):
    def __init__(self, expr: PhysicalExpr, negated: bool = False) -> None:
        self.expr = expr
        self.negated = negated

    def children(self) -> List[PhysicalExpr]:
        return [self.expr]

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        v = _as_array(self.expr.evaluate(batch), batch.num_rows)
        return pc.is_valid(v) if self.negated else pc.is_null(v)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        return f"{self.expr} IS {'NOT ' if self.negated else ''}NULL"


class CastExpr(PhysicalExpr):
    def __init__(self, expr: PhysicalExpr, dtype: pa.DataType, safe: bool = False) -> None:
        self.expr = expr
        self.dtype = dtype
        self.safe = safe  # TryCast: null on failure

    def children(self) -> List[PhysicalExpr]:
        return [self.expr]

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        v = _as_array(self.expr.evaluate(batch), batch.num_rows)
        return pc.cast(v, self.dtype, safe=not self.safe)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.dtype

    def __str__(self) -> str:
        return f"CAST({self.expr} AS {self.dtype})"


class InListExpr(PhysicalExpr):
    """expr [NOT] IN (members). Literal members use one hashed pc.is_in;
    expression members evaluate the probe ONCE and fold equality with
    Kleene OR. Both follow SQL three-valued logic: a NULL probe (or, for
    the expression form, NULL members that prevent a definite answer)
    yields NULL, so NOT IN never resurrects NULL rows."""

    def __init__(
        self,
        expr: PhysicalExpr,
        values: List[Any],
        negated: bool,
        value_exprs: Optional[List[PhysicalExpr]] = None,
    ) -> None:
        self.expr = expr
        self.values = values  # literals (ignored when value_exprs is set)
        self.negated = negated
        self.value_exprs = value_exprs

    def children(self) -> List[PhysicalExpr]:
        return [self.expr] + list(self.value_exprs or [])

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        v = _as_array(self.expr.evaluate(batch), batch.num_rows)
        if self.value_exprs is None:
            non_null = [x for x in self.values if x is not None]
            if not non_null:
                # IN (NULL, ...): never definitely true or false
                member = pa.nulls(len(v), pa.bool_())
            else:
                member = pc.is_in(v, value_set=pa.array(non_null))
                if len(non_null) < len(self.values):
                    # a NULL member makes non-matches indefinite (NULL)
                    member = pc.if_else(
                        member, member, pa.scalar(None, pa.bool_())
                    )
                # is_in returns FALSE for a null probe; SQL says NULL
                member = pc.if_else(
                    pc.is_valid(v), member, pa.scalar(None, pa.bool_())
                )
        else:
            member = None
            for ve in self.value_exprs:
                m = _as_array(ve.evaluate(batch), batch.num_rows)
                eq = pc.equal(v, m)
                member = eq if member is None else pc.or_kleene(member, eq)
        return pc.invert(member) if self.negated else member

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        members = self.value_exprs if self.value_exprs is not None else self.values
        return f"{self.expr} {'NOT ' if self.negated else ''}IN {members}"


class BetweenExpr(PhysicalExpr):
    def __init__(
        self, expr: PhysicalExpr, low: PhysicalExpr, high: PhysicalExpr, negated: bool
    ) -> None:
        self.expr = expr
        self.low = low
        self.high = high
        self.negated = negated

    def children(self) -> List[PhysicalExpr]:
        return [self.expr, self.low, self.high]

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        n = batch.num_rows
        v = _as_array(self.expr.evaluate(batch), n)
        lo = _as_array(self.low.evaluate(batch), n)
        hi = _as_array(self.high.evaluate(batch), n)
        result = pc.and_kleene(pc.greater_equal(v, lo), pc.less_equal(v, hi))
        return pc.invert(result) if self.negated else result

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def __str__(self) -> str:
        return f"{self.expr} BETWEEN {self.low} AND {self.high}"


class CaseExpr(PhysicalExpr):
    def __init__(
        self,
        base: Optional[PhysicalExpr],
        when_then: List[Tuple[PhysicalExpr, PhysicalExpr]],
        else_expr: Optional[PhysicalExpr],
        dtype: pa.DataType,
    ) -> None:
        self.base = base
        self.when_then = when_then
        self.else_expr = else_expr
        self.dtype = dtype

    def children(self) -> List[PhysicalExpr]:
        out = [] if self.base is None else [self.base]
        for w, t in self.when_then:
            out += [w, t]
        if self.else_expr is not None:
            out.append(self.else_expr)
        return out

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        n = batch.num_rows
        base = None if self.base is None else _as_array(self.base.evaluate(batch), n)
        # evaluate arms back-to-front with if_else
        if self.else_expr is not None:
            acc = pc.cast(_as_array(self.else_expr.evaluate(batch), n), self.dtype)
        else:
            acc = pa.nulls(n, type=self.dtype)
        for w, t in reversed(self.when_then):
            wv = _as_array(w.evaluate(batch), n)
            if base is not None:
                cond = pc.equal(base, wv)
            else:
                cond = wv
            cond = pc.fill_null(cond, False)
            tv = pc.cast(_as_array(t.evaluate(batch), n), self.dtype)
            acc = pc.if_else(cond, tv, acc)
        return acc

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.dtype

    def __str__(self) -> str:
        return "CASE..END"


def _extract_part(arrays: List[pa.Array], part: str) -> pa.Array:
    part = part.lower()
    fn = {
        "year": pc.year,
        "month": pc.month,
        "day": pc.day,
        "hour": pc.hour,
        "minute": pc.minute,
        "second": pc.second,
    }.get(part)
    if fn is None:
        raise ExecutionError(f"unsupported date part {part!r}")
    return pc.cast(fn(arrays[0]), pa.int64())


class ScalarFunctionExpr(PhysicalExpr):
    def __init__(self, fn: str, args: List[PhysicalExpr], dtype: pa.DataType) -> None:
        self.fn = fn
        self.args = args
        self.dtype = dtype

    def children(self) -> List[PhysicalExpr]:
        return list(self.args)

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        n = batch.num_rows
        argv = [_as_array(a.evaluate(batch), n) for a in self.args]
        fn = self.fn
        simple = {
            "sqrt": pc.sqrt,
            "sin": pc.sin,
            "cos": pc.cos,
            "tan": pc.tan,
            "asin": pc.asin,
            "acos": pc.acos,
            "atan": pc.atan,
            "exp": pc.exp,
            "ln": pc.ln,
            "log2": pc.log2,
            "log10": pc.log10,
            "log": pc.log10,
            "floor": pc.floor,
            "ceil": pc.ceil,
            "round": pc.round,
            "trunc": pc.trunc,
            "abs": pc.abs,
            "signum": pc.sign,
            "lower": pc.utf8_lower,
            "upper": pc.utf8_upper,
            "trim": pc.utf8_trim_whitespace,
            "ltrim": pc.utf8_ltrim_whitespace,
            "rtrim": pc.utf8_rtrim_whitespace,
            "btrim": pc.utf8_trim_whitespace,
            "length": pc.utf8_length,
            "char_length": pc.utf8_length,
            "octet_length": pc.binary_length,
        }
        if fn in simple:
            out = simple[fn](argv[0])
            if fn in ("length", "char_length", "octet_length"):
                out = pc.cast(out, pa.int64())
            return out
        if fn == "concat":
            return pc.binary_join_element_wise(*argv, "")
        if fn in ("substr", "substring"):
            start = self._const(1)  # 1-based SQL
            length = self._const(2) if len(self.args) > 2 else None
            if length is not None:
                return pc.utf8_slice_codeunits(
                    argv[0], start=start - 1, stop=start - 1 + length
                )
            return pc.utf8_slice_codeunits(argv[0], start=start - 1)
        if fn == "replace":
            return pc.replace_substring(
                argv[0], pattern=self._const(1), replacement=self._const(2)
            )
        if fn == "strpos":
            return pc.cast(
                pc.add(pc.find_substring(argv[0], pattern=self._const(1)), 1),
                pa.int64(),
            )
        if fn == "starts_with":
            return pc.starts_with(argv[0], pattern=self._const(1))
        if fn in ("extract", "date_part"):
            # extract(part, expr) — part is arg 0 as a string literal
            return _extract_part([argv[1]], self._const(0))
        if fn == "date_trunc":
            unit = self._const(0)
            return pc.floor_temporal(argv[1], unit=unit)
        if fn == "to_timestamp":
            return pc.cast(argv[0], pa.timestamp("us"))
        if fn == "now":
            return pa.repeat(
                pa.scalar(datetime.datetime.now(), type=pa.timestamp("us")), n
            )
        if fn == "coalesce":
            acc = argv[0]
            for other in argv[1:]:
                acc = pc.if_else(pc.is_valid(acc), acc, other)
            return acc
        if fn == "nullif":
            eq = pc.fill_null(pc.equal(argv[0], argv[1]), False)
            return pc.if_else(eq, pa.nulls(n, type=argv[0].type), argv[0])
        if fn in ("md5", "sha224", "sha256", "sha384", "sha512"):
            import hashlib

            h = getattr(hashlib, fn)
            vals = argv[0].to_pylist()
            return pa.array(
                [None if v is None else h(str(v).encode()).hexdigest() for v in vals]
            )
        raise ExecutionError(f"unsupported scalar function {fn!r}")

    def _const(self, i: int) -> Any:
        a = self.args[i]
        if not isinstance(a, LiteralExpr):
            raise ExecutionError(f"{self.fn} arg {i} must be a literal")
        return a.value

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.dtype

    def __str__(self) -> str:
        return f"{self.fn}({', '.join(str(a) for a in self.args)})"


# ---------------------------------------------------------------------------
# Logical -> physical expression compilation
# ---------------------------------------------------------------------------


def create_physical_expr(e: lx.Expr, input_schema: pa.Schema) -> PhysicalExpr:
    """Compile a logical expression against an input schema.

    The reference delegates this to DataFusion's DefaultPhysicalPlanner on a
    throwaway context (rust/core/src/serde/physical_plan/from_proto.rs:348-365).
    """
    if isinstance(e, lx.Column):
        idx = e.index_in(input_schema)
        return ColumnExpr(e.flat_name(), idx)
    if isinstance(e, lx.Literal):
        return LiteralExpr(e.value, e.dtype)
    if isinstance(e, lx.Alias):
        return create_physical_expr(e.expr, input_schema)
    if isinstance(e, lx.BinaryExpr):
        return BinaryPhysicalExpr(
            create_physical_expr(e.left, input_schema),
            e.op,
            create_physical_expr(e.right, input_schema),
        )
    if isinstance(e, lx.Not):
        return NotExpr(create_physical_expr(e.expr, input_schema))
    if isinstance(e, lx.Negative):
        return NegativeExpr(create_physical_expr(e.expr, input_schema))
    if isinstance(e, lx.IsNull):
        return IsNullExpr(create_physical_expr(e.expr, input_schema), negated=False)
    if isinstance(e, lx.IsNotNull):
        return IsNullExpr(create_physical_expr(e.expr, input_schema), negated=True)
    if isinstance(e, lx.Between):
        return BetweenExpr(
            create_physical_expr(e.expr, input_schema),
            create_physical_expr(e.low, input_schema),
            create_physical_expr(e.high, input_schema),
            e.negated,
        )
    if isinstance(e, lx.InList):
        if all(isinstance(v, lx.Literal) for v in e.values):
            values = [v.value for v in e.values]
            return InListExpr(
                create_physical_expr(e.expr, input_schema), values, e.negated
            )
        # non-literal members evaluate per row inside InListExpr (the probe
        # is computed once, not once per member)
        return InListExpr(
            create_physical_expr(e.expr, input_schema),
            [],
            e.negated,
            [create_physical_expr(v, input_schema) for v in e.values],
        )
    if isinstance(e, lx.Like):
        base = BinaryPhysicalExpr(
            create_physical_expr(e.expr, input_schema),
            "like",
            create_physical_expr(e.pattern, input_schema),
        )
        return NotExpr(base) if e.negated else base
    if isinstance(e, lx.Case):
        dtype = e.data_type(input_schema)
        return CaseExpr(
            None if e.expr is None else create_physical_expr(e.expr, input_schema),
            [
                (
                    create_physical_expr(w, input_schema),
                    create_physical_expr(t, input_schema),
                )
                for w, t in e.when_then
            ],
            None
            if e.else_expr is None
            else create_physical_expr(e.else_expr, input_schema),
            dtype,
        )
    if isinstance(e, lx.TryCast):
        return CastExpr(create_physical_expr(e.expr, input_schema), e.dtype, safe=True)
    if isinstance(e, lx.Cast):
        return CastExpr(create_physical_expr(e.expr, input_schema), e.dtype, safe=False)
    if isinstance(e, lx.ScalarFunction):
        dtype = e.data_type(input_schema)
        return ScalarFunctionExpr(
            e.fn, [create_physical_expr(a, input_schema) for a in e.args], dtype
        )
    raise PlanError(f"cannot compile logical expr {e!r} ({type(e).__name__})")
