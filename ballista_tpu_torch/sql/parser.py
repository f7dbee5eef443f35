"""Recursive-descent SQL parser covering the TPC-H q1-q22 surface.

Statements: SELECT (joins, subqueries, CASE, EXTRACT, date/interval
arithmetic, EXISTS/IN, UNION), CREATE EXTERNAL TABLE, EXPLAIN.
The reference gets this from DataFusion's sqlparser crate; built natively here.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

import pyarrow as pa

from ballista_tpu_torch.errors import SqlError
from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.sql.ast import (
    CreateExternalTableStmt,
    ExplainStmt,
    FromItem,
    IntervalLiteral,
    JoinItem,
    OrderItem,
    SelectStmt,
    SubqueryRef,
    TableRef,
)
from ballista_tpu_torch.sql.lexer import Token, tokenize

# keywords that stay legal as identifiers (clause-introducers only; the
# primary-expression and identifier parsers fall back to treating them as
# names). Frame/grouping words are positional: `rows`/`rollup` only act as
# syntax right after ORDER BY exprs / GROUP BY.
NON_RESERVED = {
    "rollup", "cube", "grouping", "sets",
    "rows", "range", "unbounded", "preceding", "following", "current",
}

_CMP_OPS = {"=": "eq", "<>": "neq", "!=": "neq", "<": "lt", "<=": "lteq",
            ">": "gt", ">=": "gteq"}

_TYPE_NAMES = {
    "int": pa.int32(), "integer": pa.int32(), "smallint": pa.int16(),
    "tinyint": pa.int8(), "bigint": pa.int64(),
    "float": pa.float32(), "real": pa.float32(),
    "double": pa.float64(), "decimal": pa.float64(), "numeric": pa.float64(),
    "varchar": pa.string(), "char": pa.string(), "text": pa.string(),
    "string": pa.string(), "boolean": pa.bool_(), "bool": pa.bool_(),
    "date": pa.date32(), "timestamp": pa.timestamp("us"),
}


def parse_type(name: str) -> pa.DataType:
    t = _TYPE_NAMES.get(name.lower())
    if t is None:
        raise SqlError(f"unknown SQL type {name!r}")
    return t


class Parser:
    def __init__(self, sql: str) -> None:
        self.tokens = tokenize(sql)
        self.pos = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.pos + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def at_keyword(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "keyword" and t.value in words

    def eat_keyword(self, *words: str) -> bool:
        if self.at_keyword(*words):
            self.next()
            return True
        return False

    def expect_keyword(self, word: str) -> None:
        if not self.eat_keyword(word):
            t = self.peek()
            raise SqlError(f"expected {word.upper()}, found {t.value!r} at {t.pos}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            t = self.peek()
            raise SqlError(f"expected {op!r}, found {t.value!r} at {t.pos}")

    def expect_ident(self) -> str:
        t = self.peek()
        # allow non-reserved keywords as identifiers where unambiguous
        if self._identish(t):
            self.next()
            return t.value
        raise SqlError(f"expected identifier, found {t.value!r} at {t.pos}")

    @staticmethod
    def _identish(t) -> bool:
        """Identifiers plus non-reserved keywords (words the lexer tokenizes
        as keywords for clause parsing but that remain legal column/table
        names, e.g. a column literally named `cube`)."""
        return t.kind == "ident" or (
            t.kind == "keyword" and t.value in NON_RESERVED
        )

    # -- entry -------------------------------------------------------------
    def parse_statement(self):
        if self.at_keyword("explain"):
            self.next()
            verbose = self.eat_keyword("verbose")
            return ExplainStmt(self.parse_select(), verbose)
        if self.at_keyword("create"):
            return self.parse_create_external_table()
        stmt = self.parse_select()
        self.eat_op(";")
        t = self.peek()
        if t.kind != "eof":
            raise SqlError(f"unexpected trailing input at {t.pos}: {t.value!r}")
        return stmt

    # -- DDL ---------------------------------------------------------------
    def parse_create_external_table(self) -> CreateExternalTableStmt:
        self.expect_keyword("create")
        self.expect_keyword("external")
        self.expect_keyword("table")
        name = self.expect_ident()
        columns: List[Tuple[str, str]] = []
        if self.eat_op("("):
            while True:
                cname = self.expect_ident()
                t = self.peek()
                if t.kind not in ("ident", "keyword"):
                    raise SqlError(f"expected type name at {t.pos}")
                self.next()
                columns.append((cname, t.value))
                # swallow precision args e.g. DECIMAL(12, 2)
                if self.eat_op("("):
                    depth = 1
                    while depth:
                        tt = self.next()
                        if tt.kind == "op" and tt.value == "(":
                            depth += 1
                        elif tt.kind == "op" and tt.value == ")":
                            depth -= 1
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        self.expect_keyword("stored")
        self.expect_keyword("as")
        ft = self.peek()
        self.next()
        file_type = ft.value
        has_header = False
        if self.eat_keyword("with"):
            self.expect_keyword("header")
            self.expect_keyword("row")
            has_header = True
        self.expect_keyword("location")
        loc = self.peek()
        if loc.kind != "string":
            raise SqlError("LOCATION requires a string literal")
        self.next()
        self.eat_op(";")
        return CreateExternalTableStmt(name, columns, file_type, loc.value, has_header)

    # -- SELECT ------------------------------------------------------------
    def parse_select(self) -> SelectStmt:
        stmt = self._parse_select_body()
        while self.at_keyword("union"):
            self.next()
            all_ = self.eat_keyword("all")
            other = self._parse_select_body()
            stmt.union_with.append((other, all_))
        # ORDER BY / LIMIT after unions apply to the whole statement
        self._parse_order_limit(stmt)
        return stmt

    def _parse_select_body(self) -> SelectStmt:
        if self.eat_op("("):
            inner = self.parse_select()
            self.expect_op(")")
            return inner
        self.expect_keyword("select")
        stmt = SelectStmt()
        stmt.distinct = self.eat_keyword("distinct")
        self.eat_keyword("all")
        # projections
        while True:
            if self.at_op("*"):
                self.next()
                stmt.projections.append(("*", None))
            elif (
                self.peek().kind == "ident"
                and self.peek(1).kind == "op" and self.peek(1).value == "."
                and self.peek(2).kind == "op" and self.peek(2).value == "*"
            ):
                rel = self.expect_ident()
                self.next()  # .
                self.next()  # *
                stmt.projections.append((("qualified_star", rel), None))
            else:
                e = self.parse_expr()
                alias = None
                if self.eat_keyword("as"):
                    alias = self._alias_ident()
                elif self.peek().kind == "ident":
                    alias = self.expect_ident()
                stmt.projections.append((e, alias))
            if not self.eat_op(","):
                break
        # FROM
        if self.eat_keyword("from"):
            stmt.from_items.append(self.parse_from_item())
            while self.eat_op(","):
                stmt.from_items.append(self.parse_from_item())
        if self.eat_keyword("where"):
            stmt.where = self.parse_expr()
        if self.eat_keyword("group"):
            self.expect_keyword("by")
            if self.at_keyword("rollup", "cube", "grouping"):
                self._parse_grouping_sets(stmt)
            else:
                while True:
                    stmt.group_by.append(self.parse_expr())
                    if not self.eat_op(","):
                        break
        if self.eat_keyword("having"):
            stmt.having = self.parse_expr()
        self._parse_order_limit(stmt)
        return stmt

    def _alias_ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            self.next()
            return t.value
        raise SqlError(f"expected alias identifier at {t.pos}")

    def _parse_order_limit(self, stmt: SelectStmt) -> None:
        if self.eat_keyword("order"):
            self.expect_keyword("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.eat_keyword("desc"):
                    asc = False
                else:
                    self.eat_keyword("asc")
                nulls_first: Optional[bool] = None
                if self.eat_keyword("nulls"):
                    if self.eat_keyword("first"):
                        nulls_first = True
                    else:
                        self.expect_keyword("last")
                        nulls_first = False
                stmt.order_by.append(OrderItem(e, asc, nulls_first))
                if not self.eat_op(","):
                    break
        if self.eat_keyword("limit"):
            t = self.next()
            if t.kind != "number":
                raise SqlError("LIMIT requires a number")
            stmt.limit = int(t.value)
        if self.eat_keyword("offset"):
            t = self.next()
            if t.kind != "number":
                raise SqlError("OFFSET requires a number")
            stmt.offset = int(t.value)

    # -- FROM --------------------------------------------------------------
    def parse_from_item(self) -> FromItem:
        item = self._parse_table_factor()
        while True:
            if self.at_keyword("join", "inner", "left", "right", "full", "cross"):
                jtype = "inner"
                if self.eat_keyword("cross"):
                    jtype = "cross"
                elif self.eat_keyword("inner"):
                    pass
                elif self.eat_keyword("left"):
                    jtype = "left"
                    self.eat_keyword("outer")
                elif self.eat_keyword("right"):
                    jtype = "right"
                    self.eat_keyword("outer")
                elif self.eat_keyword("full"):
                    jtype = "full"
                    self.eat_keyword("outer")
                self.expect_keyword("join")
                right = self._parse_table_factor()
                cond = None
                if jtype != "cross":
                    self.expect_keyword("on")
                    cond = self.parse_expr()
                item = JoinItem(item, right, jtype, cond)
            else:
                return item

    def _parse_table_factor(self) -> FromItem:
        if self.eat_op("("):
            if self.at_keyword("select"):
                sub = self.parse_select()
                self.expect_op(")")
                self.eat_keyword("as")
                alias = self._alias_ident()
                return SubqueryRef(sub, alias)
            inner = self.parse_from_item()
            self.expect_op(")")
            return inner
        name = self.expect_ident()
        alias = None
        if self.eat_keyword("as"):
            alias = self._alias_ident()
        elif self.peek().kind == "ident":
            alias = self.expect_ident()
        return TableRef(name, alias)

    # -- expressions -------------------------------------------------------
    def parse_expr(self) -> lx.Expr:
        return self._parse_or()

    def _parse_or(self) -> lx.Expr:
        left = self._parse_and()
        while self.eat_keyword("or"):
            left = lx.BinaryExpr(left, "or", self._parse_and())
        return left

    def _parse_and(self) -> lx.Expr:
        left = self._parse_not()
        while self.eat_keyword("and"):
            left = lx.BinaryExpr(left, "and", self._parse_not())
        return left

    def _parse_not(self) -> lx.Expr:
        if self.eat_keyword("not"):
            return lx.Not(self._parse_not())
        return self._parse_comparison()

    def _parse_comparison(self) -> lx.Expr:
        left = self._parse_additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in _CMP_OPS:
                self.next()
                # comparison vs subquery: = (select ...) treated as scalar
                right = self._parse_additive()
                left = lx.BinaryExpr(left, _CMP_OPS[t.value], right)
                continue
            negated = False
            save = self.pos
            if self.eat_keyword("not"):
                negated = True
            if self.eat_keyword("between"):
                low = self._parse_additive()
                self.expect_keyword("and")
                high = self._parse_additive()
                left = lx.Between(left, low, high, negated)
                continue
            if self.eat_keyword("in"):
                self.expect_op("(")
                if self.at_keyword("select"):
                    sub = self.parse_select()
                    self.expect_op(")")
                    node = lx.InSubquery(left, None, negated)  # type: ignore[arg-type]
                    node.stmt = sub  # planned later
                    left = node
                else:
                    values = [self.parse_expr()]
                    while self.eat_op(","):
                        values.append(self.parse_expr())
                    self.expect_op(")")
                    left = lx.InList(left, values, negated)
                continue
            if self.eat_keyword("like"):
                pattern = self._parse_additive()
                escape = None
                if self.eat_keyword("escape"):
                    esc = self.next()
                    escape = esc.value
                if escape is not None:
                    left = lx.Like(left, pattern, negated, escape)
                else:
                    left = lx.BinaryExpr(left, "not_like" if negated else "like", pattern)
                continue
            if negated:
                self.pos = save
                break
            if self.eat_keyword("is"):
                neg = self.eat_keyword("not")
                self.expect_keyword("null")
                left = lx.IsNotNull(left) if neg else lx.IsNull(left)
                continue
            break
        return left

    def _parse_additive(self) -> lx.Expr:
        left = self._parse_multiplicative()
        while True:
            if self.at_op("+", "-", "||"):
                op = self.next().value
                right = self._parse_multiplicative()
                if op == "||":
                    left = lx.ScalarFunction("concat", [left, right])
                else:
                    left = self._fold_date_arith(left, "plus" if op == "+" else "minus", right)
            else:
                return left

    def _fold_date_arith(self, left: lx.Expr, op: str, right: lx.Expr) -> lx.Expr:
        """Fold  date 'lit' +/- interval  at parse time (TPC-H pattern)."""
        if isinstance(right, IntervalLiteral):
            if isinstance(left, lx.Literal) and isinstance(left.value, datetime.date):
                sign = 1 if op == "plus" else -1
                d = _add_interval(left.value, sign * right.months, sign * right.days)
                return lx.Literal(d, pa.date32())
            raise SqlError("interval arithmetic requires a date literal operand")
        if isinstance(left, IntervalLiteral):
            raise SqlError("interval must be the right operand")
        return lx.BinaryExpr(left, op, right)

    def _parse_multiplicative(self) -> lx.Expr:
        left = self._parse_unary()
        while True:
            if self.at_op("*", "/", "%"):
                op = self.next().value
                right = self._parse_unary()
                left = lx.BinaryExpr(
                    left, {"*": "multiply", "/": "divide", "%": "modulo"}[op], right
                )
            else:
                return left

    def _parse_unary(self) -> lx.Expr:
        if self.eat_op("-"):
            e = self._parse_unary()
            if isinstance(e, lx.Literal) and isinstance(e.value, (int, float)):
                return lx.Literal(-e.value, e.dtype)
            return lx.Negative(e)
        if self.eat_op("+"):
            return self._parse_unary()
        return self._parse_primary()

    def _parse_primary(self) -> lx.Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            text = t.value
            if "." in text or "e" in text.lower():
                return lx.Literal(float(text), pa.float64())
            return lx.Literal(int(text), pa.int64())
        if t.kind == "string":
            self.next()
            return lx.Literal(t.value, pa.string())
        if self.at_keyword("null"):
            self.next()
            return lx.Literal(None, pa.null())
        if self.at_keyword("true"):
            self.next()
            return lx.Literal(True, pa.bool_())
        if self.at_keyword("false"):
            self.next()
            return lx.Literal(False, pa.bool_())
        if self.at_keyword("date"):
            self.next()
            s = self.next()
            if s.kind != "string":
                raise SqlError("DATE requires a string literal")
            return lx.Literal(datetime.date.fromisoformat(s.value), pa.date32())
        if self.at_keyword("timestamp"):
            self.next()
            s = self.next()
            if s.kind != "string":
                raise SqlError("TIMESTAMP requires a string literal")
            return lx.Literal(
                datetime.datetime.fromisoformat(s.value), pa.timestamp("us")
            )
        if self.at_keyword("interval"):
            self.next()
            s = self.next()
            if s.kind != "string":
                raise SqlError("INTERVAL requires a string literal")
            unit_t = self.peek()
            if unit_t.kind not in ("ident", "keyword"):
                raise SqlError("INTERVAL requires a unit")
            self.next()
            unit = unit_t.value.lower().rstrip("s")
            qty = int(s.value.strip().split()[0])
            if unit == "year":
                return IntervalLiteral(12 * qty, 0)
            if unit == "month":
                return IntervalLiteral(qty, 0)
            if unit == "day":
                return IntervalLiteral(0, qty)
            if unit == "week":
                return IntervalLiteral(0, 7 * qty)
            raise SqlError(f"unsupported interval unit {unit!r}")
        if self.at_keyword("case"):
            return self._parse_case()
        if self.at_keyword("cast"):
            self.next()
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_keyword("as")
            tt = self.peek()
            if tt.kind not in ("ident", "keyword"):
                raise SqlError(f"expected type name at {tt.pos}")
            self.next()
            if self.eat_op("("):
                depth = 1
                while depth:
                    x = self.next()
                    if x.kind == "op" and x.value == "(":
                        depth += 1
                    elif x.kind == "op" and x.value == ")":
                        depth -= 1
            self.expect_op(")")
            return lx.Cast(inner, parse_type(tt.value))
        if self.at_keyword("extract"):
            self.next()
            self.expect_op("(")
            part = self.next()
            self.expect_keyword("from")
            inner = self.parse_expr()
            self.expect_op(")")
            return lx.ScalarFunction("extract", [lx.Literal(part.value), inner])
        if self.at_keyword("substring"):
            self.next()
            self.expect_op("(")
            inner = self.parse_expr()
            if self.eat_keyword("from"):
                start = self.parse_expr()
                length = None
                if self.eat_keyword("for"):
                    length = self.parse_expr()
            else:
                self.expect_op(",")
                start = self.parse_expr()
                length = None
                if self.eat_op(","):
                    length = self.parse_expr()
            self.expect_op(")")
            args = [inner, start] + ([length] if length is not None else [])
            return lx.ScalarFunction("substring", args)
        if self.at_keyword("exists"):
            self.next()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            node = lx.Exists(None, False)  # type: ignore[arg-type]
            node.stmt = sub
            return node
        if self.eat_op("("):
            if self.at_keyword("select"):
                sub = self.parse_select()
                self.expect_op(")")
                node = lx.ScalarSubquery(None)  # type: ignore[arg-type]
                node.stmt = sub
                return node
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if self._identish(t):
            name = self.expect_ident()
            # function call?
            if self.at_op("("):
                return self._parse_function(name)
            # qualified column a.b
            if self.at_op(".") and self._identish(self.peek(1)):
                self.next()
                col2 = self.expect_ident()
                return lx.Column(col2.lower(), name.lower())
            return lx.Column(name.lower())
        raise SqlError(f"unexpected token {t.value!r} at {t.pos}")

    def _parse_function(self, name: str) -> lx.Expr:
        self.expect_op("(")
        fname = name.lower()
        distinct = False
        args: List[lx.Expr] = []
        if self.at_op("*"):
            self.next()
            self.expect_op(")")
            if fname == "count":
                return lx.AggregateExpr("count", lx.Wildcard())
            raise SqlError(f"{name}(*) not supported")
        if not self.at_op(")"):
            if self.eat_keyword("distinct"):
                distinct = True
            args.append(self.parse_expr())
            while self.eat_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        if self.at_keyword("over"):
            return self._parse_over(fname, args, distinct)
        if fname in lx.AGGREGATE_FUNCTIONS:
            if len(args) != 1:
                raise SqlError(f"{name} takes one argument")
            return lx.AggregateExpr(fname, args[0], distinct)
        if fname in ("row_number", "rank", "dense_rank"):
            raise SqlError(f"{name} requires an OVER clause")
        if distinct:
            raise SqlError("DISTINCT only valid in aggregates")
        return lx.ScalarFunction(fname, args)

    def _parse_over(self, fname, args, distinct):
        if distinct:
            raise SqlError("DISTINCT not supported in window functions")
        self.expect_keyword("over")
        self.expect_op("(")
        partition_by = []
        order_by = []
        if self.eat_keyword("partition"):
            self.expect_keyword("by")
            partition_by.append(self.parse_expr())
            while self.eat_op(","):
                partition_by.append(self.parse_expr())
        if self.eat_keyword("order"):
            self.expect_keyword("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.eat_keyword("desc"):
                    asc = False
                else:
                    self.eat_keyword("asc")
                order_by.append(lx.SortExpr(e, asc, False))
                if not self.eat_op(","):
                    break
        frame = None
        if self.eat_keyword("rows"):
            frame = self._parse_frame("rows")
        elif self.eat_keyword("range"):
            frame = self._parse_frame("range")
        self.expect_op(")")
        arg = args[0] if args else None
        return lx.WindowExpr(fname, arg, partition_by, order_by, frame)

    def _parse_grouping_sets(self, stmt) -> None:
        """GROUP BY ROLLUP(a, b) | CUBE(a, b) | GROUPING SETS ((a, b), (a), ())
        — lowered to explicit index sets over a shared key list."""

        def key_index(e) -> int:
            s = str(e)
            for i, g in enumerate(stmt.group_by):
                if str(g) == s:
                    return i
            stmt.group_by.append(e)
            return len(stmt.group_by) - 1

        if self.eat_keyword("rollup"):
            self.expect_op("(")
            idxs = [key_index(self.parse_expr())]
            while self.eat_op(","):
                idxs.append(key_index(self.parse_expr()))
            self.expect_op(")")
            stmt.grouping_sets = [idxs[:k] for k in range(len(idxs), -1, -1)]
        elif self.eat_keyword("cube"):
            self.expect_op("(")
            idxs = [key_index(self.parse_expr())]
            while self.eat_op(","):
                idxs.append(key_index(self.parse_expr()))
            self.expect_op(")")
            if len(idxs) > 6:
                raise SqlError("CUBE supports at most 6 keys (2^k grouping sets)")
            sets = []
            for mask in range(1 << len(idxs)):
                sets.append([idxs[i] for i in range(len(idxs)) if mask & (1 << i)])
            # conventional order: most-detailed first
            stmt.grouping_sets = sorted(sets, key=len, reverse=True)
        else:
            self.expect_keyword("grouping")
            self.expect_keyword("sets")
            self.expect_op("(")
            stmt.grouping_sets = []
            while True:
                self.expect_op("(")
                one: list = []
                if not self.eat_op(")"):
                    one.append(key_index(self.parse_expr()))
                    while self.eat_op(","):
                        one.append(key_index(self.parse_expr()))
                    self.expect_op(")")
                stmt.grouping_sets.append(one)
                if not self.eat_op(","):
                    break
            self.expect_op(")")

    def _parse_frame(self, mode: str):
        """ROWS|RANGE BETWEEN <bound> AND <bound> | ROWS|RANGE <bound>.
        ROWS offsets are integer row counts; RANGE offsets are numeric
        order-key value deltas."""

        def bound(is_start: bool):
            if self.eat_keyword("unbounded"):
                if self.eat_keyword("preceding"):
                    return None if is_start else ("lo",)
                self.expect_keyword("following")
                return ("hi",) if is_start else None
            if self.eat_keyword("current"):
                self.expect_keyword("row")
                return 0
            k = self.parse_expr()
            ok = isinstance(k, lx.Literal) and (
                isinstance(k.value, int)
                if mode == "rows"
                else isinstance(k.value, (int, float))
            )
            if not ok:
                kind = "an integer" if mode == "rows" else "a numeric"
                raise SqlError(f"{mode.upper()} frame offset must be {kind} literal")
            if self.eat_keyword("preceding"):
                return -k.value
            self.expect_keyword("following")
            return k.value

        if self.eat_keyword("between"):
            start = bound(True)
            self.expect_keyword("and")
            end = bound(False)
        else:
            start = bound(True)
            end = 0  # shorthand: <x> PRECEDING == .. AND CURRENT ROW
        if start == ("hi",) or end == ("lo",):
            raise SqlError("invalid window frame bounds")
        return (mode, start, end)

    def _parse_case(self) -> lx.Expr:
        self.expect_keyword("case")
        base = None
        if not self.at_keyword("when"):
            base = self.parse_expr()
        when_then = []
        while self.eat_keyword("when"):
            w = self.parse_expr()
            self.expect_keyword("then")
            t = self.parse_expr()
            when_then.append((w, t))
        else_expr = None
        if self.eat_keyword("else"):
            else_expr = self.parse_expr()
        self.expect_keyword("end")
        return lx.Case(base, when_then, else_expr)


def _add_interval(d: datetime.date, months: int, days: int) -> datetime.date:
    y = d.year
    m = d.month + months
    y += (m - 1) // 12
    m = (m - 1) % 12 + 1
    day = d.day
    while True:  # clamp day to month length (e.g. Jan 31 + 1 month -> Feb 28)
        try:
            base = datetime.date(y, m, day)
            break
        except ValueError:
            day -= 1
    return base + datetime.timedelta(days=days)


def parse_sql(sql: str):
    return Parser(sql).parse_statement()
