"""PhysicalExpr -> PyTorch compiler.

Lowers an expression tree to a function evaluated eagerly over device
columns (torch tensors). String semantics run over dictionary codes: equality against a
literal becomes a code comparison, LIKE / IN become boolean table gathers
where the table is computed host-side over the (small) dictionary and passed
as a runtime argument (so a growing dictionary never retraces the program —
tables are padded to power-of-two sizes).

This is where per-row Arrow compute kernels (DataFusion PhysicalExpr) become
branch-free vectorized tensor code. Literals are 0-dim CPU tensors, which
PyTorch combines with tensors on any device in elementwise arithmetic and
comparisons; ``_where`` moves them beside the condition where a select
needs all operands on one device.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.ops.runtime import ColumnDictionary, ScanDictionaries, UnsupportedOnDevice
from ballista_tpu_torch.physical import expr as px

# cols: Dict[int, torch.Tensor]; aux: List[torch.Tensor]
EvalFn = Callable[[Dict[int, "torch.Tensor"], List["torch.Tensor"]], "torch.Tensor"]


class CompiledValue:
    """A lowered expression: fn computes the value; null_fn (when set)
    computes the rows where the SQL value is NULL — three-valued logic
    over dictionary codes, where -1 marks a NULL string. Predicates with
    null_fn carry an UNDEFINED fn value on null rows; consumers must mask
    (predicate_fn collapses to WHERE semantics: NULL -> excluded)."""

    def __init__(self, kind: str, fn: EvalFn,
                 dictionary: Optional[ColumnDictionary] = None,
                 null_fn: Optional[EvalFn] = None) -> None:
        if kind not in ("num", "bool", "code"):
            raise ValueError(f"unknown value kind {kind!r}")
        self.kind = kind
        self.fn = fn
        self.dictionary = dictionary
        self.null_fn = null_fn


def predicate_fn(cv: CompiledValue) -> EvalFn:
    """WHERE-clause collapse of a compiled boolean: rows whose predicate is
    NULL are excluded (SQL three-valued logic)."""
    if cv.null_fn is None:
        return cv.fn
    import torch

    def collapsed(cols, aux, v=cv.fn, n=cv.null_fn):
        return torch.logical_and(v(cols, aux), torch.logical_not(n(cols, aux)))

    return collapsed


class ExprCompiler:
    """Compiles expressions; records which column indices are needed and the
    aux providers (host-side per-batch table builders)."""

    def __init__(self, schema: pa.Schema, dicts: ScanDictionaries) -> None:
        self.schema = schema
        self.dicts = dicts
        self.used_columns: Dict[int, pa.DataType] = {}
        self.aux_providers: List[Callable[[], np.ndarray]] = []

    # ------------------------------------------------------------------
    def _add_aux(self, provider: Callable[[], np.ndarray]) -> int:
        self.aux_providers.append(provider)
        return len(self.aux_providers) - 1

    def build_aux(self) -> List[np.ndarray]:
        return [p() for p in self.aux_providers]

    # ------------------------------------------------------------------
    def compile(self, e: px.PhysicalExpr) -> CompiledValue:
        import torch

        if isinstance(e, px.ColumnExpr):
            idx = e.index
            dtype = self.schema.field(idx).type
            if pa.types.is_dictionary(dtype):
                dtype = dtype.value_type
            self.used_columns[idx] = dtype
            if pa.types.is_string(dtype) or pa.types.is_large_string(dtype):
                d = self.dicts.for_column(idx)
                return CompiledValue("code", lambda cols, aux, i=idx: cols[i], d)
            if pa.types.is_boolean(dtype):
                return CompiledValue("bool", lambda cols, aux, i=idx: cols[i])
            return CompiledValue("num", lambda cols, aux, i=idx: cols[i])

        if isinstance(e, px.LiteralExpr):
            v = e.value
            if isinstance(v, bool):
                return CompiledValue("bool", lambda cols, aux, c=torch.tensor(v): c)
            if isinstance(v, (int, float)):
                dt = torch.float32 if isinstance(v, float) else torch.int32
                return CompiledValue(
                    "num", lambda cols, aux, c=torch.tensor(v, dtype=dt): c
                )
            if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
                days = torch.tensor((v - datetime.date(1970, 1, 1)).days, dtype=torch.int32)
                return CompiledValue("num", lambda cols, aux, c=days: c)
            if isinstance(v, str):
                # bare string literal: only meaningful inside comparisons,
                # which intercept it before compiling this node
                raise UnsupportedOnDevice("free-standing string literal")
            raise UnsupportedOnDevice(f"literal {v!r}")

        if isinstance(e, px.BinaryPhysicalExpr):
            return self._compile_binary(e)

        if isinstance(e, px.NotExpr):
            inner = self.compile(e.expr)
            # Kleene NOT: value flips, NULL stays NULL (NOT over a code
            # predicate must not turn excluded NULL rows into included ones)
            return CompiledValue(
                "bool",
                lambda cols, aux, f=inner.fn: torch.logical_not(f(cols, aux)),
                null_fn=inner.null_fn,
            )

        if isinstance(e, px.NegativeExpr):
            inner = self.compile(e.expr)
            return CompiledValue("num", lambda cols, aux, f=inner.fn: -f(cols, aux))

        if isinstance(e, px.IsNullExpr):
            inner = self.compile(e.expr)
            if inner.kind == "code":
                # dictionary-encoded string columns carry nulls as -1 codes
                # (ColumnDictionary.encode) — IS NULL is a code test
                def isnull_code_fn(cols, aux, f=inner.fn, neg=e.negated):
                    r = f(cols, aux) < 0
                    return torch.logical_not(r) if neg else r

                return CompiledValue("bool", isnull_code_fn)
            # numeric/date/bool device columns are null-free by construction
            # (column_to_numpy rejects nullable batches)
            const = bool(e.negated)  # IS NOT NULL -> True, IS NULL -> False

            def isnull_fn(cols, aux, c=torch.tensor(const)):
                return c

            return CompiledValue("bool", isnull_fn)

        if isinstance(e, px.BetweenExpr):
            v = self.compile(e.expr)
            lo = self.compile(e.low)
            hi = self.compile(e.high)
            if v.kind != "num":
                raise UnsupportedOnDevice("BETWEEN on non-numeric")

            def between_fn(cols, aux, vf=v.fn, lf=lo.fn, hf=hi.fn, neg=e.negated):
                x = vf(cols, aux)
                r = torch.logical_and(x >= lf(cols, aux), x <= hf(cols, aux))
                return torch.logical_not(r) if neg else r

            return CompiledValue("bool", between_fn)

        if isinstance(e, px.InListExpr):
            if e.value_exprs is not None:
                # per-row membership: equality OR-chain on device
                probe = self.compile(e.expr)
                members = [self.compile(ve) for ve in e.value_exprs]
                if probe.kind == "code" or any(m.kind == "code" for m in members):
                    raise UnsupportedOnDevice("expression IN over strings")

                def inlist_expr_fn(cols, aux, pf=probe.fn, ms=members, neg=e.negated):
                    x = pf(cols, aux)
                    r = None
                    for m in ms:
                        eq = x == m.fn(cols, aux)
                        r = eq if r is None else torch.logical_or(r, eq)
                    return torch.logical_not(r) if neg else r

                return CompiledValue("bool", inlist_expr_fn)
            v = self.compile(e.expr)
            if v.kind == "code":
                d = v.dictionary
                values = list(e.values)

                def in_table() -> np.ndarray:
                    from ballista_tpu_torch.ops.runtime import bucket_rows

                    # one consistent view: a concurrent encode() may grow
                    # the dictionary between torn len/values reads
                    vals = d.snapshot()
                    n = max(1, 0 if vals is None else len(vals))
                    table = np.zeros(bucket_rows(n, 16), dtype=np.bool_)
                    if vals is not None:
                        member = pc.is_in(vals, value_set=pa.array(values))
                        table[: len(vals)] = member.to_numpy(zero_copy_only=False)
                    return table

                slot = self._add_aux(in_table)

                def inlist_code_fn(cols, aux, vf=v.fn, s=slot, neg=e.negated):
                    r = aux[s][vf(cols, aux).long()]
                    return torch.logical_not(r) if neg else r

                def inlist_null(cols, aux, vf=v.fn):
                    # NULL IN / NOT IN a non-empty literal list is NULL
                    return vf(cols, aux) < 0

                return CompiledValue("bool", inlist_code_fn, null_fn=inlist_null)
            # numeric IN list -> chained equality
            consts = [self.compile(px.LiteralExpr(x, pa.float64() if isinstance(x, float) else pa.int64())) for x in e.values]

            def inlist_num_fn(cols, aux, vf=v.fn, cs=consts, neg=e.negated):
                x = vf(cols, aux)
                r = torch.zeros_like(x, dtype=torch.bool)
                for c in cs:
                    r = torch.logical_or(r, x == c.fn(cols, aux))
                return torch.logical_not(r) if neg else r

            return CompiledValue("bool", inlist_num_fn)

        if isinstance(e, px.CaseExpr):
            arms = []
            for w, t in e.when_then:
                cw = self.compile(w)
                ct = self.compile(t)
                if e.base is not None:
                    raise UnsupportedOnDevice("CASE base form")
                arms.append((cw, ct))
            celse = self.compile(e.else_expr) if e.else_expr is not None else None

            def case_fn(cols, aux, arms=arms, celse=celse):
                out = (
                    celse.fn(cols, aux)
                    if celse is not None
                    else torch.tensor(0.0, dtype=torch.float32)
                )
                for cw, ct in reversed(arms):
                    # a NULL condition does not match its arm (3VL)
                    out = _where(predicate_fn(cw)(cols, aux), ct.fn(cols, aux), out)
                return out

            kind = arms[0][1].kind
            return CompiledValue(kind, case_fn)

        if isinstance(e, px.CastExpr):
            inner = self.compile(e.expr)
            if pa.types.is_floating(e.dtype):
                return CompiledValue(
                    "num",
                    lambda cols, aux, f=inner.fn: f(cols, aux).to(torch.float32),
                )
            if pa.types.is_integer(e.dtype):
                return CompiledValue(
                    "num",
                    lambda cols, aux, f=inner.fn: f(cols, aux).to(torch.int32),
                )
            raise UnsupportedOnDevice(f"cast to {e.dtype}")

        if isinstance(e, px.ScalarFunctionExpr):
            return self._compile_function(e)

        raise UnsupportedOnDevice(f"expr {type(e).__name__}")

    # ------------------------------------------------------------------
    def _compile_binary(self, e: px.BinaryPhysicalExpr) -> CompiledValue:
        import torch

        op = e.op
        # string comparisons / LIKE against literals -> dictionary space
        if op in ("eq", "neq", "like", "not_like"):
            sv = self._try_string_side(e.left, e.right, op)
            if sv is not None:
                return sv
        if op in ("and", "or"):
            l = self.compile(e.left)
            r = self.compile(e.right)
            jop = torch.logical_and if op == "and" else torch.logical_or
            if l.null_fn is None and r.null_fn is None:
                return CompiledValue(
                    "bool", lambda cols, aux, lf=l.fn, rf=r.fn, j=jop: j(lf(cols, aux), rf(cols, aux))
                )

            # Kleene: AND is NULL unless a side is definitely FALSE; OR is
            # NULL unless a side is definitely TRUE
            def null3(cols, aux, l=l, r=r, is_and=(op == "and")):
                f = torch.tensor(False)
                ln = l.null_fn(cols, aux) if l.null_fn else f
                rn = r.null_fn(cols, aux) if r.null_fn else f
                lv, rv = l.fn(cols, aux), r.fn(cols, aux)
                if is_and:
                    decided = torch.logical_or(
                        torch.logical_and(torch.logical_not(lv), torch.logical_not(ln)),
                        torch.logical_and(torch.logical_not(rv), torch.logical_not(rn)),
                    )
                else:
                    decided = torch.logical_or(
                        torch.logical_and(lv, torch.logical_not(ln)),
                        torch.logical_and(rv, torch.logical_not(rn)),
                    )
                return torch.logical_and(torch.logical_or(ln, rn), torch.logical_not(decided))

            return CompiledValue(
                "bool",
                lambda cols, aux, lf=l.fn, rf=r.fn, j=jop: j(lf(cols, aux), rf(cols, aux)),
                null_fn=null3,
            )
        l = self.compile(e.left)
        r = self.compile(e.right)
        if op in ("eq", "neq") and l.kind == "code" and r.kind == "code":
            if l.dictionary is not r.dictionary:
                raise UnsupportedOnDevice("code comparison across dictionaries")
            fn = (lambda a, b: a == b) if op == "eq" else (lambda a, b: a != b)

            def codecmp_fn(cols, aux, lf=l.fn, rf=r.fn, f=fn):
                return f(lf(cols, aux), rf(cols, aux))

            def codecmp_null(cols, aux, lf=l.fn, rf=r.fn):
                # -1 codes are NULLs: NULL = / <> anything is NULL
                return torch.logical_or(lf(cols, aux) < 0, rf(cols, aux) < 0)

            return CompiledValue("bool", codecmp_fn, null_fn=codecmp_null)
        if l.kind == "code" or r.kind == "code":
            raise UnsupportedOnDevice(f"string operands for {op}")
        cmps = {
            "eq": lambda a, b: a == b,
            "neq": lambda a, b: a != b,
            "lt": lambda a, b: a < b,
            "lteq": lambda a, b: a <= b,
            "gt": lambda a, b: a > b,
            "gteq": lambda a, b: a >= b,
        }
        if op in cmps:
            return CompiledValue(
                "bool",
                lambda cols, aux, lf=l.fn, rf=r.fn, f=cmps[op]: f(lf(cols, aux), rf(cols, aux)),
            )
        ariths = {
            "plus": lambda a, b: a + b,
            "minus": lambda a, b: a - b,
            "multiply": lambda a, b: a * b,
            "divide": lambda a, b: a / b,
            "modulo": lambda a, b: torch.remainder(a, b),
        }
        if op in ariths:
            return CompiledValue(
                "num",
                lambda cols, aux, lf=l.fn, rf=r.fn, f=ariths[op]: f(lf(cols, aux), rf(cols, aux)),
            )
        raise UnsupportedOnDevice(f"binary op {op}")

    def _try_string_side(
        self, left: px.PhysicalExpr, right: px.PhysicalExpr, op: str
    ) -> Optional[CompiledValue]:
        """column-vs-string-literal comparisons in dictionary space."""
        import torch

        col, lit = left, right
        if isinstance(left, px.LiteralExpr) and isinstance(left.value, str):
            col, lit = right, left
        if not (isinstance(lit, px.LiteralExpr) and isinstance(lit.value, str)):
            return None
        cv = self.compile(col)
        if cv.kind != "code":
            raise UnsupportedOnDevice("string literal vs non-string column")
        d = cv.dictionary
        pattern = lit.value

        if op in ("eq", "neq"):
            code_slot = self._add_aux(
                lambda d=d, v=pattern: np.asarray(d.code_of(v), dtype=np.int32)
            )

            def eq_fn(cols, aux, f=cv.fn, s=code_slot, neg=(op == "neq")):
                r = f(cols, aux) == aux[s]
                return torch.logical_not(r) if neg else r

            # NULL (= code -1) compares as NULL, under = and <> alike
            def eq_null(cols, aux, f=cv.fn):
                return f(cols, aux) < 0

            return CompiledValue("bool", eq_fn, null_fn=eq_null)

        # LIKE via host-computed match table over the dictionary
        def like_table(d=d, pattern=pattern) -> np.ndarray:
            from ballista_tpu_torch.ops.runtime import bucket_rows

            # one consistent view (see in_table)
            vals = d.snapshot()
            n = max(1, 0 if vals is None else len(vals))
            table = np.zeros(bucket_rows(n, 16), dtype=np.bool_)
            if vals is not None:
                m = pc.match_like(vals, pattern)
                table[: len(vals)] = pc.fill_null(m, False).to_numpy(zero_copy_only=False)
            return table

        slot = self._add_aux(like_table)

        def like_fn(cols, aux, f=cv.fn, s=slot, neg=(op == "not_like")):
            # the -1 gather wraps to the table's last entry; null rows are
            # UNDEFINED here and masked by null_fn at the consumer
            r = aux[s][f(cols, aux).long()]
            return torch.logical_not(r) if neg else r

        def like_null(cols, aux, f=cv.fn):
            # NULL LIKE / NOT LIKE is NULL
            return f(cols, aux) < 0

        return CompiledValue("bool", like_fn, null_fn=like_null)

    # ------------------------------------------------------------------
    def _compile_function(self, e: px.ScalarFunctionExpr) -> CompiledValue:
        import torch

        fn = e.fn
        unary = {
            "sqrt": torch.sqrt, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
            "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
            "exp": torch.exp, "ln": torch.log, "log2": torch.log2, "log10": torch.log10,
            "log": torch.log10, "floor": torch.floor, "ceil": torch.ceil,
            "round": torch.round, "trunc": torch.trunc, "abs": torch.abs,
            "signum": torch.sign,
        }
        if fn in unary:
            inner = self.compile(e.args[0])
            return CompiledValue(
                "num", lambda cols, aux, f=inner.fn, j=unary[fn]: j(f(cols, aux))
            )
        if fn in ("extract", "date_part"):
            part = e.args[0]
            if not isinstance(part, px.LiteralExpr):
                raise UnsupportedOnDevice("extract part must be literal")
            inner = self.compile(e.args[1])
            pname = str(part.value).lower()
            if pname == "year":
                return CompiledValue(
                    "num",
                    lambda cols, aux, f=inner.fn: _civil_from_days(f(cols, aux))[0],
                )
            if pname == "month":
                return CompiledValue(
                    "num",
                    lambda cols, aux, f=inner.fn: _civil_from_days(f(cols, aux))[1],
                )
            if pname == "day":
                return CompiledValue(
                    "num",
                    lambda cols, aux, f=inner.fn: _civil_from_days(f(cols, aux))[2],
                )
            raise UnsupportedOnDevice(f"extract {pname}")
        if fn == "coalesce":
            first = None
            for a in e.args:
                if isinstance(a, px.LiteralExpr) and isinstance(a.value, str):
                    # string-literal fallback: needs the first code arg's dict
                    if first is None or first.kind != "code":
                        raise UnsupportedOnDevice("coalesce string literal first")
                    d = first.dictionary
                    slot = self._add_aux(
                        lambda d=d, v=a.value: np.asarray(d.code_of(v), dtype=np.int32)
                    )

                    def coalesce_lit_fn(cols, aux, f=first.fn, nf=first.null_fn, s=slot):
                        c = f(cols, aux)
                        return _where(c >= 0, c, aux[s])

                    return CompiledValue("code", coalesce_lit_fn, first.dictionary)
                cv = self.compile(a)
                if first is None:
                    first = cv
                    if cv.kind != "code":
                        # numeric/bool device columns are null-free: first
                        # argument wins outright
                        return cv
                    continue
                if cv.kind != "code" or cv.dictionary is not first.dictionary:
                    raise UnsupportedOnDevice("coalesce across dictionaries")

                def coalesce_fn(cols, aux, f=first.fn, g=cv.fn):
                    c = f(cols, aux)
                    return _where(c >= 0, c, g(cols, aux))

                def coalesce_null(cols, aux, f=first.fn, g=cv.fn):
                    return torch.logical_and(f(cols, aux) < 0, g(cols, aux) < 0)

                first = CompiledValue("code", coalesce_fn, first.dictionary,
                                      null_fn=coalesce_null)
            if first is None:
                raise UnsupportedOnDevice("empty coalesce")
            return first
        raise UnsupportedOnDevice(f"scalar function {fn}")


def _where(cond, a, b):
    """torch.where with 0-dim operands (literals) moved beside `cond`."""
    import torch

    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b)
    if a.device != cond.device:
        a = a.to(cond.device)
    if b.device != cond.device:
        b = b.to(cond.device)
    return torch.where(cond, a, b)


def _civil_from_days(days):
    """Howard Hinnant's civil_from_days: days since 1970-01-01 -> (y, m, d).
    Pure integer arithmetic."""
    import torch

    fd = torch.floor_divide
    z = days.to(torch.int32) + 719468
    era = fd(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = fd(doe - fd(doe, 1460) + fd(doe, 36524) - fd(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fd(yoe, 4) - fd(yoe, 100))
    mp = fd(5 * doy + 2, 153)
    d = doy - fd(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(torch.int32)
    return y, m, d
