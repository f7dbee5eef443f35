"""DB-API 2.0 (PEP 249) interface — the Python-native counterpart of the
reference's JDBC driver (reference jvm/jdbc/: jdbc:arrow:// over Flight,
Driver.java:34-47, FlightConnection/FlightStatement/FlightPreparedStatement/
FlightResultSet + FlightResultSetMetaData + ResultSetHelper).

    import ballista_tpu_torch.client.dbapi as db
    conn = db.connect(host="localhost", port=50050)
    cur = conn.cursor()
    cur.execute("select l_returnflag, count(*) from lineitem group by 1")
    print(cur.fetchall())

connect(local=True) runs against an in-process engine instead of a cluster.

Coverage mirrors the JDBC driver's surface: the full PEP 249 exception
hierarchy mapped from engine errors, parameterized statements (qmark style,
literal-safe substitution — the PreparedStatement analog), a result-set
metadata/type-mapping matrix (Arrow type -> DBAPI type object + precision /
scale / size, the FlightResultSetMetaData analog), and catalog metadata
(tables / columns, the DatabaseMetaData analog).
"""

from __future__ import annotations

import datetime
import time as _time
from typing import Any, List, Optional, Sequence, Tuple

import pyarrow as pa

apilevel = "2.0"
threadsafety = 1
paramstyle = "qmark"


# --- PEP 249 exception hierarchy ------------------------------------------


class Warning(Exception):  # noqa: A001  (PEP 249 mandates the name)
    pass


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


def _map_error(e: Exception) -> DatabaseError:
    from ballista_tpu_torch import errors as be

    if isinstance(e, (be.SqlError, be.PlanError, be.SchemaError)):
        return ProgrammingError(str(e))
    if isinstance(e, be.RpcError):
        return OperationalError(str(e))
    if isinstance(e, be.SerdeError):
        return InternalError(str(e))
    return DatabaseError(str(e))


# --- PEP 249 type objects + constructors ----------------------------------


class _DBAPIType(frozenset):
    """A type object equal to any of its member type names."""

    def __eq__(self, other):  # type: ignore[override]
        if isinstance(other, _DBAPIType):
            return frozenset.__eq__(self, other)
        return other in self

    def __ne__(self, other):  # type: ignore[override]
        return not self.__eq__(other)

    def __hash__(self):
        return frozenset.__hash__(self)


STRING = _DBAPIType({"string", "large_string", "utf8"})
BINARY = _DBAPIType({"binary", "large_binary", "fixed_size_binary"})
NUMBER = _DBAPIType(
    {"int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
     "uint64", "float", "halffloat", "double", "float32", "float64",
     "decimal128", "decimal256", "bool"}
)
DATETIME = _DBAPIType({"date32", "date64", "timestamp", "time32", "time64"})
ROWID = _DBAPIType(set())

Date = datetime.date
Time = datetime.time
Timestamp = datetime.datetime


def DateFromTicks(ticks: float) -> datetime.date:
    return datetime.date(*_time.localtime(ticks)[:3])


def TimeFromTicks(ticks: float) -> datetime.time:
    return datetime.time(*_time.localtime(ticks)[3:6])


def TimestampFromTicks(ticks: float) -> datetime.datetime:
    return datetime.datetime(*_time.localtime(ticks)[:6])


def Binary(data) -> bytes:
    return bytes(data)


def _type_code(t: pa.DataType) -> _DBAPIType:
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return STRING
    if pa.types.is_binary(t) or pa.types.is_large_binary(t) or pa.types.is_fixed_size_binary(t):
        return BINARY
    if pa.types.is_temporal(t):
        return DATETIME
    return NUMBER


def _describe_field(f: pa.Field) -> Tuple:
    """(name, type_code, display_size, internal_size, precision, scale,
    null_ok) — the Arrow -> DBAPI type-mapping matrix (the JDBC driver's
    FlightResultSetMetaData role)."""
    t = f.type
    precision = scale = None
    try:
        internal = t.bit_width // 8  # fixed-width types only
    except (ValueError, AttributeError):
        internal = None
    if pa.types.is_decimal(t):
        precision, scale = t.precision, t.scale
    elif pa.types.is_floating(t):
        precision = 15 if t == pa.float64() else 7
    elif pa.types.is_integer(t):
        precision = len(str(2 ** (t.bit_width - 1)))
    return (f.name, _type_code(t), None, internal, precision, scale, f.nullable)


# --- statement parameters --------------------------------------------------


def _quote(v: Any) -> str:
    import decimal

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (bytes, bytearray)):
        raise NotSupportedError("binary parameters are not supported in SQL text")
    if isinstance(v, datetime.datetime):
        return "timestamp '" + v.isoformat(sep=" ") + "'"
    if isinstance(v, datetime.date):
        return "date '" + v.isoformat() + "'"
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, (int, float)):
        return repr(v)
    raise ProgrammingError(f"unsupported parameter type {type(v).__name__}")


def _bind(operation: str, parameters: Sequence[Any]) -> str:
    """qmark substitution skipping every construct the SQL lexer treats as
    opaque: '...' literals (with '' escapes), "..." identifiers, -- line
    comments, and /* */ block comments — a naive str.replace corrupts
    queries like WHERE c = 'a?b'."""
    out: List[str] = []
    it = iter(parameters)
    i = 0
    n = len(operation)
    while i < n:
        ch = operation[i]
        if ch == "'" or ch == '"':
            quote = ch
            out.append(ch)
            i += 1
            while i < n:
                out.append(operation[i])
                if operation[i] == quote:
                    if quote == "'" and i + 1 < n and operation[i + 1] == "'":
                        out.append("'")
                        i += 2
                        continue
                    i += 1
                    break
                i += 1
            continue
        if ch == "-" and i + 1 < n and operation[i + 1] == "-":
            end = operation.find("\n", i)
            end = n if end == -1 else end
            out.append(operation[i:end])
            i = end
            continue
        if ch == "/" and i + 1 < n and operation[i + 1] == "*":
            end = operation.find("*/", i + 2)
            end = n if end == -1 else end + 2
            out.append(operation[i:end])
            i = end
            continue
        if ch == "?":
            try:
                out.append(_quote(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters for statement")
            i += 1
            continue
        out.append(ch)
        i += 1
    remaining = sum(1 for _ in it)
    if remaining:
        raise ProgrammingError(f"{remaining} unused parameter(s)")
    return "".join(out)


# --- connection / cursor ---------------------------------------------------


def connect(host: str = "localhost", port: int = 50050, local: bool = False,
            settings=None, device=None) -> "Connection":
    return Connection(host, port, local, settings, device)


class Connection:
    def __init__(self, host: str, port: int, local: bool, settings,
                 device=None) -> None:
        # `device` as ExecutionContext takes it (the GPU unless "cpu")
        if local:
            from ballista_tpu_torch.config import BallistaConfig
            from ballista_tpu_torch.engine import ExecutionContext

            self._ctx = ExecutionContext(BallistaConfig(settings), device=device)
        else:
            from ballista_tpu_torch.client import BallistaContext

            self._ctx = BallistaContext(host, port, settings, device=device)
        self._closed = False

    @property
    def context(self):
        """The underlying context (for table registration)."""
        return self._ctx

    def cursor(self) -> "Cursor":
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def commit(self) -> None:
        pass  # queries are read-only

    def rollback(self) -> None:
        pass

    def close(self) -> None:
        self._closed = True
        close = getattr(self._ctx, "close", None)
        if close:
            close()

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- catalog metadata (the JDBC DatabaseMetaData analog) -----------
    def get_tables(self) -> List[str]:
        return sorted(getattr(self._ctx, "tables", {}).keys())

    def get_columns(self, table: str) -> List[Tuple]:
        src = getattr(self._ctx, "tables", {}).get(table.lower())
        if src is None:
            raise ProgrammingError(f"no table named {table!r}")
        return [_describe_field(f) for f in src.schema()]


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection) -> None:
        self._conn = conn
        self._rows: Optional[List[Tuple]] = None
        self._pos = 0
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1
        self.lastrowid = None

    def execute(self, operation: str, parameters: Optional[Sequence[Any]] = None) -> "Cursor":
        if self._conn._closed:
            raise InterfaceError("connection is closed")
        if parameters is not None:
            operation = _bind(operation, list(parameters))
        try:
            table = self._conn._ctx.sql(operation).collect()
        except Error:
            raise
        except Exception as e:
            raise _map_error(e) from e
        self.description = [_describe_field(f) for f in table.schema]
        cols = [c.to_pylist() for c in table.columns]
        self._rows = list(zip(*cols)) if cols else [()] * table.num_rows
        self.rowcount = table.num_rows
        self._pos = 0
        return self

    def executemany(self, operation: str, seq_of_parameters) -> None:
        for p in seq_of_parameters:
            self.execute(operation, p)

    def fetchone(self) -> Optional[Tuple]:
        if self._rows is None:
            raise InterfaceError("no query executed")
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[Tuple]:
        size = size or self.arraysize
        out = []
        for _ in range(size):
            row = self.fetchone()
            if row is None:
                break
            out.append(row)
        return out

    def fetchall(self) -> List[Tuple]:
        if self._rows is None:
            raise InterfaceError("no query executed")
        out = list(self._rows[self._pos:])
        self._pos = len(self._rows)
        return out

    def nextset(self) -> None:
        return None

    def setinputsizes(self, sizes) -> None:
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass

    def close(self) -> None:
        self._rows = None

    def __enter__(self) -> "Cursor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row
