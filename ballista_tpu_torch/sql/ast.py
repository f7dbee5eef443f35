"""SQL statement AST (expressions reuse the logical Expr tree directly)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from ballista_tpu_torch.logical.expr import Expr


class FromItem:
    pass


@dataclass
class TableRef(FromItem):
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef(FromItem):
    stmt: "SelectStmt"
    alias: str


@dataclass
class JoinItem(FromItem):
    left: FromItem
    right: FromItem
    join_type: str  # inner | left | right | full | cross
    condition: Optional[Expr]


@dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = dialect default (asc: last)


@dataclass
class SelectStmt:
    distinct: bool = False
    projections: List[Tuple[Any, Optional[str]]] = field(default_factory=list)
    # each projection: (Expr | "*" | ("qualified_star", rel), alias)
    from_items: List[FromItem] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    union_with: List[Tuple["SelectStmt", bool]] = field(default_factory=list)  # (stmt, all)
    # GROUP BY ROLLUP/CUBE/GROUPING SETS: index lists into group_by, one per
    # grouping set; None = plain GROUP BY
    grouping_sets: Optional[List[List[int]]] = None


@dataclass
class CreateExternalTableStmt:
    name: str
    columns: List[Tuple[str, str]]
    file_type: str
    location: str
    has_header: bool = False


@dataclass
class ExplainStmt:
    stmt: SelectStmt
    verbose: bool = False


class IntervalLiteral(Expr):
    """INTERVAL 'n' unit — only valid in date arithmetic, folded at plan time."""

    def __init__(self, months: int, days: int) -> None:
        self.months = months
        self.days = days

    def __str__(self) -> str:
        return f"INTERVAL {self.months}mo {self.days}d"
