"""SQL -> LogicalPlan planner.

Covers the full TPC-H q1-q22 surface:
- comma-style FROM lists with join-graph ordering (equi predicates pulled from
  WHERE become join keys; single-relation predicates push to their scan side
  before joining — essential at SF>=1)
- explicit JOIN ... ON, cross joins, derived tables
- aggregate extraction + post-aggregate expression rewriting (SELECT/HAVING/
  ORDER BY over aggregate results)
- subquery decorrelation: uncorrelated IN -> SEMI join, NOT IN -> ANTI,
  correlated EXISTS/NOT EXISTS -> SEMI/ANTI on correlation keys, correlated
  scalar-aggregate subqueries -> grouped aggregate + INNER join (q2/q17-style),
  uncorrelated scalar subqueries -> single-row aggregate + cross join.

The reference gets all of this from DataFusion's SQL frontend; it is built
natively here (SQL entry at reference rust/scheduler/src/lib.rs:236-249,
client side rust/client/src/context.rs:131-143).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import pyarrow as pa

from ballista_tpu_torch.errors import PlanError, SchemaError, SqlError
from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.logical import plan as lp
from ballista_tpu_torch.sql import ast as sa
from ballista_tpu_torch.sql.parser import parse_sql, parse_type


def plan_sql(query: str, ctx) -> lp.LogicalPlan:
    stmt = parse_sql(query)
    if isinstance(stmt, sa.CreateExternalTableStmt):
        schema = None
        if stmt.columns:
            schema = pa.schema(
                [pa.field(n, parse_type(t)) for n, t in stmt.columns]
            )
        return lp.CreateExternalTable(
            stmt.name, stmt.location, stmt.file_type, stmt.has_header, schema
        )
    if isinstance(stmt, sa.ExplainStmt):
        inner = SelectPlanner(ctx).plan(stmt.stmt)
        return lp.Explain(inner, stmt.verbose)
    return SelectPlanner(ctx).plan(stmt)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def split_conjuncts(e: Optional[lx.Expr]) -> List[lx.Expr]:
    if e is None:
        return []
    if isinstance(e, lx.BinaryExpr) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def conjoin(exprs: Sequence[lx.Expr]) -> Optional[lx.Expr]:
    out: Optional[lx.Expr] = None
    for e in exprs:
        out = e if out is None else lx.BinaryExpr(out, "and", e)
    return out


def factor_or_common(e: lx.Expr) -> List[lx.Expr]:
    """(A and X) or (A and Y) -> [A, (X or Y)].

    Lifts conjuncts common to every OR branch to the top level, so equi-join
    keys hidden inside each disjunct become visible to join planning. q19's
    WHERE is the canonical shape: all three OR branches repeat
    `p_partkey = l_partkey` (+ shipmode/shipinstruct filters); without
    factoring the whole predicate lands post-join and the join degrades to a
    cartesian product (8.7 TiB of pairs at SF=1). Same rewrite DataFusion
    applies before join-key extraction. Returns the conjunct list (the input
    unchanged, as a 1-list, when nothing factors).
    """
    if not (isinstance(e, lx.BinaryExpr) and e.op == "or"):
        return [e]

    branches: List[lx.Expr] = []

    def flat_or(x: lx.Expr) -> None:
        if isinstance(x, lx.BinaryExpr) and x.op == "or":
            flat_or(x.left)
            flat_or(x.right)
        else:
            branches.append(x)

    flat_or(e)
    branch_conjs = [split_conjuncts(b) for b in branches]
    # conjuncts present (by structural string) in every branch
    keyed = [{str(c): c for c in bc} for bc in branch_conjs]
    common_keys = set(keyed[0])
    for k in keyed[1:]:
        common_keys &= set(k)
    if not common_keys:
        return [e]
    common = [c for key, c in keyed[0].items() if key in common_keys]
    residuals: List[Optional[lx.Expr]] = []
    for bc in branch_conjs:
        seen: Set[str] = set()
        rest = []
        for c in bc:
            # drop only ONE occurrence per common key (duplicates stay)
            if str(c) in common_keys and str(c) not in seen:
                seen.add(str(c))
                continue
            rest.append(c)
        residuals.append(conjoin(rest))
    if any(r is None for r in residuals):
        # some branch was exactly the common part: A or (A and X) = A
        return common
    disj: lx.Expr = residuals[0]
    for r in residuals[1:]:
        disj = lx.BinaryExpr(disj, "or", r)
    return common + [disj]


def collect_columns(e: lx.Expr, out: List[lx.Column]) -> None:
    if isinstance(e, lx.Column):
        out.append(e)
    for c in e.children():
        collect_columns(c, out)


def contains_subquery(e: lx.Expr) -> bool:
    if isinstance(e, (lx.ScalarSubquery, lx.InSubquery, lx.Exists)):
        return True
    return any(contains_subquery(c) for c in e.children())


def collect_aggregates(e: lx.Expr, out: List[lx.AggregateExpr]) -> None:
    if isinstance(e, lx.WindowExpr):
        return  # window-function internals are not GROUP BY aggregates
    if isinstance(e, lx.AggregateExpr):
        if not any(a.equals(e) for a in out):
            out.append(e)
        return
    for c in e.children():
        collect_aggregates(c, out)


def collect_windows(e: lx.Expr, out: List["lx.WindowExpr"]) -> None:
    if isinstance(e, lx.WindowExpr):
        if not any(str(w) == str(e) for w in out):
            out.append(e)
        return
    for c in e.children():
        collect_windows(c, out)


def _contains_grouping(e: lx.Expr) -> bool:
    if isinstance(e, lx.ScalarFunction) and e.fn == "grouping":
        return True
    return any(
        isinstance(c, lx.Expr) and _contains_grouping(c) for c in e.children()
    )


def dataclasses_replace_projections(stmt, mapping):
    """stmt copy with the mapping applied to projections, having, order by."""
    import dataclasses

    return dataclasses.replace(
        stmt,
        projections=[
            (rewrite_expr(e, mapping) if isinstance(e, lx.Expr) else e, a)
            for e, a in stmt.projections
        ],
        having=None if stmt.having is None else rewrite_expr(stmt.having, mapping),
        order_by=[
            dataclasses.replace(oi, expr=rewrite_expr(oi.expr, mapping))
            for oi in stmt.order_by
        ],
    )


def _null_out(e: lx.Expr, excluded_strs) -> lx.Expr:
    """Replace references to excluded group keys with NULL (grouping-set
    branches); NULL propagates through enclosing expressions. Aggregate
    arguments are protected: super-aggregate rows aggregate the REAL column
    (count(r) in the grand total counts every non-null r, per the standard),
    only the group-key projection of r becomes NULL."""
    if not excluded_strs:
        return e
    aggs: List[lx.AggregateExpr] = []
    collect_aggregates(e, aggs)
    hide = {str(a): lx.Column(f"__gs_protect_{i}") for i, a in enumerate(aggs)}
    unhide = {str(c): a for a, c in zip(aggs, hide.values())}
    e = rewrite_expr(e, hide)
    e = rewrite_expr(e, {s: lx.Literal(None, pa.null()) for s in excluded_strs})
    return rewrite_expr(e, unhide)


def rewrite_expr(e: lx.Expr, mapping: Dict[str, lx.Expr]) -> lx.Expr:
    """Replace any subtree whose str() matches a mapping key."""
    key = str(e)
    if key in mapping:
        return mapping[key]
    if isinstance(e, lx.Alias):
        return lx.Alias(rewrite_expr(e.expr, mapping), e.name)
    if isinstance(e, lx.BinaryExpr):
        return lx.BinaryExpr(
            rewrite_expr(e.left, mapping), e.op, rewrite_expr(e.right, mapping)
        )
    if isinstance(e, lx.Not):
        return lx.Not(rewrite_expr(e.expr, mapping))
    if isinstance(e, lx.Negative):
        return lx.Negative(rewrite_expr(e.expr, mapping))
    if isinstance(e, lx.IsNull):
        return lx.IsNull(rewrite_expr(e.expr, mapping))
    if isinstance(e, lx.IsNotNull):
        return lx.IsNotNull(rewrite_expr(e.expr, mapping))
    if isinstance(e, lx.Between):
        return lx.Between(
            rewrite_expr(e.expr, mapping),
            rewrite_expr(e.low, mapping),
            rewrite_expr(e.high, mapping),
            e.negated,
        )
    if isinstance(e, lx.InList):
        return lx.InList(
            rewrite_expr(e.expr, mapping),
            [rewrite_expr(v, mapping) for v in e.values],
            e.negated,
        )
    if isinstance(e, lx.Like):
        return lx.Like(
            rewrite_expr(e.expr, mapping),
            rewrite_expr(e.pattern, mapping),
            e.negated,
            e.escape,
        )
    if isinstance(e, lx.Case):
        return lx.Case(
            None if e.expr is None else rewrite_expr(e.expr, mapping),
            [
                (rewrite_expr(w, mapping), rewrite_expr(t, mapping))
                for w, t in e.when_then
            ],
            None if e.else_expr is None else rewrite_expr(e.else_expr, mapping),
        )
    if isinstance(e, lx.TryCast):
        return lx.TryCast(rewrite_expr(e.expr, mapping), e.dtype)
    if isinstance(e, lx.Cast):
        return lx.Cast(rewrite_expr(e.expr, mapping), e.dtype)
    if isinstance(e, lx.ScalarFunction):
        return lx.ScalarFunction(e.fn, [rewrite_expr(a, mapping) for a in e.args])
    if isinstance(e, lx.SortExpr):
        return lx.SortExpr(rewrite_expr(e.expr, mapping), e.ascending, e.nulls_first)
    if isinstance(e, lx.AggregateExpr):
        return lx.AggregateExpr(e.fn, rewrite_expr(e.expr, mapping), e.distinct)
    if isinstance(e, lx.WindowExpr):
        return lx.WindowExpr(
            e.fn,
            None if e.arg is None else rewrite_expr(e.arg, mapping),
            [rewrite_expr(p, mapping) for p in e.partition_by],
            [rewrite_expr(o, mapping) for o in e.order_by],
            e.frame,
        )
    return e


def _resolves_in(col: lx.Column, schema: pa.Schema) -> bool:
    try:
        col.index_in(schema)
        return True
    except SchemaError:
        return False


def _expr_resolves(e: lx.Expr, schema: pa.Schema) -> bool:
    """True when every column reference under e resolves against schema.
    Walks the tree explicitly — data_type() can short-circuit (boolean
    BinaryExprs return bool without resolving their children)."""
    if isinstance(e, lx.Column):
        return _resolves_in(e, schema)
    return all(_expr_resolves(c, schema) for c in e.children())


# ---------------------------------------------------------------------------
# SelectPlanner
# ---------------------------------------------------------------------------


class SelectPlanner:
    def __init__(self, ctx, outer_schema: Optional[pa.Schema] = None) -> None:
        self.ctx = ctx
        self.outer_schema = outer_schema

    # -- entry -------------------------------------------------------------
    def _plan_core(self, stmt: sa.SelectStmt) -> lp.LogicalPlan:
        """One statement body, grouping sets included (no union/order)."""
        if stmt.grouping_sets is not None:
            return self._plan_grouping_sets(stmt)
        return self._plan_body(stmt)

    def plan(self, stmt: sa.SelectStmt) -> lp.LogicalPlan:
        plan = self._plan_core(stmt)
        if stmt.union_with:
            branches = [plan]
            all_flags = []
            for sub, all_ in stmt.union_with:
                branches.append(self._plan_core(sub))
                all_flags.append(all_)
            # normalize field names to the first branch's
            base_schema = branches[0].schema()
            for b in branches[1:]:
                if len(b.schema()) != len(base_schema):
                    raise SqlError(
                        f"UNION branches have different column counts: "
                        f"{len(base_schema)} vs {len(b.schema())}"
                    )
            norm = [branches[0]]
            for b in branches[1:]:
                if b.schema().names != base_schema.names:
                    exprs = []
                    for f_out, f_in in zip(base_schema, b.schema()):
                        bare = f_in.name.split(".")[-1]
                        rel = f_in.name.split(".")[0] if "." in f_in.name else None
                        exprs.append(lx.Alias(lx.Column(bare, rel), f_out.name))
                    b = lp.Projection(b, exprs)
                norm.append(b)
            u: lp.LogicalPlan = lp.Union(norm, all=True)
            if not all(all_flags):
                u = lp.Distinct(u)
            plan = u
        plan = self._apply_order_limit(plan, stmt)
        return plan

    # -- grouping sets ------------------------------------------------------
    def _plan_grouping_sets(self, stmt: sa.SelectStmt) -> lp.LogicalPlan:
        """ROLLUP/CUBE/GROUPING SETS lower to a UNION ALL of one aggregation
        per grouping set; group keys excluded from a set project as typed
        NULLs (references to them inside expressions become NULL and
        propagate), and GROUPING(key) markers resolve to 0/1 per set."""
        import dataclasses

        def resolve_grouping_markers(e: lx.Expr, excluded_strs) -> lx.Expr:
            """GROUPING(key) -> 1 when the key is aggregated away in this
            grouping set, else 0 (the standard's super-aggregate marker)."""
            mapping = {}
            for g in stmt.group_by:
                marker = lx.ScalarFunction("grouping", [g])
                mapping[str(marker)] = lx.Literal(
                    1 if str(g) in excluded_strs else 0, pa.int64()
                )
            return rewrite_expr(e, mapping)

        # probe: the full-key variant fixes the output schema (types for the
        # NULL fills and the union contract)
        probe = dataclasses.replace(
            stmt,
            projections=[
                (resolve_grouping_markers(e, set()) if isinstance(e, lx.Expr) else e,
                 a)
                for e, a in stmt.projections
            ],
            having=(
                resolve_grouping_markers(stmt.having, set())
                if stmt.having is not None
                else None
            ),
            grouping_sets=None, order_by=[], limit=None, offset=0,
            union_with=[],
        )
        probe_plan = self._plan_body(probe)
        out_schema = probe_plan.schema()

        if any(not isinstance(e, lx.Expr) for e, _ in stmt.projections):
            raise SqlError("SELECT * is not valid with grouping sets")
        if len(out_schema) != len(stmt.projections):
            raise SqlError("grouping sets cannot resolve the select list")

        branches: List[lp.LogicalPlan] = []
        all_keys = set(range(len(stmt.group_by)))
        for s in stmt.grouping_sets:
            if set(s) == all_keys:
                # the probe IS the full-key branch (ROLLUP/CUBE always have
                # one); don't plan the most expensive branch twice
                branches.append(probe_plan)
                continue
            excluded = {
                str(stmt.group_by[i])
                for i in range(len(stmt.group_by))
                if i not in s
            }
            # cast + alias every entry to the probe's field so all branches
            # share one schema (names AND types) for the union
            projections = []
            for (e, _alias), f_out in zip(stmt.projections, out_schema):
                e2 = _null_out(resolve_grouping_markers(e, excluded), excluded)
                projections.append((lx.Alias(lx.Cast(e2, f_out.type), f_out.name), None))
            having = (
                _null_out(resolve_grouping_markers(stmt.having, excluded), excluded)
                if stmt.having is not None
                else None
            )
            variant = dataclasses.replace(
                stmt,
                projections=projections,
                group_by=[stmt.group_by[i] for i in s],
                having=having,
                grouping_sets=None,
                order_by=[],
                limit=None,
                offset=0,
                union_with=[],
            )
            branches.append(self._plan_body(variant))
        # ORDER BY on the union resolves selected expressions to the shared
        # output columns (per-branch aggregate mappings don't apply)
        self._order_mapping = {
            str(e): lx.Column(f_out.name)
            for (e, _a), f_out in zip(stmt.projections, out_schema)
        }
        return lp.Union(branches, all=True)

    # -- body (no union/order/limit) ---------------------------------------
    def _plan_body(self, stmt: sa.SelectStmt) -> lp.LogicalPlan:
        # GROUPING(key) under plain GROUP BY is constantly 0; anything the
        # grouping-sets rewrite didn't resolve (non-key argument, no GROUP
        # BY) must fail here with a clear message rather than at execution
        if any(
            _contains_grouping(e)
            for e, _ in stmt.projections
            if isinstance(e, lx.Expr)
        ) or (stmt.having is not None and _contains_grouping(stmt.having)):
            zeros = {
                str(lx.ScalarFunction("grouping", [g])): lx.Literal(0, pa.int64())
                for g in stmt.group_by
            }
            stmt = dataclasses_replace_projections(stmt, zeros)
            for e, _ in stmt.projections:
                if isinstance(e, lx.Expr) and _contains_grouping(e):
                    raise SqlError(
                        "GROUPING() takes a grouping key and requires GROUP BY"
                    )
            if stmt.having is not None and _contains_grouping(stmt.having):
                raise SqlError(
                    "GROUPING() takes a grouping key and requires GROUP BY"
                )
        # 1. FROM + WHERE with join-graph ordering
        plan = self._plan_from_where(stmt)

        # 2. aggregate extraction
        aggs: List[lx.AggregateExpr] = []
        select_exprs: List[lx.Expr] = []
        for proj, alias in stmt.projections:
            # note: proj may be an Expr whose __eq__ is overloaded; compare
            # types first
            if isinstance(proj, str) and proj == "*":
                for f in plan.schema():
                    bare = f.name.split(".")[-1]
                    rel = f.name.split(".")[0] if "." in f.name else None
                    select_exprs.append(lx.Column(bare, rel))
                continue
            if isinstance(proj, tuple) and proj[0] == "qualified_star":
                rel = proj[1]
                for f in plan.schema():
                    if f.name.startswith(rel + "."):
                        select_exprs.append(lx.Column(f.name.split(".")[-1], rel))
                continue
            e = proj
            if alias:
                e = lx.Alias(e, alias)
            select_exprs.append(e)

        for e in select_exprs:
            collect_aggregates(e, aggs)
        if stmt.having is not None:
            collect_aggregates(stmt.having, aggs)
        for oi in stmt.order_by:
            collect_aggregates(oi.expr, aggs)

        group_exprs = self._resolve_group_by(stmt.group_by, select_exprs)

        if aggs or group_exprs:
            plan, mapping = self._plan_aggregate(plan, group_exprs, aggs)
            select_exprs = [rewrite_expr(e, mapping) for e in select_exprs]
            if stmt.having is not None:
                having = rewrite_expr(stmt.having, mapping)
                plain_having = []
                for c in split_conjuncts(having):
                    if contains_subquery(c):
                        plan = self._apply_subquery_conjunct(plan, c)
                    else:
                        plain_having.append(c)
                if plain_having:
                    plan = lp.Filter(plan, conjoin(plain_having))
            self._order_mapping = mapping
        else:
            if stmt.having is not None:
                raise SqlError("HAVING requires GROUP BY or aggregates")
            self._order_mapping = {}

        # window functions evaluate over the (post-aggregate) relation
        wexprs: List[lx.Expr] = []
        for e in select_exprs:
            collect_windows(e, wexprs)
        if wexprs:
            plan = lp.Window(plan, wexprs)
            wmap = {str(w): lx.Column(w.output_name()) for w in wexprs}
            select_exprs = [rewrite_expr(e, wmap) for e in select_exprs]
            self._order_mapping.update(wmap)

        plan = lp.Projection(plan, select_exprs)
        if stmt.distinct:
            plan = lp.Distinct(plan)
        return plan

    def _apply_order_limit(self, plan: lp.LogicalPlan, stmt: sa.SelectStmt) -> lp.LogicalPlan:
        if stmt.order_by:
            out_schema = plan.schema()
            sort_exprs = []
            mapping = getattr(self, "_order_mapping", {})
            # ORDER BY may reference input columns/exprs the SELECT list
            # dropped (standard SQL): append them to the projection as
            # hidden sort columns, sort, then strip. DISTINCT keeps the
            # strict rule (hidden columns would change its semantics).
            base_proj = plan if isinstance(plan, lp.Projection) else None
            hidden: List[lx.Expr] = []
            for hi, oi in enumerate(stmt.order_by):
                e = oi.expr
                # ordinal reference: ORDER BY 1
                if isinstance(e, lx.Literal) and isinstance(e.value, int):
                    idx = e.value - 1
                    if not (0 <= idx < len(out_schema)):
                        raise SqlError(f"ORDER BY position {e.value} out of range")
                    f = out_schema.field(idx)
                    e = lx.Column(f.name.split(".")[-1],
                                  f.name.split(".")[0] if "." in f.name else None)
                else:
                    e = rewrite_expr(e, mapping)
                    if not _expr_resolves(e, out_schema):
                        if base_proj is not None and _expr_resolves(
                            e, base_proj.input.schema()
                        ):
                            name = f"__sort_{hi}"
                            hidden.append(lx.Alias(e, name))
                            e = lx.Column(name)
                        else:
                            raise SqlError(
                                f"ORDER BY expression {e!s} not in output"
                            )
                nf = oi.nulls_first if oi.nulls_first is not None else False
                sort_exprs.append(lx.SortExpr(e, oi.ascending, nf))
            if hidden:
                visible = [f.name for f in out_schema]
                plan = lp.Projection(base_proj.input, list(base_proj.exprs) + hidden)
                plan = lp.Sort(plan, sort_exprs)
                plan = lp.Projection(
                    plan, [lx.Alias(lx.Column(n), n) for n in visible]
                )
            else:
                plan = lp.Sort(plan, sort_exprs)
        if stmt.limit is not None:
            plan = lp.Limit(plan, stmt.limit, stmt.offset)
        return plan

    # -- FROM/WHERE --------------------------------------------------------
    def _plan_from_item(self, item: sa.FromItem) -> List[Tuple[str, lp.LogicalPlan]]:
        """Returns [(alias, plan)] — JoinItems collapse into one entry."""
        if isinstance(item, sa.TableRef):
            src = self.ctx.tables.get(item.name.lower())
            if src is None:
                raise SqlError(f"table {item.name!r} not found")
            alias = (item.alias or item.name).lower()
            scan = lp.TableScan(item.name.lower(), src)
            return [(alias, lp.SubqueryAlias(scan, alias))]
        if isinstance(item, sa.SubqueryRef):
            sub = SelectPlanner(self.ctx).plan(item.stmt)
            return [(item.alias.lower(), lp.SubqueryAlias(sub, item.alias.lower()))]
        if isinstance(item, sa.JoinItem):
            left_rels = self._plan_from_item(item.left)
            right_rels = self._plan_from_item(item.right)
            left = left_rels[0][1] if len(left_rels) == 1 else None
            right = right_rels[0][1] if len(right_rels) == 1 else None
            assert left is not None and right is not None, "nested join lists"
            alias = f"{left_rels[0][0]}+{right_rels[0][0]}"
            if item.join_type == "cross" or item.condition is None:
                return [(alias, lp.CrossJoin(left, right))]
            keys, residual = self._split_join_condition(
                item.condition, left.schema(), right.schema()
            )
            jt = {
                "inner": lp.JoinType.INNER,
                "left": lp.JoinType.LEFT,
                "right": lp.JoinType.RIGHT,
                "full": lp.JoinType.FULL,
            }[item.join_type]
            if jt in (lp.JoinType.LEFT, lp.JoinType.RIGHT, lp.JoinType.FULL):
                # ON-residuals of an outer join must filter the nullable side
                # BEFORE joining (filtering after would turn it inner)
                kept: List[lx.Expr] = []
                for c in residual:
                    cols: List[lx.Column] = []
                    collect_columns(c, cols)
                    if jt == lp.JoinType.LEFT and all(
                        _resolves_in(x, right.schema()) for x in cols
                    ):
                        right = lp.Filter(right, c)
                    elif jt == lp.JoinType.RIGHT and all(
                        _resolves_in(x, left.schema()) for x in cols
                    ):
                        left = lp.Filter(left, c)
                    else:
                        kept.append(c)
                if kept:
                    raise SqlError(
                        f"unsupported ON condition for {jt.value} join: {kept[0]}"
                    )
                residual = []
            if keys:
                join = lp.Join(left, right, keys, jt, conjoin(residual))
            else:
                if jt != lp.JoinType.INNER:
                    raise SqlError("non-equi outer joins not supported")
                j: lp.LogicalPlan = lp.CrossJoin(left, right)
                cond = conjoin(residual)
                join = lp.Filter(j, cond) if cond is not None else j
            return [(alias, join)]
        raise SqlError(f"unsupported FROM item {item!r}")

    def _split_join_condition(
        self, cond: lx.Expr, lschema: pa.Schema, rschema: pa.Schema
    ) -> Tuple[List[Tuple[lx.Column, lx.Column]], List[lx.Expr]]:
        keys: List[Tuple[lx.Column, lx.Column]] = []
        residual: List[lx.Expr] = []
        for c in split_conjuncts(cond):
            if (
                isinstance(c, lx.BinaryExpr)
                and c.op == "eq"
                and isinstance(c.left, lx.Column)
                and isinstance(c.right, lx.Column)
            ):
                if _resolves_in(c.left, lschema) and _resolves_in(c.right, rschema):
                    keys.append((c.left, c.right))
                    continue
                if _resolves_in(c.right, lschema) and _resolves_in(c.left, rschema):
                    keys.append((c.right, c.left))
                    continue
            residual.append(c)
        return keys, residual

    def _plan_from_where(self, stmt: sa.SelectStmt) -> lp.LogicalPlan:
        if not stmt.from_items:
            plan: lp.LogicalPlan = lp.EmptyRelation(produce_one_row=True)
            if stmt.where is not None:
                plan = lp.Filter(plan, stmt.where)
            return plan

        rels: List[Tuple[str, lp.LogicalPlan]] = []
        for item in stmt.from_items:
            rels.extend(self._plan_from_item(item))

        conjuncts = [
            f for c in split_conjuncts(stmt.where) for f in factor_or_common(c)
        ]
        subquery_conjuncts = [c for c in conjuncts if contains_subquery(c)]
        plain = [c for c in conjuncts if not contains_subquery(c)]

        # classify plain conjuncts by referenced relations
        rel_schemas = {a: p.schema() for a, p in rels}

        def rels_of(e: lx.Expr) -> Set[str]:
            cols: List[lx.Column] = []
            collect_columns(e, cols)
            out: Set[str] = set()
            for col in cols:
                hits = [a for a, s in rel_schemas.items() if _resolves_in(col, s)]
                if len(hits) == 1:
                    out.add(hits[0])
                elif len(hits) == 0:
                    out.add("?outer")  # may be an outer (correlated) reference
                else:
                    raise SqlError(f"ambiguous column {col.flat_name()!r}")
            return out

        single_rel: Dict[str, List[lx.Expr]] = {a: [] for a, _ in rels}
        equi_edges: List[Tuple[str, str, lx.Column, lx.Column]] = []
        post_join: List[lx.Expr] = []

        for c in plain:
            refs = rels_of(c)
            if "?outer" in refs:
                post_join.append(c)  # resolved later against joined/outer schema
                continue
            if len(refs) == 1:
                single_rel[next(iter(refs))].append(c)
                continue
            if (
                len(refs) == 2
                and isinstance(c, lx.BinaryExpr)
                and c.op == "eq"
                and isinstance(c.left, lx.Column)
                and isinstance(c.right, lx.Column)
            ):
                la = next(a for a, s in rel_schemas.items() if _resolves_in(c.left, s))
                ra = next(a for a, s in rel_schemas.items() if _resolves_in(c.right, s))
                equi_edges.append((la, ra, c.left, c.right))
                continue
            post_join.append(c)

        # push single-relation predicates down
        planned: Dict[str, lp.LogicalPlan] = {}
        for a, p in rels:
            preds = single_rel[a]
            planned[a] = lp.Filter(p, conjoin(preds)) if preds else p

        # greedy join-graph ordering
        order = [a for a, _ in rels]
        joined = {order[0]}
        plan = planned[order[0]]
        remaining = set(order[1:])
        edges = list(equi_edges)
        while remaining:
            # find an edge between joined set and one remaining relation
            pick = None
            for a in order:
                if a not in remaining:
                    continue
                usable = [
                    (la, ra, lc, rc)
                    for (la, ra, lc, rc) in edges
                    if (la in joined and ra == a) or (ra in joined and la == a)
                ]
                if usable:
                    pick = (a, usable)
                    break
            if pick is None:
                # no connecting edge: cross join the next relation
                a = next(x for x in order if x in remaining)
                plan = lp.CrossJoin(plan, planned[a])
                joined.add(a)
                remaining.discard(a)
                continue
            a, usable = pick
            keys = []
            for (la, ra, lc, rc) in usable:
                if la in joined:
                    keys.append((lc, rc))
                else:
                    keys.append((rc, lc))
                edges.remove((la, ra, lc, rc))
            plan = lp.Join(plan, planned[a], keys, lp.JoinType.INNER)
            joined.add(a)
            remaining.discard(a)

        # remaining equi edges between already-joined rels -> post filters
        for (la, ra, lc, rc) in edges:
            post_join.append(lx.BinaryExpr(lc, "eq", rc))

        if post_join:
            plan = lp.Filter(plan, conjoin(post_join))

        # subquery conjuncts (decorrelation)
        for c in subquery_conjuncts:
            plan = self._apply_subquery_conjunct(plan, c)

        return plan

    # -- GROUP BY / aggregates ---------------------------------------------
    def _resolve_group_by(
        self, group_by: List[lx.Expr], select_exprs: List[lx.Expr]
    ) -> List[lx.Expr]:
        out = []
        for g in group_by:
            if isinstance(g, lx.Literal) and isinstance(g.value, int):
                idx = g.value - 1
                if not (0 <= idx < len(select_exprs)):
                    raise SqlError(f"GROUP BY position {g.value} out of range")
                e = select_exprs[idx]
                if isinstance(e, lx.Alias):
                    e = e.expr
                out.append(e)
            else:
                out.append(g)
        return out

    def _plan_aggregate(
        self,
        plan: lp.LogicalPlan,
        group_exprs: List[lx.Expr],
        aggs: List[lx.AggregateExpr],
    ) -> Tuple[lp.LogicalPlan, Dict[str, lx.Expr]]:
        agg_plan = lp.Aggregate(plan, group_exprs, list(aggs))
        mapping: Dict[str, lx.Expr] = {}
        for g in group_exprs:
            mapping[str(g)] = lx.Column(g.output_name())
        for a in aggs:
            mapping[str(a)] = lx.Column(a.output_name())
        return agg_plan, mapping

    # -- subqueries --------------------------------------------------------
    def _plan_subquery(
        self, stmt: sa.SelectStmt, outer_schema: pa.Schema
    ) -> Tuple[
        lp.LogicalPlan,
        List[Tuple[lx.Column, lx.Column]],
        List[lx.Expr],
    ]:
        """Plan a subquery's FROM/WHERE, extracting correlation predicates.

        Returns (inner joined+filtered plan, [(outer_col, inner_col)]
        correlation equi keys, residual correlated predicates referencing
        both scopes)."""
        inner_planner = SelectPlanner(self.ctx)
        # plan FROM items
        rels: List[Tuple[str, lp.LogicalPlan]] = []
        for item in stmt.from_items:
            rels.extend(inner_planner._plan_from_item(item))
        rel_schemas = {a: p.schema() for a, p in rels}

        def inner_resolves(col: lx.Column) -> bool:
            return any(_resolves_in(col, s) for s in rel_schemas.values())

        conjuncts = split_conjuncts(stmt.where)
        corr_keys: List[Tuple[lx.Column, lx.Column]] = []
        residuals: List[lx.Expr] = []
        inner_conjuncts: List[lx.Expr] = []
        nested_subq: List[lx.Expr] = []
        for c in conjuncts:
            if contains_subquery(c):
                nested_subq.append(c)
                continue
            cols: List[lx.Column] = []
            collect_columns(c, cols)
            outer_cols = [
                col for col in cols
                if not inner_resolves(col) and _resolves_in(col, outer_schema)
            ]
            if not outer_cols:
                inner_conjuncts.append(c)
                continue
            # correlated equi predicate inner_col = outer_col -> join key
            if (
                isinstance(c, lx.BinaryExpr)
                and c.op == "eq"
                and isinstance(c.left, lx.Column)
                and isinstance(c.right, lx.Column)
            ):
                if inner_resolves(c.left) and not inner_resolves(c.right):
                    corr_keys.append((c.right, c.left))
                    continue
                if inner_resolves(c.right) and not inner_resolves(c.left):
                    corr_keys.append((c.left, c.right))
                    continue
            # other correlated predicate -> residual join filter
            residuals.append(c)

        # build inner join tree with the non-correlated conjuncts
        inner_stmt = sa.SelectStmt(
            projections=[("*", None)],
            from_items=stmt.from_items,
            where=conjoin(inner_conjuncts),
        )
        inner_plan = inner_planner._plan_from_where(inner_stmt)
        for c in nested_subq:
            inner_plan = inner_planner._apply_subquery_conjunct(inner_plan, c)
        return inner_plan, corr_keys, residuals

    def _subquery_is_correlated(
        self, stmt: sa.SelectStmt, outer_schema: pa.Schema
    ) -> bool:
        """Check whether any WHERE conjunct references an outer column."""
        inner_planner = SelectPlanner(self.ctx)
        rels: List[Tuple[str, lp.LogicalPlan]] = []
        for item in stmt.from_items:
            rels.extend(inner_planner._plan_from_item(item))
        rel_schemas = [p.schema() for _a, p in rels]
        for c in split_conjuncts(stmt.where):
            if contains_subquery(c):
                continue
            cols: List[lx.Column] = []
            collect_columns(c, cols)
            for col in cols:
                if not any(_resolves_in(col, s) for s in rel_schemas) and _resolves_in(
                    col, outer_schema
                ):
                    return True
        return False

    def _apply_subquery_conjunct(
        self, plan: lp.LogicalPlan, conjunct: lx.Expr
    ) -> lp.LogicalPlan:
        outer_schema = plan.schema()

        # EXISTS / NOT EXISTS
        if isinstance(conjunct, lx.Exists) or (
            isinstance(conjunct, lx.Not) and isinstance(conjunct.expr, lx.Exists)
        ):
            node = conjunct if isinstance(conjunct, lx.Exists) else conjunct.expr
            negated = isinstance(conjunct, lx.Not) or node.negated
            if not self._subquery_is_correlated(node.stmt, outer_schema):
                # uncorrelated EXISTS gates every outer row on whether the
                # subquery yields any row at all: cross-join a one-row
                # count aggregate over LIMIT 1 (one row decides the truth),
                # filter on it, project it back away
                try:
                    sub = SelectPlanner(self.ctx).plan(node.stmt)
                except SchemaError:
                    # correlation the WHERE-conjunct scan missed (e.g. via
                    # the SELECT list): fall through to the correlated path
                    sub = None
                if sub is not None:
                    alias = f"__exists_{id(node)}"
                    ncol_name = "__exists_n"
                    probe = lp.Aggregate(
                        lp.Limit(sub, 1),
                        [],
                        [lx.Alias(
                            lx.AggregateExpr("count", lx.Wildcard(), False),
                            ncol_name,
                        )],
                    )
                    probe = lp.SubqueryAlias(probe, alias)
                    joined = lp.CrossJoin(plan, probe)
                    ncol = lx.Column(ncol_name, alias)
                    zero = lx.Literal(0, pa.int64())
                    cond = lx.BinaryExpr(ncol, "eq" if negated else "gt", zero)
                    filtered = lp.Filter(joined, cond)
                    # alias kept columns back to their FLAT names; the bare
                    # Column resolves each flat name EXACTLY (outer schema
                    # names are unique), so a legitimate dot inside an
                    # output name is not misread as qualifier.column
                    keep = [
                        lx.Alias(lx.Column(f.name), f.name)
                        for f in outer_schema
                    ]
                    return lp.Projection(filtered, keep)
            inner_plan, corr_keys, residuals = self._plan_subquery(
                node.stmt, outer_schema
            )
            if not corr_keys:
                raise SqlError(
                    "EXISTS subquery correlation must appear as equality "
                    "conjuncts in the subquery's WHERE clause"
                )
            on = [(o, i) for o, i in corr_keys]
            jt = lp.JoinType.ANTI if negated else lp.JoinType.SEMI
            return lp.Join(plan, inner_plan, on, jt, conjoin(residuals))

        # [NOT] IN (subquery)
        if isinstance(conjunct, lx.InSubquery) or (
            isinstance(conjunct, lx.Not) and isinstance(conjunct.expr, lx.InSubquery)
        ):
            node = conjunct if isinstance(conjunct, lx.InSubquery) else conjunct.expr
            negated = isinstance(conjunct, lx.Not) or node.negated
            if not isinstance(node.expr, lx.Column):
                raise SqlError("IN (subquery) requires a column on the left")
            jt = lp.JoinType.ANTI if negated else lp.JoinType.SEMI
            if not self._subquery_is_correlated(node.stmt, outer_schema):
                # full sub-select planning (aggregates/HAVING/DISTINCT ok);
                # wrap in a unique alias so inner names can't collide with
                # outer scope
                sub = SelectPlanner(self.ctx).plan(node.stmt)
                alias = f"__in_{id(node)}"
                sub = lp.SubqueryAlias(sub, alias)
                in_key = lx.Column(sub.schema().names[0].split(".")[-1], alias)
                on = [(node.expr, in_key)]
                if negated:
                    # SQL three-valued NOT IN: any NULL in the subquery result
                    # means no row qualifies, and a NULL probe value never
                    # qualifies either
                    return self._not_in_null_aware(plan, node.expr, sub, in_key, on)
                return lp.Join(plan, sub, on, jt)
            inner_plan, corr_keys, residuals = self._plan_subquery(
                node.stmt, outer_schema
            )
            # project the IN value under a unique alias (bare select-list names
            # can collide with the kept qualified columns), keeping original
            # columns for correlation keys / residuals
            proj0, _al = node.stmt.projections[0]
            if isinstance(proj0, str):
                raise SqlError("IN (subquery) requires an explicit select column")
            in_alias = f"__in_val_{id(node)}"
            keep = [
                lx.Column(f.name.split(".")[-1], f.name.split(".")[0] if "." in f.name else None)
                for f in inner_plan.schema()
            ]
            inner_full = lp.Projection(
                inner_plan, [lx.Alias(proj0, in_alias)] + keep
            )
            on = [(node.expr, lx.Column(in_alias))]
            for o, i in corr_keys:
                on.append((o, i))
            if negated and residuals:
                raise SqlError("correlated NOT IN with residual predicates not supported")
            return lp.Join(plan, inner_full, on, jt, conjoin(residuals))

        # comparison with scalar subquery
        subqs: List[lx.ScalarSubquery] = []

        def walk(e: lx.Expr) -> None:
            if isinstance(e, lx.ScalarSubquery):
                subqs.append(e)
                return
            for ch in _expr_children_full(e):
                walk(ch)

        walk(conjunct)
        if not subqs:
            raise SqlError(f"unhandled subquery conjunct: {conjunct}")

        mapping: Dict[str, lx.Expr] = {}
        for sq in subqs:
            plan, ref = self._join_scalar_subquery(plan, sq, outer_schema)
            mapping[str(sq)] = ref
        rewritten = rewrite_expr(conjunct, mapping)
        return lp.Filter(plan, rewritten)

    def _not_in_null_aware(
        self,
        plan: lp.LogicalPlan,
        probe_expr: lx.Column,
        sub: lp.LogicalPlan,
        in_key: lx.Column,
        on: List[Tuple[lx.Column, lx.Column]],
    ) -> lp.LogicalPlan:
        """NOT IN with SQL three-valued semantics: anti-join against non-null
        inner values, drop null probe values, and produce no rows at all if
        the subquery result contains any NULL."""
        original_fields = list(plan.schema().names)
        nonnull_sub = lp.Filter(sub, lx.IsNotNull(in_key))
        out: lp.LogicalPlan = lp.Join(plan, nonnull_sub, on, lp.JoinType.ANTI)
        out = lp.Filter(out, lx.IsNotNull(probe_expr))
        # null guard: cross join a 1-row count of NULL inner values, require 0
        nullcnt = f"__in_nullcnt_{id(sub)}"
        nulls_agg = lp.Aggregate(
            lp.Filter(sub, lx.IsNull(in_key)),
            [],
            [lx.Alias(lx.AggregateExpr("count", lx.Wildcard()), nullcnt)],
        )
        out = lp.CrossJoin(out, nulls_agg)
        out = lp.Filter(out, lx.BinaryExpr(lx.Column(nullcnt), "eq", lx.Literal(0)))
        # strip the helper column so downstream SELECT * stays clean
        restore = [
            lx.Alias(
                lx.Column(n.split(".")[-1], n.split(".")[0] if "." in n else None), n
            )
            for n in original_fields
        ]
        return lp.Projection(out, restore)

    def _join_scalar_subquery(
        self, plan: lp.LogicalPlan, sq: lx.ScalarSubquery, outer_schema: pa.Schema
    ) -> Tuple[lp.LogicalPlan, lx.Expr]:
        stmt: sa.SelectStmt = sq.stmt  # type: ignore[attr-defined]
        inner_plan, corr_keys, residuals = self._plan_subquery(stmt, outer_schema)
        if residuals:
            raise SqlError(
                "scalar subquery with non-equi correlated predicates "
                f"not supported: {residuals[0]}"
            )
        # subquery must be a single aggregate projection
        if len(stmt.projections) != 1:
            raise SqlError("scalar subquery must have one projection")
        proj, _alias = stmt.projections[0]
        aggs: List[lx.AggregateExpr] = []
        collect_aggregates(proj, aggs)
        if not aggs:
            raise SqlError("scalar subquery must be an aggregate")
        out_name = f"__sq_{id(sq)}"

        if corr_keys:
            group_cols = [i for (_o, i) in corr_keys]
            # exact_floats: the subquery result is compared against source
            # values (q2: = MIN(ps_supplycost)); f32 device paths decline
            agg = lp.Aggregate(inner_plan, group_cols, list(aggs),
                               exact_floats=True)
            mapping = {str(a): lx.Column(a.output_name()) for a in aggs}
            value = rewrite_expr(proj, mapping)
            # project: correlation keys (renamed uniquely) + value
            key_aliases = []
            proj_exprs: List[lx.Expr] = []
            for k, (o, i) in enumerate(corr_keys):
                kname = f"__sqk_{id(sq)}_{k}"
                proj_exprs.append(lx.Alias(lx.Column(i.name, i.relation), kname))
                key_aliases.append(kname)
            proj_exprs.append(lx.Alias(value, out_name))
            agg_proj = lp.Projection(agg, proj_exprs)
            on = [
                (o, lx.Column(kname)) for (o, _i), kname in zip(corr_keys, key_aliases)
            ]
            # LEFT join: outer rows with an empty group must survive — their
            # aggregate value is NULL (comparisons then drop them, matching
            # SQL), except COUNT whose value over an empty group is 0
            joined = lp.Join(plan, agg_proj, on, lp.JoinType.LEFT)
            ref: lx.Expr = lx.Column(out_name)
            if all(a.fn == "count" for a in aggs):
                ref = lx.ScalarFunction(
                    "coalesce", [lx.Cast(ref, pa.int64()), lx.Literal(0)]
                )
            return joined, ref

        # uncorrelated: single-row aggregate, cross join
        agg = lp.Aggregate(inner_plan, [], list(aggs), exact_floats=True)
        mapping = {str(a): lx.Column(a.output_name()) for a in aggs}
        value = rewrite_expr(proj, mapping)
        agg_proj = lp.Projection(agg, [lx.Alias(value, out_name)])
        joined = lp.CrossJoin(plan, agg_proj)
        return joined, lx.Column(out_name)


def _expr_children_full(e: lx.Expr) -> List[lx.Expr]:
    """children() plus subquery-bearing nodes' wrapped exprs."""
    if isinstance(e, lx.InSubquery):
        return [e.expr]
    return e.children()
