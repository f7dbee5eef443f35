"""Logical optimizer.

The reference delegates optimization to DataFusion (invoked at
rust/scheduler/src/lib.rs:317). Implemented natively here. The headline rule
is projection pushdown: scans read only required columns — essential for
Parquet/TPC-H (lineitem has 16 columns, q6 needs 4) and for keeping
host->device transfer minimal on the TPU path.
"""

from __future__ import annotations

from typing import List, Optional, Set

from ballista_tpu_torch.logical import expr as lx
from ballista_tpu_torch.logical import plan as lp


def optimize_plan(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    plan = push_down_projection(plan, None)
    return plan


# ---------------------------------------------------------------------------
# Projection pushdown
# ---------------------------------------------------------------------------


def _expr_columns(e: lx.Expr, out: Set[str]) -> bool:
    """Collect flat column names; returns False if the expr is opaque
    (contains a subquery), which disables pushdown above it."""
    if isinstance(e, (lx.ScalarSubquery, lx.InSubquery, lx.Exists)):
        return False
    if isinstance(e, lx.Column):
        out.add(e.flat_name())
    ok = True
    for c in e.children():
        ok = _expr_columns(c, out) and ok
    return ok


def _exprs_columns(exprs, out: Set[str]) -> bool:
    ok = True
    for e in exprs:
        ok = _expr_columns(e, out) and ok
    return ok


def _resolve(names: Set[str], schema) -> Set[str]:
    """Normalize required names to the actual field names in a schema
    (an unqualified name may match a qualified field and vice versa)."""
    fields = list(schema.names)
    out: Set[str] = set()
    for n in names:
        if n in fields:
            out.add(n)
            continue
        # unqualified ref matching one qualified field
        matches = [f for f in fields if f.endswith("." + n)]
        if len(matches) == 1:
            out.add(matches[0])
            continue
        bare = n.split(".")[-1]
        if bare in fields:
            out.add(bare)
    return out


def push_down_projection(
    plan: lp.LogicalPlan, required: Optional[Set[str]]
) -> lp.LogicalPlan:
    """required = flat column names needed above this node; None = all."""

    if isinstance(plan, lp.TableScan):
        if required is None:
            return plan
        schema = plan.source.schema()
        req = _resolve(required, schema)
        indices = [i for i, n in enumerate(schema.names) if n in req]
        if not indices:
            indices = [0]  # keep at least one column (e.g. COUNT(*) scans)
        if len(indices) == len(schema.names):
            return plan
        return lp.TableScan(plan.table_name, plan.source, indices, plan.filters)

    if isinstance(plan, lp.Projection):
        used: Set[str] = set()
        ok = _exprs_columns(plan.exprs, used)
        child = push_down_projection(plan.input, used if ok else None)
        return lp.Projection(child, plan.exprs)

    if isinstance(plan, lp.Filter):
        used = set(required) if required is not None else None
        ok = True
        if used is not None:
            ok = _expr_columns(plan.predicate, used)
        child = push_down_projection(plan.input, used if ok else None)
        return lp.Filter(child, plan.predicate)

    if isinstance(plan, lp.Aggregate):
        used = set()
        ok = _exprs_columns(plan.group_exprs, used)
        ok = _exprs_columns(plan.aggr_exprs, used) and ok
        child = push_down_projection(plan.input, used if ok else None)
        return lp.Aggregate(
            child, plan.group_exprs, plan.aggr_exprs,
            exact_floats=getattr(plan, "exact_floats", False),
        )

    if isinstance(plan, lp.Sort):
        used = set(required) if required is not None else None
        ok = True
        if used is not None:
            ok = _exprs_columns(plan.sort_exprs, used)
        child = push_down_projection(plan.input, used if ok else None)
        return lp.Sort(child, plan.sort_exprs)

    if isinstance(plan, lp.Limit):
        child = push_down_projection(plan.input, required)
        return lp.Limit(child, plan.n, plan.skip)

    if isinstance(plan, lp.Repartition):
        used = set(required) if required is not None else None
        ok = True
        if used is not None and plan.scheme == lp.PartitionScheme.HASH:
            ok = _exprs_columns(plan.hash_exprs, used)
        child = push_down_projection(plan.input, used if ok else None)
        return lp.Repartition(child, plan.scheme, plan.n, plan.hash_exprs)

    if isinstance(plan, lp.SubqueryAlias):
        if required is None:
            child = push_down_projection(plan.input, None)
            return lp.SubqueryAlias(child, plan.alias)
        # map required output names -> input names positionally
        out_schema = plan.schema()
        in_schema = plan.input.schema()
        req = _resolve(required, out_schema)
        child_req = {
            in_schema.names[i]
            for i, n in enumerate(out_schema.names)
            if n in req
        }
        if not child_req:
            child_req = {in_schema.names[0]}
        child = push_down_projection(plan.input, child_req)
        # rebuild alias over (possibly narrowed) child — schema recomputed
        return lp.SubqueryAlias(child, plan.alias)

    if isinstance(plan, lp.Join):
        lschema = plan.left.schema()
        rschema = plan.right.schema()
        lnames = set(lschema.names)
        used = set(required) if required is not None else None
        ok = True
        if used is not None:
            for l, r in plan.on:
                used.add(l.flat_name())
                used.add(r.flat_name())
            if plan.filter is not None:
                ok = _expr_columns(plan.filter, used)
        if used is None or not ok:
            lreq = rreq = None
        else:
            resolved_l = _resolve(used, lschema)
            resolved_r = _resolve(used, rschema)
            lreq, rreq = resolved_l, resolved_r
        left = push_down_projection(plan.left, lreq)
        right = push_down_projection(plan.right, rreq)
        # a narrowed child may have dropped columns entirely absent from
        # requirements; Join schema recomputes from children
        return lp.Join(left, right, plan.on, plan.join_type, plan.filter)

    if isinstance(plan, lp.CrossJoin):
        if required is None:
            lreq = rreq = None
        else:
            lreq = _resolve(required, plan.left.schema())
            rreq = _resolve(required, plan.right.schema())
            if not lreq:
                lreq = {plan.left.schema().names[0]}
            if not rreq:
                rreq = {plan.right.schema().names[0]}
        left = push_down_projection(plan.left, lreq)
        right = push_down_projection(plan.right, rreq)
        return lp.CrossJoin(left, right)

    if isinstance(plan, (lp.Distinct, lp.Union, lp.Window, lp.Explain)):
        # these need all input columns (or handled elsewhere)
        children = [push_down_projection(c, None) for c in plan.children()]
        return plan.with_children(children)

    # unknown node: conservative recurse requiring everything
    children = [push_down_projection(c, None) for c in plan.children()]
    if children:
        return plan.with_children(children)
    return plan
