"""COUNT over a LEFT join as device membership counting (q13), the JAX
package's ``ops/countjoin.py``.

TPC-H q13's inner aggregate

    SELECT c_custkey, COUNT(o_orderkey) FROM customer
    LEFT OUTER JOIN orders ON c_custkey = o_custkey [AND <orders filter>]
    GROUP BY c_custkey

materialises the whole joined table on the host just to count matches per
customer. COUNT(<right column>) grouped by left-side keys IS the per-probe
match run-length that ``ops/join.py::device_membership_counts`` computes: one
int64 count per LEFT row, NULL keys and NULL counted values excluded as SQL
COUNT demands. The join's M:N expansion never happens (no gather, no
multiplicity tier, one int32-per-probe readback) and the aggregate sums the
counts per group key over the LEFT table alone.

``try_count_left_join`` routes a matching HashAggregateExec through that
plane and returns the partial-state table (bit-identical to the host path:
counts are exact integers and the group-by is the same pyarrow hash
aggregation the host runs); None hands the shape back to the stage ladder.
The ANTI-join half (q22's NOT EXISTS) lives in physical/join.py, which
keeps rows off the same counts plane.

Admitted shape (everything else returns None: a prescreen, not a decline):

- mode SINGLE or PARTIAL;
- input chain of schema-preserving passthroughs (Merge / CoalesceBatches)
  over a LEFT HashJoinExec without residual filter;
- every group key a plain column of the join's LEFT side;
- every aggregate COUNT over a plain column of the join's RIGHT side.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.physical import expr as px
from ballista_tpu_torch.physical.basic import CoalesceBatchesExec, MergeExec
from ballista_tpu_torch.physical.plan import TaskContext, collect_partition

_PASSTHROUGH = (MergeExec, CoalesceBatchesExec)


def _match_shape(agg):
    """(join, merges_input) for an admissible aggregate, else None."""
    from ballista_tpu_torch.logical.plan import JoinType
    from ballista_tpu_torch.physical.aggregate import AggregateMode
    from ballista_tpu_torch.physical.join import HashJoinExec

    if agg.mode not in (AggregateMode.SINGLE, AggregateMode.PARTIAL):
        return None
    node = agg.input
    merged = False
    while isinstance(node, _PASSTHROUGH):
        merged = merged or isinstance(node, MergeExec)
        node = node.input
    if (
        not isinstance(node, HashJoinExec)
        or node.join_type != JoinType.LEFT
        or node.filter is not None
    ):
        return None
    n_left = len(node.left.schema())
    for e, _name in agg.group_exprs:
        if not isinstance(e, px.ColumnExpr) or e.index >= n_left:
            return None
    if not agg.aggr_funcs:
        return None
    for a in agg.aggr_funcs:
        if (
            a.fn != "count"
            or not isinstance(a.expr, px.ColumnExpr)
            or a.expr.index < n_left
        ):
            return None
    return node, merged


def _partition_counts(
    left: pa.Table, right: pa.Table, join, counted: List[int], device
) -> Optional[List[np.ndarray]]:
    """One int64 counts array per counted right column for this
    partition's (left, right) pair. A counted column with nulls gets its
    own device pass over the null-filtered build rows (COUNT skips nulls);
    null-free columns share one pass."""
    from ballista_tpu_torch.ops.join import device_membership_counts
    from ballista_tpu_torch.physical.joinutil import combined_key_codes

    left_keys = [n for n, _ in join.on]
    right_keys = [n for _, n in join.on]
    n_left_rows = left.num_rows
    out: List[Optional[np.ndarray]] = []
    for idx in counted:
        col = right.column(idx - len(join.left.schema()))
        if col.null_count == 0:
            out.append(None)  # filled from the shared pass below
            continue
        valid = right.filter(pc.is_valid(col))
        if valid.num_rows == 0 or n_left_rows == 0:
            out.append(np.zeros(n_left_rows, dtype=np.int64))
            continue
        bcodes, pcodes = combined_key_codes(
            [valid.column(k) for k in right_keys],
            [left.column(k) for k in left_keys],
        )
        counts = device_membership_counts(bcodes, pcodes, device)
        if counts is None:
            return None
        out.append(counts)
    shared: Optional[np.ndarray] = None
    if any(c is None for c in out):
        if right.num_rows == 0 or n_left_rows == 0:
            shared = np.zeros(n_left_rows, dtype=np.int64)
        else:
            bcodes, pcodes = combined_key_codes(
                [right.column(k) for k in right_keys],
                [left.column(k) for k in left_keys],
            )
            shared = device_membership_counts(bcodes, pcodes, device)
            if shared is None:
                return None
    return [shared if c is None else c for c in out]


def try_count_left_join(agg, partition: int, ctx: TaskContext) -> Optional[pa.Table]:
    """Partial-state table (group columns, then one int64 count column per
    aggregate) for an admissible COUNT over a LEFT join, or None to fall
    through to the stage ladder."""
    from ballista_tpu_torch.physical.aggregate import HashAggregateExec, _cast_to_schema
    from ballista_tpu_torch.utils import tracing

    m = _match_shape(agg)
    if m is None:
        return None
    join, merged = m
    n_join_parts = join.output_partitioning().partition_count()
    # a MergeExec in the chain merges EVERY join partition into this one
    # call; without it the aggregate drives exactly one join partition
    parts = range(n_join_parts) if merged else [partition]
    counted = [a.expr.index for a in agg.aggr_funcs]
    key_chunks: List[List[pa.Array]] = [[] for _ in agg.group_exprs]
    count_chunks: List[List[np.ndarray]] = [[] for _ in counted]
    for p in parts:
        if join.partitioned:
            left = collect_partition(join.left, p, ctx)
        else:
            left = join._collect_build(join.left, ctx)
        right = collect_partition(join.right, p, ctx)
        counts = _partition_counts(left, right, join, counted, ctx.device)
        if counts is None:
            return None  # the device declined (reason recorded)
        for i, (e, _name) in enumerate(agg.group_exprs):
            key_chunks[i].append(left.column(e.index))
        for i, c in enumerate(counts):
            count_chunks[i].append(c)
    cols = {}
    keys = []
    for i, chunks in enumerate(key_chunks):
        kn = f"__g{i}"
        cols[kn] = pa.chunked_array(chunks).combine_chunks()
        keys.append(kn)
    for i, chunks in enumerate(count_chunks):
        cols[f"__c{i}"] = pa.array(np.concatenate(chunks), type=pa.int64())
    t = pa.table(cols)
    specs = [(f"__c{i}", "sum", None) for i in range(len(counted))]
    key_tbl, agg_arrays = HashAggregateExec._group_aggregate(t, keys, specs)
    out_cols = [key_tbl.column(i) for i in range(len(keys))]
    # COUNT is never NULL: summing zero count rows yields null from pyarrow,
    # where the host path's count gives 0
    out_cols += [pc.fill_null(a, 0) for a in agg_arrays]
    tracing.incr("device.count_join")
    # partial-state shape: SINGLE callers run _final over it (an identity
    # fold per group), PARTIAL callers ship it as the partial state
    state_schema = pa.schema(
        [pa.field(n, cols[k].type) for k, (_, n) in zip(keys, agg.group_exprs)]
        + [f for a in agg.aggr_funcs for f in a.state_fields()]
    )
    return _cast_to_schema(out_cols, state_schema)
