"""Generalized eager aggregation: Aggregate over a PK-FK join TREE rewritten
to Aggregate over a mapped fact scan.

FactAggregateStage (ops/factagg.py) covers aggregate-over-join shapes whose
group keys are the fact join key and whose aggregate inputs are fact-side —
q3/q5/q10/q18. The shapes it documents as excluded (its own header):
multi-key fact joins (q7-q9) and dim-valued aggregate inputs / fact-column
group keys (q12). This module closes those: the reference executes them by
materializing every join then hash-aggregating the joined rows
(rust/core/src/serde/physical_plan/from_proto.rs:176-214, 370-384); on a
device that volatile join output pays encode+transfer per query.

Rewrite (device path only; the host path keeps the original plan):

    Aggregate(ops*(Join(Join(...(dim_k, fact)...), dim_1)))
      -> Aggregate(ops*(MappedScanExec(fact_chain, attachments)))

Each INNER equi-join against a unique-keyed dim subtree becomes an
*attachment*: at stage-prepare time the dim subtree executes on the host
(it may carry its own filters/joins — q7's orders x customer x nation leg),
and its columns are gathered per fact row through the key (sorted dim keys
+ searchsorted, the same regular shape the device join kernel uses). The
fact batch comes out extended with the mapped dim columns plus an
``__member`` int8 column (0 where the inner join would drop the row — a
membership filter the stage fuses onto the device). Attachments chain:
a later attachment's fact-side key may itself be a mapped column
(q7: orders attaches o_custkey, customer attaches through it).

After the rewrite the ordinary FusedAggregateStage compiles everything —
mapped columns are just columns: they narrow, dictionary-encode, ride the
persisted layout cache (dim file mtimes are part of the stage key), and
group keys / aggregate inputs / filters may reference them freely
(q12's SUM(CASE over o_orderpriority), q7's n_name cross-filter).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.ops.runtime import UnsupportedOnDevice
from ballista_tpu_torch.physical import expr as px
from ballista_tpu_torch.physical.basic import (
    CoalesceBatchesExec,
    FilterExec,
    MergeExec,
    ProjectionExec,
    coalesce_batches,
)
from ballista_tpu_torch.physical.plan import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    collect_all,
)
from ballista_tpu_torch.utils import tracing
from ballista_tpu_torch.utils.locks import make_lock

# dim subtrees larger than this are not dimension maps; host joins them.
# Sized for SF=100 TPC-H: q12/q7 attach the whole orders table (~150M rows,
# ~2.4 GB of sorted int64 key + order arrays on a 125 GB host); the DEVICE
# cost is membership bits + narrow mapped columns over the filtered fact,
# which the HBM budget still guards independently
MAX_MAP_ROWS = 200_000_000
_PASSTHROUGH = (FilterExec, ProjectionExec, CoalesceBatchesExec, MergeExec)


class Attachment:
    """One subtree joined to the fact on integer key column(s).

    kind "inner": unique-keyed dim whose columns map onto fact rows.
    kind "semi"/"anti": membership only — no columns attach, no
    uniqueness requirement (EXISTS / NOT EXISTS semantics; q4's shape)."""

    def __init__(self, dim: ExecutionPlan, fact_keys: List[str],
                 dim_keys: List[str], kind: str = "inner") -> None:
        self.dim = dim
        self.fact_keys = fact_keys
        self.dim_keys = dim_keys
        self.kind = kind


def _subtree_scan_bytes(node: ExecutionPlan) -> int:
    import os

    files = getattr(getattr(node, "source", None), "files", None)
    total = sum(
        os.path.getsize(f) for f in (files or []) if os.path.exists(f)
    )
    return total + sum(_subtree_scan_bytes(c) for c in node.children())


def _flatten_join_tree(node: ExecutionPlan):
    """Peel INNER equi-joins off the fact subtree, innermost first.
    Returns (fact_subtree, [Attachment...]) — an empty list means `node`
    has no join to rewrite."""
    from ballista_tpu_torch.logical.plan import JoinType
    from ballista_tpu_torch.physical.join import HashJoinExec

    if (
        not isinstance(node, HashJoinExec)
        or node.join_type not in (JoinType.INNER, JoinType.SEMI, JoinType.ANTI)
        or node.filter is not None
    ):
        return node, []
    if node.join_type in (JoinType.SEMI, JoinType.ANTI):
        # semi/anti preserve the LEFT schema: the fact is always the left
        # side; the right side contributes membership bits only
        fact, atts = _flatten_join_tree(node.left)
        kind = "semi" if node.join_type == JoinType.SEMI else "anti"
        return fact, atts + [
            Attachment(node.right, [l for l, _ in node.on],
                       [r for _, r in node.on], kind=kind)
        ]
    lb = _subtree_scan_bytes(node.left)
    rb = _subtree_scan_bytes(node.right)
    if rb >= lb:
        fact_side, dim_side = node.right, node.left
        fact_keys = [r for _, r in node.on]
        dim_keys = [l for l, _ in node.on]
    else:
        fact_side, dim_side = node.left, node.right
        fact_keys = [l for l, _ in node.on]
        dim_keys = [r for _, r in node.on]
    fact, atts = _flatten_join_tree(fact_side)
    return fact, atts + [Attachment(dim_side, fact_keys, dim_keys)]


class MappedScanExec(ExecutionPlan):
    """Fact chain extended with per-row dim columns and a membership flag.

    Built only inside the device stage builder (never planned, never
    serialized); `ballista_cacheable` marks it a stable file-backed row
    source for FusedAggregateStage residency (the stage cache key already
    carries every underlying file's mtime via the ORIGINAL plan's leaves).
    """

    ballista_cacheable = True

    def __init__(self, fact: ExecutionPlan, attachments: List[Attachment]) -> None:
        self.fact = fact
        self.attachments = attachments
        fields = list(fact.schema())
        for a in attachments:
            if a.kind == "inner":
                fields.extend(list(a.dim.schema()))
        fields.append(pa.field("__member", pa.int8()))
        self._schema = pa.schema(fields)
        self._maps: Optional[List[dict]] = None  # guarded-by: self._lock
        self._lock = make_lock("ops.mappedscan._lock")

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return self.fact.output_partitioning()

    def children(self) -> List[ExecutionPlan]:
        return [self.fact] + [a.dim for a in self.attachments]

    def with_children(self, children: List[ExecutionPlan]) -> "MappedScanExec":
        atts = [
            Attachment(d, a.fact_keys, a.dim_keys, kind=a.kind)
            for d, a in zip(children[1:], self.attachments)
        ]
        return MappedScanExec(children[0], atts)

    def fmt(self) -> str:
        parts = ", ".join(
            f"{a.dim_keys} via {a.fact_keys}" for a in self.attachments
        )
        return f"MappedScanExec: {len(self.attachments)} attachments [{parts}]"

    # ------------------------------------------------------------------
    # collects dimension plans while holding the lock (see join.py note)
    # may-acquire: group:exec_substrate
    def _ensure_maps(self, ctx: TaskContext) -> List[dict]:
        with self._lock:
            if self._maps is not None:
                return self._maps
            # the host side of the rewrite (dim plans collected, keys packed
            # and sorted) as one span: chip_smoke.py reports it per query
            with tracing.span("mappedscan.dim_maps"):
                self._maps = self._build_maps(ctx)
            return self._maps

    def _build_maps(self, ctx: TaskContext) -> List[dict]:
        """Each attachment's dim plan collected into a sorted key map."""
        maps = []
        for a in self.attachments:
            table = collect_all(a.dim, ctx).combine_chunks()
            if table.num_rows > MAX_MAP_ROWS:
                raise UnsupportedOnDevice(
                    f"dim map {a.dim_keys} has {table.num_rows} rows"
                )
            if a.kind == "inner" and table.num_rows == 0:
                # an empty inner dim means zero joined rows; _extend's
                # gather through an empty order array would IndexError —
                # decline and let the host path produce the empty result
                raise UnsupportedOnDevice(
                    f"inner dim map {a.dim_keys} has zero rows"
                )
            for k in a.dim_keys:
                if not pa.types.is_integer(table.column(k).type):
                    raise UnsupportedOnDevice(
                        f"non-integer dim key {k!r}"
                    )
            if any(table.column(k).null_count for k in a.dim_keys):
                # a null key can never match (SQL EXISTS semantics):
                # drop rows where ANY key is null — filtering the TABLE
                # keeps composite tuples row-aligned AND converts int64
                # losslessly (a null-bearing column would round-trip
                # through float64, corrupting keys above 2^53). Inner
                # dims must decline instead (a mapped row would vanish).
                if a.kind == "inner":
                    raise UnsupportedOnDevice(
                        f"null dim key in {a.dim_keys}"
                    )
                import pyarrow.compute as pc

                mask = None
                for k in a.dim_keys:
                    v = pc.is_valid(table.column(k))
                    mask = v if mask is None else pc.and_(mask, v)
                table = table.filter(mask).combine_chunks()
            key_vals = [
                table.column(k).to_numpy(zero_copy_only=False)
                .astype(np.int64)
                for k in a.dim_keys
            ]
            packed, mins, ranges, strides = _pack_dim_keys(key_vals)
            if a.kind == "inner":
                order = np.argsort(packed, kind="stable")
                sorted_keys = packed[order]
                if len(sorted_keys) and np.any(
                    sorted_keys[1:] == sorted_keys[:-1]
                ):
                    raise UnsupportedOnDevice(
                        f"dim keys {a.dim_keys} not unique (join multiplies)"
                    )
            else:
                # membership only: distinct keys suffice, nothing to
                # gather — no uniqueness requirement, no retained table
                sorted_keys = np.unique(packed)
                order = None
                table = None
            maps.append(
                {
                    "table": table,
                    "sorted": sorted_keys,
                    "order": order,
                    "mins": mins,
                    "ranges": ranges,
                    "strides": strides,
                    "att": a,
                }
            )
        return maps

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        """The fact's batches merged up to the context's batch size, then
        extended: a selective filter below the join yields many small
        batches, and the device stage runs one step per batch it stages
        (DataFusion coalesces a filter's output the same way). A batch that
        already fills the batch size passes through as it is."""
        maps = self._ensure_maps(ctx)
        merged = coalesce_batches(
            _counted(self.fact.execute(partition, ctx)), ctx.batch_size
        )
        for batch in merged:
            tracing.incr("mappedscan.batches_out")
            yield self._extend(batch, maps)

    def _extend(self, batch: pa.RecordBatch, maps: List[dict]) -> pa.RecordBatch:
        n = batch.num_rows
        arrays: List[pa.Array] = list(batch.columns)
        by_name: Dict[str, pa.Array] = {
            f.name: arr for f, arr in zip(batch.schema, arrays)
        }
        member = np.ones(n, dtype=bool)
        for m in maps:
            a: Attachment = m["att"]
            packed = np.zeros(n, dtype=np.int64)
            valid = np.ones(n, dtype=bool)
            for k, mn, rng, stride in zip(
                a.fact_keys, m["mins"], m["ranges"], m["strides"]
            ):
                import pyarrow.compute as pc

                col = by_name[k]
                if isinstance(col, pa.ChunkedArray):
                    col = col.combine_chunks()
                if col.null_count:
                    valid &= col.is_valid().to_numpy(zero_copy_only=False)
                    col = pc.fill_null(col, pa.scalar(0, type=col.type))
                v = col.to_numpy(zero_copy_only=False).astype(np.int64)
                rel = v - mn
                # out-of-range values can never match AND must not pack
                # (an over-range component would alias another tuple)
                in_range = (rel >= 0) & (rel < rng)
                valid &= in_range
                packed = packed + np.where(in_range, rel, 0) * stride
            if len(m["sorted"]) == 0:
                hit = np.zeros(n, dtype=bool)
                idx_c = np.zeros(n, dtype=np.int64)
            else:
                idx = np.searchsorted(m["sorted"], packed)
                idx_c = np.minimum(idx, len(m["sorted"]) - 1)
                hit = valid & (m["sorted"][idx_c] == packed)
            if a.kind == "anti":
                # NOT EXISTS: keep rows with no match (null keys never
                # match, so they are kept — SQL NOT EXISTS semantics)
                member &= ~hit
                continue
            member &= hit
            if a.kind == "semi":
                continue
            # non-member rows gather row 0 (garbage, masked by __member;
            # group codes need non-null values so no null fill here)
            take = m["order"][np.where(hit, idx_c, 0)]
            gathered = m["table"].take(pa.array(take))
            for f, col in zip(gathered.schema, gathered.columns):
                arr = col.combine_chunks()
                arrays.append(arr)
                by_name[f.name] = arr
        arrays.append(pa.array(member.astype(np.int8)))
        return pa.record_batch(arrays, schema=self._schema)


def _counted(batches: Iterator[pa.RecordBatch]) -> Iterator[pa.RecordBatch]:
    for batch in batches:
        tracing.incr("mappedscan.batches_in")
        yield batch


def _pack_dim_keys(key_vals: List[np.ndarray]):
    """Combine multi-column integer keys into one int64 per row by
    range-shifted packing; strides derived from each column's dim range so
    fact values pack consistently. Declines when ranges could overflow."""
    mins = [int(v.min()) if len(v) else 0 for v in key_vals]
    ranges = [
        (int(v.max()) - mn + 1) if len(v) else 1
        for v, mn in zip(key_vals, mins)
    ]
    total = 1
    for r in ranges:
        if r > 0 and total > (1 << 62) // r:
            raise UnsupportedOnDevice("dim key ranges overflow packing")
        total *= r
    strides = []
    acc = 1
    for r in reversed(ranges):
        strides.append(acc)
        acc *= r
    strides = list(reversed(strides))
    packed = np.zeros(len(key_vals[0]), dtype=np.int64)
    for v, mn, s in zip(key_vals, mins, strides):
        packed += (v - mn) * s
    return packed, mins, ranges, strides


# ---------------------------------------------------------------------------
# the rewrite
# ---------------------------------------------------------------------------


def try_rewrite_mapped(agg) -> Optional[object]:
    """Rewrite HashAggregate(ops*(join tree)) to HashAggregate(ops*(
    Filter(__member = 1, MappedScanExec))), or None when the shape doesn't
    match. Expressions referencing the join schema are remapped by name."""
    from ballista_tpu_torch.physical.aggregate import HashAggregateExec
    from ballista_tpu_torch.physical.join import HashJoinExec
    from ballista_tpu_torch.physical.scan import MemoryScanExec
    from ballista_tpu_torch.ops.stage import _SCAN_TYPES, substitute_columns

    node = agg.input
    chain: List[ExecutionPlan] = []
    while isinstance(node, _PASSTHROUGH):
        chain.append(node)
        node = node.input
    if not isinstance(node, HashJoinExec):
        return None
    fact, atts = _flatten_join_tree(node)
    if not atts:
        return None

    # the fact subtree must be a plain scan chain (no memory scans: their
    # id()-keyed identity must not silently gain dim-file dependencies)
    probe = fact
    while isinstance(probe, _PASSTHROUGH):
        probe = probe.input
    if not isinstance(probe, _SCAN_TYPES) or isinstance(probe, MemoryScanExec):
        return None

    # every attachment's fact-side keys must resolve, in order, against the
    # fact schema extended by earlier attachments
    available = set(fact.schema().names)
    for a in atts:
        if not all(k in available for k in a.fact_keys):
            return None
        available |= {f.name for f in a.dim.schema()}

    mapped = MappedScanExec(fact, atts)
    mschema = mapped.schema()
    join_schema = node.schema()
    positions = {f.name: i for i, f in enumerate(mschema)}
    if len(positions) != len(mschema):
        return None  # duplicate names would remap ambiguously
    try:
        mapping = [
            px.ColumnExpr(f.name, positions[f.name]) for f in join_schema
        ]
    except KeyError:
        return None  # a join output column the mapped schema lacks

    member_filter = FilterExec(
        mapped,
        px.BinaryPhysicalExpr(
            px.ColumnExpr("__member", mschema.names.index("__member")),
            "eq",
            px.LiteralExpr(1, pa.int8()),
        ),
    )

    # rebuild the op chain bottom-up; nodes keep referencing the join
    # schema until the first projection redefines it
    cur: ExecutionPlan = member_filter
    needs_remap = True
    for op in reversed(chain):
        if isinstance(op, FilterExec):
            pred = (
                substitute_columns(op.predicate, mapping)
                if needs_remap else op.predicate
            )
            cur = FilterExec(cur, pred)
        elif isinstance(op, ProjectionExec):
            exprs = [
                (
                    substitute_columns(e, mapping) if needs_remap else e,
                    name,
                )
                for e, name in op.exprs
            ]
            cur = ProjectionExec(cur, exprs)
            needs_remap = False
        else:  # Coalesce / Merge: schema-preserving passthrough
            cur = op.with_children([cur])
    group_exprs = [
        (substitute_columns(e, mapping) if needs_remap else e, name)
        for e, name in agg.group_exprs
    ]
    from ballista_tpu_torch.physical.aggregate import AggregateFunc

    aggr_funcs = [
        AggregateFunc(
            a.fn,
            substitute_columns(a.expr, mapping) if needs_remap else a.expr,
            a.name,
            a.dtype,
            a.input_type,
        )
        for a in agg.aggr_funcs
    ]
    try:
        out = HashAggregateExec(agg.mode, cur, group_exprs, aggr_funcs,
                                exact_floats=getattr(agg, "exact_floats", False))
    except Exception:
        return None
    # the rewrite must not change the aggregate's output contract
    if out.schema() != agg.schema():
        return None
    if getattr(agg, "_topk_pushdown", None) is not None:
        out._topk_pushdown = agg._topk_pushdown
    # the framework drives the ORIGINAL aggregate's partition count (the
    # join's probe side); the rewritten stage scans the FACT's partitions.
    # When they differ, the stage must stripe fact partitions over the
    # driven ones or it would silently aggregate a fraction of the fact
    # (same hazard factagg guards at ops/factagg.py:343-347)
    n_driven = agg.input.output_partitioning().partition_count()
    n_fact = mapped.output_partitioning().partition_count()
    if n_driven != n_fact:
        out._scan_stride_hint = n_driven
    return out
