"""Incremental execution: result-cache advancement helpers (ISSUE 19).

A repeated aggregate query over a GROWN scan-file set (``files ∪ {new}``)
misses the result cache — the ``result_key`` covers every file's (path,
mtime, size) — even though the cached result already embodies all the old
files' work. When the plan's aggregate state is RESUMABLE, the scheduler
advances instead of recomputing: it runs a delta job over only the new
files through the ordinary planning/ledger machinery, folds the delta's
output into the cached result, and publishes the advanced entry under the
new key. The contract is bit-identity — the advanced result must equal a
cold full run byte for byte — so eligibility is conservative:

- the plan is Sort > [Projection] > Aggregate > (Filter|SubqueryAlias)* >
  file-backed TableScan, the projection a pure rename layer;
- every aggregate member folds by an ORDER-INSENSITIVE merge: count and
  integer sum fold by addition, min/max by themselves. Float sums (f32
  device accumulation is not associative), avg, and DISTINCT aggregates
  decline to a full recompute — recorded (``advance_declined``), never
  silent;
- the output carries a total row order: the Sort keys must cover every
  group column (group keys are unique per row, so re-sorting the folded
  table reproduces the cold run's order), or the aggregate has no group
  columns at all (one row).

The fold itself is plain Arrow host compute over exact types — int64
sums/counts and min/max merge without any floating-point reassociation,
which is what makes the bit-identity contract holdable.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import pyarrow as pa

from ballista_tpu_torch.logical import plan as lp
from ballista_tpu_torch.logical.expr import (
    AggregateExpr,
    Alias,
    Column,
)

log = logging.getLogger(__name__)


class FoldSpec:
    """How to merge a cached aggregate result with a delta result.

    keys:      output column names that are group keys (row identity)
    merges:    (output column name, arrow aggregate op) for every member —
               "sum" (covers count), "min", or "max"
    sort_keys: (output column name, ascending) restoring the cold run's
               total row order after the fold
    nulls_first: the (uniform) null placement of the sort
    """

    def __init__(self, keys, merges, sort_keys, nulls_first):
        self.keys: List[str] = keys
        self.merges: List[Tuple[str, str]] = merges
        self.sort_keys: List[Tuple[str, bool]] = sort_keys
        self.nulls_first: bool = nulls_first


def _decline(reason: str) -> None:
    log.info("advancement ineligible: %s", reason)


def fold_spec(plan: lp.LogicalPlan) -> Optional[FoldSpec]:
    """FoldSpec when `plan`'s result is resumable aggregate state, else
    None (with the reason logged). See the module docstring for the
    eligibility contract."""
    p = plan
    sort = None
    if isinstance(p, lp.Sort):
        sort = p
        p = p.input
    if isinstance(p, lp.Limit):
        _decline("LIMIT truncates fold inputs")
        return None
    proj = None
    if isinstance(p, lp.Projection):
        proj = p
        p = p.input
    if not isinstance(p, lp.Aggregate):
        _decline("plan root is not an aggregate")
        return None
    agg = p
    q = agg.input
    while isinstance(q, (lp.Filter, lp.SubqueryAlias)):
        q = q.input
    if not isinstance(q, lp.TableScan):
        _decline(f"aggregate input is {type(q).__name__}, not a plain scan")
        return None
    if not getattr(q.source, "files", None):
        _decline("scan is not file-backed")
        return None

    # role of every aggregate-schema field: group key, or a merge op
    in_schema = agg.input.schema()
    roles = {}
    for ge in agg.group_exprs:
        if not isinstance(ge, Column):
            _decline(f"group key {ge} is not a plain column")
            return None
        roles[ge.output_name()] = "key"
    for ae in agg.aggr_exprs:
        inner = ae.expr if isinstance(ae, Alias) else ae
        if not isinstance(inner, AggregateExpr):
            _decline(f"aggregate member {ae} is not an aggregate function")
            return None
        if inner.distinct:
            _decline(f"{inner} requires the full input (DISTINCT)")
            return None
        if inner.fn == "count":
            role = "sum"  # counts fold by addition
        elif inner.fn in ("min", "max"):
            role = inner.fn
        elif inner.fn == "sum":
            if not pa.types.is_integer(inner.data_type(in_schema)):
                _decline(f"{inner} accumulates floats (not associative on "
                         "the device's f32 lanes)")
                return None
            role = "sum"
        else:
            _decline(f"{inner} has no order-insensitive fold")
            return None
        roles[ae.output_name()] = role

    # the projection must be a pure rename layer over the aggregate output
    out_cols: List[Tuple[str, str]] = []  # (output name, aggregate field)
    if proj is None:
        out_cols = [(n, n) for n in roles]
    else:
        for e in proj.exprs:
            inner = e.expr if isinstance(e, Alias) else e
            if not isinstance(inner, Column) or inner.name not in roles:
                _decline(f"projection expr {e} computes, not renames")
                return None
            out_cols.append((e.output_name(), inner.name))
    names = [n for n, _ in out_cols]
    if len(set(names)) != len(names):
        _decline("duplicate output column names")
        return None
    covered_groups = {src for _, src in out_cols if roles[src] == "key"}
    all_groups = {n for n, r in roles.items() if r == "key"}
    if covered_groups != all_groups:
        _decline("projection drops a group key (fold would merge rows the "
                 "cold run keeps distinct)")
        return None
    keys = [n for n, src in out_cols if roles[src] == "key"]
    merges = [(n, roles[src]) for n, src in out_cols if roles[src] != "key"]

    # total row order: sort keys covering every group key (group rows are
    # unique per key set), or a single global-aggregate row
    sort_keys: List[Tuple[str, bool]] = []
    nulls_first = False
    if keys:
        if sort is None:
            _decline("no ORDER BY: cold-run row order is partition-"
                     "dependent, the fold cannot reproduce it")
            return None
        nf_flags = set()
        for se in sort.sort_exprs:
            inner = se.expr
            if not isinstance(inner, Column) or inner.name not in names:
                _decline(f"sort key {se} is not an output column")
                return None
            sort_keys.append((inner.name, se.ascending))
            nf_flags.add(se.nulls_first)
        if len(nf_flags) > 1:
            _decline("mixed NULLS FIRST/LAST across sort keys")
            return None
        nulls_first = nf_flags.pop()
        if not set(keys) <= {n for n, _ in sort_keys}:
            _decline("ORDER BY does not cover every group key (row order "
                     "among ties is partition-dependent)")
            return None
    return FoldSpec(keys, merges, sort_keys, nulls_first)


# -- delta plan -------------------------------------------------------------

def new_scan_files(facts, base_facts) -> Optional[List[str]]:
    """The file paths a submission's fact set grew over a cached base, or
    None when the delta is not purely additive (a BASE file's identity
    moved — its old fact would be folded in as if still true)."""
    base = set(base_facts)
    cur = set(facts)
    if not base < cur:
        return None
    base_paths = {f.rsplit("|", 2)[0] for f in base}
    new = sorted(cur - base)
    paths = [f.rsplit("|", 2)[0] for f in new]
    if any(p in base_paths for p in paths):
        return None  # moved identity, not an append
    return paths


def build_delta_plan(plan: lp.LogicalPlan, new_file: str) -> lp.LogicalPlan:
    """The same logical plan over ONE new file. Single-file sources are
    serde-clean: ParquetTableSource(file).files == [file], and the proto
    round-trip re-discovers exactly that list, so the delta job's tasks
    recover/requeue like any other job's."""
    from ballista_tpu_torch.datasource import ParquetTableSource

    def rebuild(p: lp.LogicalPlan) -> lp.LogicalPlan:
        if isinstance(p, lp.TableScan):
            return lp.TableScan(
                p.table_name, ParquetTableSource(new_file),
                p.projection, list(p.filters),
            )
        return p.with_children([rebuild(c) for c in p.children()])

    return rebuild(plan)


# -- the fold ---------------------------------------------------------------

def table_to_ipc(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def ipc_to_table(raw: bytes) -> pa.Table:
    with pa.ipc.open_stream(pa.BufferReader(raw)) as r:
        return r.read_all()


def fold_tables(
    tables: List[pa.Table], spec: FoldSpec, schema: pa.Schema
) -> pa.Table:
    """Merge the cached result with the delta results into the table a
    cold full run would produce: concatenate, re-group on the key columns
    with each member's fold op, restore the total sort order. All host
    Arrow compute over exact types (int64 sums/counts, min/max) — no
    floating-point reassociation, so bit-identity holds."""
    import pyarrow.compute as pc

    combined = pa.concat_tables(
        [t.select(schema.names).cast(schema) for t in tables]
    )
    if spec.keys:
        folded = combined.group_by(spec.keys, use_threads=False).aggregate(
            list(spec.merges)
        )
        rename = {f"{n}_{op}": n for n, op in spec.merges}
        folded = folded.rename_columns(
            [rename.get(c, c) for c in folded.column_names]
        ).select(schema.names)
    else:
        # global aggregate: one row per input, one row out
        cols = {}
        for n, op in spec.merges:
            fn = {"sum": pc.sum, "min": pc.min, "max": pc.max}[op]
            cols[n] = pa.array(
                [fn(combined.column(n)).as_py()], type=schema.field(n).type
            )
        folded = pa.table(
            {n: cols[n] for n in schema.names}, schema=schema
        )
    folded = folded.cast(schema)
    if spec.sort_keys:
        idx = pc.sort_indices(
            folded,
            sort_keys=[
                (n, "ascending" if asc else "descending")
                for n, asc in spec.sort_keys
            ],
            null_placement="at_start" if spec.nulls_first else "at_end",
        )
        folded = folded.take(idx)
    return folded.combine_chunks()


# -- result fetch (the scheduler acting as a client) ------------------------

def _storage_read(loc, config) -> Optional[pa.Table]:
    """Shared-storage read of a storage-homed partition, confined to the
    scheduler's own configured shuffle dir (mirrors the client's read)."""
    if not loc.storage_uri:
        return None
    root = config.shuffle_dir()
    if not root:
        return None
    from ballista_tpu_torch.executor.confine import resolve_contained

    resolved = resolve_contained(os.path.join(loc.path, "0.arrow"), root)
    if resolved is None or not os.path.exists(resolved):
        return None
    try:
        with pa.ipc.open_file(resolved) as r:
            return r.read_all()
    except Exception:
        return None


def fetch_completed_table(locations, config, schema: pa.Schema) -> pa.Table:
    """All result partitions of a completed job (or cached entry) as one
    table, in partition order — storage first, Flight fallback. Any fetch
    failure raises; the caller declines the advancement and falls back to
    a full recompute (the ordinary lost-partition machinery still guards
    the non-advancement paths)."""
    from ballista_tpu_torch.client.flight import BallistaClient

    tables = []
    for loc in sorted(locations, key=lambda l: l.partition_id.partition_id):
        t = _storage_read(loc, config)
        if t is None:
            client = BallistaClient(
                loc.executor_meta.host,
                loc.executor_meta.port,
                retries=config.rpc_retries(),
                backoff_s=config.rpc_backoff_s(),
            )
            try:
                t = client.fetch_partition(os.path.join(loc.path, "0.arrow"))
            finally:
                client.close()
        tables.append(t)
    if not tables:
        return schema.empty_table()
    return pa.concat_tables(
        [t.cast(schema) for t in tables]
    ).combine_chunks()
