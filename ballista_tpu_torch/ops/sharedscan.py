"""Shared-scan multi-query execution: one upload, one step, N queries.

Concurrent distinct queries often scan the same tables, yet each solo fused
aggregate stage pays its own Parquet decode, its own host-to-device upload
and its own device step. The scheduler groups compatible co-pending stage
tasks of different jobs into one batched dispatch (scheduler/state.py
form_shared_batch; _find_aggregate below is the walk both halves share).
This module is the executor's half, the JAX package's rules on PyTorch: it
resolves each member's fused stage (ops/kernels.py resolve_stage), checks
real compatibility, reads the union of the members' pruned scan columns
once, uploads every shared column once, and runs the group's members over
that one upload. Each member's readback decodes through its own stage, so
the spliced table is what the member's solo stage.run would have given:
bit identity to solo execution holds at every decision point.

Why the union read is solo-identical: a member's solo scan reads its pruned
column list from the same Parquet files, combine_chunks()es, and slices
into ctx.batch_size row batches. Row boundaries depend only on the row
count and the batch size, never on which columns ride along, so selecting
a member's columns by name out of the union batch gives byte-identical
member batches, and every shared column is lowered by the same
column_to_numpy / _lower_planes as the member's solo prepare.

Two step shapes, one invariant. Members whose packed output rows are all
order-insensitive (int sums, counts, min/max, float-bits min/max) run in
the combined step: every such member's unrolled core over the shared
tensors, the outputs concatenated and read back once. A member with an f32
sum or avg runs its own step over the same shared upload and is read back
on its own, as the reference keeps f32 reductions in the member's own
program. In this port "one launch" is one step and one readback, not one
kernel: the counters device_launches and launches_saved count steps and
readbacks. Eager PyTorch compiles nothing, so a composition is always
ready: the reference's background warm of a cold composition has no
counterpart here, and warm_fallback_launches stays 0.

Compatibility (the executor is authoritative; the scheduler's signature
is a cheap heuristic):
- a plain FusedAggregateStage (no top-k epilogue, no fact-aggregate
  derivations) over a Parquet scan;
- identical (files, mtimes, chunk cover, batch size, HBM budget, device):
  members must read byte-identical row streams;
- no dictionary-coded (string) device columns: each stage grows its own
  string dictionary (string GROUP BY keys stay on the host and batch fine);
- every batch's group count within the "batches" route's MAX_GROUPS.

A member or group that cannot share (a string-coded device column, too many
groups, a column that does not lower, a budget overrun) declines with
UnsupportedOnDevice and runs solo. Any other exception propagates and fails
the batched task: an error on the card is never hidden behind a solo run.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.ops.runtime import UnsupportedOnDevice
from ballista_tpu_torch.utils import counters

log = logging.getLogger("ballista.sharedscan")

# order for widening int narrow-choice priors across members
_INT_ORDER = {"int8": 0, "int16": 1, "int32": 2}


class SharedResults:
    """Per-batched-task registry of precomputed member tables, keyed on the
    aggregate node object inside the member's (deserialized, soon to be
    executed) plan tree plus the partition, so the splice in
    kernels.hash_aggregate can only hit the exact node this group ran.
    Node references are pinned for the registry's lifetime, so ids are
    never recycled. take() consumes the entry."""

    def __init__(self) -> None:
        self._tables: Dict[Tuple[int, int], pa.Table] = {}
        self._pins: List[object] = []

    def put(self, node, partition: int, table: pa.Table) -> None:
        self._pins.append(node)
        self._tables[(id(node), partition)] = table

    def take(self, node, partition: int) -> Optional[pa.Table]:
        return self._tables.pop((id(node), partition), None)

    def drop(self, node, partition: int) -> None:
        self._tables.pop((id(node), partition), None)

    def __len__(self) -> int:
        return len(self._tables)


class _Member:
    """One batch member: its plan's aggregate node, resolved fused stage,
    stable identity, partition, task context and scan-compatibility key.

    `exact` marks stages whose every packed output row is order-insensitive
    (int sums, counts, min/max, float-bits min/max): only those join the
    combined step; an f32 sum or avg runs the member's own step."""

    __slots__ = ("node", "stage", "stable", "partition", "ctx", "group_key",
                 "cover", "exact")

    def __init__(self, node, stage, stable, partition, ctx, group_key,
                 cover) -> None:
        self.node = node
        self.stage = stage
        self.stable = stable
        self.partition = partition
        self.ctx = ctx
        self.group_key = group_key
        self.cover = cover
        self.exact = not any(
            (not ix) and a.fn in ("sum", "avg")
            for a, ix in zip(stage.aggs, stage.int_exact)
        )


def _find_aggregate(plan):
    """The batchable aggregate node under a stage plan: the FIRST
    HashAggregateExec down the single-child operator spine (stage plans put
    sort/projection/coalesce epilogues ABOVE the aggregate; they consume
    its output per member and never affect what the aggregate computes).
    None when the spine forks or ends before an aggregate, or the mode is
    FINAL (final aggregates read shuffles, not scans)."""
    from ballista_tpu_torch.physical.aggregate import AggregateMode, HashAggregateExec

    node = plan
    while not isinstance(node, HashAggregateExec):
        kids = node.children()
        if len(kids) != 1:
            return None
        node = kids[0]
    if node.mode in (AggregateMode.PARTIAL, AggregateMode.SINGLE):
        return node
    return None


def _member_key_map(stage) -> Dict[object, tuple]:
    """Member cols-dict key -> shared column key. The member's step reads
    columns by pruned-schema index (plus the float-bits plane keys derived
    from it); the shared staging is keyed by column name, so members with
    different pruned schemas share one lowered array."""
    from ballista_tpu_torch.ops.stage import plane_keys

    schema = stage.scan_schema
    out: Dict[object, tuple] = {}
    for idx in stage.compiler.used_columns:
        out[idx] = ("col", schema.field(idx).name)
    for idx, width in stage._bit_planes.items():
        hk, lk = plane_keys(idx)
        out[hk] = ("hi", schema.field(idx).name)
        if width == "f64":
            out[lk] = ("lo", schema.field(idx).name)
    return out


def _member_info(plan, partition: int, ctx) -> Optional[_Member]:
    """Resolve one member's stage and compatibility facts, or None when the
    member cannot ride a shared-scan group (it then executes solo through
    the untouched normal path)."""
    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.ops.stage import FusedAggregateStage
    from ballista_tpu_torch.physical.scan import ParquetScanExec

    if ctx.backend != "cuda":
        return None
    node = _find_aggregate(plan)
    if node is None:
        return None
    stage, _key, stable, _units = kernels.resolve_stage(node, ctx)
    # plain fused stages only: fact-aggregate subclasses derive columns and
    # run epilogues this group step does not model, and a live top-k spec
    # routes the stage through the sorted layout
    if stage is False or type(stage) is not FusedAggregateStage:
        return None
    if stage.topk is not None or stage.derive_columns:
        return None
    scan = stage.scan
    if not isinstance(scan, ParquetScanExec):
        return None
    if ctx.config.device_cache() and stage._device_cache.get(partition) is not None:
        # the member's columns are already resident: its solo run skips the
        # scan and the upload, which beats re-scanning it into a batch
        return None
    if stage.dicts.dicts:
        return None  # string-coded device columns: per-stage dictionaries
    schema = stage.scan_schema
    for idx in stage.compiler.used_columns:
        t = schema.field(idx).type
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            return None
    files = tuple(getattr(scan.source, "files", ()) or ())
    if not files:
        return None
    try:
        mtimes = tuple(str(os.path.getmtime(f)) for f in files)
    except OSError:
        return None
    total = scan.output_partitioning().partition_count()
    stride = stage.scan_stride
    # the chunk cover: exactly which scan partitions this member's task
    # reads (ops/stage.py _scan_batches); members must match it so the
    # shared batch stream is row-identical to each member's solo stream
    cover = tuple(range(partition, total, stride)) if stride else (partition,)
    if any(p >= len(files) for p in cover):
        return None  # out-of-range partition: let the solo path surface it
    # bound now: the group step holds every member's prepare lock, which
    # bind_device takes
    stage.bind_device(ctx)
    group_key = (
        files, mtimes, cover, ctx.batch_size, ctx.config.tpu_hbm_budget(),
        str(ctx.device),
    )
    return _Member(node, stage, stable, partition, ctx, group_key, cover)


def precompute(items, max_batch: int = 8) -> SharedResults:
    """Group compatible members and run each group over one shared upload.
    `items` are (stage plan, partition, TaskContext) triples of a batched
    task's members. Returns the per-member precomputed tables; members
    absent from the result execute solo. A group that declines
    (UnsupportedOnDevice) leaves its members to run solo; any other
    exception propagates."""
    res = SharedResults()
    if len(items) < 2:
        return res
    groups: Dict[tuple, List[_Member]] = {}
    for plan, partition, ctx in items:
        m = _member_info(plan, partition, ctx)
        if m is None:
            counters.shared_scan.record("member_ineligible")
            continue
        groups.setdefault(m.group_key, []).append(m)
    for g in groups.values():
        # canonical member order: the stable identity, so a composition's
        # combined output is laid out the same in every wave
        g.sort(key=lambda m: m.stable)
        for lo in range(0, len(g), max(2, max_batch)):
            chunk = g[lo:lo + max(2, max_batch)]
            if len(chunk) < 2:
                continue
            try:
                _run_group(chunk, res)
            except UnsupportedOnDevice as e:
                log.info("shared-scan group runs solo: %s", e)
                counters.shared_scan.record("batch_degraded")
                for m in chunk:
                    res.drop(m.node, m.partition)
    return res


def _codes_fingerprint(stage) -> Optional[tuple]:
    """Sharing key for host-side group ranking: members whose group keys
    are the same plain scan columns rank identical codes from the same
    batch (dense ranking is a pure function of the evaluated key arrays),
    so one member's _group_codes output serves them all. Computed group
    keys return None: those members rank their own."""
    from ballista_tpu_torch.physical import expr as px

    names = []
    for e, _name in stage.group_exprs:
        if not isinstance(e, px.ColumnExpr):
            return None
        names.append(stage.scan_schema.field(e.index).name)
    return tuple(names)


def _merge_prior(a, b):
    """Widest of two narrow-choice priors (never downgrade a member's
    width; the choice only affects residency dtype, never values)."""
    if a is None:
        return b
    if b is None:
        return a
    if a in _INT_ORDER and b in _INT_ORDER:
        return a if _INT_ORDER[a] >= _INT_ORDER[b] else b
    if "wide" in (a, b):
        return "wide"
    return a


def _scan_union_batches(members: List[_Member]):
    """Read the members' shared chunk cover once with the union of their
    pruned scan schemas (strings as dictionary columns, like
    FusedAggregateStage._read_scan_file), yielding ctx.batch_size row
    batches. Row boundaries depend only on row count and batch size, so
    each member's name-selected view of every batch is identical to its
    solo scan stream."""
    import pyarrow.parquet as pq

    names: List[str] = []
    strings: List[str] = []
    for m in members:
        for f in m.stage.scan_schema:
            if f.name not in names:
                names.append(f.name)
                if pa.types.is_string(f.type) or pa.types.is_large_string(f.type):
                    strings.append(f.name)
    files = members[0].stage.scan.source.files
    batch_size = members[0].ctx.batch_size
    for p in members[0].cover:
        table = pq.read_table(
            files[p], columns=names, read_dictionary=strings
        ).combine_chunks()
        yield from table.to_batches(max_chunksize=batch_size)


def _run_group(members: List[_Member], res: SharedResults) -> None:
    """Shared prepare and steps for one compatible group. Stage state
    (narrow choices, dictionaries) is touched under every member stage's
    prepare lock, acquired in id order (two identical queries can resolve
    to the same stage object; locks dedupe by identity)."""
    locks = {}
    for m in members:
        locks[id(m.stage._prepare_lock)] = m.stage._prepare_lock
    ordered = [locks[k] for k in sorted(locks)]
    for lk in ordered:
        lk.acquire()
    try:
        _run_group_locked(members, res)
    finally:
        for lk in reversed(ordered):
            lk.release()


# every member stage's prepare lock is held (_run_group takes them in id
# order), named here by its class for the lock-order graph
# holds-lock: ops.stage._prepare_lock
def _run_group_locked(members: List[_Member], res: SharedResults) -> None:
    from ballista_tpu_torch.ops.runtime import (
        bucket_rows,
        column_to_numpy,
        make_headroom,
        narrow_column,
        pad_to,
        readback,
        upload,
    )
    from ballista_tpu_torch.ops.stage import MAX_GROUPS, FusedAggregateStage

    budget = min(m.ctx.config.tpu_hbm_budget() for m in members)
    device = members[0].ctx.device
    live = list(members)

    def degrade(m: _Member) -> None:
        if m in live:
            live.remove(m)
            counters.shared_scan.record("member_degraded")

    # negotiated narrow choices for the shared staged columns (keyed by
    # shared column key): start from the widest of the members' priors (a
    # member that already chose a width must never see a narrower batch),
    # then carry each batch's choice forward as a solo prepare does
    keymaps = {id(m): _member_key_map(m.stage) for m in members}
    shared_choice: Dict[tuple, object] = {}
    for m in members:
        for mkey, skey in keymaps[id(m)].items():
            shared_choice[skey] = _merge_prior(
                shared_choice.get(skey), m.stage._narrow_choice.get(mkey)
            )
    for m in list(members):
        if not m.exact and any(
            shared_choice.get(skey) != m.stage._narrow_choice.get(mkey)
            for mkey, skey in keymaps[id(m)].items()
        ):
            # an inexact member's own step must see the dtypes its solo run
            # would (f32 sums are reassociation-sensitive in the reference):
            # any starting prior other than its own sends it solo
            members.remove(m)
            live.remove(m)
            counters.shared_scan.record("member_degraded")
    if len(live) < 2:
        counters.shared_scan.record("batch_degraded")
        return

    batches: List[dict] = []
    total_bytes = 0
    for batch in _scan_union_batches(members):
        n = batch.num_rows
        if not n:
            continue
        bucket = bucket_rows(n)
        # per-member group ranking over the member's name-selected view of
        # the shared batch: the member's own host work, so codes and keys
        # are solo-identical; members grouping by the same plain columns
        # share one ranking
        per: Dict[int, tuple] = {}  # id(member) -> (codes, key_values, n_groups)
        codes_cache: Dict[tuple, tuple] = {}
        for m in list(live):
            try:
                fp = _codes_fingerprint(m.stage)
                if fp is not None and fp in codes_cache:
                    codes, key_values, n_groups = codes_cache[fp]
                else:
                    view = batch.select(m.stage.scan_schema.names)
                    codes, key_values, n_groups = m.stage._group_codes(view)
                    if fp is not None:
                        codes_cache[fp] = (codes, key_values, n_groups)
            except UnsupportedOnDevice:
                degrade(m)
                continue
            if n_groups > MAX_GROUPS:
                # solo would retry on the sorted layout, which is
                # per-member by construction: hand the member back
                degrade(m)
                continue
            if n_groups:
                per[id(m)] = (codes, key_values, n_groups)
        if len(live) < 2:
            break
        # lower the union of live members' device columns once, keyed by
        # shared column key (name-based: members prune differently)
        needed: Dict[tuple, tuple] = {}
        for m in live:
            schema = m.stage.scan_schema
            for idx, dtype in m.stage.compiler.used_columns.items():
                name = schema.field(idx).name
                needed[("col", name)] = ("col", name, dtype)
            for idx, width in m.stage._bit_planes.items():
                name = schema.field(idx).name
                needed[("plane", name)] = ("plane", name, width)
        shared_np: Dict[tuple, np.ndarray] = {}
        bad: set = set()  # shared keys that failed to lower
        for spec in needed.values():
            kind, name = spec[0], spec[1]
            try:
                if kind == "col":
                    shared_np[("col", name)] = column_to_numpy(
                        batch.column(name), spec[2], None
                    )
                else:
                    # plane_keys(0) == (-2, -3): lower once, remap by name
                    d = FusedAggregateStage._lower_planes(
                        batch.column(name), 0, spec[2]
                    )
                    shared_np[("hi", name)] = d[-2]
                    if spec[2] == "f64":
                        shared_np[("lo", name)] = d[-3]
            except UnsupportedOnDevice:
                bad.add(("col", name) if kind == "col" else ("hi", name))
                bad.add(("lo", name))
        if bad:
            # a column that cannot lower declines the members reading it:
            # solo they would decline to the host path on the same batch
            for m in list(live):
                if any(skey in bad for skey in keymaps[id(m)].values()):
                    degrade(m)
        for m in list(live):
            if id(m) not in per:
                continue
            try:
                npview = {
                    mkey: shared_np[skey]
                    for mkey, skey in keymaps[id(m)].items()
                    if skey in shared_np
                }
                m.stage._check_int_ranges(npview, n)
            except UnsupportedOnDevice:
                degrade(m)
        if len(live) < 2:
            break
        # narrow and pad the shared tiles once; keep only columns live
        # members still read
        live_keys: set = set()
        for m in live:
            live_keys |= set(keymaps[id(m)].values())
        staged: Dict[tuple, tuple] = {}
        for skey in sorted(k for k in shared_np if k in live_keys):
            npcol = shared_np[skey]
            fill = False if npcol.dtype == np.bool_ else 0
            narrow, lut, choice = narrow_column(npcol, shared_choice.get(skey))
            shared_choice[skey] = choice
            padded = pad_to(narrow, bucket, fill)
            staged[skey] = (padded, lut, choice)
            total_bytes += padded.nbytes + (0 if lut is None else lut.nbytes)
        row_valid = np.zeros(bucket, dtype=np.bool_)
        row_valid[:n] = True
        recs = []
        for m in live:
            hit = per.get(id(m))
            if hit is None:
                continue  # no groups in this batch (solo skips it too)
            codes, key_values, n_groups = hit
            seg_bucket = bucket_rows(n_groups, 16) + 1  # +1 dump slot
            codes_pad = pad_to(codes.astype(np.int16), bucket, 0)
            total_bytes += codes_pad.nbytes
            recs.append((m, codes_pad, seg_bucket, n_groups, key_values))
        total_bytes += bucket  # shared bool row_valid
        if total_bytes > budget:
            raise UnsupportedOnDevice(
                f"shared-scan batches ({total_bytes >> 20} MiB) exceed the "
                "HBM budget"
            )
        batches.append({"staged": staged, "row_valid": row_valid, "recs": recs})
    if len(live) < 2:
        counters.shared_scan.record("batch_degraded")
        return
    counters.shared_scan.record("shared_groups")
    tables: Dict[int, List[pa.Table]] = {id(m): [] for m in live}
    # per-member aux is batch-independent: built and uploaded once per group
    aux_by_member = {
        id(m): [upload(np.asarray(a), device) for a in m.stage.compiler.build_aux()]
        for m in live
    }
    for rec in batches:
        recs = [r for r in rec["recs"] if r[0] in live]
        if not recs:
            continue
        make_headroom(members[0].stage, total_bytes, budget)
        # one upload per shared column; the members' cols dicts alias the
        # same device tensors under their own pruned-schema keys
        dev_by_skey: Dict[tuple, object] = {}
        for skey, (padded, lut, _choice) in rec["staged"].items():
            dev = upload(padded, device)
            dev_by_skey[skey] = dev if lut is None else (dev, upload(lut, device))
        rv = upload(rec["row_valid"], device)
        args = [
            (
                seg_bucket,
                {mkey: dev_by_skey[skey] for mkey, skey in keymaps[id(m)].items()
                 if skey in dev_by_skey},
                aux_by_member[id(m)],
                upload(codes_pad, device),
            )
            for m, codes_pad, seg_bucket, _ng, _kv in recs
        ]
        # only exact members (order-insensitive packed rows) join the
        # combined step; inexact members (f32 sums) run their own step over
        # the same shared upload and are read back on their own
        fuse_idx = [i for i, r in enumerate(recs) if r[0].exact]
        own_idx = [i for i, r in enumerate(recs) if not r[0].exact]
        if len(fuse_idx) < 2:
            own_idx, fuse_idx = sorted(own_idx + fuse_idx), []
        blocks: List[Optional[np.ndarray]] = [None] * len(recs)
        if fuse_idx:
            step = _combined_step([recs[i][0].stage for i in fuse_idx])
            flat = readback(step([args[i] for i in fuse_idx], rv))
            counters.shared_scan.record("device_launches")
            counters.shared_scan.record("launches_saved", len(fuse_idx) - 1)
            off = 0
            for i in fuse_idx:
                m, _cp, seg_bucket, _ng, _kv = recs[i]
                r_packed = len(m.stage._int_rows)
                blocks[i] = flat[off:off + r_packed * seg_bucket].reshape(
                    r_packed, seg_bucket
                )
                off += r_packed * seg_bucket
        for i in own_idx:
            seg_bucket, cols, aux, codes = args[i]
            core = recs[i][0].stage._unrolled_core()
            blocks[i] = readback(core(seg_bucket, cols, aux, codes, rv))
            counters.shared_scan.record("device_launches")
        counters.shared_scan.record("uploads_saved", len(recs) - 1)
        for block, (m, _cp, _sb, n_groups, key_values) in zip(blocks, recs):
            # the member's own decode and assembly: the solo readback path
            rows = m.stage._decode_stacked(block)
            counts = rows[0][:n_groups]
            outputs = [o[:n_groups] for o in m.stage._state_outputs(rows)]
            t = m.stage._assemble_partial(outputs, counts, key_values, n_groups)
            if t.num_rows:
                tables[id(m)].append(t)
    # carry the negotiated narrow choices into each member's own prior map
    # so its later solo runs keep the dtypes this group used
    for m in live:
        for mkey, skey in keymaps[id(m)].items():
            if skey in shared_choice:
                m.stage._narrow_choice[mkey] = shared_choice[skey]
    for m in live:
        tabs = tables[id(m)]
        table = (
            pa.concat_tables(tabs) if tabs
            else m.stage.partial_schema.empty_table()
        )
        res.put(m.node, m.partition, table)


def _combined_step(stages: list):
    """One step running every member's unrolled core with its own
    (seg_bucket, cols view, aux, codes) over the shared row_valid, the
    packed outputs concatenated into one int32 vector for one readback.
    The member sub-steps are the solo cores, so each slice is bit-identical
    to that member's solo rows."""
    import torch

    cores = [s._unrolled_core() for s in stages]

    def combined(member_args, row_valid):
        return torch.cat([
            core(sb, cols, aux, codes, row_valid).reshape(-1)
            for core, (sb, cols, aux, codes) in zip(cores, member_args)
        ])

    return combined
