"""Mesh aggregation stage: Partial -> exchange -> Final as one mesh program.

The reference executes a distributed aggregation as independent
per-partition partial tasks, a materialized hash shuffle, and final tasks.
Here partitions map to shards of a mesh (parallel/mesh.py), the partial
phase is the fused stage's step on each shard, and the exchange is a
psum / pmin / pmax between the shards (parallel/spmd.py): no
materialize-then-fetch, one stage for the whole Partial -> shuffle -> Final
pipeline.

Distributed structure (nothing is gathered globally in row space):

  1. per-shard reads: input batches go to the least-loaded shard; each
     shard scans, lowers and group-codes only its own rows (on several
     processes each reads only the partitions its shards own,
     parallel/multihost.py);
  2. two-pass global key coding: shards exchange only their distinct key
     rows; the union is dense-ranked once (host work proportional to the
     distinct-key count, not the row count) and each shard remaps its local
     codes through its slice of the ranking;
  3. one mesh program: per-shard fused partials, then the exchange:
       G <= 1024: the "batches" step (FusedAggregateStage._batch_step) per
       shard over its rows, then the collectives;
       G  > 1024: per-shard sorted chunked-segment tiles (ops/layout.py) ->
       per-chunk partials (FusedAggregateStage.sorted_step) -> a segment
       fold by chunk owner to dense [G] -> the collectives.
     Either way one readback.

SpmdAggregateExec is emitted by the DistributedPlanner (config
`ballista.tpu.spmd_stages` = true) in place of the
HashAggregate(Final) <- Repartition(hash) <- HashAggregate(Partial)
subtree, collapsing two stages and a shuffle into one stage. It runs on the
card when ctx.backend is "cuda". The mesh spans the task context's
`mesh_devices` when the caller set them, else every CUDA device (the
context's own device when that is not a CUDA device).

Declines: UnsupportedOnDevice (with its reason, counted in
routing_stats()["reasons"] and tracing's spmd.host_fallback) and the
cost-model admission (spmd.host_declined) run the untouched subplan on the
host. Any other exception propagates: an error on the card fails the task
instead of being answered on the host.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.ops.runtime import (
    UnsupportedOnDevice,
    record_routing,
    record_routing_reason,
)
from ballista_tpu_torch.physical.plan import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    batch_table,
    collect_all,
)

# elements of the [G, rows] membership mask one "batches" step may span:
# a shard's rows go through the step in chunks of at most this many / G
_STEP_ELEMENTS = 1 << 24


def _rank_rows(columns):
    """Dense-rank the rows of a small key table (the union of per-shard
    distinct keys). Returns (rank per input row [int32], per-column unique
    key arrays in rank order, n_groups). Work is O(K log K) in the number
    of distinct-key candidates, never in the number of data rows."""
    import pyarrow.compute as pc

    from ballista_tpu_torch.ops.stage import dense_rank

    if not columns:
        return np.zeros(0, dtype=np.int32), [], 1
    encoded = []
    for arr in columns:
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        d = arr if isinstance(arr, pa.DictionaryArray) else pc.dictionary_encode(arr)
        encoded.append(
            (d.indices.to_numpy(zero_copy_only=False).astype(np.int64), d)
        )
    inv, first_idx, n_uniq = dense_rank(
        [(codes_i, len(d.dictionary)) for codes_i, d in encoded]
    )
    take = pa.array(first_idx.astype(np.int64))
    uniq_rows = []
    for arr, (_c, d) in zip(columns, encoded):
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if isinstance(arr, pa.DictionaryArray):
            uniq_rows.append(d.dictionary.take(d.indices.take(take)))
        else:
            uniq_rows.append(arr.take(take))
    return inv.astype(np.int32), uniq_rows, n_uniq


def _key_as_i64(a) -> np.ndarray:
    """Key column -> int64 numpy for the multi-process union all-gather."""
    if isinstance(a, pa.ChunkedArray):
        a = a.combine_chunks()
    if not isinstance(a, pa.Array):
        a = pa.array(a)
    t = a.type
    if pa.types.is_date32(t):
        a = a.cast(pa.int32())
    elif pa.types.is_boolean(t):
        a = a.cast(pa.int8())
    elif not pa.types.is_integer(t):
        raise UnsupportedOnDevice(
            "multi-process key union requires integer-like keys"
        )
    return a.cast(pa.int64()).to_numpy(zero_copy_only=False).astype(np.int64)


def _rebuild_key_arrays(stage, gathered: List[np.ndarray],
                        first_idx: np.ndarray, n_keys: int) -> List[pa.Array]:
    """Group key values in rank order, cast from the int64 wire form back
    to each key expression's Arrow type."""
    gkv = []
    for j in range(n_keys):
        target = stage.group_exprs[j][0].data_type(stage.scan_schema)
        vals = gathered[j][first_idx]
        arr = pa.array(vals)
        if arr.type != target:
            if pa.types.is_date32(target):
                arr = arr.cast(pa.int32()).cast(target)
            elif pa.types.is_boolean(target):
                arr = arr.cast(pa.int8()).cast(target)
            else:
                arr = arr.cast(target)
        gkv.append(arr)
    return gkv


def _fold_rows(acc: Optional[list], rows: list, folds) -> list:
    """Fold one row chunk's logical rows into the running per-shard rows."""
    import torch

    if acc is None:
        return list(rows)
    out = []
    for a, r, f in zip(acc, rows, folds):
        out.append(a + r if f == "sum"
                   else torch.minimum(a, r) if f == "min" else torch.maximum(a, r))
    return out


def unrolled_program(stage, seg: int):
    """The G <= MAX_GROUPS mesh program: per shard the "batches" step over
    its rows (in row chunks that bound the [G, rows] membership mask), then
    one collective per logical row (psum / pmin / pmax by the row's fold).
    program(shard_args) takes one (cols, aux, codes, row_valid) per local
    shard, on that shard's device, and returns the packed int32 [R, seg]
    rows (ops/stage.py _pack_rows) on the first shard's device."""
    from ballista_tpu_torch.parallel.spmd import collective

    folds = stage._folds
    chunk = 1024
    while chunk * 2 * seg <= _STEP_ELEMENTS:
        chunk *= 2

    def per_shard(cols, aux, codes, row_valid):
        acc = None
        for lo in range(0, codes.shape[0], chunk):
            part = {k: v[lo:lo + chunk] for k, v in cols.items()}
            ints, floats = stage._batch_step(
                seg, part, aux, codes[lo:lo + chunk], row_valid[lo:lo + chunk]
            )
            acc = _fold_rows(acc, stage._logical_rows(ints, floats), folds)
        return acc

    def program(shard_args):
        per = [per_shard(*a) for a in shard_args]
        rows = [collective([p[r] for p in per], f) for r, f in enumerate(folds)]
        return stage._pack_rows(rows)

    return program


def sorted_program(stage, G_pad: int, L1: int):
    """The G > MAX_GROUPS mesh program: per shard the sorted step over its
    [V, L1] tiles (per-chunk partials), a segment fold by chunk owner to
    dense [G_pad] (groups a shard never saw keep the fold's identity), then
    the same collectives. program(shard_args) takes one (cols, aux, clen,
    owner) per local shard and returns the packed int32 [R, G_pad] rows on
    the first shard's device."""
    import torch

    from ballista_tpu_torch.parallel.spmd import collective

    folds = stage._folds

    def dense(v, owner, fold):
        if fold == "sum":
            out = torch.zeros(G_pad, dtype=v.dtype, device=v.device)
            return out.index_add_(0, owner, v)
        if v.is_floating_point():
            ident = float("inf") if fold == "min" else float("-inf")
        else:
            info = torch.iinfo(v.dtype)
            ident = info.max if fold == "min" else info.min
        out = torch.full((G_pad,), ident, dtype=v.dtype, device=v.device)
        return out.scatter_reduce_(0, owner, v, reduce="amin" if fold == "min" else "amax")

    def per_shard(cols, aux, clen, owner):
        rows = stage.sorted_step(L1, cols, aux, clen)
        owner = owner.long()
        return [dense(r, owner, f) for r, f in zip(rows, folds)]

    def program(shard_args):
        per = [per_shard(*a) for a in shard_args]
        rows = [collective([p[r] for p in per], f) for r, f in enumerate(folds)]
        return stage._pack_rows(rows)

    return program


class SpmdAggregateExec(ExecutionPlan):
    """Executes Final(Repartition(Partial(input))) as one mesh program.

    Declines (UnsupportedOnDevice, the cost-model admission, a backend other
    than "cuda") run the wrapped subplan on the host: it is the untouched
    original subtree, so the answer is the unfused plan's.
    """

    def __init__(self, subplan: ExecutionPlan) -> None:
        # subplan = HashAggregateExec(FINAL) over RepartitionExec over
        # HashAggregateExec(PARTIAL); kept whole for serde and the host path
        from ballista_tpu_torch.physical.aggregate import AggregateMode, HashAggregateExec
        from ballista_tpu_torch.physical.repartition import RepartitionExec

        if not (isinstance(subplan, HashAggregateExec)
                and subplan.mode == AggregateMode.FINAL
                and isinstance(subplan.input, RepartitionExec)
                and isinstance(subplan.input.input, HashAggregateExec)
                and subplan.input.input.mode == AggregateMode.PARTIAL):
            raise ValueError("SpmdAggregateExec wraps Final(Repartition(Partial))")
        self.subplan = subplan
        self.final = subplan
        self.partial = subplan.input.input
        self._stage = None
        self._mesh = None
        self._mesh_key = None
        self._program = None
        self._program_key = None
        # "mesh" or "host" after each execute (tests and the smoke assert
        # the mesh path ran: the host path gives the same answer)
        self.last_path: Optional[str] = None

    # ------------------------------------------------------------------
    def schema(self) -> pa.Schema:
        return self.subplan.schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> List[ExecutionPlan]:
        # the subplan is serialized and traversed whole; no planner
        # recursion into it (it must stay one stage)
        return []

    def with_children(self, children: List[ExecutionPlan]) -> "SpmdAggregateExec":
        if children:
            raise ValueError("SpmdAggregateExec has no children")
        return self

    def fmt(self) -> str:
        return "SpmdAggregateExec: partial+exchange+final as one mesh program"

    # ------------------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable short id of the fused subtree (cost-model op names)."""
        import hashlib

        def walk(n):
            yield n.fmt()
            for c in n.children():
                yield from walk(c)

        text = "\n".join(walk(self.subplan))
        return hashlib.sha1(text.encode()).hexdigest()[:12]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        from ballista_tpu_torch.ops import costmodel
        from ballista_tpu_torch.utils import tracing

        if partition != 0:
            raise ValueError(f"SpmdAggregateExec has one partition, got {partition}")
        if ctx.backend != "cuda":
            yield from self._execute_host(ctx)
            return
        # the mesh aggregate's cost feeds the store the single-card ladder
        # consults, keyed on this stage's identity
        costmodel.configure(ctx.config)
        op = "mesh.agg|" + self.fingerprint()
        host_op = "mesh.agg.host|" + self.fingerprint()
        # admission: with both paths warm for this stage shape and the mesh
        # predicted slower, decline to the host up front. Cold on either
        # side: admit; the host run stays predictive, so a stage that
        # outgrew its host rate re-tiers and earns the mesh back
        mesh_pred = costmodel.predict(op, 1.0)
        host_pred = costmodel.predict(host_op, 1.0, engine="host")
        if mesh_pred is not None and host_pred is not None and mesh_pred > host_pred:
            record_routing("host", "mesh.agg", mesh_pred, None)
            tracing.incr("spmd.host_declined")
            self.last_path = "host"
            with costmodel.timed(host_op, engine="host"):
                out = collect_all(self.subplan, ctx)
            yield from batch_table(out, ctx.batch_size)
            return
        try:
            with costmodel.timed(op, routing_op="mesh.agg"):
                out = self._execute_mesh(ctx)
        except UnsupportedOnDevice as e:
            tracing.incr("spmd.host_fallback")
            record_routing_reason(f"mesh aggregate: {e}")
            record_routing("host", "mesh.agg")
            self.last_path = "host"
            # the decline still warms the host rate the admission compares
            # against (predictive=False: a forced run must not re-tier)
            with costmodel.timed(host_op, engine="host", predictive=False):
                out = collect_all(self.subplan, ctx)
            yield from batch_table(out, ctx.batch_size)
            return
        self.last_path = "mesh"
        tracing.incr("spmd.mesh")
        yield from batch_table(out, ctx.batch_size)

    def _execute_host(self, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        """Run the untouched subtree on the host. The Final aggregate above
        the hash Repartition spreads groups over all its output partitions;
        this single-partition stage drains every one of them."""
        yield from batch_table(collect_all(self.subplan, ctx), ctx.batch_size)

    # ------------------------------------------------------------------
    def _execute_mesh(self, ctx: TaskContext) -> pa.Table:
        from ballista_tpu_torch.ops.stage import MAX_GROUPS, FusedAggregateStage
        from ballista_tpu_torch.parallel import multihost
        from ballista_tpu_torch.physical.aggregate import needs_exact_float_minmax

        if needs_exact_float_minmax(self.partial):
            # q2-shape MIN(float): the f32 mesh pmin would be equality-joined
            # against exact f64 values; the host subplan instead
            raise UnsupportedOnDevice("exact float min/max required")
        if self._stage is None:
            # float_bits=False: the mesh collectives fold each row on its
            # own, which cannot express the lexicographic hi/lo f64 key
            # pair; this path keeps f32 float min/max
            self._stage = FusedAggregateStage(self.partial, float_bits=False)
        stage = self._stage
        mesh = _context_mesh(self, ctx)
        n_dev = mesh.size
        if multihost.process_count() > 1:
            # several processes: per-process shard reads, a collective key
            # exchange, the same program with a cross-process all_reduce
            return self._execute_mesh_multihost(ctx, stage, mesh, n_dev)

        # ---- 1. per-shard reads: each shard scans and group-codes only its
        # own rows. Batches go to the least-loaded shard (batches are finer
        # than partitions, so skewed or few partitions still balance)
        parts = stage.scan.output_partitioning().partition_count()
        shard_batches: List[List[pa.RecordBatch]] = [[] for _ in range(n_dev)]
        shard_rows = [0] * n_dev
        for p in range(parts):
            for b in stage._scan_batches(p, ctx):
                if not b.num_rows:
                    continue
                si = shard_rows.index(min(shard_rows))
                shard_batches[si].append(b)
                shard_rows[si] += b.num_rows
        shards: List[Optional[dict]] = []
        for bs in shard_batches:
            if not bs:
                shards.append(None)  # empty shard: identity contribution
                continue
            t = pa.Table.from_batches(bs).combine_chunks()
            batch = t.to_batches(max_chunksize=t.num_rows)[0]
            codes, kv, g = stage._group_codes(batch)
            shards.append({"batch": batch, "codes": codes, "kv": kv, "g": g})
        live = [d for d in shards if d is not None]
        if not live:
            return self.schema().empty_table()

        # ---- 2. global key coding from per-shard distincts only
        n_keys = len(stage.group_exprs)
        if n_keys == 0:
            n_groups, gkv = 1, []
            for d in live:
                d["gcodes"] = d["codes"]
        else:
            union_cols = []
            for j in range(n_keys):
                parts_j = []
                for d in live:
                    a = d["kv"][j]
                    parts_j.append(
                        a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a
                    )
                union_cols.append(
                    pa.chunked_array(parts_j).combine_chunks()
                    if len(parts_j) > 1 else parts_j[0]
                )
            inv, gkv, n_groups = _rank_rows(union_cols)
            off = 0
            for d in live:
                mapping = inv[off:off + d["g"]]
                off += d["g"]
                d["gcodes"] = mapping[d["codes"]]
        if n_groups == 0:
            return self.schema().empty_table()

        # ---- 3. lower columns per shard; global int32-sum overflow check
        # (psum adds across shards, so the bound spans all rows)
        for d in live:
            d["npcols"] = stage._lower_columns(d["batch"])
        total_n = sum(d["batch"].num_rows for d in live)
        stage._check_int_ranges([d["npcols"] for d in live], total_n)

        if n_groups <= MAX_GROUPS:
            counts, outputs = self._run_unrolled_mesh(mesh, stage, shards, n_groups)
        else:
            counts, outputs = self._run_sorted_mesh(mesh, stage, shards, n_groups)
        partial_table = stage._assemble_partial(outputs, counts, gkv, n_groups)
        return self.final._final(partial_table)

    def _execute_mesh_multihost(self, ctx, stage, mesh, n_dev) -> pa.Table:
        """Multi-process mesh execution (torch.distributed): this process
        reads only the partitions its local shards own, every process ranks
        the all-gathered distinct-key union identically, and the same
        program runs over the local shards with its collectives
        all-reduced across processes. Every decline is collective
        (multihost.agree): a one-sided decline would leave the other
        processes blocked inside the collectives.

        Scope (collectively enforced): integer/date/bool group keys (the
        key union rides an int64 all-gather) and no string columns
        anywhere in the stage (per-process dictionaries would diverge)."""
        from ballista_tpu_torch.ops.runtime import bucket_rows
        from ballista_tpu_torch.ops.stage import MAX_GROUPS, dense_rank
        from ballista_tpu_torch.parallel import multihost as mh

        # ---- per-process reads: only partitions owned by local shards ----
        parts = stage.scan.output_partitioning().partition_count()
        my_shards = mh.local_shard_ids(mesh)
        shard_batches = {i: [] for i in my_shards}
        shard_rows = {i: 0 for i in my_shards}
        n_keys = len(stage.group_exprs)
        local: Dict[int, dict] = {}
        ok = bool(my_shards)
        my_distinct: List[np.ndarray] = [
            np.zeros(0, dtype=np.int64) for _ in range(n_keys)
        ]
        try:
            if any(
                pa.types.is_string(t) or pa.types.is_large_string(t)
                for t in stage.compiler.used_columns.values()
            ):
                raise UnsupportedOnDevice(
                    "multi-process mesh: string columns diverge per-process dictionaries"
                )
            for p in mh.owned_partitions(parts, mesh):
                for b in stage._scan_batches(p, ctx):
                    if not b.num_rows:
                        continue
                    # balance batches among this process's own shards only
                    si = min(shard_rows, key=shard_rows.get)
                    shard_batches[si].append(b)
                    shard_rows[si] += b.num_rows
            for si, bs in shard_batches.items():
                if not bs:
                    continue
                t = pa.Table.from_batches(bs).combine_chunks()
                batch = t.to_batches(max_chunksize=t.num_rows)[0]
                codes, kv, g = stage._group_codes(batch)
                local[si] = {"batch": batch, "codes": codes, "kv": kv, "g": g}
            # this process's distinct key tuples as parallel int64 columns
            cols_j: List[List[np.ndarray]] = [[] for _ in range(n_keys)]
            for d in local.values():
                for j in range(n_keys):
                    cols_j[j].append(_key_as_i64(d["kv"][j]))
            for j in range(n_keys):
                if cols_j[j]:
                    my_distinct[j] = np.concatenate(cols_j[j])
            for d in local.values():
                d["npcols"] = stage._lower_columns(d["batch"])
        except (UnsupportedOnDevice, MemoryError, OSError, pa.ArrowException):
            # host-side failures too (a missing file, an OOM during decode,
            # a corrupt Parquet file): the decline has to be collective, or
            # the healthy peers block in the all-gather below
            ok = False
        if not mh.agree(ok):
            raise UnsupportedOnDevice("multi-process mesh declined collectively")

        my_rows = sum(d["batch"].num_rows for d in local.values())
        all_rows = mh.allgather_rows(np.array([my_rows], dtype=np.int64))
        if int(all_rows.sum()) == 0:
            return self.schema().empty_table()

        # ---- collective key union; identical ranking on every process ----
        if n_keys == 0:
            n_groups, gkv = 1, []
            for d in local.values():
                d["gcodes"] = d["codes"]
        else:
            gathered = [mh.allgather_rows(c) for c in my_distinct]
            encoded = []
            for col in gathered:
                uniq, inv = np.unique(col, return_inverse=True)
                encoded.append((inv.astype(np.int64), len(uniq)))
            inv_all, first_idx, n_groups = dense_rank(encoded)
            # this process's slice of the gathered ranking
            my_count = sum(d["g"] for d in local.values())
            counts = mh.allgather_rows(np.array([my_count], dtype=np.int64))
            pos = int(counts[: mh.process_index()].sum())
            for d in local.values():
                mapping = inv_all[pos: pos + d["g"]]
                pos += d["g"]
                d["gcodes"] = mapping[d["codes"]].astype(np.int32)
            gkv = _rebuild_key_arrays(stage, gathered, first_idx, n_keys)

        # ---- int-overflow check over the global row count --------------
        ok = True
        try:
            stage._check_int_ranges(
                [d["npcols"] for d in local.values()],
                max(int(all_rows.sum()), 1),
            )
        except UnsupportedOnDevice:
            ok = False
        if not mh.agree(ok):
            raise UnsupportedOnDevice("multi-process int-range decline")

        if n_groups > MAX_GROUPS:
            # n_groups derives from the same gathered union on every
            # process, so the path choice needs no extra agreement
            return self._multihost_sorted(ctx, stage, mesh, local, gkv, n_groups)

        # ---- local shard blocks at the common block size; the same program
        local_max = max([d["batch"].num_rows for d in local.values()], default=1)
        S = mh.global_max(int(bucket_rows(local_max)))
        col_ids = sorted(stage.compiler.used_columns)
        col_blocks: Dict[int, Dict[int, np.ndarray]] = {}
        for idx in col_ids:
            np_dtype = _np_dtype_for(stage.compiler.used_columns[idx])
            blocks = {}
            for si in my_shards:
                big = np.zeros(S, dtype=np_dtype)
                d = local.get(si)
                if d is not None:
                    npcol = d["npcols"][idx].astype(np_dtype, copy=False)
                    big[: len(npcol)] = npcol
                blocks[si] = big
            col_blocks[idx] = mh.make_sharded(mesh, blocks, S * n_dev, np_dtype)
        codes_blocks, valid_blocks = {}, {}
        for si in my_shards:
            cb = np.zeros(S, dtype=np.int32)
            vb = np.zeros(S, dtype=np.bool_)
            d = local.get(si)
            if d is not None:
                n = d["batch"].num_rows
                cb[:n] = d["gcodes"]
                vb[:n] = True
            codes_blocks[si] = cb
            valid_blocks[si] = vb
        codes_g = mh.make_sharded(mesh, codes_blocks, S * n_dev, np.int32)
        valid_g = mh.make_sharded(mesh, valid_blocks, S * n_dev, np.bool_)
        seg = int(bucket_rows(n_groups, 16)) + 1
        program = self._get_program(stage, seg)
        shard_args = [
            ({idx: col_blocks[idx][si] for idx in col_ids},
             _aux(stage, codes_g[si].device), codes_g[si], valid_g[si])
            for si in my_shards
        ]
        rows = self._readback_rows(stage, program(shard_args))
        counts_np = rows[0][:n_groups]
        outputs = [r[:n_groups] for r in rows[1:]]
        partial_table = stage._assemble_partial(outputs, counts_np, gkv, n_groups)
        return self.final._final(partial_table)

    def _multihost_sorted(self, ctx, stage, mesh, local, gkv, n_groups) -> pa.Table:
        """Multi-process path for G > MAX_GROUPS: per-shard sorted
        chunked-segment tiles built locally, tile widths (L1) and chunk
        counts (V) unified with collective maxima, then the same sorted
        program (segment fold + all-reduced collectives)."""
        from ballista_tpu_torch.ops.layout import SortedSegmentLayout
        from ballista_tpu_torch.ops.runtime import bucket_rows
        from ballista_tpu_torch.parallel import multihost as mh

        my_shards = mh.local_shard_ids(mesh)
        n_dev = mesh.size
        # fallible local work is fenced with collective agreement before the
        # next collective: a one-sided raise would strand the others
        ok = True
        layouts: Dict[int, SortedSegmentLayout] = {}
        try:
            for si, d in local.items():
                layouts[si] = SortedSegmentLayout(d["gcodes"], n_groups, min_one_chunk=False)
        except (UnsupportedOnDevice, MemoryError):
            ok = False
        if not mh.agree(ok):
            raise UnsupportedOnDevice("multi-process sorted layout decline")
        L1 = mh.global_max(max((l.L1 for l in layouts.values()), default=8))
        my_V = 1
        ok = True
        try:
            for si in list(layouts):
                if layouts[si].L1 != L1:
                    layouts[si] = SortedSegmentLayout(
                        local[si]["gcodes"], n_groups, force_L1=L1, min_one_chunk=False,
                    )
            my_V = max((l.V for l in layouts.values()), default=1)
        except (UnsupportedOnDevice, MemoryError):
            ok = False
        if not mh.agree(ok):
            raise UnsupportedOnDevice("multi-process sorted rebuild decline")
        V_pad = mh.global_max(int(bucket_rows(my_V, 8)))
        G_pad = int(bucket_rows(n_groups, 16))
        col_ids = sorted(stage.compiler.used_columns)
        col_blocks: Dict[int, Dict[int, np.ndarray]] = {}
        clen_blocks: Dict[int, np.ndarray] = {}
        owner_blocks: Dict[int, np.ndarray] = {}
        ok = True
        try:
            for idx in col_ids:
                np_dtype = _np_dtype_for(stage.compiler.used_columns[idx])
                blocks = {}
                for si in my_shards:
                    big = np.zeros((V_pad, L1), dtype=np_dtype)
                    l = layouts.get(si)
                    if l is not None and l.V:
                        big[: l.V] = l.materialize(
                            local[si]["npcols"][idx].astype(np_dtype, copy=False)
                        )
                    blocks[si] = big
                col_blocks[idx] = blocks
            for si in my_shards:
                cb = np.zeros(V_pad, dtype=np.int16)
                # padding chunks carry identity partials (clen=0); G_pad-1
                # keeps each shard's owner slice sorted
                ob = np.full(V_pad, G_pad - 1, dtype=np.int32)
                l = layouts.get(si)
                if l is not None and l.V:
                    cb[: l.V] = l.clen
                    ob[: l.V] = l.owner
                clen_blocks[si] = cb
                owner_blocks[si] = ob
        except (UnsupportedOnDevice, MemoryError):
            ok = False
        if not mh.agree(ok):
            raise UnsupportedOnDevice("multi-process tile materialization decline")
        cols = {
            idx: mh.make_sharded(mesh, col_blocks.pop(idx), V_pad * n_dev,
                                 _np_dtype_for(stage.compiler.used_columns[idx]))
            for idx in col_ids
        }
        clen_g = mh.make_sharded(mesh, clen_blocks, V_pad * n_dev, np.int16)
        owner_g = mh.make_sharded(mesh, owner_blocks, V_pad * n_dev, np.int32)
        program = self._get_sorted_program(stage, G_pad, L1)
        shard_args = [
            ({idx: cols[idx][si] for idx in col_ids},
             _aux(stage, clen_g[si].device), clen_g[si], owner_g[si])
            for si in my_shards
        ]
        rows = self._readback_rows(stage, program(shard_args))
        counts_np = rows[0][:n_groups]
        outputs = [r[:n_groups] for r in rows[1:]]
        partial_table = stage._assemble_partial(outputs, counts_np, gkv, n_groups)
        return self.final._final(partial_table)

    def _run_unrolled_mesh(self, mesh, stage, shards, n_groups):
        """G <= MAX_GROUPS: each shard's rows, padded to the common block
        size, on that shard's device; the unrolled program; one readback."""
        from ballista_tpu_torch.ops.runtime import bucket_rows, upload

        live_ns = [d["batch"].num_rows for d in shards if d is not None]
        S = int(bucket_rows(max(live_ns)))
        col_ids = sorted(stage.compiler.used_columns)
        shard_args = []
        for d, dev in zip(shards, mesh.flat_devices()):
            if d is None:
                continue  # an empty shard adds only the folds' identities
            n = d["batch"].num_rows
            cols = {idx: upload(_padded(d["npcols"][idx], S), dev) for idx in col_ids}
            codes = np.zeros(S, dtype=np.int32)
            codes[:n] = d["gcodes"]
            valid = np.zeros(S, dtype=np.bool_)
            valid[:n] = True
            shard_args.append((cols, _aux(stage, dev), upload(codes, dev), upload(valid, dev)))
        seg = int(bucket_rows(n_groups, 16)) + 1  # +1 dump slot
        rows = self._readback_rows(stage, self._get_program(stage, seg)(shard_args))
        return rows[0][:n_groups], [r[:n_groups] for r in rows[1:]]

    def _run_sorted_mesh(self, mesh, stage, shards, n_groups):
        """G > MAX_GROUPS: per-shard sorted chunked-segment tiles, chunk
        partials folded to dense [G] in the program, then the collectives.
        Cardinality-independent: device work is O(rows + G)."""
        from ballista_tpu_torch.ops.layout import SortedSegmentLayout
        from ballista_tpu_torch.ops.runtime import bucket_rows, upload

        layouts: List[Optional[SortedSegmentLayout]] = [
            None if d is None
            else SortedSegmentLayout(d["gcodes"], n_groups, min_one_chunk=False)
            for d in shards
        ]
        L1 = max(l.L1 for l in layouts if l is not None)
        for i, (d, l) in enumerate(zip(shards, layouts)):
            if l is not None and l.L1 != L1:
                layouts[i] = SortedSegmentLayout(
                    d["gcodes"], n_groups, force_L1=L1, min_one_chunk=False
                )
        V_pad = int(bucket_rows(max(l.V for l in layouts if l is not None), 8))
        G_pad = int(bucket_rows(n_groups, 16))
        col_ids = sorted(stage.compiler.used_columns)
        shard_args = []
        for d, l, dev in zip(shards, layouts, mesh.flat_devices()):
            if d is None or not l.V:
                continue
            cols = {}
            for idx in col_ids:
                tile = np.zeros((V_pad, L1), dtype=d["npcols"][idx].dtype)
                tile[: l.V] = l.materialize(d["npcols"][idx])
                cols[idx] = upload(tile, dev)
            # padding chunks carry identity partials (clen=0 -> empty mask)
            clen = np.zeros(V_pad, dtype=np.int16)
            clen[: l.V] = l.clen
            owner = np.full(V_pad, G_pad - 1, dtype=np.int32)
            owner[: l.V] = l.owner
            shard_args.append((cols, _aux(stage, dev), upload(clen, dev), upload(owner, dev)))
        program = self._get_sorted_program(stage, G_pad, L1)
        rows = self._readback_rows(stage, program(shard_args))
        return rows[0][:n_groups], [r[:n_groups] for r in rows[1:]]

    @staticmethod
    def _readback_rows(stage, packed) -> List[np.ndarray]:
        from ballista_tpu_torch.ops.runtime import readback

        return stage._decode_stacked(readback(packed))

    def _get_program(self, stage, seg: int):
        """The unrolled mesh program, built once per segment bucket."""
        key = ("unrolled", seg)
        if self._program_key != key:
            self._program = unrolled_program(stage, seg)
            self._program_key = key
        return self._program

    def _get_sorted_program(self, stage, G_pad: int, L1: int):
        """The sorted mesh program, built once per (group bucket, L1)."""
        key = ("sorted", G_pad, L1)
        if self._program_key != key:
            self._program = sorted_program(stage, G_pad, L1)
            self._program_key = key
        return self._program


def _aux(stage, device) -> list:
    from ballista_tpu_torch.ops.runtime import upload

    return [upload(np.asarray(a), device) for a in stage.compiler.build_aux()]


def _padded(arr: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _np_dtype_for(dtype: pa.DataType) -> np.dtype:
    """The numpy dtype column_to_numpy produces for an Arrow type, derived
    by lowering a zero-length column through column_to_numpy itself, so an
    empty process's blocks always match its data-bearing peers'."""
    from ballista_tpu_torch.ops.runtime import ColumnDictionary, column_to_numpy

    d = (
        ColumnDictionary()
        if pa.types.is_string(dtype) or pa.types.is_large_string(dtype)
        else None
    )
    return column_to_numpy(pa.array([], type=dtype), dtype, d).dtype


def _context_mesh(node, ctx: TaskContext):
    """The mesh a mesh stage runs on: the context's mesh_devices (or every
    CUDA device) shaped by ballista.tpu.mesh; a shape that needs more
    devices than there are falls back to one shard per device. Cached on
    the node per (shape, devices)."""
    from ballista_tpu_torch.parallel import multihost
    from ballista_tpu_torch.parallel.mesh import build_mesh, default_devices

    devices = getattr(ctx, "mesh_devices", None) or default_devices(ctx.device)
    shape = ctx.config.mesh_shape() or None
    key = (tuple(sorted((shape or {}).items())), tuple(str(d) for d in devices))
    if node._mesh is None or node._mesh_key != key:
        try:
            node._mesh = build_mesh(shape, devices)
        except ValueError:
            node._mesh = build_mesh(
                {"data": len(devices) * multihost.process_count()}, devices
            )
        node._mesh_key = key
    return node._mesh
