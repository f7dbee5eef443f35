"""Mesh co-partitioned join: the hash-repartition exchange as one mesh
program.

The reference feeds a partitioned join through two materialized hash
shuffles (RepartitionExec -> ShuffleWriter/Reader pairs) and joins partition
pairs on the CPU. Here key-hash buckets are exchanged between mesh shards
with all_to_all (parallel/spmd.py) inside one program, and each shard
matches its key range with sort + searchsorted, the same regular shape the
device join uses (ops/join.py match_runs / gather_matches).

What travels between shards is (dense key code, row id) per side, the
matching plane. Payload columns do not: every payload row is already in
this process, so the final assembly is an Arrow take on the matched row-id
pairs the program returns.

Key coding is shared with the host join (physical/joinutil.py): any Arrow
key type, composite keys, nulls -> -1 (never match). Coding is dense, so
bucket ownership `splitmix(code) % n_dev` balances shards and codes fit
int32 for the device sort.

Duplicate build keys run on the mesh: each shard computes per-probe match
run-lengths with paired searchsorted (side='left'/'right') and materializes
them through a bounded-width gather whose static width is the smallest
admission tier (ops/kernels.py JOIN_MULTIPLICITY_TIERS) covering the build
side's largest key multiplicity. Output order is the JAX package's:
probe-slot-major over the exchanged probe slots, stable among ties.

Declines: non-INNER/LEFT join types, residual filters, several processes
(the reference's mesh join is single-process too), multiplicity past the
top tier (steps aside to the inline host join) and the cost-model
admission. Each decline is an UnsupportedOnDevice or an inline host join
with its recorded reason; any other exception propagates and fails the
task. Every outcome is recorded via runtime.record_join_path.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.logical.plan import JoinType
from ballista_tpu_torch.ops.runtime import UnsupportedOnDevice, record_join_path, record_routing
from ballista_tpu_torch.physical.plan import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    batch_table,
    collect_all,
)
from ballista_tpu_torch.physical.repartition import RepartitionExec, _splitmix64


def _strip_repartition(node: ExecutionPlan) -> ExecutionPlan:
    """The mesh program is the exchange: read the repartition's input."""
    return node.input if isinstance(node, RepartitionExec) else node


def stage_side(codes: np.ndarray, n_dev: int):
    """Rows -> per-(source shard, dest shard) buckets, padded to a common
    capacity C. Source shard = row % n_dev (each shard would read its own
    partitions); dest = splitmix(code) % n_dev. Returns (codes
    [n_dev * n_dev * C] int32, row ids the same, C); pad slots are -1."""
    n = len(codes)
    src = np.arange(n, dtype=np.int64) % n_dev
    dest = (_splitmix64(np.maximum(codes, 0)) % np.uint64(n_dev)).astype(np.int64)
    flat = src * n_dev + dest
    counts = np.bincount(flat, minlength=n_dev * n_dev)
    C = max(1, int(counts.max()))
    B = n_dev * C
    out_codes = np.full(n_dev * B, -1, dtype=np.int32)
    out_rows = np.full(n_dev * B, -1, dtype=np.int32)
    order = np.argsort(flat, kind="stable")
    sorted_flat = flat[order]
    starts = np.searchsorted(sorted_flat, np.arange(n_dev * n_dev))
    ends = np.searchsorted(sorted_flat, np.arange(n_dev * n_dev), side="right")
    for s in range(n_dev):
        for d in range(n_dev):
            lo, hi = int(starts[s * n_dev + d]), int(ends[s * n_dev + d])
            rows = order[lo:hi]
            base = s * B + d * C
            out_codes[base: base + len(rows)] = codes[rows]
            out_rows[base: base + len(rows)] = rows
    return out_codes, out_rows, C


def join_program(devices: List, width: int, want_left_bitmap: bool):
    """The mesh join program: all_to_all of (code, row id) for both sides,
    then per shard a stable sort of the build codes, match_runs and a
    bounded-width gather (ops/join.py). program(lc, lr, pc, pr) takes one
    block per shard of each side (on that shard's device) and returns, per
    shard, (matched [probe slots, width], probe row ids) and, with the left
    bitmap, (left slot matched, left row ids)."""
    import torch

    from ballista_tpu_torch.ops.join import gather_matches, match_runs
    from ballista_tpu_torch.parallel.spmd import all_to_all

    def per_shard(lcode, lrow, pcode, prow):
        sl, order = torch.sort(lcode, stable=True)
        slrow = lrow[order]
        starts, counts = match_runs(sl, pcode)
        outs = [gather_matches(slrow, starts, counts, width), prow]
        if want_left_bitmap:
            # a left slot is matched iff its key occurs among this shard's
            # probe codes: binary search over the sorted probe plane
            sp = torch.sort(pcode).values
            lo = torch.searchsorted(sp, sl, side="left")
            hi = torch.searchsorted(sp, sl, side="right")
            hit_sorted = (hi > lo) & (sl >= 0)
            lmatched = torch.zeros(lcode.shape[0], dtype=torch.bool, device=lcode.device)
            lmatched[order] = hit_sorted
            outs.extend([lmatched, lrow])
        return outs

    def program(lc, lr, pc, pr):
        # the exchange: every shard sends bucket d of its slice to shard d
        # and receives all buckets it owns
        lc, lr = all_to_all(lc, devices), all_to_all(lr, devices)
        pc, pr = all_to_all(pc, devices), all_to_all(pr, devices)
        return [per_shard(*a) for a in zip(lc, lr, pc, pr)]

    return program


class SpmdJoinExec(ExecutionPlan):
    """Executes HashJoin(Repartition(L), Repartition(R)) as one mesh program.

    Mirrors SpmdAggregateExec's contract: one output partition, the wrapped
    subplan serialized whole (serde and host path), `last_path` records
    whether the mesh ran ("mesh", "host-inline" or "host").
    """

    def __init__(self, subplan) -> None:
        from ballista_tpu_torch.physical.join import HashJoinExec

        if not isinstance(subplan, HashJoinExec):
            raise ValueError("SpmdJoinExec wraps a HashJoinExec")
        self.subplan = subplan  # kept whole for serde
        self._mesh = None
        self._mesh_key = None
        self.last_path: Optional[str] = None

    # ------------------------------------------------------------------
    def schema(self) -> pa.Schema:
        return self.subplan.schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> List[ExecutionPlan]:
        return []  # serialized and traversed whole; must stay one stage

    def with_children(self, children: List[ExecutionPlan]) -> "SpmdJoinExec":
        if children:
            raise ValueError("SpmdJoinExec has no children")
        return self

    def fmt(self) -> str:
        on = ", ".join(f"{l} = {r}" for l, r in self.subplan.on)
        return (
            f"SpmdJoinExec: type={self.subplan.join_type.value}, on=[{on}], "
            "all_to_all exchange as one mesh program"
        )

    # ------------------------------------------------------------------
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        from ballista_tpu_torch.utils import tracing

        if partition != 0:
            raise ValueError(f"SpmdJoinExec has one partition, got {partition}")
        if ctx.backend != "cuda":
            yield from self._execute_host(ctx)
            return
        try:
            self._inline_host = False
            self._mesh_cost = (None, None)
            out = self._execute_mesh(ctx)
        except UnsupportedOnDevice as e:
            tracing.incr("spmd.join_host_fallback")
            record_join_path("host_fallback", f"mesh join: {e}")
            record_routing("host", "join.mesh")
            self.last_path = "host"
            yield from self._execute_host(ctx)
            return
        self.last_path = "host-inline" if self._inline_host else "mesh"
        tracing.incr("spmd.join_host_inline" if self._inline_host else "spmd.join_mesh")
        if not self._inline_host:
            predicted, observed = self._mesh_cost
            record_join_path("device")
            record_routing("device", "join.mesh", predicted_s=predicted, observed_s=observed)
        yield from batch_table(out, ctx.batch_size)

    def _execute_host(self, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        yield from batch_table(collect_all(self.subplan, ctx), ctx.batch_size)

    # ------------------------------------------------------------------
    def _execute_mesh(self, ctx: TaskContext) -> pa.Table:
        import time as _time

        import torch

        from ballista_tpu_torch.ops import costmodel
        from ballista_tpu_torch.ops.kernels import host_fallback, join_multiplicity_tier
        from ballista_tpu_torch.ops.runtime import readback, upload
        from ballista_tpu_torch.parallel import multihost
        from ballista_tpu_torch.parallel.spmd import shard_blocks
        from ballista_tpu_torch.parallel.spmd_stage import _context_mesh
        from ballista_tpu_torch.physical.joinutil import (
            _refactorize,
            combined_key_codes,
            take_table,
        )

        if multihost.process_count() > 1:
            # collect_all below reads this process's rows only, but the mesh
            # spans every process: decline to the host join
            raise UnsupportedOnDevice("mesh join is single-process")
        join = self.subplan
        if join.join_type not in (JoinType.INNER, JoinType.LEFT):
            raise UnsupportedOnDevice(f"mesh join type {join.join_type.value}")
        if join.filter is not None:
            raise UnsupportedOnDevice("mesh join residual filter")

        mesh = _context_mesh(self, ctx)
        n_dev = mesh.size

        # the mesh replaces the hash exchange: read the repartition inputs
        left = collect_all(_strip_repartition(join.left), ctx)
        right = collect_all(_strip_repartition(join.right), ctx)
        if max(left.num_rows, right.num_rows) >= (1 << 31):
            raise UnsupportedOnDevice("row ids exceed int32")

        lkeys = [n for n, _ in join.on]
        rkeys = [n for _, n in join.on]
        bcodes, pcodes = combined_key_codes(
            [left.column(k) for k in lkeys], [right.column(k) for k in rkeys]
        )
        if left.num_rows == 0 or right.num_rows == 0:
            # no mesh work to do; join inline over what was collected
            return self._host_join_collected(
                left, right, bcodes, pcodes, reason="empty join side"
            )
        hi = max(int(bcodes.max()), int(pcodes.max()))
        if hi >= (1 << 31):
            # dense re-map: distinct count <= row count < 2^31. _refactorize
            # gives the -1 null sentinel a dense code too: restore it, or
            # null keys would match each other on the mesh
            bnull, pnull = bcodes < 0, pcodes < 0
            bcodes, pcodes, _ = _refactorize(bcodes, pcodes)
            bcodes = np.where(bnull, -1, bcodes)
            pcodes = np.where(pnull, -1, pcodes)
        # build-key multiplicity bounds the static gather width
        valid_b = bcodes >= 0
        if valid_b.any():
            _, dup_counts = np.unique(bcodes[valid_b], return_counts=True)
            max_mult = int(dup_counts.max())
        else:
            max_mult = 0

        lc, lr, C_l = stage_side(bcodes, n_dev)
        pc_, pr, C_p = stage_side(pcodes, n_dev)

        # admission: the smallest static gather width covering the build-key
        # multiplicity; past the ladder the mesh steps aside to the inline
        # host join (the sides are already collected and coded)
        costmodel.configure(ctx.config)
        width, why = join_multiplicity_tier(max_mult, n_dev * n_dev * C_p)
        if width is None:
            host_fallback(why)
            return self._host_join_collected(
                left, right, bcodes, pcodes, kind="step_aside", reason=why
            )
        # cost-model admission: with both the mesh exchange and the inline
        # host join warm for this shape, skip the mesh when the model says
        # the host wins. Cold on either side: admit
        mesh_units = n_dev * n_dev * C_p * width
        mesh_pred = costmodel.predict("join.mesh", mesh_units)
        host_pred = costmodel.predict("join.host", len(bcodes) + len(pcodes), engine="host")
        if mesh_pred is not None and host_pred is not None and mesh_pred > host_pred:
            return self._host_join_collected(
                left, right, bcodes, pcodes, kind="host_declined",
                reason=f"cost model: mesh {mesh_pred:.4f}s > host {host_pred:.4f}s",
            )

        devices = mesh.flat_devices()
        program = join_program(devices, width, join.join_type == JoinType.LEFT)
        t_mesh0 = _time.perf_counter()
        outs = program(*(shard_blocks(upload(a, devices[0]), mesh)
                         for a in (lc, lr, pc_, pr)))
        # matched build rows per probe slot [n_dev * B_p, width], -1 = no
        # match, and the exchanged probe row ids; shard-major, as the
        # reference's axis-0-sharded outputs concatenate
        cat = [torch.cat([o[k].to(devices[0]) for o in outs]) for k in range(len(outs[0]))]
        matched = readback(cat[0], rows=cat[0].shape[0])
        recv_prow = readback(cat[1])
        dt_mesh = _time.perf_counter() - t_mesh0
        costmodel.observe("join.mesh", mesh_units, dt_mesh)
        costmodel.check_mispredict("join.mesh", mesh_units, mesh_pred, dt_mesh)
        self._mesh_cost = (mesh_pred, dt_mesh)

        # flatten probe-slot-major: pad and null slots have all-(-1) rows,
        # so their repeat count is 0 and they vanish from the selection
        hits = matched >= 0
        lidx = matched[hits].astype(np.int64)
        ridx = np.repeat(recv_prow, hits.sum(axis=1)).astype(np.int64)
        left_out = take_table(left, lidx)
        right_out = take_table(right, ridx)
        if join.join_type == JoinType.LEFT:
            lmatched = readback(cat[2])
            recv_lrow = readback(cat[3])
            un = recv_lrow[(recv_lrow >= 0) & ~lmatched].astype(np.int64)
            if len(un):
                left_un = take_table(left, un)
                nulls = pa.table(
                    [pa.nulls(len(un), type=f.type) for f in right.schema],
                    schema=right.schema,
                )
                left_out = pa.concat_tables([left_out, left_un])
                right_out = pa.concat_tables([right_out, nulls])
        cols = list(left_out.columns) + list(right_out.columns)
        return pa.table(cols, schema=self.schema())

    def _host_join_collected(
        self, left: pa.Table, right: pa.Table,
        bcodes: np.ndarray, pcodes: np.ndarray,
        kind: str = "host_fallback", reason: str = "",
    ) -> pa.Table:
        """Vectorized host join over the already-collected sides: the
        decline path for shapes the mesh program does not take
        (multiplicity past the tiers, empty sides, the cost model). One
        collect and one join pass; no shuffle, no re-execution."""
        from ballista_tpu_torch.ops import costmodel
        from ballista_tpu_torch.physical.joinutil import join_indices, take_table

        record_routing("host", "join.mesh")
        record_join_path(kind, reason or None)
        self._inline_host = True
        how = "inner" if self.subplan.join_type == JoinType.INNER else "left"
        with costmodel.timed("join.host", len(bcodes) + len(pcodes),
                             engine="host", predictive=False):
            li, ri = join_indices(bcodes, pcodes, how)
        lt = take_table(left, li)
        rt = take_table(right, ri)
        return pa.table(list(lt.columns) + list(rt.columns), schema=self.schema())
