"""Distributed execution operators.

The reference's stage-stitching operator trio
(rust/core/src/execution_plans/): QueryStageExec -> here ShuffleWriterExec
(with map-side hash split, the design later Ballista versions adopted),
ShuffleReaderExec (fetch materialized partitions from peers), and
UnresolvedShuffleExec (placeholder until upstream stages complete,
ref unresolved_shuffle.rs:34-91).

Shuffle file layout under an executor's work dir:
    {work_dir}/{job_id}/{stage_id}/{input_partition}/{output_partition}.arrow
CompletedTask.path points at the {input_partition} directory; readers derive
piece paths from it (ref flight_service.rs:104-126 wrote a single data.arrow).

Disaggregated shuffle tier (ISSUE 15): with ballista.shuffle.tier=shared the
SAME layout roots at ballista.shuffle.dir instead of the executor's private
work dir, published with the same atomic tmp-then-os.replace discipline. A
piece's home is then a path, not a process — CompletedTask/PartitionLocation
carry it as `storage_uri` — so executor death after map completion loses
nothing, and readers resolve storage-homed pieces from the shared dir FIRST,
with the Flight peer fetch as the local-tier path and the fallback ladder
(storage read -> peer fetch -> fetch_failed/lineage recompute).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Tuple

import pyarrow as pa
import pyarrow.ipc

from ballista_tpu_torch.errors import ExecutionError, InternalError
from ballista_tpu_torch.physical.expr import PhysicalExpr
from ballista_tpu_torch.physical.plan import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    batch_table,
)
from ballista_tpu_torch.physical.repartition import hash_rows
from ballista_tpu_torch.physical.expr import _as_array
from ballista_tpu_torch.utils import counters, tracing


class PartitionStats:
    """Row/batch/byte counts for a materialized partition
    (ref utils.rs:49-84 PartitionStats accumulation)."""

    def __init__(self, num_rows: int = 0, num_batches: int = 0, num_bytes: int = 0) -> None:
        self.num_rows = num_rows
        self.num_batches = num_batches
        self.num_bytes = num_bytes

    def __repr__(self) -> str:
        return f"PartitionStats(rows={self.num_rows}, batches={self.num_batches}, bytes={self.num_bytes})"


def _ipc_options(codec: Optional[str]) -> Optional[pa.ipc.IpcWriteOptions]:
    """Shuffle piece compression (ballista.shuffle.codec: "", zstd, lz4).
    Readers decompress transparently — the frame carries the codec."""
    if not codec:
        return None
    return pa.ipc.IpcWriteOptions(compression=codec)


def _piece_tmp_path(path: str) -> str:
    """Writer-unique temp name beside the final piece. Pieces are published
    by os.replace so a reader (or a concurrent duplicate execution — e.g. a
    client retrying an execute_partition whose first run is still going)
    never sees a half-written or interleaved file: last complete writer
    wins atomically."""
    import threading

    return f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"


def write_stream_to_disk(
    batches: Iterator[pa.RecordBatch], schema: pa.Schema, path: str,
    codec: Optional[str] = None, pre_publish=None,
) -> PartitionStats:
    """Arrow IPC file writer with stats (ref utils.rs write_stream_to_disk).
    Writes to a temp name and atomically publishes on success. `pre_publish`
    (shared tier, ISSUE 15) runs after the temp file closed clean and before
    the os.replace — a raise there is a TORN write: the temp is discarded
    and nothing was published, exactly the failure the shuffle.store chaos
    site rehearses."""
    stats = PartitionStats()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = _piece_tmp_path(path)
    try:
        with pa.ipc.new_file(tmp, schema, options=_ipc_options(codec)) as w:
            for b in batches:
                w.write_batch(b)
                stats.num_rows += b.num_rows
                stats.num_batches += 1
                stats.num_bytes += b.nbytes
        if pre_publish is not None:
            pre_publish()
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return stats


def shuffle_output_base(
    ctx: TaskContext, job_id: str, stage_id: int, partition: int
) -> Tuple[str, str]:
    """(piece-set base dir, storage_uri) for one map task's output.

    Shared tier: the base roots at ballista.shuffle.dir and doubles as the
    storage_uri — the location's home is the path itself, so any node with
    the mount resolves the pieces without the producing executor. Local
    tier: the executor's private work dir, storage_uri empty (peers fetch
    over Flight, the reference design)."""
    root = ctx.config.shuffle_storage_root()
    if root:
        base = os.path.join(root, job_id, str(stage_id), str(partition))
        return base, base
    if ctx.work_dir is None:
        raise ExecutionError("shuffle write requires a work_dir")
    return os.path.join(ctx.work_dir, job_id, str(stage_id), str(partition)), ""


def read_ipc_file(path: str) -> Iterator[pa.RecordBatch]:
    with pa.ipc.open_file(path) as r:
        for i in range(r.num_record_batches):
            yield r.get_batch(i)


class _ExchangeCapture:
    """Producer-side tee for the HBM-resident exchange tier (ISSUE 16):
    accumulates the batches streaming through a shuffle write, per output
    piece, until ballista.tpu.residency_budget_bytes says stop — the write
    itself is untouched (the disk piece stays the authoritative home), and
    an over-budget capture is abandoned wholesale rather than registering a
    partial piece. Published to ops/exchange.py only AFTER the atomic
    os.replace, so the registry never advertises bytes the piece ladder
    cannot also produce."""

    def __init__(self, ctx: TaskContext, job_id: str, stage_id: int,
                 map_partition: int, attempt: int) -> None:
        self.executor_id = ctx.executor_id
        self.job_id = job_id
        self.stage_id = stage_id
        self.map_partition = map_partition
        self.attempt = attempt
        self.budget = ctx.config.residency_budget()
        # per-tenant residency cap (ISSUE 19 satellite): captured from the
        # job's config here so the registry's leaf lock never reads config
        self.tenant = ctx.config.tenant()
        self.tenant_budget = ctx.config.tenant_residency_budget()
        self.nbytes = 0
        self.overflow = False
        self.pieces: dict = {}  # piece idx -> [RecordBatch]

    @staticmethod
    def for_task(ctx: TaskContext, job_id: str, stage_id: int,
                 partition: int) -> "Optional[_ExchangeCapture]":
        """A capture when the exchange tier is on AND this context runs on
        a real executor (empty executor_id = in-process/local engine, where
        a process-global registry would fake same-executor locality)."""
        if not ctx.executor_id or not ctx.config.tpu_exchange():
            return None
        return _ExchangeCapture(ctx, job_id, stage_id, partition, ctx.attempt)

    def add(self, piece: int, batch: pa.RecordBatch) -> None:
        if self.overflow or not batch.num_rows:
            return
        self.nbytes += batch.nbytes
        if self.nbytes > self.budget:
            self.overflow = True
            self.pieces = {}
            return
        self.pieces.setdefault(piece, []).append(batch)

    def publish(self, schema: pa.Schema, finals: dict) -> bool:
        """Register the captured pieces; `finals` maps piece idx -> the
        published on-disk path. Returns whether anything was kept."""
        from ballista_tpu_torch.ops import exchange

        if self.overflow:
            counters.exchange.record("skipped_budget")
            return False
        kept = False
        for piece, batches in self.pieces.items():
            kept |= exchange.publish(
                self.executor_id, self.job_id, self.stage_id,
                self.map_partition, piece, batches, schema,
                self.attempt, finals[piece], self.budget,
                tenant=self.tenant, tenant_budget=self.tenant_budget,
            )
        return kept


class ShuffleWriterExec(ExecutionPlan):
    """Stage-top operator: executes one input partition of its child and
    materializes it, hash/round-robin split across output partitions."""

    def __init__(
        self,
        job_id: str,
        stage_id: int,
        input: ExecutionPlan,
        output_partitioning: Optional[Partitioning] = None,
    ) -> None:
        self.job_id = job_id
        self.stage_id = stage_id
        self.input = input
        # None -> passthrough (one output piece per input partition)
        self.shuffle_output_partitioning = output_partitioning

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        # tasks are per INPUT partition
        return self.input.output_partitioning()

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "ShuffleWriterExec":
        return ShuffleWriterExec(
            self.job_id, self.stage_id, children[0], self.shuffle_output_partitioning
        )

    def out_partition_count(self) -> int:
        if self.shuffle_output_partitioning is None:
            return self.input.output_partitioning().partition_count()
        return self.shuffle_output_partitioning.partition_count()

    # ------------------------------------------------------------------
    def _storage_publish_chaos(self, partition: int, ctx: TaskContext):
        """Pre-publish hook for the shared tier: a `shuffle.store` write
        verdict (keyed on plan coordinates + attempt, so the retried
        attempt draws fresh) raises AFTER the temp pieces closed clean and
        BEFORE any os.replace — a torn publish that leaves nothing visible.
        None on the local tier (the site is about the storage tier)."""
        from ballista_tpu_torch.utils.chaos import chaos_from_config

        chaos = chaos_from_config(ctx.config)
        if chaos is None:
            return None

        def pre_publish() -> None:
            from ballista_tpu_torch.utils.chaos import ChaosInjected

            try:
                chaos.maybe_fail(
                    "shuffle.store",
                    f"w{self.stage_id}/{partition}@a{ctx.attempt}",
                )
            except ChaosInjected:
                counters.shuffle_tier.record("storage_publish_torn")
                raise

        return pre_publish

    def execute_shuffle_write(self, partition: int, ctx: TaskContext) -> PartitionStats:
        """Run the child partition and write the split pieces; returns
        aggregate stats. Piece paths: {base}/{m}.arrow with {base} from
        shuffle_output_base — the executor work dir (local tier) or the
        shared storage dir (shared tier, same atomic publish)."""
        base, storage_uri = shuffle_output_base(
            ctx, self.job_id, self.stage_id, partition
        )
        schema = self.schema()
        pscheme = self.shuffle_output_partitioning
        total = PartitionStats()
        codec = ctx.config.shuffle_codec()
        pre_publish = (
            self._storage_publish_chaos(partition, ctx) if storage_uri else None
        )
        capture = _ExchangeCapture.for_task(
            ctx, self.job_id, self.stage_id, partition
        )
        if pscheme is None:
            piece_path = os.path.join(base, "0.arrow")

            def teed() -> Iterator[pa.RecordBatch]:
                for b in self.input.execute(partition, ctx):
                    if capture is not None:
                        capture.add(0, b)
                    yield b

            stats = write_stream_to_disk(
                teed(), schema, piece_path, codec=codec,
                pre_publish=pre_publish,
            )
            counters.shuffle_tier.record(
                "storage_publish" if storage_uri else "local_publish"
            )
            if capture is not None:
                # only after the atomic publish: the registry must never
                # advertise a piece the ladder cannot also produce
                capture.publish(schema, {0: piece_path})
            return stats
        n_out = pscheme.partition_count()
        writers = []
        os.makedirs(base, exist_ok=True)
        opts = _ipc_options(codec)
        finals = [os.path.join(base, f"{m}.arrow") for m in range(n_out)]
        tmps = [_piece_tmp_path(p) for p in finals]
        for tmp in tmps:
            sink = pa.OSFile(tmp, "wb")
            writers.append((sink, pa.ipc.new_file(sink, schema, options=opts)))
        ok = False
        try:
            import numpy as np

            from ballista_tpu_torch.physical.repartition import split_by_partition

            for batch in self.input.execute(partition, ctx):
                if pscheme.scheme == "hash":
                    keys = [
                        _as_array(e.evaluate(batch), batch.num_rows)
                        for e in pscheme.exprs
                    ]
                    ids = hash_rows(keys, n_out)
                else:
                    ids = np.arange(batch.num_rows, dtype=np.int64) % n_out
                for m, piece in enumerate(split_by_partition(batch, ids, n_out)):
                    if piece.num_rows:
                        writers[m][1].write_batch(piece)
                        if capture is not None:
                            capture.add(m, piece)
                        total.num_rows += piece.num_rows
                        total.num_bytes += piece.nbytes
                total.num_batches += 1
            if pre_publish is not None:
                # shared-tier torn-write seam: raising here leaves ok=False,
                # so every temp piece is discarded and nothing publishes
                pre_publish()
            ok = True
        finally:
            for sink, w in writers:
                w.close()
                sink.close()
            if ok:
                # publish atomically only after EVERY piece closed clean —
                # readers (and concurrent duplicate executions) never see a
                # partial or interleaved piece
                for tmp, final in zip(tmps, finals):
                    os.replace(tmp, final)
            else:
                for tmp in tmps:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        if ok:
            counters.shuffle_tier.record(
                "storage_publish" if storage_uri else "local_publish"
            )
            if capture is not None:
                capture.publish(schema, dict(enumerate(finals)))
        return total

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        # in-process fallback: write then read back the pieces concatenated
        self.execute_shuffle_write(partition, ctx)
        base, _storage = shuffle_output_base(
            ctx, self.job_id, self.stage_id, partition
        )
        for name in sorted(os.listdir(base)):
            # only PUBLISHED pieces: a concurrent duplicate execution's
            # in-flight *.tmp-* files are not readable IPC yet
            if name.endswith(".arrow"):
                yield from read_ipc_file(os.path.join(base, name))

    def fmt(self) -> str:
        return (
            f"ShuffleWriterExec: job={self.job_id}, stage={self.stage_id}, "
            f"out={self.shuffle_output_partitioning!r}"
        )


class ShuffleLocation:
    """Where one completed map task's output lives. stage_id/map_partition
    name the producing map task (lineage): a reduce task that fails to fetch
    from here reports them in its fetch_failed status so the scheduler can
    recompute exactly that map partition.

    storage_uri (ISSUE 15): non-empty when the piece set lives in the
    SHARED storage tier — the home is then the path itself, readers resolve
    it from the mount first, and the executor coordinates degrade to a
    fallback transport rather than the data's single point of failure.

    resident (ISSUE 16): a HINT that the producing executor also registered
    this piece set in its HBM-resident exchange registry — a same-executor
    consumer resolves it with zero decode and zero re-upload, and the
    scheduler prefers placing consumers where their inputs are resident.
    Never load-bearing: a stale hint (evicted entry, dead producer) just
    falls through to the authoritative piece ladder."""

    def __init__(
        self,
        executor_id: str,
        host: str,
        port: int,
        path: str,
        stage_id: int = 0,
        map_partition: int = 0,
        storage_uri: str = "",
        resident: bool = False,
        nbytes: int = 0,
    ) -> None:
        self.executor_id = executor_id
        self.host = host
        self.port = port
        self.path = path  # base dir containing {m}.arrow pieces
        self.stage_id = stage_id
        self.map_partition = map_partition
        self.storage_uri = storage_uri
        self.resident = resident
        # total piece-set bytes (PartitionStats.num_bytes): sizes the
        # scheduler's predicted transfer saving for locality ordering
        self.nbytes = nbytes

    def __repr__(self) -> str:
        home = f", storage={self.storage_uri}" if self.storage_uri else ""
        return (
            f"ShuffleLocation({self.executor_id}@{self.host}:{self.port}, "
            f"{self.path}, map={self.stage_id}/{self.map_partition}{home})"
        )


class ShuffleReaderExec(ExecutionPlan):
    """Leaf reading previously materialized shuffle output
    (ref shuffle_reader.rs:33-100). For output partition m it fetches piece m
    from every map task's location — local disk read or Flight fetch via
    ctx.shuffle_fetcher."""

    def __init__(
        self,
        locations: List[ShuffleLocation],
        schema: pa.Schema,
        num_partitions: int,
        identity: bool = False,
    ) -> None:
        self.locations = locations
        self._schema = schema
        self.num_partitions = num_partitions
        # identity mapping: output partition m is exactly map task m's single
        # piece (a passthrough/merge boundary, no re-split)
        self.identity = identity

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(self.num_partitions)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        if self.identity:
            loc = self.locations[partition]
            yield from self._read_piece(loc, 0, ctx)
            return
        workers = ctx.config.tpu_ingest_workers()
        if workers <= 0 or len(self.locations) <= 1:
            for loc in self.locations:
                yield from self._read_piece(loc, partition, ctx)
            return
        # per-location fetches are independent (local disk read or a Flight
        # round-trip to the owning executor, each with its own client):
        # fetch up to `workers` pieces concurrently so reduce stages overlap
        # network with decode, but yield pieces in location order — batch
        # order must match the serial loop exactly. Tradeoff vs the serial
        # loop: overlapping requires buffering, so up to ingest_depth + 1
        # WHOLE pieces are resident at once (a piece is one map task's
        # output for this reduce partition, i.e. ~1/num_partitions of a map
        # task) where the serial path streams batch-by-batch; set
        # ingest_workers=0 to restore the streaming read if pieces are huge.
        from ballista_tpu_torch.ops.runtime import ordered_map

        def fetch(loc: ShuffleLocation) -> List[pa.RecordBatch]:
            with tracing.span("shuffle.fetch"):
                return list(self._read_piece(loc, partition, ctx))

        for piece_batches in ordered_map(
            fetch, self.locations, workers, ctx.config.tpu_ingest_depth()
        ):
            yield from piece_batches

    def _read_piece(
        self, loc: ShuffleLocation, piece_idx: int, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        from ballista_tpu_torch.errors import RpcError, ShuffleFetchError
        from ballista_tpu_torch.utils.chaos import ChaosInjected, chaos_from_config

        piece = os.path.join(loc.path, f"{piece_idx}.arrow")
        chaos = chaos_from_config(ctx.config)
        if chaos is not None:
            try:
                # keyed on PLAN coordinates (map stage/partition + piece) +
                # the consuming attempt — never on job id or paths, which
                # are random per run: the same seed injects the same faults
                # every run, and the retry after a lineage recompute draws a
                # fresh verdict instead of failing forever
                chaos.maybe_fail(
                    "flight.fetch",
                    f"{loc.stage_id}/{loc.map_partition}/piece{piece_idx}"
                    f"@a{ctx.attempt}",
                )
            except ChaosInjected as e:
                # surface exactly like a real lost fetch so the injected
                # fault drives the fetch_failed -> lineage-recompute path
                raise ShuffleFetchError(
                    f"shuffle fetch of {piece} from {loc.executor_id}: {e}",
                    executor_id=loc.executor_id,
                    host=loc.host,
                    port=loc.port,
                    path=loc.path,
                    stage_id=loc.stage_id,
                    map_partition=loc.map_partition,
                ) from e
        if (
            ctx.executor_id
            and loc.executor_id == ctx.executor_id
            and ctx.config.tpu_exchange()
        ):
            # HBM-resident exchange (ISSUE 16): this executor produced the
            # piece, so resolve its OWN residency registry first — zero
            # decode, zero re-upload. Every miss (evicted, over budget,
            # chaos, never registered) falls through to the authoritative
            # ladder below, bit-identical by construction. The probe keys
            # on ctx.executor_id, so a StandaloneCluster's co-resident
            # executors never see false "local" hits.
            from ballista_tpu_torch.ops import exchange

            if chaos is not None and chaos.should_inject(
                "exchange.evict",
                f"{loc.stage_id}/{loc.map_partition}/piece{piece_idx}"
                f"@a{ctx.attempt}",
            ):
                # seeded eviction between produce and consume: drop the
                # entry and take the ladder — a cache going cold is never
                # a task failure, so zero retries by construction
                counters.recovery.record("chaos_injected")
                if exchange.evict(
                    ctx.executor_id, ctx.job_id, loc.stage_id,
                    loc.map_partition, piece_idx,
                ):
                    counters.exchange.record("evicted_chaos")
            hit = exchange.resolve(
                ctx.executor_id, ctx.job_id, loc.stage_id,
                loc.map_partition, piece_idx,
            )
            if hit is not None:
                batches, nbytes = hit
                counters.exchange.record("reupload_skipped")
                counters.exchange.record("h2d_bytes_saved", nbytes)
                yield from batches
                return
            counters.exchange.record("miss")
        if loc.storage_uri:
            # disaggregated tier (ISSUE 15): the piece's home is a PATH —
            # resolve it from the shared mount first. A shuffle.store READ
            # verdict (keyed like flight.fetch on plan coordinates + the
            # consuming attempt) makes the published piece unreadable for
            # this attempt, exercising the fallback ladder: Flight peer
            # fetch below, then fetch_failed -> lineage recompute — the
            # recomputed map republishes and the requeued consumer's fresh
            # attempt draws a fresh verdict.
            torn = chaos is not None and chaos.should_inject(
                "shuffle.store",
                f"r{loc.stage_id}/{loc.map_partition}/piece{piece_idx}"
                f"@a{ctx.attempt}",
            )
            if torn:
                counters.recovery.record("chaos_injected")
                counters.shuffle_tier.record("storage_read_torn")
            else:
                resolved = self._storage_read_path(piece, ctx)
                if resolved is not None and os.path.exists(resolved):
                    counters.shuffle_tier.record("storage_fetch")
                    yield from read_ipc_file(resolved)
                    return
            counters.shuffle_tier.record("storage_fallback_peer")
            if not loc.host or not loc.port:
                # no live peer to fall back to (the producing executor is
                # gone and its metadata never bound): the piece is LOST for
                # this attempt — name it so lineage recomputes exactly it
                raise ShuffleFetchError(
                    f"storage-homed shuffle piece {piece} unreadable and "
                    f"no peer fallback (producer {loc.executor_id} gone)",
                    executor_id=loc.executor_id,
                    host=loc.host,
                    port=loc.port,
                    path=loc.path,
                    stage_id=loc.stage_id,
                    map_partition=loc.map_partition,
                )
        resolved = self._local_read_path(piece, ctx)
        if resolved is not None and os.path.exists(resolved):
            yield from read_ipc_file(resolved)
        elif ctx.shuffle_fetcher is not None:
            counters.shuffle_tier.record("peer_fetch")
            try:
                yield from ctx.shuffle_fetcher(loc, piece_idx)
            except ShuffleFetchError:
                raise
            except RpcError as e:
                # attach the lineage of the lost location: the executor's
                # task runner turns this into a fetch_failed status and the
                # scheduler recomputes ONLY loc's map partition
                raise ShuffleFetchError(
                    f"shuffle fetch of {piece} from "
                    f"{loc.executor_id}@{loc.host}:{loc.port} failed: {e}",
                    executor_id=loc.executor_id,
                    host=loc.host,
                    port=loc.port,
                    path=loc.path,
                    stage_id=loc.stage_id,
                    map_partition=loc.map_partition,
                ) from e
        else:
            raise ExecutionError(
                f"shuffle piece not found locally and no fetcher: {piece}"
            )

    @staticmethod
    def _storage_read_path(piece: str, ctx: TaskContext):
        """Resolved shared-storage path for a storage-homed piece, or None
        when this reader has no storage access (no ballista.shuffle.dir —
        e.g. a local-tier consumer handed a storage-homed location by a
        mixed deployment; the Flight fallback still works). Confined to the
        READER'S OWN configured storage root, exactly like the work-dir
        shortcut: the location path arrived over the wire and must not be
        able to name arbitrary host files."""
        from ballista_tpu_torch.executor.confine import resolve_contained

        root = ctx.config.shuffle_dir()
        if not root:
            return None
        return resolve_contained(piece, root)

    @staticmethod
    def _local_read_path(piece: str, ctx: TaskContext):
        """Resolved path for the local-disk shortcut, or None to use the
        Flight fetcher. The shortcut is only for THIS task's own job
        directory: a wire plan can carry arbitrary ShuffleLocation paths,
        and reading them from local disk would let a peer exfiltrate
        another job's shuffle pieces (or any host .arrow file) — those go
        through the fetcher instead, where the OWNING executor confines the
        path to its work_dir. The RESOLVED path is returned and opened (not
        the raw one), so a symlink swapped after the check cannot escape.
        A trusted in-process context (no work_dir, no fetcher) keeps the
        direct read."""
        from ballista_tpu_torch.executor.confine import resolve_contained

        if ctx.work_dir is None:
            return piece if ctx.shuffle_fetcher is None else None
        root = (
            os.path.join(ctx.work_dir, ctx.job_id) if ctx.job_id else ctx.work_dir
        )
        return resolve_contained(piece, root)

    def fmt(self) -> str:
        return f"ShuffleReaderExec: partitions={self.num_partitions}, maps={len(self.locations)}"


class UnresolvedShuffleExec(ExecutionPlan):
    """Placeholder for a dependency stage whose outputs don't exist yet
    (ref unresolved_shuffle.rs). Refuses to execute."""

    def __init__(self, stage_id: int, schema: pa.Schema, partition_count: int,
                 identity: bool = False) -> None:
        self.stage_id = stage_id
        self._schema = schema
        self.partition_count = partition_count
        self.identity = identity

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(self.partition_count)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        raise InternalError(
            f"UnresolvedShuffleExec(stage={self.stage_id}) cannot execute; "
            "the scheduler must substitute a ShuffleReaderExec"
        )

    def fmt(self) -> str:
        return f"UnresolvedShuffleExec: stage={self.stage_id}, partitions={self.partition_count}"
