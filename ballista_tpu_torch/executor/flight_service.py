"""Executor Flight data plane.

Arrow Flight do_get keyed on a protobuf Action ticket, like the reference
(rust/executor/src/flight_service.rs:80-230):

- FetchPartition: stream a materialized shuffle piece (schema-first framing
  comes with Flight itself) — serves peers (ShuffleReaderExec) and clients.
- ExecutePartition: execute a plan's partitions and materialize them
  (the push-based path; the pull-based poll loop executes tasks in-process
  instead — the reference's loopback-Flight-to-itself indirection
  (execution_loop.rs:93-101) is dropped deliberately).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Iterator, Optional

import pyarrow as pa
import pyarrow.flight as flight

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed.stages import ShuffleLocation
from ballista_tpu_torch.physical.plan import TaskContext
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.utils import counters

log = logging.getLogger("ballista.executor.flight")

# job ids are 7-char alphanumeric (scheduler/state.py); anything path-like
# is hostile
_JOB_ID_RE = re.compile(r"[A-Za-z0-9_-]{1,64}")


class BallistaFlightService(flight.FlightServerBase):
    def __init__(self, location: str, work_dir: str, config: BallistaConfig,
                 device=None) -> None:
        super().__init__(location)
        self.work_dir = work_dir
        self.config = config
        # torch.device of the partitions this service executes itself
        self.device = device

    # ------------------------------------------------------------------
    def do_get(self, context, ticket: flight.Ticket) -> flight.RecordBatchStream:
        action = pb.Action()
        action.ParseFromString(ticket.ticket)
        which = action.WhichOneof("action_type")
        if which == "fetch_partition":
            path = self._resolve_work_path(action.fetch_partition.path)
            if self.config.tpu_exchange():
                # HBM-resident exchange (ISSUE 16): serve a registered
                # piece straight from memory instead of re-reading it off
                # disk — the same batches the authoritative IPC file holds,
                # so the stream is bit-identical to the file read. Confined
                # FIRST (_resolve_work_path above): the registry only ever
                # indexes paths this executor published itself, so a miss
                # falls through to the ordinary confined file read.
                from ballista_tpu_torch.ops import exchange

                hit = exchange.resolve_path(path) or exchange.resolve_path(
                    action.fetch_partition.path
                )
                if hit is not None:
                    schema, batches, nbytes = hit
                    counters.exchange.record("served_from_registry")
                    counters.exchange.record("d2h_bytes_saved", nbytes)
                    return flight.GeneratorStream(schema, iter(batches))
            if not os.path.isfile(path):
                raise flight.FlightServerError(f"no such shuffle piece: {path}")
            # batch-at-a-time so a fetch never materializes the whole
            # partition in executor memory (ref streams through a channel,
            # rust/executor/src/flight_service.rs:315-333)
            reader = pa.ipc.open_file(path)
            batches = (
                reader.get_batch(i) for i in range(reader.num_record_batches)
            )
            return flight.GeneratorStream(reader.schema, batches)
        if which == "execute_partition":
            return self._execute_partition(action.execute_partition, action.settings)
        raise flight.FlightServerError(f"unsupported action {which!r}")

    def _resolve_work_path(self, raw: str) -> str:
        """Confine ticket paths to this executor's work_dir — or, with the
        shared shuffle tier configured (ISSUE 15), to ITS OWN configured
        storage root (never a per-job override: the ticket comes from an
        unauthenticated peer, and self.config is the only trust anchor).
        The storage fallback is what makes Flight a real backup transport
        for storage-homed pieces: a reader without the mount can fetch them
        through any live executor that has it. Without either check
        FetchPartition would serve any readable file on the host
        (ADVICE r1, high)."""
        from ballista_tpu_torch.executor.confine import resolve_contained

        resolved = resolve_contained(raw, self.work_dir)
        if resolved is None:
            storage = self.config.shuffle_dir()
            if storage:
                resolved = resolve_contained(raw, storage)
        if resolved is None:
            raise flight.FlightServerError(
                f"path outside work_dir refused: {raw!r}"
            )
        return resolved

    def _execute_partition(self, req: pb.ExecutePartition, settings) -> flight.RecordBatchStream:
        from ballista_tpu_torch.serde.physical import phys_plan_from_proto
        from ballista_tpu_torch.distributed.stages import ShuffleWriterExec

        # job_id is joined into work_dir paths by the shuffle writer; an
        # unauthenticated peer must not steer writes outside work_dir
        if not _JOB_ID_RE.fullmatch(req.job_id):
            raise flight.FlightServerError(f"invalid job id {req.job_id!r}")
        # allowlist comes from the EXECUTOR's own config; per-job client
        # settings (attacker-controlled) must not widen it. The proto-level
        # check runs BEFORE deserialization (which already opens parquet
        # footers); the plan-level check covers resolved files.
        from ballista_tpu_torch.executor.confine import (
            check_proto_scan_roots,
            check_scan_roots,
        )

        roots = self.config.data_roots()
        check_proto_scan_roots(req.plan, roots)
        plan = phys_plan_from_proto(req.plan)
        check_scan_roots(plan, roots)
        import functools

        from ballista_tpu_torch.config import BALLISTA_SHUFFLE_DIR, BALLISTA_SHUFFLE_TIER

        # like the scan-root allowlist above, the shuffle WRITE home comes
        # from the EXECUTOR's own config: an unauthenticated peer's
        # settings must not steer execute_shuffle_write's os.replace
        # publish to an arbitrary host path (pre-ISSUE-15 every write was
        # confined to work_dir by construction)
        cfg = BallistaConfig({
            **self.config.to_dict(),
            **{kv.key: kv.value for kv in settings},
            BALLISTA_SHUFFLE_TIER: self.config.shuffle_tier(),
            BALLISTA_SHUFFLE_DIR: self.config.shuffle_dir(),
        })
        ctx = TaskContext(config=cfg, work_dir=self.work_dir, job_id=req.job_id,
                          shuffle_fetcher=functools.partial(
                              flight_shuffle_fetcher, config=cfg),
                          device=self.device)
        from ballista_tpu_torch.distributed.stages import shuffle_output_base

        rows = []
        for p in req.partition_ids:
            if not isinstance(plan, ShuffleWriterExec):
                plan = ShuffleWriterExec(req.job_id, req.stage_id, plan, None)
            stats = plan.execute_shuffle_write(p, ctx)
            # the base the writer actually used (work dir, or the shared
            # storage dir when the merged config selects the shared tier)
            base, _storage = shuffle_output_base(ctx, req.job_id, req.stage_id, p)
            rows.append((base, stats.num_rows, stats.num_batches, stats.num_bytes))
        # 1-row-per-partition result batch (path, stats), ref flight_service.rs:135-160
        table = pa.table(
            {
                "path": pa.array([r[0] for r in rows]),
                "num_rows": pa.array([r[1] for r in rows], type=pa.int64()),
                "num_batches": pa.array([r[2] for r in rows], type=pa.int64()),
                "num_bytes": pa.array([r[3] for r in rows], type=pa.int64()),
            }
        )
        return flight.RecordBatchStream(table)


def flight_shuffle_fetcher(
    loc: ShuffleLocation, partition: int, config: Optional[BallistaConfig] = None
) -> Iterator[pa.RecordBatch]:
    """ShuffleReaderExec's remote path: Flight do_get(FetchPartition) against
    the executor owning the piece (ref client.rs:123-169). Bind `config`
    (functools.partial at TaskContext construction) so the data plane honors
    ballista.rpc.retries/backoff_ms like the control plane does."""
    from ballista_tpu_torch.client.flight import BallistaClient

    action = pb.Action()
    action.fetch_partition.path = os.path.join(loc.path, f"{partition}.arrow")
    cfg = config or BallistaConfig()
    client = BallistaClient(
        loc.host, loc.port,
        retries=cfg.rpc_retries(), backoff_s=cfg.rpc_backoff_s(),
    )
    try:
        yield from client.stream_action(action)
    finally:
        client.close()
