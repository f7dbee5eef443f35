"""BallistaClient: the Flight data-plane client wrapper.

Mirrors the reference's BallistaClient (rust/core/src/client.rs:51-208):
connect to an executor's Flight endpoint and
- execute_partition: run plan partitions remotely (push-based path), returns
  per-partition (path, stats) rows
- fetch_partition: stream a materialized partition back
- execute_action: raw Action round-trip (both of the above go through it)
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import pyarrow as pa
import pyarrow.flight as flight

from ballista_tpu_torch.distributed.stages import PartitionStats
from ballista_tpu_torch.errors import RpcError
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.utils import counters


class BallistaClient:
    def __init__(
        self, host: str, port: int, retries: int = 3, backoff_s: float = 0.05
    ) -> None:
        # gRPC channels connect lazily; failures surface per-call with the
        # endpoint attached
        self.host = host
        self.port = port
        # transient (UNAVAILABLE/connect) failures retry with jittered
        # exponential backoff; server-side execution errors surface
        # immediately (retrying them would just re-fail slower)
        self.retries = max(0, retries)
        self.backoff_s = backoff_s
        self._client = flight.connect(f"grpc://{host}:{port}")

    @staticmethod
    def _transient(e: flight.FlightError) -> bool:
        # NOT FlightTimedOutError: a deadline expiring says nothing about
        # whether the server stopped working on the request — retrying an
        # execute_partition whose first run is still going duplicates the
        # execution (shuffle writes themselves are atomic, but the wasted
        # work amplifies exactly when the cluster is slowest)
        return isinstance(e, flight.FlightUnavailableError)

    # ------------------------------------------------------------------
    def execute_action(self, action: pb.Action) -> pa.Table:
        """Encode the Action into a Flight ticket, read the result stream
        (schema-first framing is Flight's own, ref client.rs:134-169).
        Whole-call retry is safe: both actions are idempotent (fetch reads
        an immutable piece; execute_partition rewrites the same files)."""
        from ballista_tpu_torch.scheduler.rpc import backoff_delay

        ticket = flight.Ticket(action.SerializeToString())
        attempts = self.retries + 1
        for i in range(attempts):
            try:
                return self._client.do_get(ticket).read_all()
            except flight.FlightError as e:
                if not self._transient(e) or i + 1 >= attempts:
                    raise RpcError(f"executor {self.host}:{self.port}: {e}") from e
                counters.recovery.record("rpc_retry")
                import time

                time.sleep(backoff_delay(i, self.backoff_s))
        raise AssertionError("unreachable")

    def stream_action(self, action: pb.Action):
        """Batch-streaming variant of execute_action. Transient failures
        retry only BEFORE the first batch is yielded — a consumer may have
        acted on earlier batches, so a mid-stream drop must surface (the
        task-level retry machinery re-runs the whole task instead)."""
        from ballista_tpu_torch.scheduler.rpc import backoff_delay

        ticket = flight.Ticket(action.SerializeToString())
        attempts = self.retries + 1
        for i in range(attempts):
            yielded = False
            try:
                reader = self._client.do_get(ticket)
                for chunk in reader:
                    yielded = True
                    yield chunk.data
                return
            except flight.FlightError as e:
                if yielded or not self._transient(e) or i + 1 >= attempts:
                    raise RpcError(f"executor {self.host}:{self.port}: {e}") from e
                counters.recovery.record("rpc_retry")
                import time

                time.sleep(backoff_delay(i, self.backoff_s))

    def execute_partition(
        self,
        job_id: str,
        stage_id: int,
        partition_ids: List[int],
        plan,
        settings: Optional[dict] = None,
    ) -> List[Tuple[str, PartitionStats]]:
        """Run plan partitions on the remote executor; returns
        [(shuffle dir path, stats)] — the reference's 1-row-per-partition
        result batch (ref client.rs:76-121)."""
        from ballista_tpu_torch.serde.physical import phys_plan_to_proto

        action = pb.Action()
        action.execute_partition.job_id = job_id
        action.execute_partition.stage_id = stage_id
        action.execute_partition.partition_ids.extend(partition_ids)
        action.execute_partition.plan.CopyFrom(phys_plan_to_proto(plan))
        for k, v in (settings or {}).items():
            action.settings.add(key=k, value=v)
        table = self.execute_action(action)
        out = []
        for row in table.to_pylist():
            out.append(
                (
                    row["path"],
                    PartitionStats(
                        row["num_rows"], row["num_batches"], row["num_bytes"]
                    ),
                )
            )
        return out

    def fetch_partition(self, path: str) -> pa.Table:
        """Fetch one materialized shuffle piece (ref client.rs:123-131)."""
        action = pb.Action()
        action.fetch_partition.path = path
        return self.execute_action(action)

    def close(self) -> None:
        self._client.close()
