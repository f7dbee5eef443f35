"""Distributed client: BallistaContext + BallistaDataFrame.

Mirrors the reference client crate (rust/client/src/context.rs): tables are
registered client-side and plans are built locally; collect() submits the
logical plan to the scheduler (ExecuteQuery), polls GetJobStatus every 100ms
(ref context.rs:183-207), and on completion fetches each result partition
from the executor holding it over Arrow Flight (ref context.rs:218-230).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import pyarrow as pa
import pyarrow.flight as flight

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.datasource import (
    CsvTableSource,
    MemoryTableSource,
    ParquetTableSource,
    TableSource,
)
from ballista_tpu_torch.engine.context import DataFrame, ExecutionContext
from ballista_tpu_torch.errors import BallistaError, ExecutionError, PlanError
from ballista_tpu_torch.logical import plan as lp
from ballista_tpu_torch.logical.builder import LogicalPlanBuilder
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.scheduler.rpc import SchedulerGrpcClient
from ballista_tpu_torch.serde.logical import plan_to_proto

POLL_INTERVAL = 0.1  # ref context.rs:195
# status polls start here and double toward POLL_INTERVAL (ISSUE 8): a
# small query completing in a few ms should not pay a fixed 100ms poll
# gap, while long jobs converge to the reference cadence within 5 polls
POLL_INTERVAL_MIN = 0.005


class _CachedResultLost(BallistaError):
    """A result-cache-served job's partitions died before the fetch; the
    scheduler invalidated the entry — collect() resubmits the plan once."""

    def __init__(self, job_id: str) -> None:
        super().__init__(f"cached result partitions of job {job_id} lost")
        self.job_id = job_id


class _StatusWatch:
    """Server-push job-status subscription (ISSUE 11): a reader thread
    drains one SubscribeJobStatus stream into a queue; next() blocks until
    a fresh status lands (or the timeout passes) — which is what removes
    the 5ms-floor polling gap from job completion latency. Degrades
    cleanly: any stream failure (scheduler restart, push disabled,
    pre-ISSUE-11 scheduler answering UNIMPLEMENTED) just flips alive() off
    and the caller's poll loop takes over."""

    def __init__(self, client, job_id: str) -> None:
        import queue as _queue
        import threading

        self._q: "_queue.Queue" = _queue.Queue()
        self._call = None
        self._down = False
        try:
            self._call = client.subscribe_job_status(
                pb.GetJobStatusParams(job_id=job_id)
            )
        except Exception:
            self._down = True
            return
        from ballista_tpu_torch.ops.runtime import record_serving

        record_serving("status_push_subscribed")
        threading.Thread(
            target=self._read, daemon=True, name="status-watch"
        ).start()

    def _read(self) -> None:
        try:
            for res in self._call:
                self._q.put(res.status)
        except Exception:
            pass
        finally:
            self._q.put(None)  # stream over (terminal served, or dropped)

    def next(self, timeout: float):
        """Next pushed JobStatus, or None when the timeout passed (caller
        falls through to a safety poll) or the stream ended (alive() is
        then False and the caller's poll loop owns the job)."""
        import queue as _queue

        if self._down:
            return None
        try:
            st = self._q.get(timeout=max(0.0, timeout))
        except _queue.Empty:
            return None
        if st is None:
            self._down = True
            from ballista_tpu_torch.ops.runtime import record_serving

            record_serving("status_push_closed")
            return None
        from ballista_tpu_torch.ops.runtime import record_serving

        record_serving("status_push")
        return st

    def alive(self) -> bool:
        return not self._down

    def close(self) -> None:
        if self._call is not None:
            try:
                self._call.cancel()
            except Exception:
                pass


class _JobStatusSource:
    """Watch-or-poll job-status acquisition (ISSUE 11): ONE implementation
    of the push/poll contract shared by every status-consuming loop —
    the push subscription (when `ballista.client.push_status` is on), the
    safety-poll fallback, and the adaptive pure-poll pacing. next() blocks
    up to POLL_INTERVAL on a live stream (a pushed transition returns the
    instant the scheduler writes it) and polls otherwise, sleeping the
    adaptive backoff between successive pure polls only."""

    def __init__(self, client, config, job_id: str) -> None:
        self._client = client
        self._config = config
        self._job_id = job_id
        self._watch = (
            _StatusWatch(client, job_id) if config.push_status() else None
        )
        self._interval = POLL_INTERVAL_MIN
        self._polled = False

    def next(self, deadline: float) -> pb.JobStatus:
        """The next JobStatus before `deadline` — pushed when the stream
        is live, polled otherwise (also the safety net when a live stream
        stays silent for a full POLL_INTERVAL)."""
        if self._watch is not None and self._watch.alive():
            status = self._watch.next(
                min(POLL_INTERVAL, max(0.0, deadline - time.time()))
            )
            if status is not None:
                return status
        elif self._polled:
            # pure-poll pacing (push disabled or stream down) between
            # successive polls; with a live watch, next() above already
            # blocked waiting for the change
            time.sleep(self._interval)
            self._interval = min(self._interval * 2, POLL_INTERVAL)
        self._polled = True
        res = self._client.get_job_status(
            pb.GetJobStatusParams(job_id=self._job_id)
        )
        # ownership redirect (ISSUE 20): the polled replica named the
        # job's owner. Status POLLS answer from any replica (shared KV
        # truth), but the push stream only fires on the owner — jump the
        # client there and re-home the subscription once per switch.
        if res.owner_addr and self._client.prefer_endpoint(res.owner_addr):
            if self._watch is not None:
                self._watch.close()
            if self._config.push_status():
                from ballista_tpu_torch.ops.runtime import record_serving

                record_serving("status_push_rehomed")
                self._watch = _StatusWatch(self._client, self._job_id)
        return res.status

    def close(self) -> None:
        if self._watch is not None:
            self._watch.close()


class BallistaContext(ExecutionContext):
    """Client context talking to a remote scheduler (ref BallistaContext::remote)."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 50050,
        settings: Optional[Dict[str, str]] = None,
        endpoints: Optional[Sequence] = None,
        device=None,
    ) -> None:
        # `device` as ExecutionContext takes it: the GPU unless the caller
        # asks for the CPU (raises when CUDA is missing)
        super().__init__(BallistaConfig(settings), device=device)
        self.host = host
        self.port = port
        # `endpoints` adds failover scheduler replicas (ISSUE 20): submit,
        # poll and subscribe work against ANY of them — transient failures
        # and ownership redirects rotate the client automatically
        self._client = SchedulerGrpcClient(
            host,
            port,
            retries=self.config.rpc_retries(),
            backoff_s=self.config.rpc_backoff_s(),
            endpoints=endpoints,
        )

    @classmethod
    def remote(cls, host: str, port: int, settings=None,
               device=None) -> "BallistaContext":
        return cls(host, port, settings, device=device)

    # DataFrames constructed through the inherited registration/verb surface
    # execute remotely:
    def table(self, name: str) -> "BallistaDataFrame":
        src = self.tables.get(name.lower())
        if src is None:
            raise PlanError(f"no table registered as {name!r}")
        return BallistaDataFrame(self, LogicalPlanBuilder.scan(name, src))

    def sql(self, query: str) -> "BallistaDataFrame":
        from ballista_tpu_torch.sql.planner import plan_sql

        plan = plan_sql(query, self)
        if isinstance(plan, lp.CreateExternalTable):
            self._create_external_table(plan)
            return BallistaDataFrame(self, LogicalPlanBuilder.empty(False))
        return BallistaDataFrame(self, LogicalPlanBuilder(plan))

    # -- execution ---------------------------------------------------------
    def collect(self, plan: lp.LogicalPlan, timeout: float = 300.0) -> pa.Table:
        job_id = self.submit(plan)
        try:
            return self._collect_results(job_id, plan.schema(), timeout)
        except _CachedResultLost:
            # the scheduler served this job from the result cache but the
            # cached partitions died under a live lease; it invalidated the
            # entry and failed the job. ONE resubmission re-executes for
            # real (the fresh submission misses the now-deleted entry).
            from ballista_tpu_torch.ops.runtime import record_tenancy

            record_tenancy("cache_lost_resubmitted")
            job_id = self.submit(plan)
            try:
                return self._collect_results(job_id, plan.schema(), timeout)
            except _CachedResultLost as e:
                # the resubmission ALSO rode a (concurrently re-published)
                # dead entry: the cluster is churning faster than the cache
                # invalidates — surface a public error, not the internal
                # retry marker
                raise ExecutionError(
                    f"job {e.job_id}: cached result partitions lost twice "
                    "in a row (executor churn outpacing cache "
                    "invalidation) — retry the query"
                ) from e

    def submit(self, plan: lp.LogicalPlan) -> str:
        """ExecuteQuery only: returns the job id without waiting for (or
        fetching) results — collect() is submit + _collect_results."""
        params = pb.ExecuteQueryParams()
        params.logical_plan.CopyFrom(plan_to_proto(plan))
        # only non-default settings travel: they override scheduler/executor
        # configs per job without clobbering host-local tuning
        for k, v in self.config.explicit_settings().items():
            params.settings.add(key=k, value=v)
        # tenancy rides first-class fields too (ISSUE 7): admission control
        # must not depend on parsing the settings map
        params.tenant = self.config.tenant()
        params.priority = self.config.tenant_priority()
        return self._client.execute_query(params).job_id

    def collect_stream(self, plan: lp.LogicalPlan, timeout: float = 300.0):
        """Streaming collect (ISSUE 8): yield result RecordBatches in
        final-partition order, starting as soon as the FIRST final-stage
        partition completes (per-partition completion notifications on the
        running job status) instead of after the whole job. Batches are
        committed per partition — a mid-stream fetch loss discards that
        partition's partial batches and routes through ReportLostPartition
        + re-poll, so everything yielded is final. The concatenation of the
        yielded batches is bit-identical to collect()'s table (pre-cast).

        A cache-served job whose partitions died is resubmitted ONCE, like
        collect() — but only while nothing has been yielded yet (yielded
        batches cannot be retracted)."""
        job_id = self.submit(plan)
        yielded = False
        try:
            for batch in self._stream_results(job_id, plan.schema(), timeout):
                yielded = True
                yield batch
        except _CachedResultLost as e:
            if yielded:
                raise ExecutionError(
                    f"job {e.job_id}: cached result partitions lost "
                    "mid-stream — retry the query"
                ) from e
            from ballista_tpu_torch.ops.runtime import record_tenancy

            record_tenancy("cache_lost_resubmitted")
            job_id = self.submit(plan)
            try:
                yield from self._stream_results(job_id, plan.schema(), timeout)
            except _CachedResultLost as e2:
                raise ExecutionError(
                    f"job {e2.job_id}: cached result partitions lost twice "
                    "in a row (executor churn outpacing cache "
                    "invalidation) — retry the query"
                ) from e2

    def _stream_results(self, job_id: str, schema, timeout: float = 300.0):
        """Poll the job status; fetch each final-stage partition the moment
        its completion is published (running.partial_location while the job
        runs, completed.partition_location at the end) and yield its
        batches once the whole partition streamed cleanly, in partition
        order. Fetch failures — including mid-stream drops after the first
        batch — discard the partition's uncommitted batches and report the
        lost location (ReportLostPartition), exactly like the buffered
        path: a restarted job re-polls for fresh locations; a dead cached
        entry surfaces _CachedResultLost for the caller's resubmission."""
        from ballista_tpu_torch.errors import ShuffleFetchError
        from ballista_tpu_torch.ops.runtime import record_recovery, record_serving

        deadline = time.time() + timeout
        # push-status source (ISSUE 11): each status transition — every
        # new partial_location included — arrives the moment the scheduler
        # writes it, with the adaptive poll as the automatic safety net
        # (cooldown re-fetches, stream drops, schedulers without the RPC)
        source = _JobStatusSource(self._client, self.config, job_id)
        committed: Dict[int, list] = {}  # partition -> batches (not yet yielded)
        done: set = set()  # partitions committed (incl. already yielded)
        # partition -> ((executor id, path), failure time) of a location
        # that already failed + was reported: re-fetching the identical
        # location before the scheduler publishes a fresh one would just
        # spin. Cooldown-based, not until-it-changes: a recompute can
        # legitimately land on the same executor AND path (sole survivor).
        failed_locs: Dict[int, tuple] = {}
        FAILED_LOC_COOLDOWN = 0.5
        next_yield = 0
        try:
            while True:
                if time.time() > deadline:
                    raise ExecutionError(
                        f"job {job_id} timed out after {timeout}s"
                    )
                status = source.next(deadline)
                which = status.WhichOneof("status")
                if which == "failed":
                    raise ExecutionError(
                        f"job {job_id} failed: {status.failed.error}"
                    )
                total = None
                if which == "completed":
                    # advanced-entry results ride the status itself (ISSUE
                    # 19): one Arrow IPC stream, checked BEFORE the empty
                    # location list is read as an empty result
                    if status.completed.inline_result:
                        with pa.ipc.open_stream(
                            pa.BufferReader(status.completed.inline_result)
                        ) as r:
                            for batch in r:
                                yield batch
                        return
                    locs = list(status.completed.partition_location)
                    total = len(locs)
                elif which == "running":
                    locs = list(status.running.partial_location)
                else:
                    locs = []
                for loc in locs:
                    p = loc.partition_id.partition_id
                    sig = (loc.executor_meta.id, loc.path)
                    if p in done:
                        continue
                    prior = failed_locs.get(p)
                    if (
                        prior is not None
                        and prior[0] == sig
                        and time.time() - prior[1] < FAILED_LOC_COOLDOWN
                    ):
                        # a known-dead location the scheduler has not
                        # replaced yet (a stale status snapshot can
                        # republish it for a few polls); retried after the
                        # cooldown either way
                        continue
                    try:
                        batches = self._fetch_partition_batches(loc)
                    except ShuffleFetchError as e:
                        result = self._client.report_lost_partition(
                            pb.ReportLostPartitionParams(
                                job_id=job_id,
                                executor_id=e.executor_id,
                                stage_id=e.stage_id,
                                partition_id=e.map_partition,
                                path=e.path,
                            )
                        )
                        if not result.restarted:
                            if which == "completed" and status.completed.cached:
                                raise _CachedResultLost(job_id) from e
                            raise
                        record_recovery("result_fetch_restarted")
                        # keep fetching the OTHER listed partitions this
                        # round (one dead location must not starve the
                        # rest); this one retries after the cooldown / on
                        # a fresh location
                        failed_locs[p] = (sig, time.time())
                        continue
                    failed_locs.pop(p, None)
                    committed[p] = batches
                    done.add(p)
                    if which == "running":
                        record_serving("stream_partition_early")
                while next_yield in committed:
                    for batch in committed.pop(next_yield):
                        yield batch
                    next_yield += 1
                if total is not None and next_yield >= total:
                    return
        finally:
            source.close()

    def _storage_read_table(self, loc: pb.PartitionLocation):
        """Direct shared-storage read of a storage-homed result partition
        (ISSUE 15), or None to use the Flight ladder — the client fetches
        the bytes from the mount instead of round-tripping them through the
        (possibly already retired) producing executor. Confined to this
        client's OWN configured ballista.shuffle.dir: the location path
        came from the scheduler and must not name arbitrary local files.
        Any read failure falls back to Flight, never errors here."""
        if not loc.storage_uri:
            return None
        root = self.config.shuffle_dir()
        if not root:
            return None
        from ballista_tpu_torch.executor.confine import resolve_contained
        from ballista_tpu_torch.ops.runtime import record_shuffle_tier

        resolved = resolve_contained(os.path.join(loc.path, "0.arrow"), root)
        if resolved is None or not os.path.exists(resolved):
            record_shuffle_tier("client_storage_miss")
            return None
        try:
            with pa.ipc.open_file(resolved) as r:
                table = r.read_all()
        except Exception:
            record_shuffle_tier("client_storage_miss")
            return None
        record_shuffle_tier("client_storage_fetch")
        return table

    def _fetch_partition_batches(self, loc: pb.PartitionLocation) -> list:
        """One result partition as a committed batch list — read straight
        from shared storage when the location is storage-homed (ISSUE 15),
        else streamed over Flight (client/flight.py stream_action). Any
        Flight failure — connect, first byte, or mid-stream — surfaces as
        ShuffleFetchError naming the lost location; partial batches are
        dropped by the caller."""
        from ballista_tpu_torch.client.flight import BallistaClient
        from ballista_tpu_torch.errors import RpcError, ShuffleFetchError

        table = self._storage_read_table(loc)
        if table is not None:
            return table.to_batches()
        action = pb.Action()
        action.fetch_partition.path = os.path.join(loc.path, "0.arrow")
        try:
            client = BallistaClient(
                loc.executor_meta.host,
                loc.executor_meta.port,
                retries=self.config.rpc_retries(),
                backoff_s=self.config.rpc_backoff_s(),
            )
        except Exception as e:
            raise ShuffleFetchError(
                f"result partition unreachable: {e}",
                executor_id=loc.executor_meta.id,
                host=loc.executor_meta.host,
                port=loc.executor_meta.port,
                path=loc.path,
                stage_id=loc.partition_id.stage_id,
                map_partition=loc.partition_id.partition_id,
            ) from e
        try:
            return list(client.stream_action(action))
        except RpcError as e:
            raise ShuffleFetchError(
                f"result partition fetch failed: {e}",
                executor_id=loc.executor_meta.id,
                host=loc.executor_meta.host,
                port=loc.executor_meta.port,
                path=loc.path,
                stage_id=loc.partition_id.stage_id,
                map_partition=loc.partition_id.partition_id,
            ) from e
        finally:
            client.close()

    def _collect_results(
        self, job_id: str, schema, timeout: float = 300.0
    ) -> pa.Table:
        """Wait for the job, then fetch each result partition from the
        executor holding it. A fetch failure against the now-TERMINAL job
        (the owner died between completion and this fetch — the scheduler's
        lost-task machinery skips finished jobs, so nobody else notices)
        is reported back via ReportLostPartition: the scheduler requeues
        the lost final-stage tasks through lineage and flips the job back
        to running, and this loop re-polls for the fresh locations instead
        of erroring (ISSUE 6 / PR 5 residue).

        With ballista.client.stream_results on, the same contract runs in
        STREAMING mode: partitions are fetched as they complete and the
        table assembles from the streamed batches — bit-identical to the
        buffered result."""
        from ballista_tpu_torch.errors import ShuffleFetchError

        if self.config.stream_results():
            batches = list(self._stream_results(job_id, schema, timeout))
            if not batches:
                return schema.empty_table()
            return pa.Table.from_batches(
                batches, schema=batches[0].schema
            ).cast(schema)

        deadline = time.time() + timeout
        while True:
            status = self._wait_for_job(job_id, max(0.0, deadline - time.time()))
            if status.completed.inline_result:
                # advanced-entry result (ISSUE 19): the folded table rides
                # the status inline — nothing to fetch, nothing to lose.
                # Checked BEFORE the location list, or an inline result
                # would be misread as an empty table.
                with pa.ipc.open_stream(
                    pa.BufferReader(status.completed.inline_result)
                ) as r:
                    return r.read_all().cast(schema)
            try:
                tables = [
                    self._fetch_partition(loc)
                    for loc in status.completed.partition_location
                ]
            except ShuffleFetchError as e:
                cached = status.completed.cached
                result = self._client.report_lost_partition(
                    pb.ReportLostPartitionParams(
                        job_id=job_id,
                        executor_id=e.executor_id,
                        stage_id=e.stage_id,
                        partition_id=e.map_partition,
                        path=e.path,
                    )
                )
                if not result.restarted:
                    if cached:
                        # cache-served job: the scheduler invalidated the
                        # entry; collect() resubmits the plan once
                        raise _CachedResultLost(job_id) from e
                    # nothing for the scheduler to restart (or the job
                    # already failed for good): surface the fetch error
                    raise
                from ballista_tpu_torch.ops.runtime import record_recovery

                record_recovery("result_fetch_restarted")
                continue
            if not tables:
                return schema.empty_table()
            return pa.concat_tables(tables).cast(schema)

    def _wait_for_job(self, job_id: str, timeout: float) -> pb.JobStatus:
        """Wait for a terminal status — via the SubscribeJobStatus push
        stream when enabled (the completion arrives the instant the
        scheduler writes it, no polling floor), with the adaptive poll as
        the automatic fallback whenever the stream is down or refused."""
        deadline = time.time() + timeout
        source = _JobStatusSource(self._client, self.config, job_id)
        try:
            while time.time() < deadline:
                status = source.next(deadline)
                which = status.WhichOneof("status")
                if which == "completed":
                    return status
                if which == "failed":
                    raise ExecutionError(
                        f"job {job_id} failed: {status.failed.error}"
                    )
            raise ExecutionError(f"job {job_id} timed out after {timeout}s")
        finally:
            source.close()

    def _fetch_partition(self, loc: pb.PartitionLocation) -> pa.Table:
        from ballista_tpu_torch.client.flight import BallistaClient
        from ballista_tpu_torch.errors import RpcError, ShuffleFetchError

        # storage-homed result partitions read straight from the shared
        # mount (ISSUE 15); Flight stays the fallback transport
        table = self._storage_read_table(loc)
        if table is not None:
            return table
        try:
            client = BallistaClient(
                loc.executor_meta.host,
                loc.executor_meta.port,
                retries=self.config.rpc_retries(),
                backoff_s=self.config.rpc_backoff_s(),
            )
        except Exception as e:  # connect failure = same lost location
            raise ShuffleFetchError(
                f"result partition unreachable: {e}",
                executor_id=loc.executor_meta.id,
                host=loc.executor_meta.host,
                port=loc.executor_meta.port,
                path=loc.path,
                stage_id=loc.partition_id.stage_id,
                map_partition=loc.partition_id.partition_id,
            ) from e
        try:
            # the final stage writes piece 0 per input partition
            return client.fetch_partition(os.path.join(loc.path, "0.arrow"))
        except RpcError as e:
            # name the lost location so _collect_results can report it to
            # the scheduler (ReportLostPartition) instead of just erroring
            raise ShuffleFetchError(
                f"result partition fetch failed: {e}",
                executor_id=loc.executor_meta.id,
                host=loc.executor_meta.host,
                port=loc.executor_meta.port,
                path=loc.path,
                stage_id=loc.partition_id.stage_id,
                map_partition=loc.partition_id.partition_id,
            ) from e
        finally:
            client.close()

    # -- cluster info ------------------------------------------------------
    def executors(self) -> List[pb.ExecutorMetadata]:
        return list(self._client.get_executors_metadata().metadata)

    def close(self) -> None:
        self._client.close()


class BallistaDataFrame(DataFrame):
    """DataFrame whose collect() executes on the cluster."""

    def _wrap(self, builder: LogicalPlanBuilder) -> "BallistaDataFrame":
        return BallistaDataFrame(self._ctx, builder)

    # rewrap verbs so chaining stays distributed
    def select(self, *exprs) -> "BallistaDataFrame":
        return self._wrap(self._builder.project(list(exprs)))

    def filter(self, predicate) -> "BallistaDataFrame":
        return self._wrap(self._builder.filter(predicate))

    def aggregate(self, group_by, aggs) -> "BallistaDataFrame":
        return self._wrap(self._builder.aggregate(group_by, aggs))

    def sort(self, *exprs) -> "BallistaDataFrame":
        return self._wrap(self._builder.sort(list(exprs)))

    def limit(self, n: int, skip: int = 0) -> "BallistaDataFrame":
        return self._wrap(self._builder.limit(n, skip))

    def collect(self) -> pa.Table:
        return self._ctx.collect(self.logical_plan())
