"""Executor poll loop + push-subscribe loop + task execution.

The reference's pull model (rust/executor/src/execution_loop.rs): every 250ms
the executor calls PollWork with its metadata, whether it can accept a task,
and the statuses of tasks that finished since the last poll (heartbeat and
work queue in one RPC). Returned TaskDefinitions are decoded and run on a
bounded task pool; results become Completed/Failed statuses pushed on the
next poll (ref as_task_status, execution_loop.rs:112-140).

The 250ms poll was a POC simplification (PAPER.md: "proof-of-concept"); at
serving QPS it puts half a poll interval of dead time in front of every
task. ISSUE 8 adds the push path: the executor opens ONE server-streaming
SubscribeWork stream and the scheduler pushes TaskDefinitions the moment
assignment picks them. The poll loop stays — as the heartbeat (statuses,
lease refresh, running_echo for ledger reconciliation) and as the AUTOMATIC
dispatch fallback: while the stream is healthy polls say
can_accept_task=False and their interval decays toward
ballista.executor.idle_poll_max_s; the moment the stream drops, the
interval snaps back to 250ms and polls pull work again, until the
re-subscribe (jittered backoff) succeeds.

Unlike the reference, task execution happens in-process rather than through
a loopback Flight call to the executor's own data plane
(ref execution_loop.rs:93-101 + the NOTE at flight_service.rs:90-91 saying
exactly this should happen).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import traceback
from typing import Optional

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed.stages import ShuffleWriterExec
from ballista_tpu_torch.executor.flight_service import flight_shuffle_fetcher
from ballista_tpu_torch.physical.plan import TaskContext
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.scheduler.rpc import SchedulerGrpcClient
from ballista_tpu_torch.utils.locks import make_lock

log = logging.getLogger("ballista.executor")

POLL_INTERVAL_SECS = 0.25  # ref execution_loop.rs:75
# shared_scan_stats() reason of a batched dispatch whose members ran solo
BATCH_SOLO_REASON = "batch_solo: combined step not ported"


class PollLoop:
    def __init__(
        self,
        scheduler: SchedulerGrpcClient,
        metadata: pb.ExecutorMetadata,
        work_dir: str,
        config: Optional[BallistaConfig] = None,
        concurrent_tasks: int = 4,  # ref executor_config_spec.toml default
        on_death=None,
        device=None,
    ) -> None:
        from ballista_tpu_torch.utils.chaos import chaos_from_config

        from ballista_tpu_torch.utils import locks as _locks

        self.scheduler = scheduler
        self.metadata = metadata
        self.work_dir = work_dir
        self.config = config or BallistaConfig()
        # the torch.device every task's device stages run on (resolved by
        # the executor runtime)
        self.device = device
        # ISSUE 14: arm the dynamic lock-order witness when configured
        _locks.maybe_enable_from_config(self.config)
        self.concurrent_tasks = concurrent_tasks
        self._available = threading.Semaphore(concurrent_tasks)
        self._finished: "queue.Queue[pb.TaskStatus]" = queue.Queue()
        self._stop = threading.Event()
        # lifecycle state shared between the poll thread and start()/stop()
        # callers (the queue/semaphore/event above are internally
        # thread-safe and need no extra guard)
        self._mu = make_lock("executor.execution_loop._mu")
        self._thread: Optional[threading.Thread] = None  # guarded-by: self._mu
        # shuffle-dir GC: the reference never collects work dirs
        # (SURVEY §5 "Nothing garbage-collects work dirs")
        self.shuffle_ttl_seconds = 3600.0
        self._last_gc = time.time()  # guarded-by: self._mu
        # deterministic fault injection (utils/chaos.py): "executor.death"
        # hard-stops this loop mid-run — on_death (wired by the runtime to
        # also shut the Flight data plane) makes the death total, so the
        # executor's completed shuffle outputs really become unreachable
        self._chaos = chaos_from_config(self.config)
        self._poll_n = 0  # poll-thread only: chaos key rotation
        self.on_death = on_death
        # tasks currently executing here, echoed in every poll so the
        # scheduler can reconcile assignments whose response never reached
        # us (lost-in-transit PollWork replies would otherwise orphan the
        # task in Running forever). The echo carries the ATTEMPT so a
        # restarted scheduler's ledger re-adoption never accepts a stale
        # attempt's vouch (ISSUE 6).
        self._inflight_mu = make_lock("executor.execution_loop._inflight_mu")
        # (job, stage, part) -> (PartitionId, attempt)
        # guarded-by: self._inflight_mu
        self._inflight: dict = {}
        # statuses popped from _finished by a poll whose RPC is still in
        # flight: a failed delivery requeues them, so drain() must not
        # declare the executor empty while any are outstanding
        self._delivering = 0  # guarded-by: self._inflight_mu
        # -- push dispatch (ISSUE 8) ------------------------------------
        self._push_enabled = self.config.push_dispatch()
        self._idle_poll_max = self.config.idle_poll_max_s()
        # set while the SubscribeWork stream is live: polls become pure
        # heartbeats (can_accept_task=False) and their interval decays
        self._stream_ok = threading.Event()
        self._subscribe_thread: Optional[threading.Thread] = None  # guarded-by: self._mu
        self._push_call = None  # live stream call, for cancel; guarded-by: self._mu
        self._poll_interval = POLL_INTERVAL_SECS  # guarded-by: self._mu
        # kicks the poll loop out of a decayed idle wait: a finishing task
        # must deliver its status NOW (job completion latency), and a
        # dropped stream must start fallback polling NOW — the backoff only
        # ever delays true idle heartbeats
        self._wake = threading.Event()
        # graceful scale-in (ISSUE 15): once set, this executor stops
        # offering slots (polls become pure heartbeats, the push stream is
        # cancelled and never re-opened) but keeps running — and reporting
        # — its in-flight tasks until they drain. drain() waits for that.
        self._draining = threading.Event()

    # ------------------------------------------------------------------
    def start(self) -> None:
        t = threading.Thread(target=self.run, daemon=True)
        with self._mu:
            self._thread = t
        t.start()
        if self._push_enabled:
            st = threading.Thread(target=self._subscribe_loop, daemon=True)
            with self._mu:
                self._subscribe_thread = st
            st.start()

    def _cancel_push(self) -> None:
        """Tear down the live push stream (stop/death): cancelling the call
        unblocks the subscribe thread AND lets the scheduler's stream
        generator observe the disconnect and unregister the subscriber."""
        with self._mu:
            call = self._push_call
        if call is not None:
            try:
                call.cancel()
            except Exception:
                pass

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful scale-in (ISSUE 15): stop accepting work, finish — and
        REPORT — every in-flight task, then return True. The poll loop
        keeps heartbeating throughout (statuses ride it; the lease stays
        fresh, so no recovery machinery fires on a draining executor), and
        the push stream is cancelled so the scheduler's pump stops
        offering credit here. Returns False when in-flight work outlives
        `timeout` — the caller decides whether to stop anyway (which would
        reintroduce the recovery path drain exists to avoid)."""
        from ballista_tpu_torch.ops.runtime import record_fleet

        self._draining.set()
        self._cancel_push()
        self._wake.set()
        deadline = time.time() + timeout
        while time.time() < deadline and not self._stop.is_set():
            # one atomic read: pops out of _finished happen only inside
            # _drain_statuses' _inflight_mu section, so under the same
            # lock an undelivered status is in the queue OR in-delivery
            with self._inflight_mu:
                busy = (
                    bool(self._inflight)
                    or self._delivering > 0
                    or not self._finished.empty()
                )
            if not busy:
                # one synchronous flush: a racing heartbeat that failed
                # mid-delivery requeues its statuses — drain must not
                # declare victory while any are still undelivered
                try:
                    self.poll_once()
                except Exception:
                    pass
                with self._inflight_mu:
                    clean = (
                        self._delivering == 0 and self._finished.empty()
                    )
                if clean:
                    record_fleet("drain_completed")
                    return True
                continue
            # a finished task's status must leave on the NEXT poll, not a
            # decayed heartbeat
            self._wake.set()
            time.sleep(0.05)
        record_fleet("drain_timeout")
        return False

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._cancel_push()
        with self._mu:
            t = self._thread
            st = self._subscribe_thread
        if t:
            t.join(timeout=5)
        if st:
            st.join(timeout=5)

    def run(self) -> None:
        while not self._stop.is_set():
            self._poll_n += 1
            if self._chaos is not None and self._chaos.should_inject(
                "executor.death", f"{self.metadata.id}/poll{self._poll_n}"
            ):
                from ballista_tpu_torch.ops.runtime import record_recovery

                record_recovery("chaos_injected")
                record_recovery("chaos_executor_death")
                log.warning(
                    "chaos[executor.death]: executor %s dying at poll %d",
                    self.metadata.id, self._poll_n,
                )
                self._stop.set()
                # a dead process's streams die with it: cancel so the
                # scheduler unregisters the subscriber and stops pushing
                self._cancel_push()
                if self.on_death is not None:
                    try:
                        self.on_death()
                    except Exception as e:
                        log.warning("on_death hook failed: %s", e)
                return
            try:
                self.poll_once()
            except Exception as e:
                # repeated poll failure only warns (ref execution_loop.rs:70-72)
                log.warning("poll failed: %s", e)
            with self._mu:
                gc_due = time.time() - self._last_gc > 60
                if gc_due:
                    self._last_gc = time.time()
            if gc_due:
                try:
                    self.gc_work_dir()
                except Exception as e:
                    log.warning("work-dir GC failed: %s", e)
            # adaptive idle backoff (ISSUE 8): while the push stream is
            # healthy the heartbeat decays toward the configured ceiling —
            # the steady-state PollWork load of an idle fleet collapses
            # without touching dispatch latency (push owns dispatch) or
            # crash tolerance (echo/lease ride whatever polls happen). The
            # subscribe loop snaps the interval back on stream loss.
            if self._stream_ok.is_set():
                with self._mu:
                    self._poll_interval = min(
                        self._poll_interval * 2.0, self._idle_poll_max
                    )
                    interval = self._poll_interval
            else:
                with self._mu:
                    self._poll_interval = POLL_INTERVAL_SECS
                    interval = POLL_INTERVAL_SECS
            if self._wake.wait(interval):
                self._wake.clear()
                with self._mu:
                    self._poll_interval = POLL_INTERVAL_SECS

    def gc_work_dir(self) -> int:
        """Delete shuffle job dirs idle longer than shuffle_ttl_seconds —
        in the private work dir AND (ISSUE 15) in this executor's
        configured shared storage root, which would otherwise grow without
        bound (a retired producer's pieces have no other owner). Every
        executor on the mount runs the same sweep; racing rmtrees of an
        expired dir are harmless (ignore_errors), and the TTL keeps live
        jobs' pieces far out of reach."""
        import shutil

        removed = 0
        cutoff = time.time() - self.shuffle_ttl_seconds
        roots = [self.work_dir]
        storage = self.config.shuffle_dir()
        if storage:
            roots.append(storage)
        for root in roots:
            if not os.path.isdir(root):
                continue
            for job_dir in os.listdir(root):
                path = os.path.join(root, job_dir)
                try:
                    if os.path.isdir(path) and os.path.getmtime(path) < cutoff:
                        shutil.rmtree(path, ignore_errors=True)
                        removed += 1
                        # the exchange registry (ISSUE 16) must not outlive
                        # the authoritative pieces it mirrors
                        from ballista_tpu_torch.ops import exchange

                        exchange.evict_job(job_dir)
                except OSError:
                    continue
        if removed:
            log.info("gc: removed %d expired job dirs", removed)
        return removed

    # ------------------------------------------------------------------
    def _drain_statuses(self):
        """Pop every finished status AND count it in-delivery, atomically
        under _inflight_mu: drain() reads the queue and the _delivering
        counter under the same lock, so an undelivered status is ALWAYS
        visible to it — in the queue, or counted — with no window between
        the pop and the count."""
        with self._inflight_mu:
            out = []
            while True:
                try:
                    out.append(self._finished.get_nowait())
                except queue.Empty:
                    break
            self._delivering += len(out)
            return out

    def poll_once(self) -> bool:
        """One PollWork round; returns True if a task was received.

        The slot probe acquires ONCE, non-blocking, and hands the held slot
        to _run_task when a task arrives. (The previous probe-release-then-
        blocking-reacquire was a TOCTOU: concurrent completions between the
        probe and the reacquire could leave the poll thread BLOCKED on the
        semaphore, stopping heartbeats until a slot freed — long enough and
        a healthy executor got its lease lapsed and its tasks reset.)

        While the push stream is healthy this poll is a pure heartbeat:
        can_accept_task=False (dispatch belongs to the push path, and the
        latency harness asserts a healthy push cluster runs with ZERO
        poll-dispatched tasks); the moment the stream drops, polls pull
        work again — that IS the fallback."""
        slot_held = (
            False
            if self._stream_ok.is_set() or self._draining.is_set()
            else self._available.acquire(blocking=False)
        )
        # snapshot in-flight BEFORE draining statuses: a task finishing in
        # between is then reported as running (its status follows next
        # poll) rather than as neither — "neither" would read as an
        # orphaned assignment and trigger a spurious requeue
        with self._inflight_mu:
            inflight = list(self._inflight.values())
        # pops + the in-delivery count are one atomic step (see
        # _drain_statuses): a failed RPC puts them back below
        statuses = self._drain_statuses()
        try:
            params = pb.PollWorkParams(
                metadata=self.metadata, can_accept_task=slot_held
            )
            for pid, attempt in inflight:
                # both echo forms: running_tasks for wire compat with
                # pre-ISSUE-6 schedulers, running_echo (attempt-enriched)
                # for precise ledger reconciliation
                params.running_tasks.add().CopyFrom(pid)
                e = params.running_echo.add()
                e.partition_id.CopyFrom(pid)
                e.attempt = attempt
            for st in statuses:
                params.task_status.add().CopyFrom(st)
            result = self.scheduler.poll_work(params)
        except Exception:
            if slot_held:
                self._available.release()
            # the poll carried finished-task statuses; losing them would
            # wedge their jobs (the scheduler would wait forever) — requeue
            # for the next poll, which retries the delivery (BEFORE the
            # finally's _delivering decrement, so drain never observes
            # queue-empty + nothing-in-delivery while these are undelivered)
            for st in statuses:
                self._finished.put(st)
            raise
        finally:
            if statuses:
                with self._inflight_mu:
                    self._delivering -= len(statuses)
        if result.HasField("task"):
            self._register_inflight(result.task)
            # slot ownership transfers to the task thread (released in
            # _run_task's finally). A task arriving WITHOUT a held slot
            # (scheduler ignored can_accept_task=False) must not be
            # dropped — the task thread blocks for a slot itself, where
            # waiting cannot stall heartbeats
            threading.Thread(
                target=self._run_task,
                args=(result.task, slot_held),
                daemon=True,
            ).start()
            return True
        if slot_held:
            self._available.release()
        return False

    # -- push dispatch (ISSUE 8) ----------------------------------------
    def _subscribe_loop(self) -> None:
        """Keep ONE SubscribeWork stream open; run pushed tasks; on any
        drop, mark the stream unhealthy (polls snap back to 250ms and pull
        work — the automatic fallback) and re-subscribe with jittered
        backoff. A scheduler with push disabled answers UNIMPLEMENTED —
        still just a failed subscription here; the executor keeps probing
        at the backoff cap, so flipping the scheduler's config (or a
        rolling upgrade) picks the stream back up without a restart."""
        from ballista_tpu_torch.ops.runtime import record_serving
        from ballista_tpu_torch.scheduler.rpc import backoff_delay

        failures = 0
        while not self._stop.is_set() and not self._draining.is_set():
            params = pb.SubscribeWorkParams(slots=self.concurrent_tasks)
            params.metadata.CopyFrom(self.metadata)
            was_up = False
            try:
                call = self.scheduler.subscribe_work(params)
                with self._mu:
                    self._push_call = call
                # optimistic health: a refused/unreachable stream raises on
                # the first iteration below, within one scheduler tick
                self._stream_ok.set()
                was_up = True
                record_serving("push_subscribed")
                failures = 0
                for td in call:
                    self._on_pushed_task(td)
            except Exception as e:
                if not self._stop.is_set():
                    log.info("push stream down: %s", e)
            finally:
                self._stream_ok.clear()
                with self._mu:
                    self._push_call = None
                    self._poll_interval = POLL_INTERVAL_SECS
                if was_up:
                    record_serving("push_stream_drop")
                self._wake.set()  # fallback polling starts NOW
            if self._stop.is_set() or self._draining.is_set():
                return
            failures += 1
            self._stop.wait(backoff_delay(failures - 1, 0.05, cap=2.0))

    def _register_inflight(self, task: pb.TaskDefinition) -> None:
        """Track a received task — and every shared-scan batch sibling
        riding it (ISSUE 13) — in the running echo BEFORE execution starts,
        so the scheduler's orphaned-assignment grace never fires on a
        member whose batch is still being set up."""
        with self._inflight_mu:
            for td in (task, *task.siblings):
                pid = td.task_id
                self._inflight[(pid.job_id, pid.stage_id, pid.partition_id)] = (
                    pid, td.attempt,
                )

    def _on_pushed_task(self, task: pb.TaskDefinition) -> None:
        """One pushed TaskDefinition: exactly the poll-receive path, minus
        the held slot — the task thread blocks for its semaphore slot
        itself (the scheduler's credit keeps pushes ≈ slots; a transient
        overrun just queues on the semaphore, never drops work)."""
        from ballista_tpu_torch.ops.runtime import record_serving

        self._register_inflight(task)
        record_serving("task_pushed")
        threading.Thread(
            target=self._run_task, args=(task, False), daemon=True
        ).start()

    def _member_setup(self, task: pb.TaskDefinition):
        """Status skeleton + confined, deserialized plan + task context for
        one member of a dispatch. Failures land in the member's OWN failed
        status (plan None) — in a shared-scan batch (ISSUE 13) a bad member
        must never take its siblings down. Returns (task, status, plan,
        ctx)."""
        import functools

        from ballista_tpu_torch.serde.physical import phys_plan_from_proto

        pid = task.task_id
        status = pb.TaskStatus()
        status.partition_id.CopyFrom(pid)
        # echo the attempt in every reported status: the scheduler uses it
        # to drop stale reports from attempts it already reset — and the
        # speculative provenance (ISSUE 11), so a losing duplicate's drop
        # is attributable in the scheduler's logs/counters
        status.attempt = task.attempt
        status.speculative = task.speculative
        try:
            # allowlist comes from the EXECUTOR's own config; the per-job
            # settings merged below are client-controlled and must not
            # widen it. Proto check first: deserializing a parquet source
            # already reads the file footer.
            from ballista_tpu_torch.executor.confine import (
                check_proto_scan_roots,
                check_scan_roots,
            )

            roots = self.config.data_roots()
            check_proto_scan_roots(task.plan, roots)
            plan = phys_plan_from_proto(task.plan)
            check_scan_roots(plan, roots)
            if not isinstance(plan, ShuffleWriterExec):
                plan = ShuffleWriterExec(pid.job_id, pid.stage_id, plan, None)
            cfg = self.config
            if task.settings:
                # the submitting client's per-job settings override the
                # executor's own defaults
                cfg = BallistaConfig(
                    {**cfg.to_dict(), **{kv.key: kv.value for kv in task.settings}}
                )
                # ... except the shuffle WRITE/READ home (ISSUE 15): like
                # the data_roots allowlist, an executor whose OWN config
                # pins a shuffle tier keeps it — per-job settings must not
                # steer os.replace publishes (or confine storage reads) to
                # a client-chosen host path. An unconfigured executor (the
                # standalone/local default, tier=local + no dir) lets the
                # job opt in, mirroring data_roots="" = unrestricted.
                from ballista_tpu_torch.config import (
                    BALLISTA_SHUFFLE_DIR,
                    BALLISTA_SHUFFLE_TIER,
                )

                if (
                    self.config.shuffle_dir()
                    or self.config.shuffle_tier() != "local"
                ):
                    cfg = BallistaConfig({
                        **cfg.to_dict(),
                        BALLISTA_SHUFFLE_TIER: self.config.shuffle_tier(),
                        BALLISTA_SHUFFLE_DIR: self.config.shuffle_dir(),
                    })
            ctx = TaskContext(
                config=cfg,
                work_dir=self.work_dir,
                job_id=pid.job_id,
                # bind the merged config so fetch retries honor
                # ballista.rpc.* (incl. per-job overrides)
                shuffle_fetcher=functools.partial(
                    flight_shuffle_fetcher, config=cfg
                ),
                attempt=task.attempt,
                # keys the HBM-resident exchange registry (ISSUE 16) per
                # executor, so co-resident executors never cross-hit
                executor_id=self.metadata.id,
                device=self.device,
            )
            return task, status, plan, ctx
        except Exception as e:
            log.error("task %s setup failed: %s", pid, traceback.format_exc())
            status.failed.error = f"{type(e).__name__}: {e}"
            status.failed.executor_id = self.metadata.id
            return task, status, None, None

    def _member_execute(self, task, status, plan, ctx) -> None:
        """Execute one member's plan, filling its status in place."""
        from ballista_tpu_torch.errors import ShuffleFetchError
        from ballista_tpu_torch.utils.chaos import chaos_from_config

        pid = task.task_id
        try:
            # chaos from the MERGED config: per-job settings can arm the
            # "task.execute" site for just their job. Keyed on the attempt
            # so a retried attempt draws a fresh deterministic verdict —
            # and applied PER MEMBER, so a faulted member of a batch fails
            # alone while its siblings complete.
            chaos = chaos_from_config(ctx.config)
            if chaos is not None:
                # keyed on plan coordinates + attempt, NOT the (random) job
                # id: the same seed faults the same tasks every run
                chaos.maybe_fail(
                    "task.execute",
                    f"{pid.stage_id}/{pid.partition_id}@a{task.attempt}",
                )
                if chaos.should_inject(
                    "task.slow",
                    f"{pid.stage_id}/{pid.partition_id}@a{task.attempt}",
                ):
                    # deterministic straggler (ISSUE 11): the task still
                    # completes correctly, just late — the seeded tail the
                    # speculation subsystem must beat. Keyed on the attempt,
                    # so a speculative duplicate (attempt N+1) draws a
                    # FRESH verdict and is not slowed with its primary.
                    from ballista_tpu_torch.ops.runtime import record_recovery

                    delay = ctx.config.chaos_slow_ms() / 1000.0
                    record_recovery("chaos_injected")
                    record_recovery("chaos_slow_injected")
                    log.warning(
                        "chaos[task.slow]: delaying task %s/%s/%s attempt "
                        "%d by %.0fms", pid.job_id, pid.stage_id,
                        pid.partition_id, task.attempt, delay * 1000,
                    )
                    time.sleep(delay)
            stats = plan.execute_shuffle_write(pid.partition_id, ctx)
            from ballista_tpu_torch.distributed.stages import shuffle_output_base

            # the path-home the writer actually used: the shared storage
            # dir (tier=shared; storage_uri rides the completed status so
            # the piece set survives this executor, ISSUE 15) or this
            # executor's private work dir
            base, storage_uri = shuffle_output_base(
                ctx, pid.job_id, pid.stage_id, pid.partition_id
            )
            status.completed.executor_id = self.metadata.id
            status.completed.path = base
            if storage_uri:
                status.completed.storage_uri = storage_uri
            # advertise HBM residency (ISSUE 16): the scheduler folds this
            # into the consumer stage's ShuffleLocations (locality-aware
            # assignment) — a HINT only, the piece on disk stays the home
            from ballista_tpu_torch.ops import exchange

            if exchange.stage_resident(
                self.metadata.id, pid.job_id, pid.stage_id, pid.partition_id
            ):
                status.completed.resident = True
            status.completed.stats.num_rows = stats.num_rows
            status.completed.stats.num_batches = stats.num_batches
            status.completed.stats.num_bytes = stats.num_bytes
            log.info(
                "task %s/%s/%s completed (%d rows)",
                pid.job_id, pid.stage_id, pid.partition_id, stats.num_rows,
            )
        except ShuffleFetchError as e:
            # a shuffle fetch died, not this task's own work: report
            # fetch_failed NAMING THE LOST LOCATION so the scheduler
            # recomputes just that map partition (lineage recovery)
            log.warning(
                "task %s/%s/%s fetch failed (lost %s:%s): %s",
                pid.job_id, pid.stage_id, pid.partition_id,
                e.executor_id, e.path, e,
            )
            status.fetch_failed.error = str(e)
            status.fetch_failed.executor_id = self.metadata.id
            status.fetch_failed.map_stage_id = e.stage_id
            status.fetch_failed.map_partition_id = e.map_partition
            status.fetch_failed.map_executor_id = e.executor_id
            status.fetch_failed.path = e.path
        except Exception as e:
            log.error("task %s failed: %s", pid, traceback.format_exc())
            status.failed.error = f"{type(e).__name__}: {e}"
            status.failed.executor_id = self.metadata.id

    def _run_task(self, task: pb.TaskDefinition, slot_held: bool = True) -> None:
        """Run one TaskDefinition — or a shared-scan batch group (ISSUE 13:
        the primary plus task.siblings) under ONE task slot. Each member
        gets its own status; a member failing at any point (setup, chaos,
        execution) fails alone. Every member runs solo (the combined
        one-launch step is not ported yet)."""
        if not slot_held:
            self._available.acquire()
        members = [task] + list(task.siblings)
        prepped = []
        reported = 0

        def report(td: pb.TaskDefinition, status: pb.TaskStatus) -> None:
            # enqueue the status BEFORE dropping from in-flight: a poll in
            # the gap then reports the task as still running (harmless)
            # instead of as vanished (which would look like an orphaned
            # assignment). Per member, AS IT FINISHES — member 1's job
            # completion must not wait out member 8's execution — and the
            # wake kicks the poll loop out of any decayed idle wait so no
            # status rides a multi-second heartbeat.
            self._finished.put(status)
            pid = td.task_id
            with self._inflight_mu:
                self._inflight.pop(
                    (pid.job_id, pid.stage_id, pid.partition_id), None
                )
            self._wake.set()

        try:
            for td in members:
                prepped.append(self._member_setup(td))
            if len(members) > 1:
                # the combined one-launch step (the JAX package's
                # sharedscan.precompute) is not ported yet: every member
                # runs solo, as the JAX package's members do when
                # precompute declines, and gives its solo answer
                from ballista_tpu_torch.ops.runtime import record_shared_scan

                record_shared_scan(BATCH_SOLO_REASON)
                record_shared_scan("member_solo", len(members))
            for td, status, plan, ctx in prepped:
                if plan is not None:
                    self._member_execute(td, status, plan, ctx)
                report(td, status)
                reported += 1
        finally:
            self._available.release()
            # safety net: members never reached (an unexpected raise mid-
            # loop) still report — as failures, never as phantom pendings
            for td, status, _plan, _ctx in prepped[reported:]:
                if status.WhichOneof("status") is None:
                    status.failed.error = (
                        "batched execution aborted before this member ran"
                    )
                    status.failed.executor_id = self.metadata.id
                report(td, status)
