"""SchedulerServer: the control plane's 5 RPCs.

Mirrors the reference's SchedulerServer (rust/scheduler/src/lib.rs:82-428):

- ExecuteQuery: decode logical plan proto (or parse SQL), mint a 7-char
  alphanumeric job id (ref lib.rs:262-269), persist Queued, then plan
  asynchronously: optimize -> physical plan -> distributed stages -> persist
  each stage plan + one pending TaskStatus per (stage, partition)
  (ref lib.rs:288-401).
- PollWork: executor heartbeat + piggy-backed task statuses + work pull,
  the whole body under the global state lock (ref lib.rs:105-182).
- GetJobStatus / GetExecutorsMetadata / GetFileMetadata (parquet-only
  schema discovery, ref lib.rs:184-222).
"""

from __future__ import annotations

import logging
import queue
import random
import string
import threading
import time
from concurrent import futures
from typing import Dict, Optional

import grpc

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed.planner import DistributedPlanner
from ballista_tpu_torch.engine.context import ExecutionContext
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.scheduler.kv import KvBackend, MemoryBackend
from ballista_tpu_torch.scheduler.rpc import add_scheduler_service
from ballista_tpu_torch.scheduler.state import SchedulerState
from ballista_tpu_torch.serde.arrow import schema_to_ipc
from ballista_tpu_torch.serde.logical import plan_from_proto
from ballista_tpu_torch.utils.locks import make_lock

log = logging.getLogger("ballista.scheduler")


def _job_id() -> str:
    # 7 alphanumeric chars, first char alphabetic (ref lib.rs:262-269)
    first = random.choice(string.ascii_lowercase)
    rest = "".join(random.choices(string.ascii_lowercase + string.digits, k=6))
    return first + rest


class _PushSubscriber:
    """One executor's open SubscribeWork stream (ISSUE 8).

    `outstanding` is the scheduler-side credit ledger: plan coordinates of
    tasks pushed over this stream whose terminal status has not arrived yet
    — at most `slots` may be outstanding, so a slow executor is never
    buried under pushed work its semaphore cannot absorb. Entries resolve
    from the executor's own heartbeat statuses and are re-verified against
    the KV on every pump (a requeued orphan must free its credit). All
    fields are touched only under the scheduler's global KV lock (pump,
    PollWork) except `queue`/`closed`, which are internally thread-safe and
    shared with the stream generator thread."""

    def __init__(self, executor_id: str, slots: int) -> None:
        self.executor_id = executor_id  # durability: ephemeral(stream identity, dies with the stream)
        self.slots = max(1, slots)  # durability: ephemeral(credit capacity of this live stream)
        self.queue: "queue.Queue[pb.TaskDefinition]" = queue.Queue()  # durability: ephemeral(live stream plumbing)
        self.closed = threading.Event()  # durability: ephemeral(live stream plumbing)
        # (job, stage, part, attempt)
        # durability: ephemeral(credit ledger, re-verified against the KV on every pump)
        self.outstanding: set = set()

    def close(self) -> None:
        """Close + UNBLOCK: the None sentinel wakes a stream generator
        parked in queue.get immediately, so scheduler shutdown/restart
        never waits out the 0.25s tick (a restarted scheduler must rebind
        its port before retrying clients exhaust their backoff budget)."""
        self.closed.set()
        self.queue.put(None)


class SchedulerServer:
    def __init__(
        self,
        kv: Optional[KvBackend] = None,
        namespace: str = "default",
        config: Optional[BallistaConfig] = None,
        synchronous_planning: bool = False,
        replica_id: str = "",
        advertise_addr: str = "",
    ) -> None:
        self.config = config or BallistaConfig()  # durability: ephemeral(construction parameter)
        # ISSUE 14: one config flag arms the dynamic lock-order witness for
        # the whole process (scheduler threads, stream generators, pumps)
        from ballista_tpu_torch.utils import locks as _locks

        _locks.maybe_enable_from_config(self.config)
        self.state = SchedulerState(kv or MemoryBackend(), namespace, config=self.config)  # durability: ephemeral(the owned SchedulerState, classified field by field)
        # replica identity (ISSUE 20) lands BEFORE recovery: recover()'s
        # lease reclaim compares replica ids, and a replica restarting
        # under its own name must reclaim its predecessor's surviving
        # leases instead of treating them as a live peer's
        self.state.replica_id = replica_id
        self.state.replica_addr = advertise_addr
        # restart recovery BEFORE serving: discard torn (uncommitted) jobs,
        # reload the durable assignment ledger with a fresh grace window
        # (no-op with zero counters on a fresh store)
        self.recovery_stats = self.state.recover()  # durability: ephemeral(snapshot of this life's recovery counters)
        # catalog for SQL queries arriving as text (CREATE EXTERNAL TABLE
        # statements executed through the scheduler register here)
        # (the scheduler plans and never runs a stage, so its contexts
        # hold no card)
        self.catalog = ExecutionContext(self.config, device="cpu")  # durability: ephemeral(clients re-register external tables per session)
        self.synchronous_planning = synchronous_planning  # durability: ephemeral(construction parameter)
        # dead-executor sweep clock, touched only inside PollWork's global
        # lock (the `self._lock = threading.Lock()` that used to sit here
        # guarded nothing — the ISSUE 14 coverage sweep retired it)
        self._last_lost_check = 0.0  # durability: ephemeral(sweep clock, a fresh replica sweeps promptly)  # guarded-by: self.state.kv.lock()
        # deterministic scheduler-death injection (utils/chaos.py
        # "scheduler.crash"): keyed on the ACCEPTED-STATUS sequence so the
        # seeded crash lands mid-job (statuses only exist after planning
        # committed), regardless of poll interleaving. Once crashed, every
        # RPC answers UNAVAILABLE — exactly what a dead process looks like
        # to retrying clients — until the harness restarts the scheduler on
        # the same KV store (StandaloneCluster.restart_scheduler).
        self._chaos = self.state._chaos  # durability: ephemeral(deterministic fault-injection config, per process by design)
        self._accepted_statuses = 0  # under the kv lock (PollWork body)  # durability: ephemeral(per-process chaos sequence)
        self.crashed = False  # durability: ephemeral(crash-simulation flag for this process only)
        self.on_crash = None  # durability: ephemeral(harness callback)
        # tasks running on executors whose lease lapsed are rescheduled this
        # often (the reference loses such work permanently)
        self.lost_task_check_interval = 5.0  # durability: ephemeral(tuning knob)
        # GetFileMetadata walks globs and reads parquet footers; cap how many
        # RPC worker threads it may hold at once so a burst of large metadata
        # requests can never starve PollWork heartbeats of workers
        self._file_meta_slots = threading.BoundedSemaphore(4)  # durability: ephemeral(RPC worker throttle, process-local by nature)
        # cross-job physical-plan cache (ISSUE 7): optimize + physical
        # planning output serialized per CONTENT key (plan proto + settings,
        # no mtimes — planning depends on the file LIST, not file contents),
        # so N tenants submitting the same dashboard query plan once. The
        # cached value is the serialized proto, deserialized fresh per job:
        # plan trees are mutable (stage split, operator state) and must
        # never be shared across planner invocations.
        self._plan_cache_mu = make_lock("scheduler.server._plan_cache_mu")  # durability: ephemeral(a lock guards state, it is not state)
        self._plan_cache: "dict[str, bytes]" = {}  # durability: ephemeral(content-keyed memo, a fresh replica misses once per plan)  # guarded-by: self._plan_cache_mu
        self._plan_cache_cap = 128  # durability: ephemeral(tuning knob)
        # push-based task dispatch (ISSUE 8): executor id -> open stream.
        # The registry lock only guards the dict itself; subscriber credit
        # state is touched under the global KV lock (see _PushSubscriber).
        # Ordering: kv.lock() may be held when _push_mu is taken (pump),
        # NEVER the reverse.
        self.push_enabled = self.config.push_dispatch()  # durability: ephemeral(config snapshot)
        self._push_mu = make_lock("scheduler.server._push_mu")  # durability: ephemeral(a lock guards state, it is not state)
        self._subscribers: Dict[str, _PushSubscriber] = {}  # durability: ephemeral(live stream registry, streams die with the process)  # guarded-by: self._push_mu
        self._push_seq = 0  # scheduler.push chaos rotation; under the kv lock  # durability: ephemeral(per-process chaos sequence)
        # push job-status notifications (ISSUE 11): job id -> queues of
        # open SubscribeJobStatus streams. The state hook fans every
        # job-status write out to them; each stream terminates itself after
        # a terminal status (or client disconnect), so entries are
        # short-lived. Queue puts are internally thread-safe; the dict is
        # guarded by its own lock (never taken with the KV lock held by
        # anything that blocks).
        self._status_mu = make_lock("scheduler.server._status_mu")  # durability: ephemeral(a lock guards state, it is not state)
        self._status_subs: Dict[str, list] = {}  # durability: ephemeral(live stream registry, streams die with the process)  # guarded-by: self._status_mu
        # job -> last pushed serialized status: synchronize_job_status
        # re-writes a byte-identical running status on every non-final
        # task completion; one push per TRANSITION means suppressing those
        self._status_last: Dict[str, bytes] = {}  # durability: ephemeral(push dedup memo, a reconnected stream gets a fresh snapshot)  # guarded-by: self._status_mu
        self.state.on_job_status = self._notify_job_status
        # replicated-control-plane housekeeping (ISSUE 20): the daemon that
        # renews this replica's job leases, adopts dead peers' expired jobs,
        # and fails queued jobs whose planning replica died mid-plan. Started
        # from serve() ONLY — in-process test servers must not leak threads.
        self._hk_stop = threading.Event()  # durability: ephemeral(live thread plumbing)
        self._hk_thread: Optional[threading.Thread] = None  # durability: ephemeral(live thread handle, dies with the process)
        # job ids THIS replica is still planning/advancing: the queued-grace
        # sweep must never fail a job whose planner is alive in this very
        # process (set add/discard are atomic under the GIL)
        self._planning: set = set()  # durability: ephemeral(in-flight planning threads die with the process; peers judge them by the replica heartbeat instead)
        # scheduler-side shared-shuffle TTL sweep (ISSUE 20 satellite,
        # ROADMAP residue): same 1h TTL as the executor-side sweep
        self.shuffle_ttl_seconds = 3600.0  # durability: ephemeral(tuning knob)

    # -- crash simulation ---------------------------------------------------
    def _refuse_if_crashed(self, context) -> None:
        """A chaos-crashed scheduler is a dead process: every RPC fails
        UNAVAILABLE (transient to retrying clients) until the restart."""
        if not self.crashed:
            return
        if context is not None:
            context.abort(
                grpc.StatusCode.UNAVAILABLE, "scheduler crashed (chaos)"
            )
        raise RuntimeError("scheduler crashed (chaos)")

    def _crash(self, context) -> None:
        from ballista_tpu_torch.ops.runtime import record_recovery

        record_recovery("chaos_injected")
        record_recovery("chaos_scheduler_crash")
        log.warning(
            "chaos[scheduler.crash]: scheduler dying after accepting "
            "status #%d", self._accepted_statuses,
        )
        self.crashed = True
        # a dead process's housekeeping and streams die with it
        self._hk_stop.set()
        self.close_push_streams()
        if self.on_crash is not None:
            try:
                self.on_crash()
            except Exception as e:
                log.warning("on_crash hook failed: %s", e)
        self._refuse_if_crashed(context)

    # -- replicated-control-plane housekeeping (ISSUE 20) -------------------
    def start_housekeeping(self) -> None:
        """Start the replica housekeeping daemon: lease renewal (every
        ~TTL/3), the replica liveness heartbeat, adoption of dead peers'
        expired running jobs, the queued-grace sweep, and the scheduler-
        side shared-shuffle TTL sweep. Called from serve() — never from
        __init__, so the hundreds of in-process test servers stay
        thread-free."""
        if self._hk_thread is not None or self.crashed:
            return
        self._hk_stop.clear()
        self._hk_thread = threading.Thread(
            target=self._housekeeping_loop, daemon=True,
            name=f"scheduler-housekeeping-{self.state.replica_id or 'solo'}",
        )
        self._hk_thread.start()

    def stop_housekeeping(self) -> None:
        self._hk_stop.set()
        t = self._hk_thread
        if t is not None:
            t.join(timeout=5)
            self._hk_thread = None

    def _housekeeping_loop(self) -> None:
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        state = self.state
        # renew at a third of the TTL: two consecutive torn/missed rounds
        # still leave the lease alive, three depose us truthfully
        tick = max(0.05, state._lease_ttl / 3.0)
        renew_seq = 0
        queued_seen: Dict[str, float] = {}  # job -> first seen queued, grace clock
        last_shuffle_sweep = time.time()
        while not self._hk_stop.wait(tick):
            if self.crashed:
                return
            try:
                renew_seq += 1
                # scheduler.lease chaos: one torn RENEWAL round — the
                # heartbeat and every owned lease burn a round of TTL
                # budget; enough consecutive verdicts and peers adopt this
                # replica's jobs, which is exactly the failure under test
                if self._chaos is not None:
                    self._chaos.maybe_fail(
                        "scheduler.lease",
                        f"g{state.generation}/renew{renew_seq}",
                    )
                with state.kv.lock():
                    state.replica_heartbeat()
                    state.renew_owned_leases()
            except ChaosInjected:
                log.warning(
                    "chaos[scheduler.lease]: renewal round %d skipped",
                    renew_seq,
                )
            except Exception:
                log.warning("lease renewal round failed", exc_info=True)
            try:
                with state.kv.lock():
                    if self._adopt_orphaned_jobs_locked():
                        self._pump_pushes()
                    self._sweep_queued_grace_locked(queued_seen)
            except ChaosInjected:
                pass  # kv.lease tore an adoption claim; next round retries
            except Exception:
                log.warning("failover scan failed", exc_info=True)
            now = time.time()
            if now - last_shuffle_sweep >= 60.0:
                last_shuffle_sweep = now
                try:
                    self.sweep_shuffle_dir()
                except Exception:
                    log.warning("shuffle-dir sweep failed", exc_info=True)

    def _adopt_orphaned_jobs_locked(self) -> int:
        """Adopt every running job whose owner's lease expired (caller
        holds the global KV lock). The leasegen/ scan finds exactly the
        jobs that HAVE had owners; a live lease means the owner still
        heartbeats and the job is not ours to touch. adopt_job runs
        recovery scoped to the job — assignment/speculation ledgers
        reload, orphan grace restarts — so failover is the restart story
        executed by a peer."""
        state = self.state
        adopted = 0
        for key, _gen in state.kv.get_prefix(state._key("leasegen", "")):
            job_id = key.rsplit("/", 1)[1]
            if state.owns_job(job_id):
                continue
            if state.kv.get(state._lease_key(job_id)) is not None:
                continue  # owner alive (or a peer just adopted)
            st = state.get_job_metadata(job_id)
            if st is None or st.WhichOneof("status") != "running":
                continue
            if state.adopt_job(job_id):
                adopted += 1
                log.warning(
                    "replica %s adopted job %s from its expired owner",
                    state.replica_id or "<solo>", job_id,
                )
        return adopted

    def _sweep_queued_grace_locked(self, queued_seen: Dict[str, float]) -> int:
        """Fail queued jobs whose submitting replica died before the
        planning commit (caller holds the global KV lock). Scoped hard:
        only jobs carrying a planner/ provenance stamp whose replica
        heartbeat lapsed, never this replica's own in-flight planning,
        and only after a 2xTTL grace. The failure is a CAS against the
        exact queued bytes — racing the (resurrected) planner's atomic
        commit, exactly one of the two writes lands."""
        from ballista_tpu_torch.ops.runtime import record_recovery

        state = self.state
        now = time.time()
        failed_n = 0
        live = set()
        for key, raw in state.kv.get_prefix(state._key("jobs", "")):
            job_id = key.rsplit("/", 1)[1]
            st = pb.JobStatus()
            try:
                st.ParseFromString(raw)
            except Exception:
                continue
            if st.WhichOneof("status") != "queued":
                continue
            live.add(job_id)
            if job_id in self._planning:
                continue
            planner = state.job_planner(job_id)
            if planner is None:
                continue  # anonymous submission: restart recovery owns it
            if planner != state.replica_id and state.replica_alive(planner):
                queued_seen.pop(job_id, None)  # planner heartbeating: reset
                continue
            # our own stamp but not in self._planning: the planner thread
            # died with a predecessor process (restart under the same
            # replica id, with live peers suppressing the full-recovery
            # torn-job sweep) — grace applies to us like any dead peer
            first = queued_seen.setdefault(job_id, now)
            if now - first < 2.0 * state._lease_ttl:
                continue
            failed = pb.JobStatus()
            failed.failed.error = (
                f"planning replica {planner!r} died before committing "
                "the job's plan"
            )
            if state.kv.put_all(
                [(key, failed.SerializeToString())], compare=(key, raw)
            ):
                failed_n += 1
                record_recovery("queued_grace_failed")
                log.warning(
                    "queued job %s failed: planner replica %r lapsed "
                    "without committing", job_id, planner,
                )
            queued_seen.pop(job_id, None)
        # drop grace clocks for jobs that left queued (committed/failed)
        for job_id in [j for j in queued_seen if j not in live]:
            queued_seen.pop(job_id, None)
        return failed_n

    def _peer_with_pending_work_locked(self):
        """A live peer's (job_id, JobLease) whose job still has PENDING
        tasks (caller holds the global KV lock) — the re-home target for an
        idle executor this replica has nothing to dispatch to. None when
        every leased job is ours, drained, or address-less. Runs only on
        fully idle polls, whose frequency decays toward the idle ceiling."""
        state = self.state
        for key, raw in state.kv.get_prefix(state._key("leases", "")):
            job_id = key.rsplit("/", 1)[1]
            if state.owns_job(job_id):
                continue
            jl = pb.JobLease()
            try:
                jl.ParseFromString(raw)
            except Exception:
                continue
            if not jl.addr or jl.addr == state.replica_addr:
                continue
            for _k, v in state.kv.get_prefix(state._key("tasks", job_id) + "/"):
                ts = pb.TaskStatus()
                try:
                    ts.ParseFromString(v)
                except Exception:
                    continue
                if ts.WhichOneof("status") is None:
                    return job_id, jl
        return None

    def sweep_shuffle_dir(self) -> int:
        """Scheduler-side TTL sweep of the shared shuffle root (ISSUE 20
        satellite, ROADMAP residue): executors sweep the mount too, but a
        fleet scaled to zero — or torn down uncleanly — leaves nobody else
        to reclaim expired job dirs, and the mount would grow without
        bound. Same TTL and racing-rmtree tolerance as the executor
        sweep (executor/execution_loop.py::gc_work_dir)."""
        import os
        import shutil

        root = self.config.shuffle_dir()
        if not root or not os.path.isdir(root):
            return 0
        removed = 0
        cutoff = time.time() - self.shuffle_ttl_seconds
        for job_dir in os.listdir(root):
            path = os.path.join(root, job_dir)
            try:
                if os.path.isdir(path) and os.path.getmtime(path) < cutoff:
                    shutil.rmtree(path, ignore_errors=True)
                    removed += 1
            except OSError:
                continue
        if removed:
            log.info(
                "scheduler shuffle sweep: removed %d expired job dirs",
                removed,
            )
        return removed

    # -- RPC implementations ------------------------------------------------
    def ExecuteQuery(self, request: pb.ExecuteQueryParams, context=None) -> pb.ExecuteQueryResult:
        self._refuse_if_crashed(context)
        from ballista_tpu_torch.executor.confine import (
            check_proto_scan_roots,
            check_scan_files,
            check_scan_roots,
            check_scan_roots_path,
        )

        which = request.WhichOneof("query")
        settings = {kv.key: kv.value for kv in request.settings}
        config = BallistaConfig({**self.config.to_dict(), **settings})
        # data-root allowlist from the SCHEDULER's own config (client
        # settings must not widen it). Two layers, like the executor entry
        # points: the raw proto before any table source construction touches
        # disk, then the constructed plan's RESOLVED file lists (discovery
        # follows directory symlinks).
        roots = self.config.data_roots()
        if which == "logical_plan":
            check_proto_scan_roots(request.logical_plan, roots)
            plan = plan_from_proto(request.logical_plan)
            check_scan_roots(plan, roots)
        elif which == "sql":
            from ballista_tpu_torch.logical import plan as lp
            from ballista_tpu_torch.sql.planner import plan_sql

            plan = plan_sql(request.sql, self.catalog)
            if isinstance(plan, lp.CreateExternalTable):
                check_scan_roots_path(plan.location, roots)
                key = plan.name.lower()
                prior = self.catalog.tables.get(key)
                self.catalog._create_external_table(plan)
                src = self.catalog.tables.get(key)
                try:
                    check_scan_files(getattr(src, "files", []) or [], roots)
                except Exception:
                    # restore the pre-existing registration (a failing CET
                    # must not unregister someone else's table)
                    if prior is None:
                        self.catalog.tables.pop(key, None)
                    else:
                        self.catalog.tables[key] = prior
                    raise
                return pb.ExecuteQueryResult(job_id="")
        else:
            raise ValueError("ExecuteQueryParams requires a plan or sql")

        from ballista_tpu_torch.config import BALLISTA_TENANT, BALLISTA_TENANT_PRIORITY
        from ballista_tpu_torch.ops.runtime import record_tenancy
        from ballista_tpu_torch.scheduler.fingerprint import (
            plan_file_facts,
            plan_fingerprint,
        )

        # tenancy (ISSUE 7): the proto field is authoritative; settings keep
        # wire compat with clients that only flow the config map
        tenant = request.tenant or settings.get(BALLISTA_TENANT, "").strip()
        try:
            # clamp: pb.JobTenant.priority is uint32 — a negative settings
            # value must degrade to 0, not kill the submission
            priority = request.priority or max(0, int(
                settings.get(BALLISTA_TENANT_PRIORITY, "0") or 0
            ))
        except ValueError:
            priority = 0

        # plan-fingerprint identity (None when any source is neither
        # file-backed nor content-embedded — such plans never cache). The
        # facts are statted ONCE and shared with the key derivation, so
        # the stored scan_fact set always agrees with the result_key.
        fp = None
        facts = None
        if config.result_cache() or config.plan_cache():
            facts = plan_file_facts(plan)
            fp = plan_fingerprint(plan, settings, file_facts=facts)
        if fp is None and config.result_cache():
            record_tenancy("cache_unkeyable")

        job_id = _job_id()
        if fp is not None and config.result_cache():
            # result-cache lookup + job publish under the global lock so a
            # concurrent completion's cache put cannot interleave
            with self.state.kv.lock():
                hit = self.state.result_cache_lookup(fp[1])
                if hit is not None:
                    completed = pb.JobStatus()
                    completed.completed.CopyFrom(hit)
                    self.state.save_job_metadata(job_id, completed)
                    self.state.save_job_tenant(job_id, tenant, priority)
                    # link job -> entry so a lost cached result partition
                    # (ReportLostPartition) invalidates the right entry
                    self.state.save_job_fingerprint(job_id, fp[1])
                    # cache-served jobs complete HERE, never through
                    # synchronize_job_status — their SLO outcome (ISSUE
                    # 11) counts all the same, or per-tenant attainment
                    # would exclude exactly the fastest workloads
                    self.state._note_job_slo(job_id)
                    log.info(
                        "job %s served from result cache (tenant=%s, fp=%s...)",
                        job_id, tenant or "<default>", fp[1][:16],
                    )
                    return pb.ExecuteQueryResult(job_id=job_id)
                # miss: result-cache advancement (ISSUE 19) — a live
                # same-content entry over a strict SUBSET of this
                # submission's scan files can be folded forward with a
                # delta job over only the new files, instead of paying a
                # full recompute. Probed under the same lock, so the job
                # publish cannot interleave with a concurrent put.
                if config.cache_advance() and facts is not None:
                    if self._try_advance(job_id, plan, config, settings,
                                         tenant, priority, fp, facts):
                        return pb.ExecuteQueryResult(job_id=job_id)

        queued = pb.JobStatus()
        queued.queued.SetInParent()
        self.state.save_job_metadata(job_id, queued)
        # queued-grace provenance (ISSUE 20): peers may fail this job if
        # this replica dies before the planning commit
        self.state.mark_job_planner(job_id)
        # per-job client settings ride TaskDefinition to executors (the
        # reference drops its settings map, serde/scheduler/to_proto.rs:29-35)
        self.state.save_job_settings(job_id, settings)
        self.state.save_job_tenant(job_id, tenant, priority)
        if fp is not None and config.result_cache():
            self.state.save_job_fingerprint(job_id, fp[1])
            if facts is not None:
                # advancement identity (ISSUE 19): the completion-time
                # cache put stamps these onto the entry, making it a
                # candidate fold base for later grown-file-set submissions
                self.state.save_job_facts(job_id, fp[0], facts)

        content_key = fp[0] if (fp is not None and config.plan_cache()) else None
        if self.synchronous_planning:
            self._planning.add(job_id)
            try:
                self._plan_job(job_id, plan, config, content_key=content_key)
            finally:
                self._planning.discard(job_id)
        else:
            threading.Thread(
                target=self._plan_job_safe,
                args=(job_id, plan, config, content_key),
                daemon=True,
            ).start()
        return pb.ExecuteQueryResult(job_id=job_id)

    def _plan_job_safe(self, job_id: str, plan, config, content_key=None) -> None:
        self._planning.add(job_id)
        try:
            self._plan_job_guarded(job_id, plan, config, content_key)
        finally:
            # only now may a peer's queued-grace sweep judge the job: past
            # this point either the commit landed (running) or a terminal
            # failed status did — a still-queued job is truly abandoned
            self._planning.discard(job_id)

    def _plan_job_guarded(self, job_id: str, plan, config, content_key=None) -> None:
        from ballista_tpu_torch.ops.runtime import record_recovery
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        limit = self.state.retry_limit(job_id)
        attempt = 0
        while True:
            if self.crashed:
                # fence: this planning thread belongs to a crashed (or
                # restarted-over) scheduler instance. Committing now would
                # resurrect a job the successor's recover() already failed
                # as torn — abandon without writing anything
                log.warning("abandoning planning of job %s: scheduler "
                            "instance crashed", job_id)
                return
            try:
                self._plan_job(job_id, plan, config, attempt=attempt,
                               content_key=content_key)
                return
            except ChaosInjected as e:
                # the staged batch died before commit, so NOTHING was
                # published (atomic publish) — planning retries whole, like
                # a task attempt, with the chaos key rotated so the seeded
                # retry draws fresh verdicts
                attempt += 1
                if attempt > limit:
                    log.error("planning job %s failed after %d chaos-torn "
                              "attempts", job_id, attempt)
                    failed = pb.JobStatus()
                    failed.failed.error = (
                        f"planning failed after {attempt} attempts: {e}"
                    )
                    self.state.save_job_metadata(job_id, failed)
                    return
                record_recovery("plan_retry")
                log.warning("planning job %s torn by chaos; retrying "
                            "(attempt %d)", job_id, attempt)
            except Exception as e:  # surface planning failure as job failure
                log.exception("planning job %s failed", job_id)
                if self.crashed:
                    return  # successor owns the job's fate now
                failed = pb.JobStatus()
                failed.failed.error = f"planning failed: {e}"
                self.state.save_job_metadata(job_id, failed)
                return

    # -- result-cache advancement (ISSUE 19) --------------------------------
    def _try_advance(
        self, job_id, plan, config, settings, tenant, priority, fp, facts
    ) -> bool:
        """Called UNDER the global KV lock on a result-cache miss: when a
        fold base exists and the plan's aggregate state is resumable,
        publish the user job (queued) and hand it to the advancement
        worker. Returns False to fall through to ordinary planning. A base
        that exists but cannot fold (float sums, DISTINCT, no total
        order…) is a recorded decline — never a silent one."""
        from ballista_tpu_torch.ops.runtime import record_delta
        from ballista_tpu_torch.scheduler import delta as delta_mod

        base = self.state.result_cache_probe_advance(fp[0], facts)
        if base is None:
            return False
        spec = delta_mod.fold_spec(plan)
        if spec is None:
            record_delta("advance_declined")
            return False
        new_files = delta_mod.new_scan_files(facts, list(base.scan_fact))
        if not new_files:
            return False
        queued = pb.JobStatus()
        queued.queued.SetInParent()
        self.state.save_job_metadata(job_id, queued)
        self.state.mark_job_planner(job_id)
        self.state.save_job_settings(job_id, settings)
        self.state.save_job_tenant(job_id, tenant, priority)
        self.state.save_job_fingerprint(job_id, fp[1])
        self.state.save_job_facts(job_id, fp[0], facts)
        log.info(
            "job %s advancing cached result (epoch %d, +%d file(s), fp=%s...)",
            job_id, base.advance_epoch, len(new_files), fp[1][:16],
        )
        # the user job stays QUEUED for the whole advancement (possibly
        # minutes of delta-job execution): shield it from peers' queued-
        # grace sweeps for as long as this worker lives
        self._planning.add(job_id)
        threading.Thread(
            target=self._advance_job_safe,
            args=(job_id, plan, config, settings, tenant, priority, fp,
                  facts, base, new_files, spec),
            daemon=True,
        ).start()
        return True

    def _advance_job_safe(
        self, job_id, plan, config, settings, tenant, priority, fp, facts,
        base, new_files, spec,
    ) -> None:
        """Advancement worker: run one delta job per new file through the
        ORDINARY planning machinery (ledger, retries, speculation and
        recovery all apply to its tasks), fold the delta outputs into the
        cached base, publish the advanced entry under the grown set's
        result_key, and complete the user job with the folded result
        inline. ANY failure — a failed delta job, an unfetchable base, a
        chaos-torn publish — declines: recorded, logged, and the user job
        replans as a full recompute, so the fold is only ever an
        accelerator on a path whose fallback is the bit-identical truth."""
        try:
            self._advance_job(job_id, plan, config, settings, tenant,
                              priority, fp, facts, base, new_files, spec)
        finally:
            self._planning.discard(job_id)

    def _advance_job(
        self, job_id, plan, config, settings, tenant, priority, fp, facts,
        base, new_files, spec,
    ) -> None:
        import time as _time

        from ballista_tpu_torch.config import BALLISTA_DELTA_FOR
        from ballista_tpu_torch.ops.runtime import record_delta
        from ballista_tpu_torch.scheduler import delta as delta_mod

        content_key = fp[0] if config.plan_cache() else None

        def fall_back(reason: str) -> None:
            record_delta("advance_declined")
            log.warning("advancement of job %s declined (%s); planning a "
                        "full recompute", job_id, reason)
            self._plan_job_safe(job_id, plan, config, content_key)

        try:
            schema = plan.schema()
            delta_jobs = []
            for f in new_files:
                dj = _job_id()
                dsettings = dict(settings)
                dsettings[BALLISTA_DELTA_FOR] = job_id
                queued = pb.JobStatus()
                queued.queued.SetInParent()
                with self.state.kv.lock():
                    # no jobfp/jobfacts: a delta job's partial result must
                    # never enter the result cache under any key
                    self.state.save_job_metadata(dj, queued)
                    self.state.mark_job_planner(dj)
                    self.state.save_job_settings(dj, dsettings)
                    self.state.save_job_tenant(dj, tenant, priority)
                threading.Thread(
                    target=self._plan_job_safe,
                    args=(dj, delta_mod.build_delta_plan(plan, f), config,
                          None),
                    daemon=True,
                ).start()
                delta_jobs.append(dj)
            deadline = _time.time() + 600.0
            delta_tables = []
            for dj in delta_jobs:
                while True:
                    if self.crashed:
                        return  # the successor owns the job's fate now
                    st = self.state.get_job_metadata(dj)
                    which = st.WhichOneof("status") if st else None
                    if which == "completed":
                        break
                    if which == "failed":
                        return fall_back(
                            f"delta job {dj} failed: {st.failed.error}"
                        )
                    if _time.time() > deadline:
                        return fall_back(f"delta job {dj} timed out")
                    _time.sleep(0.005)
                delta_tables.append(delta_mod.fetch_completed_table(
                    st.completed.partition_location, config, schema
                ))
            if base.state_ipc:
                base_table = delta_mod.ipc_to_table(base.state_ipc)
            else:
                base_table = delta_mod.fetch_completed_table(
                    base.partition_location, config, schema
                )
            folded = delta_mod.fold_tables(
                [base_table] + delta_tables, spec, schema
            )
            ipc = delta_mod.table_to_ipc(folded)
            with self.state.kv.lock():
                if self.crashed:
                    return
                published = self.state.result_cache_put_advanced(
                    fp[1], fp[0], facts, ipc, base.advance_epoch
                )
                if published:
                    record_delta("advance_hits")
                    completed = pb.JobStatus()
                    completed.completed.cached = True
                    completed.completed.inline_result = ipc
                    self.state.save_job_metadata(job_id, completed)
                    self.state._note_job_slo(job_id)
            if not published:
                # outside the KV lock: the fallback replans through the
                # plan cache, whose mutex must never nest under the store
                return fall_back("publish torn by chaos")
            log.info(
                "job %s advanced from cached base (epoch %d -> %d, %d delta "
                "file(s), fp=%s...)",
                job_id, base.advance_epoch, base.advance_epoch + 1,
                len(new_files), fp[1][:16],
            )
        except Exception as e:
            if self.crashed:
                return
            log.exception("advancement of job %s failed", job_id)
            fall_back(str(e))

    def _physical_plan(self, plan, config, content_key=None):
        """Optimize + physical-plan, through the cross-job plan cache when a
        content key is available: a cache hit deserializes the stored proto
        (fresh tree per job — plan nodes are mutable) instead of re-running
        the optimizer, so N tenants submitting the same query plan once."""
        from ballista_tpu_torch.config import BALLISTA_TPU_COALESCE_AGG
        from ballista_tpu_torch.ops.runtime import record_tenancy
        from ballista_tpu_torch.serde.physical import (
            phys_plan_from_proto,
            phys_plan_to_proto,
        )

        if content_key is not None:
            with self._plan_cache_mu:
                blob = self._plan_cache.get(content_key)
            kv_hit = False
            if blob is None:
                # KV read-through tier (ISSUE 20): a peer replica's
                # planning output serves this replica's first miss — N
                # replicas sharing an admission load plan each dashboard
                # query ONCE cluster-wide, not once per replica
                blob = self.state.kv.get(
                    self.state._key("plancache", content_key)
                )
                kv_hit = blob is not None
            if blob is not None:
                # a cached blob that stops deserializing (e.g. after a code
                # change mid-process) must evict and fall through to fresh
                # planning, never fail the job
                try:
                    node = pb.PhysicalPlanNode()
                    node.ParseFromString(blob)
                    plan_tree = phys_plan_from_proto(node)
                except Exception:
                    with self._plan_cache_mu:
                        self._plan_cache.pop(content_key, None)
                    self.state.kv.delete(
                        self.state._key("plancache", content_key)
                    )
                else:
                    record_tenancy("plan_cache_hit")
                    if kv_hit:
                        self._plan_cache_insert(content_key, blob)
                    return plan_tree
        # distributed jobs keep the Partial/exchange/Final shape: the stage
        # split parallelizes across executors, and the SPMD fuse needs it
        ctx = ExecutionContext(
            config.with_setting(BALLISTA_TPU_COALESCE_AGG, "false"), device="cpu"
        )
        physical = ctx.create_physical_plan(plan)
        if content_key is not None:
            # validate the blob round-trips BEFORE inserting (and hand out
            # the fresh tree): a plan that serializes but cannot
            # deserialize must never enter the cache — inserting first
            # would open a window where a concurrent submission hits the
            # poisoned entry
            try:
                blob = phys_plan_to_proto(physical).SerializeToString()
                node = pb.PhysicalPlanNode()
                node.ParseFromString(blob)
                fresh = phys_plan_from_proto(node)
            except Exception:
                return physical  # unserializable plans just don't cache
            self._plan_cache_insert(content_key, blob)
            # the KV tier is namespace-lifetime (no cap): plancache rows
            # are keyed by plan content and die with the store, like
            # resultcache entries
            self.state.kv.put(
                self.state._key("plancache", content_key), blob
            )
            return fresh
        return physical

    def _plan_cache_insert(self, content_key: str, blob: bytes) -> None:
        with self._plan_cache_mu:
            if len(self._plan_cache) >= self._plan_cache_cap:
                # drop the oldest insertion (dict preserves order) —
                # a simple bound, not an LRU; the cap is generous
                self._plan_cache.pop(next(iter(self._plan_cache)))
            self._plan_cache[content_key] = blob

    def _plan_job(
        self, job_id: str, plan, config, attempt: int = 0, content_key=None
    ) -> None:
        physical = self._physical_plan(plan, config, content_key)
        stages = DistributedPlanner(config).plan_query_stages(job_id, physical)
        # all-or-nothing publish: stage plans, pending tasks, and the
        # queued->running flip land in ONE KV batch, so a crash mid-plan
        # leaves no torn job (the job stays queued with no planning keys
        # and recover() fails it cleanly on restart)
        batch = self.state.stage_job_plan(job_id, attempt)
        for stage in stages:
            batch.add_stage_plan(stage.stage_id, stage)
            n = stage.output_partitioning().partition_count()
            for p in range(n):
                batch.add_pending_task(stage.stage_id, p)
        if self.crashed:
            # last fence before the publish (narrow in-process race left:
            # real restarts are separate processes where the dead
            # scheduler's threads cannot write at all)
            raise RuntimeError("scheduler crashed during planning")
        batch.commit()
        log.info("job %s planned into %d stages", job_id, len(stages))
        # the whole point of push dispatch: the job's first tasks leave for
        # subscribed executors the moment planning commits, not after the
        # next PollWork round-trip
        with self.state.kv.lock():
            self._pump_pushes()

    # -- push dispatch (ISSUE 8) --------------------------------------------
    def _task_definition(self, status: pb.TaskStatus, plan) -> pb.TaskDefinition:
        """Serialize one assignment into the wire TaskDefinition — the ONE
        shape both dispatch paths (PollWork reply, SubscribeWork push) send,
        so the executor cannot tell them apart."""
        from ballista_tpu_torch.serde.physical import phys_plan_to_proto

        from ballista_tpu_torch.config import BALLISTA_DELTA_FOR

        td = pb.TaskDefinition()
        td.task_id.CopyFrom(status.partition_id)
        td.attempt = status.attempt
        td.plan.CopyFrom(phys_plan_to_proto(plan))
        for k, v in self.state.get_job_settings(
            status.partition_id.job_id
        ).items():
            td.settings.add(key=k, value=v)
            if k == BALLISTA_DELTA_FOR:
                # delta provenance (ISSUE 19) rides first-class too
                td.delta_for = v
        return td

    def _close_subscriber(self, sub: _PushSubscriber) -> None:
        sub.close()
        with self._push_mu:
            if self._subscribers.get(sub.executor_id) is sub:
                del self._subscribers[sub.executor_id]

    def close_push_streams(self) -> None:
        """Close every server-push stream NOW (shutdown/restart/crash) —
        work-dispatch subscribers AND job-status subscribers: the
        generators return on their sentinel instead of finishing a 0.25s
        tick, so the gRPC server's stop().wait() drains promptly (clients
        fall back to status polling until they re-subscribe)."""
        with self._push_mu:
            subs = list(self._subscribers.values())
            self._subscribers.clear()
        for sub in subs:
            sub.close()
        with self._status_mu:
            status_qs = [q for qs in self._status_subs.values() for q in qs]
            self._status_subs.clear()
            self._status_last.clear()
        for q in status_qs:
            q.put(None)

    # -- push job-status notifications (ISSUE 11) ---------------------------
    def _notify_job_status(self, job_id: str, status: pb.JobStatus) -> None:
        """State hook: fan one job-status write out to this job's open
        SubscribeJobStatus streams — one push per TRANSITION: a re-write
        byte-identical to the last pushed status is suppressed. Each
        subscriber gets its own copy (the caller may keep mutating the
        message)."""
        with self._status_mu:
            qs = list(self._status_subs.get(job_id, ()))
            if not qs:
                # no listeners: skip the serialization too — this hook
                # rides the scheduler's hottest write path
                self._status_last.pop(job_id, None)
                return
            data = status.SerializeToString()
            if self._status_last.get(job_id) == data:
                return
            self._status_last[job_id] = data
        for q in qs:
            snap = pb.JobStatus()
            snap.CopyFrom(status)
            q.put(snap)

    def SubscribeJobStatus(self, request: pb.GetJobStatusParams, context=None):
        """Server-streaming job-status push (ISSUE 11): one
        GetJobStatusResult per status transition, seeded with the current
        status (subscribing after completion still answers immediately),
        terminating after a terminal status. Mirrors SubscribeWork's
        lifecycle: the client's status POLL stays as the automatic fallback
        whenever this stream is down, refused, or racing a restart."""
        self._refuse_if_crashed(context)
        job_id = request.job_id
        # push is replica-LOCAL by design (ISSUE 20): status transitions
        # fan out from the replica that writes them — subscribing here for
        # a live peer's job would hold a silent stream. Refuse with the
        # owner's address; the client re-homes (or its poll fallback,
        # which reads shared KV truth, carries it to completion).
        lease = self.state.job_lease(job_id)
        if lease is not None and not self.state.owns_job(job_id):
            detail = (
                f"job {job_id} owned by peer replica {lease.replica_id!r}"
                f" at {lease.addr}; subscribe there"
            )
            if context is not None:
                context.abort(grpc.StatusCode.UNAVAILABLE, detail)
            raise RuntimeError(detail)
        q: "queue.Queue" = queue.Queue()
        with self._status_mu:
            self._status_subs.setdefault(job_id, []).append(q)
        cur = self.state.get_job_metadata(job_id)
        if cur is not None:
            # the seed is this subscriber's baseline — record it for the
            # transition dedup too (only when no push set it already: a
            # racing notify may have just advanced it past this snapshot)
            with self._status_mu:
                self._status_last.setdefault(job_id, cur.SerializeToString())
            q.put(cur)

        def stream():
            try:
                while not self.crashed:
                    if context is not None and not context.is_active():
                        return
                    try:
                        st = q.get(timeout=0.25)
                    except queue.Empty:
                        continue
                    if st is None:  # close sentinel (shutdown/restart)
                        return
                    res = pb.GetJobStatusResult()
                    res.status.CopyFrom(st)
                    yield res
                    if st.WhichOneof("status") in ("completed", "failed"):
                        return
            finally:
                with self._status_mu:
                    qs = self._status_subs.get(job_id)
                    if qs is not None:
                        try:
                            qs.remove(q)
                        except ValueError:
                            pass
                        if not qs:
                            del self._status_subs[job_id]
                            self._status_last.pop(job_id, None)

        return stream()

    def _pump_pushes(self) -> int:
        """Assign + push runnable tasks to every subscribed executor with
        free credit. Caller MUST hold the global KV lock — assignment, the
        credit ledger, and the chaos sequence all live under it, exactly
        like the PollWork dispatch path. Returns the number pushed.

        The `scheduler.push` chaos site tears the DELIVERY, after the
        Running flip: the assignment stands, the subscriber's stream is
        killed with the verdict, and recovery is exactly the lost-PollWork-
        response story — the executor's polls never echo the task, the
        orphaned-assignment grace reconciliation requeues it, and the
        executor re-subscribes. Keyed on a generation-rotated per-process
        sequence (like scheduler.admit) so a restarted scheduler draws
        fresh verdicts."""
        from ballista_tpu_torch.ops.runtime import record_recovery, record_serving
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        if not self.push_enabled or self.crashed:
            return 0
        with self._push_mu:
            subs = list(self._subscribers.values())
        pushed = 0
        for sub in subs:
            pushed += self._pump_one_locked(sub)
        return pushed

    def _pump_one_locked(self, sub: _PushSubscriber) -> int:
        """Pump ONE subscriber (caller holds the global KV lock). The
        per-subscriber stream tick calls this for its own stream only —
        pumping every subscriber from every tick would be O(N^2) idle KV
        traffic at 4Hz on the scheduler's one lock."""
        from ballista_tpu_torch.ops.runtime import record_recovery, record_serving
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        if not self.push_enabled or self.crashed or sub.closed.is_set():
            return 0
        # re-verify outstanding credits against the KV: a task requeued
        # behind our back (orphan reconciliation, lost-task reset) must
        # free its credit even though no terminal status ever arrives.
        # Bounded by `slots` reads, and only when credit is actually held.
        # A SPECULATIVE duplicate (ISSUE 11) has no tasks/ status of its
        # own — its credit stands while its speculation-ledger entry lives.
        for key in list(sub.outstanding):
            if self.state.speculation_active(
                (key[0], key[1], key[2]), sub.executor_id, key[3]
            ):
                continue
            cur = self.state.get_task_status(key[0], key[1], key[2])
            if (
                cur is None
                or cur.WhichOneof("status") != "running"
                or cur.attempt != key[3]
                or cur.running.executor_id != sub.executor_id
            ):
                sub.outstanding.discard(key)
        pushed = 0
        while len(sub.outstanding) < sub.slots and not sub.closed.is_set():
            speculative = False
            try:
                assigned = self.state.assign_next_schedulable_task(
                    sub.executor_id
                )
            except ChaosInjected:
                # scheduler.admit chaos: nothing was written (the abort
                # fires before the Running flip); the next pump retries
                # with a rotated admission key — same recovery story as
                # the aborted-PollWork form of this site
                break
            if assigned is None:
                # no fresh work for this executor: offer the slot to the
                # straggler monitor — push dispatch is exactly what makes
                # a speculative duplicate land instantly (ISSUE 11)
                assigned = self.state.maybe_speculate(sub.executor_id)
                speculative = assigned is not None
            if assigned is None:
                break
            status, plan = assigned
            pid = status.partition_id
            self._push_seq += 1
            if self._chaos is not None and self._chaos.should_inject(
                "scheduler.push",
                f"g{self.state.generation}/push{self._push_seq}",
            ):
                record_recovery("chaos_injected")
                record_recovery("chaos_push_torn")
                log.warning(
                    "chaos[scheduler.push]: tearing delivery of "
                    "%s/%s/%s to %s (stream killed)",
                    pid.job_id, pid.stage_id, pid.partition_id,
                    sub.executor_id,
                )
                self._close_subscriber(sub)
                break
            td = self._task_definition(status, plan)
            td.speculative = speculative
            sub.outstanding.add(
                (pid.job_id, pid.stage_id, pid.partition_id, status.attempt)
            )
            if not speculative:
                # scan-sharing pass (ISSUE 13): ride co-pending compatible
                # stages of OTHER jobs on this dispatch as batch siblings —
                # each holds its own push credit, resolved by its own
                # terminal status like any pushed task
                for st2, plan2 in self.state.form_shared_batch(
                    status, plan, sub.executor_id
                ):
                    td.siblings.add().CopyFrom(
                        self._task_definition(st2, plan2)
                    )
                    p2 = st2.partition_id
                    sub.outstanding.add(
                        (p2.job_id, p2.stage_id, p2.partition_id, st2.attempt)
                    )
            sub.queue.put(td)
            record_serving("dispatch_push")
            pushed += 1
        return pushed

    def SubscribeWork(self, request: pb.SubscribeWorkParams, context=None):
        """Server-streaming push dispatch (ISSUE 8): register the executor,
        then stream TaskDefinitions as the pump assigns them. One stream per
        executor — a new subscription supersedes (and closes) the old one,
        so a reconnect after a network blip cannot leave a zombie stream
        holding credit."""
        self._refuse_if_crashed(context)
        if not self.push_enabled:
            if context is not None:
                context.abort(
                    grpc.StatusCode.UNIMPLEMENTED,
                    "push dispatch disabled on this scheduler",
                )
            raise RuntimeError("push dispatch disabled")
        sub = _PushSubscriber(request.metadata.id, request.slots or 4)
        with self._push_mu:
            prior = self._subscribers.get(sub.executor_id)
            if prior is not None:
                prior.close()
            self._subscribers[sub.executor_id] = sub
        log.info("executor %s subscribed for push dispatch (slots=%d)",
                 sub.executor_id, sub.slots)
        with self.state.kv.lock():
            # register the executor before its first poll so assignment's
            # liveness/blacklist checks see it, then hand it whatever is
            # already runnable
            self.state.save_executor_metadata(request.metadata)
            self._pump_pushes()

        def stream():
            try:
                while not sub.closed.is_set() and not self.crashed:
                    if context is not None and not context.is_active():
                        return
                    try:
                        td = sub.queue.get(timeout=0.25)
                        if td is None:  # close() sentinel
                            return
                    except queue.Empty:
                        # periodic self-heal pump — THIS subscriber only:
                        # requeues with no event hook (restart recovery,
                        # lease-expiry resets) still dispatch within one
                        # tick, at O(subscribers) total idle cost
                        try:
                            with self.state.kv.lock():
                                self._pump_one_locked(sub)
                        except Exception:
                            pass
                        continue
                    yield td
            finally:
                self._close_subscriber(sub)

        return stream()

    def PollWork(self, request: pb.PollWorkParams, context=None) -> pb.PollWorkResult:
        import time as _time

        self._refuse_if_crashed(context)
        with self.state.kv.lock():
            self.state.save_executor_metadata(request.metadata)
            now = _time.time()
            if now - self._last_lost_check > self.lost_task_check_interval:
                self._last_lost_check = now
                n = self.state.reset_lost_tasks()
                if n:
                    log.warning("re-scheduled %d tasks from dead executors", n)
            # ownership gate (ISSUE 20): fold statuses only for jobs this
            # replica owns — adopting expired-lease jobs on the spot (the
            # thread-free half of failover). Statuses for a live PEER's
            # jobs are left on the executor's queue: the poll still folds
            # everything writable, then ends in a redirecting UNAVAILABLE
            # so the executor's retry loop re-homes to the owner and
            # re-delivers (accept_task_status is idempotent).
            foreign: Dict[str, pb.JobLease] = {}
            for job_id in sorted(
                {ts.partition_id.job_id for ts in request.task_status}
            ):
                holder = self.state.ensure_job_writable(job_id)
                if holder is not None:
                    foreign[job_id] = holder
            jobs = set()
            for ts in request.task_status:
                if ts.partition_id.job_id in foreign:
                    continue
                # stale reports from already-reset attempts are dropped;
                # accepted ones keep the KV-side attempt history
                if self.state.accept_task_status(ts):
                    jobs.add(ts.partition_id.job_id)
                    self._accepted_statuses += 1
                    # generation-rotated key: a restarted scheduler must
                    # draw fresh verdicts, not re-crash at the same status
                    if self._chaos is not None and self._chaos.should_inject(
                        "scheduler.crash",
                        f"g{self.state.generation}"
                        f"/status{self._accepted_statuses}",
                    ):
                        # accepted writes up to HERE are durable; the rest
                        # of this poll's statuses are requeued by the
                        # executor and re-delivered to the restarted
                        # scheduler (accept_task_status is idempotent)
                        self._crash(context)
            # after statuses (a completed report must clear its assignment
            # first): requeue assignments this executor never received.
            # Prefer the attempt-enriched echo; fall back to the bare
            # PartitionId form for pre-ISSUE-6 executors
            echo = (
                request.running_echo
                if len(request.running_echo)
                else request.running_tasks
            )
            n = self.state.reconcile_running_tasks(request.metadata.id, echo)
            if n:
                log.warning(
                    "requeued %d orphaned assignment(s) for executor %s",
                    n, request.metadata.id,
                )
            # push-credit resolution (ISSUE 8): a terminal status from this
            # executor frees the pushed-task credit it held
            with self._push_mu:
                sub = self._subscribers.get(request.metadata.id)
            if sub is not None:
                for ts in request.task_status:
                    if ts.WhichOneof("status") in (
                        "completed", "failed", "fetch_failed"
                    ):
                        pid = ts.partition_id
                        sub.outstanding.discard(
                            (pid.job_id, pid.stage_id, pid.partition_id,
                             ts.attempt)
                        )
            result = pb.PollWorkResult()
            # no dispatch on a poll that is about to redirect: an assigned
            # task would flip Running durably and then die with the abort,
            # riding the 3s orphan grace for nothing
            if request.can_accept_task and not foreign:
                speculative = False
                assigned = self.state.assign_next_schedulable_task(request.metadata.id)
                if assigned is None:
                    # idle capacity + no fresh work: offer the slot to the
                    # straggler monitor (ISSUE 11) — on poll-mode clusters
                    # this is how a speculative duplicate dispatches
                    assigned = self.state.maybe_speculate(request.metadata.id)
                    speculative = assigned is not None
                if assigned is not None:
                    from ballista_tpu_torch.ops.runtime import record_serving

                    status, plan = assigned
                    result.task.CopyFrom(self._task_definition(status, plan))
                    result.task.speculative = speculative
                    if not speculative:
                        # scan-sharing pass (ISSUE 13): batch co-pending
                        # compatible stages of other jobs onto this reply
                        for st2, plan2 in self.state.form_shared_batch(
                            status, plan, request.metadata.id
                        ):
                            result.task.siblings.add().CopyFrom(
                                self._task_definition(st2, plan2)
                            )
                    record_serving("dispatch_poll")
            for job_id in jobs:
                self.state.synchronize_job_status(job_id)
            # accepted statuses may have completed upstream stages (or the
            # credit resolution above freed slots): dispatch the newly
            # runnable work NOW instead of waiting for a subscriber tick
            self._pump_pushes()
            if foreign:
                from ballista_tpu_torch.ops.runtime import record_recovery

                job_id, holder = sorted(foreign.items())[0]
                record_recovery("ownership_redirected")
                detail = (
                    f"job {job_id} owned by peer replica "
                    f"{holder.replica_id!r} at {holder.addr}; re-home"
                )
                log.info("PollWork(%s) redirected: %s",
                         request.metadata.id, detail)
                if context is not None:
                    context.abort(grpc.StatusCode.UNAVAILABLE, detail)
                raise RuntimeError(detail)
            # idle-capacity re-home (ISSUE 20): a fully idle executor (no
            # statuses, no echoes, nothing assigned this poll) polled a
            # replica with nothing to dispatch while a live peer owns a job
            # that still has PENDING tasks. Without this, an executor homed
            # to a workless replica never learns a failover moved its work:
            # the non-owner answers empty polls forever. Bounce it to the
            # owner — the client's retry loop jumps endpoints on the named
            # address, and closing the local push stream (idle by the same
            # check) makes the re-subscribe follow.
            if (
                not result.HasField("task")
                and not request.task_status
                and not len(request.running_echo)
                and not len(request.running_tasks)
            ):
                hint = self._peer_with_pending_work_locked()
                if hint is not None:
                    job_id, holder = hint
                    with self._push_mu:
                        sub = self._subscribers.get(request.metadata.id)
                        if sub is not None and sub.outstanding:
                            # pushed work in flight: not idle after all
                            return result
                        self._subscribers.pop(request.metadata.id, None)
                    if sub is not None:
                        sub.close()
                    from ballista_tpu_torch.ops.runtime import record_recovery

                    record_recovery("idle_rehomed")
                    detail = (
                        f"job {job_id} owned by peer replica "
                        f"{holder.replica_id!r} at {holder.addr}; re-home"
                    )
                    log.info("PollWork(%s) idle re-home: %s",
                             request.metadata.id, detail)
                    if context is not None:
                        context.abort(grpc.StatusCode.UNAVAILABLE, detail)
                    raise RuntimeError(detail)
            return result

    def GetJobStatus(self, request: pb.GetJobStatusParams, context=None) -> pb.GetJobStatusResult:
        self._refuse_if_crashed(context)
        status = self.state.get_job_metadata(request.job_id)
        result = pb.GetJobStatusResult()
        if status is not None:
            result.status.CopyFrom(status)
            # ownership hint (ISSUE 20): the status itself is KV truth and
            # answers from ANY replica, but push subscriptions and lost-
            # partition reports belong on the owner — hand clients its
            # address when that is a live peer
            lease = self.state.job_lease(request.job_id)
            if (
                lease is not None
                and lease.addr
                and not self.state.owns_job(request.job_id)
            ):
                result.owner_addr = lease.addr
        return result

    def ReportLostPartition(
        self, request: pb.ReportLostPartitionParams, context=None
    ) -> pb.ReportLostPartitionResult:
        """A client's result fetch failed: restart the final-stage tasks
        that died with the named executor through the lineage/retry
        machinery (scheduler/state.py::restart_completed_job). Covers both
        a COMPLETED job (the PR 5/6 buffered-fetch case; the status flips
        back to running) and a still-RUNNING job whose published
        partial_location died under a streaming client (ISSUE 8). Declined
        (restarted=False) when the job is terminal-failed/queued or nothing
        completed on that executor — the client re-raises its fetch error."""
        self._refuse_if_crashed(context)
        with self.state.kv.lock():
            # restart surgery belongs on the owner (ISSUE 20): it rewrites
            # task statuses and the assignment ledger. Adopt expired-lease
            # jobs on the spot; redirect for a live peer's.
            holder = self.state.ensure_job_writable(request.job_id)
            if holder is not None:
                detail = (
                    f"job {request.job_id} owned by peer replica "
                    f"{holder.replica_id!r} at {holder.addr}; report there"
                )
                if context is not None:
                    context.abort(grpc.StatusCode.UNAVAILABLE, detail)
                raise RuntimeError(detail)
            n = self.state.restart_completed_job(
                request.job_id, request.executor_id
            )
            restarted = n > 0
            if n == 0:
                # concurrent-reporter race: another client's report already
                # flipped the job back to running. Tell this client to keep
                # polling (restarted=True) instead of re-raising its fetch
                # error while recovery is in flight.
                js = self.state.get_job_metadata(request.job_id)
                restarted = (
                    js is not None and js.WhichOneof("status") == "running"
                )
                if (
                    js is not None
                    and js.WhichOneof("status") == "completed"
                    and js.completed.cached
                ):
                    # a CACHE-SERVED job has no tasks to restart: the data
                    # died (or was GC'd) under a still-live lease. Eagerly
                    # invalidate the entry and fail the job — the client
                    # resubmits and the fresh submission misses the cache
                    # and executes for real (client/context.py retries the
                    # resubmission itself on collect()).
                    fp = self.state.get_job_fingerprint(request.job_id)
                    if fp is not None:
                        self.state.result_cache_invalidate(fp)
                    failed = pb.JobStatus()
                    failed.failed.error = (
                        "cached result partitions lost with executor "
                        f"{request.executor_id}; the cache entry was "
                        "invalidated — resubmit the query"
                    )
                    self.state.save_job_metadata(request.job_id, failed)
                    restarted = False
            if n:
                # the requeued final-stage tasks are runnable immediately
                self._pump_pushes()
        log.warning(
            "ReportLostPartition(job=%s, executor=%s, %s/%s): restarted %d",
            request.job_id, request.executor_id,
            request.stage_id, request.partition_id, n,
        )
        return pb.ReportLostPartitionResult(restarted=restarted, tasks_restarted=n)

    def GetExecutorsMetadata(self, request, context=None) -> pb.GetExecutorMetadataResult:
        self._refuse_if_crashed(context)
        result = pb.GetExecutorMetadataResult()
        for m in self.state.get_executors_metadata():
            result.metadata.add().CopyFrom(m)
        return result

    def GetFileMetadata(self, request: pb.GetFileMetadataParams, context=None) -> pb.GetFileMetadataResult:
        self._refuse_if_crashed(context)
        # parquet only, like the reference (lib.rs:184-222)
        if request.file_type.lower() != "parquet":
            raise ValueError("GetFileMetadata supports parquet only")
        # fail fast: a blocked waiter would itself occupy an RPC worker
        # thread, defeating the purpose of the cap
        if not self._file_meta_slots.acquire(blocking=False):
            raise RuntimeError(
                "GetFileMetadata: too many concurrent metadata requests; retry"
            )
        try:
            from ballista_tpu_torch.datasource import ParquetTableSource
            from ballista_tpu_torch.executor.confine import (
                check_scan_files,
                check_scan_roots_path,
            )

            # same allowlist as ExecuteQuery: this RPC reads parquet footers of
            # client-named host paths
            check_scan_roots_path(request.path, self.config.data_roots())
            src = ParquetTableSource(request.path)
            check_scan_files(src.files, self.config.data_roots())
            return pb.GetFileMetadataResult(
                schema_ipc=schema_to_ipc(src.schema()),
                num_partitions=src.num_partitions(),
            )
        finally:
            self._file_meta_slots.release()


def serve(
    server_impl: SchedulerServer,
    bind_host: str = "0.0.0.0",
    port: int = 50050,
    max_workers: int = 32,
) -> grpc.Server:
    from ballista_tpu_torch.scheduler.rpc import GRPC_MESSAGE_OPTIONS

    # each subscribed executor's SubscribeWork stream pins one worker thread
    # for its lifetime (ISSUE 8): deployments MUST size max_workers to
    # executor_count + heartbeat headroom (default fits ~16 push executors;
    # past that, raise it or disable ballista.executor.push_dispatch), or a
    # full pool would starve PollWork heartbeats and lapse healthy leases
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=GRPC_MESSAGE_OPTIONS,
    )
    add_scheduler_service(server, server_impl)
    bound = server.add_insecure_port(f"{bind_host}:{port}")
    if bound == 0:
        raise RuntimeError(f"cannot bind scheduler to {bind_host}:{port}")
    server.start()
    # a SERVING scheduler runs replica housekeeping (ISSUE 20): lease
    # renewal, dead-peer adoption, queued-grace, shuffle-dir TTL sweep.
    # In-process test servers that never serve() stay thread-free.
    server_impl.start_housekeeping()
    # SubscribeWork streams (ISSUE 8) hold their worker thread inside the
    # response generator until cancelled; a process exiting WITHOUT a clean
    # cluster shutdown would then hang in ThreadPoolExecutor's atexit join
    # forever. Regular atexit callbacks run BEFORE threading's — stopping
    # the server here cancels every live stream so the join drains.
    # Idempotent: a second stop() on an already-stopped server is a no-op.
    import atexit

    atexit.register(server.stop, None)
    log.info("scheduler listening on %s:%s", bind_host, bound)
    server._ballista_port = bound  # actual port when port=0
    return server
