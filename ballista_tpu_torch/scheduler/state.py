"""Scheduler cluster state over a KV backend.

Mirrors the reference's SchedulerState (rust/scheduler/src/state/mod.rs):
every piece of cluster state is a protobuf value under
/ballista/{namespace}/... keys, so a restarted scheduler on a durable
backend resumes mid-job. Key layout (ref state/mod.rs:387-434):

    executors/{id}                  ExecutorMetadata (60s lease)
    jobs/{job_id}                   JobStatus
    settings/{job_id}               JobSettings (client per-job settings)
    stages/{job_id}/{stage_id}      PhysicalPlanNode (the stage plan)
    tasks/{job_id}/{stage_id}/{p}   TaskStatus (empty oneof = pending)
    assignments/{job_id}/{stage}/{p} Assignment (durable in-flight ledger)
    tenants/{job_id}                JobTenant (tenant + priority, ISSUE 7)
    jobfp/{job_id}                  result-cache fingerprint of the job
    resultcache/{fingerprint}       ResultCacheEntry (completed locations)
    meta/restart_generation         int (bumped by each restart recovery)
    leases/{job_id}                 JobLease, TTL-leased (ISSUE 20: which
                                    replica owns the job + fencing gen)
    leasegen/{job_id}               int (monotonic fencing-generation
                                    counter; outlives each lease)
    meta/plan_epoch                 int (bumped on task-set mutations so
                                    peer task indexes re-seed on change)
    meta/rc_epoch                   int (bumped on result-cache count
                                    changes; peers re-derive the count)
    replicas/{replica_id}           replica liveness heartbeat, TTL-leased
                                    (renewed by the housekeeping thread)
    planner/{job_id}                which replica accepted the submission
                                    (queued-grace provenance, ISSUE 20)
    plancache/{content_key}         serialized PhysicalPlanNode — the KV
                                    tier of the cross-job plan cache

Crash tolerance (ISSUE 6): planning writes publish atomically through
KvBackend.put_all (the `running` job status is the commit marker — a job
still `queued` after a scheduler crash was never committed), the
assignment ledger is written through to the KV so a restarted scheduler
reloads it, and `recover()` folds the reloaded ledger against executors'
PollWork `running_echo` — tasks the owner still runs are re-adopted,
tasks nobody vouches for within the grace window requeue through the
normal retry/lineage path.

Replicated control plane (ISSUE 20): N scheduler replicas share one KV
store, and job ownership shards by lease — `leases/{job}` is minted
atomically WITH the planning commit (same put_all) and renewed by the
owner; replica death is lease expiry, and an idle peer adopts the dead
replica's jobs by running recover() scoped to them (failover = restart
recovery run by a peer). Every job-scoped durable write by an owner is a
compare-and-swap against its remembered lease value (the FENCING rule):
a deposed-but-alive owner's stale writes are rejected whole, and the
rejection drops its local ownership. The fencing generation is minted
from the durable `leasegen/{job}` counter in the same atomic batch, so
generations never repeat across adoptions.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ballista_tpu_torch.config import BALLISTA_MAX_TASK_RETRIES, BallistaConfig
from ballista_tpu_torch.distributed.planner import (
    find_unresolved_shuffles,
    remove_unresolved_shuffles,
)
from ballista_tpu_torch.distributed.stages import (
    ShuffleLocation,
    ShuffleReaderExec,
    ShuffleWriterExec,
)
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.scheduler.kv import KvBackend
from ballista_tpu_torch.serde.physical import phys_plan_from_proto, phys_plan_to_proto
from ballista_tpu_torch.utils.locks import make_lock

log = logging.getLogger("ballista.scheduler")

EXECUTOR_LEASE_SECS = 60.0  # ref state/mod.rs:42

# how long after assignment an executor's polls may omit a task from its
# running_tasks echo before the scheduler treats the assignment as lost in
# transit (PollWork response never arrived) and requeues it. Must exceed a
# couple of executor poll intervals (0.25s) plus scheduling slack.
ORPHANED_ASSIGNMENT_GRACE_SECS = 3.0

# cold prior one never-observed pending task contributes to the predicted
# autoscaling backlog (ISSUE 15): small enough that priors alone never
# grow the fleet, nonzero so a deep cold queue still registers
BACKLOG_COLD_TASK_SECONDS = 0.02


def _record_recovery(event: str, n: int = 1) -> None:
    # lazy: scheduler state must stay importable before the ops runtime
    from ballista_tpu_torch.ops.runtime import record_recovery

    record_recovery(event, n)


def _record_tenancy(event: str, n: int = 1) -> None:
    from ballista_tpu_torch.ops.runtime import record_tenancy

    record_tenancy(event, n)


def _record_speculation(event: str, n: float = 1) -> None:
    from ballista_tpu_torch.ops.runtime import record_speculation

    record_speculation(event, n)


def _record_shared_scan(event: str, n: int = 1) -> None:
    from ballista_tpu_torch.ops.runtime import record_shared_scan

    record_shared_scan(event, n)


def _record_routing(engine: str, op: str = "", predicted_s=None,
                    observed_s=None) -> None:
    from ballista_tpu_torch.ops.runtime import record_routing

    record_routing(engine, op, predicted_s, observed_s)


def _record_delta(event: str, n: int = 1) -> None:
    from ballista_tpu_torch.ops.runtime import record_delta

    record_delta(event, n)


def _record_shuffle_tier(event: str, n: int = 1) -> None:
    from ballista_tpu_torch.ops.runtime import record_shuffle_tier

    record_shuffle_tier(event, n)


def _attempts_error(t: pb.TaskStatus) -> str:
    """Human-readable failure naming EVERY attempt of the task — the error
    a job fails with once retries are exhausted."""
    lines = [
        f"attempt {h.attempt} on {h.executor_id or '?'}: {h.error}"
        for h in t.history
    ]
    w = t.WhichOneof("status")
    if w == "failed":
        lines.append(
            f"attempt {t.attempt} on {t.failed.executor_id or '?'}: {t.failed.error}"
        )
    elif w == "fetch_failed":
        ff = t.fetch_failed
        lines.append(
            f"attempt {t.attempt} on {ff.executor_id or '?'}: fetch of lost "
            f"shuffle output {ff.map_executor_id}:{ff.path} "
            f"(map {ff.map_stage_id}/{ff.map_partition_id}) failed: {ff.error}"
        )
    pid = t.partition_id
    return (
        f"task {pid.job_id}/{pid.stage_id}/{pid.partition_id} failed after "
        f"{len(lines)} attempt(s): " + "; ".join(lines)
    )


class _TaskIndex:
    """Per-stage pending/incomplete index over task statuses.

    assign_next_schedulable_task previously re-scanned (and re-parsed) EVERY
    task protobuf in the KV under the global scheduler lock on every poll —
    O(total tasks) per idle poll. The index keeps, per (job_id, stage_id):
    the pending partitions (status oneof unset), the not-yet-completed
    partitions (answers "is this upstream stage fully done" in O(1)), and
    the total task count (a stage with NO tasks is never a satisfied
    dependency). It is seeded lazily from one full scan — a restarted
    scheduler on a durable backend resumes correctly — and then maintained
    on every save_task_status transition, which is the single write path
    for task state (planning, poll updates, lost-task resets)."""

    def __init__(self) -> None:
        self.pending: Dict[Tuple[str, int], set] = {}
        self.incomplete: Dict[Tuple[str, int], set] = {}
        self.total: Dict[Tuple[str, int], set] = {}
        # in-flight partitions per stage (status oneof == running): the
        # per-tenant in-flight totals behind admission quotas and weighted
        # fair share (ISSUE 7) sum these through the job->tenant map
        self.running: Dict[Tuple[str, int], set] = {}

    def observe(self, status: pb.TaskStatus) -> None:
        pid = status.partition_id
        key = (pid.job_id, pid.stage_id)
        part = pid.partition_id
        self.total.setdefault(key, set()).add(part)
        w = status.WhichOneof("status")
        if w is None:
            self.pending.setdefault(key, set()).add(part)
        else:
            self._drop(self.pending, key, part)
        if w == "running":
            self.running.setdefault(key, set()).add(part)
        else:
            self._drop(self.running, key, part)
        if w == "completed":
            self._drop(self.incomplete, key, part)
        else:
            self.incomplete.setdefault(key, set()).add(part)

    @staticmethod
    def _drop(index: Dict[Tuple[str, int], set], key, part) -> None:
        """Remove part from index[key], deleting drained entries — a
        long-lived scheduler must not re-sort every stage it ever saw on
        each poll."""
        s = index.get(key)
        if s is None:
            return
        s.discard(part)
        if not s:
            del index[key]

    def stage_done(self, job_id: str, stage_id: int) -> bool:
        key = (job_id, stage_id)
        return bool(self.total.get(key)) and not self.incomplete.get(key)


# a peer scheduler sharing the namespace writes tasks this instance's index
# never observes; re-seed from a full scan at most this often so peer-
# submitted jobs are discovered within a bounded delay (single-scheduler
# deployments see every write through save_task_status and never need it,
# but still pay at most one scan per interval instead of one per poll)
TASK_INDEX_RESEED_SECS = 5.0


class JobPlanBatch:
    """One job's planning output, published all-or-nothing (ISSUE 6).

    Job submission used to write job metadata, per-stage plans, and task
    statuses as independent puts — a scheduler crash mid-plan left a torn
    job (some stages visible, some tasks missing, status forever queued).
    The batch stages every planning write in memory and commits them in a
    single KvBackend.put_all TOGETHER WITH the `running` job-status flip,
    which is therefore the commit marker: a job still `queued` after a
    crash provably has no planning keys (transactional backends roll the
    batch back; recover() discards leakage from non-transactional ones).

    Every staged write passes the `scheduler.plan_write` chaos site, keyed
    on PLAN coordinates + the planning attempt (never the random job id),
    so a seeded chaos run tears planning at the same point every run and a
    planning retry draws fresh verdicts."""

    def __init__(self, state: "SchedulerState", job_id: str, attempt: int = 0) -> None:
        self._state = state
        self.job_id = job_id
        self.attempt = attempt
        self._items: List[Tuple[str, bytes]] = []
        self._tasks: List[pb.TaskStatus] = []

    def _chaos(self, key: str) -> None:
        if self._state._chaos is not None:
            self._state._chaos.maybe_fail(
                "scheduler.plan_write", f"{key}@a{self.attempt}"
            )

    def add_stage_plan(self, stage_id: int, plan) -> None:
        self._chaos(f"stage{stage_id}")
        msg = phys_plan_to_proto(plan)
        self._items.append((
            self._state._key("stages", self.job_id, str(stage_id)),
            msg.SerializeToString(),
        ))

    def add_pending_task(self, stage_id: int, partition: int) -> None:
        self._chaos(f"{stage_id}/{partition}")
        pending = pb.TaskStatus()
        pending.partition_id.job_id = self.job_id
        pending.partition_id.stage_id = stage_id
        pending.partition_id.partition_id = partition
        self._items.append((
            self._state._key(
                "tasks", self.job_id, str(stage_id), str(partition)
            ),
            pending.SerializeToString(),
        ))
        self._tasks.append(pending)

    def commit(self) -> None:
        """Publish the whole plan + the queued->running flip atomically,
        minting the job's ownership lease in the same batch (ISSUE 20)."""
        self._chaos("commit")
        running = pb.JobStatus()
        running.running.SetInParent()
        items = self._items + [(
            self._state._key("jobs", self.job_id),
            running.SerializeToString(),
        )]
        self._state.commit_plan_batch(self.job_id, items)
        # index only AFTER the publish succeeded: an aborted batch must
        # leave no trace, in the index included
        if self._state._task_index is not None:
            for t in self._tasks:
                self._state._task_index.observe(t)
        # the running flip bypasses save_job_metadata (it rides the atomic
        # batch), so push-status subscribers (ISSUE 11) are notified here
        self._state._notify_job_status(self.job_id, running)


class SchedulerState:
    def __init__(
        self,
        kv: KvBackend,
        namespace: str = "default",
        config: Optional[BallistaConfig] = None,
    ) -> None:
        self.kv = kv  # durability: ephemeral(the backend handle itself, not state)
        self.namespace = namespace  # durability: ephemeral(construction parameter)
        self.config = config or BallistaConfig()  # durability: ephemeral(construction parameter)
        self._task_index: Optional[_TaskIndex] = None  # durability: derived(_ensure_task_index)
        self._task_index_seeded_at = 0.0  # durability: derived(_ensure_task_index)
        # deterministic fault injection for the KV write seam (utils/chaos.py)
        from ballista_tpu_torch.utils.chaos import chaos_from_config

        # durability: ephemeral(deterministic fault-injection config, per process by design)
        self._chaos = chaos_from_config(self.config)
        # kv.put key rotation; under the kv lock
        # durability: ephemeral(per-process chaos sequence, fresh verdicts after restart by design)
        self._chaos_puts = 0
        # assignment ledger: (job, stage, part) -> (executor, attempt,
        # monotonic time, restored-by-restart). PollWork is retried on
        # UNAVAILABLE and is NOT idempotent: if the response carrying an
        # assignment is lost, the task sits Running on a live-lease executor
        # that never heard of it. Executors echo their in-flight tasks each
        # poll; reconcile_running_tasks requeues ledger entries the owner
        # stopped vouching for. Every mutation is WRITTEN THROUGH to the KV
        # under assignments/{job}/{stage}/{part} (pb.Assignment, keyed by
        # plan coordinates so replays are idempotent) — recover() reloads it
        # after a scheduler restart with a fresh grace window, so restart
        # reconciliation re-adopts tasks executors still run instead of
        # waiting for the lease machinery. The in-memory map carries the
        # monotonic timestamp (wall clock is not restart-comparable). All
        # access happens under the scheduler's global KV lock held by
        # PollWork.
        self._assigned: Dict[  # durability: durable(assignments)
            Tuple[str, int, int], Tuple[str, int, float, bool]
        ] = {}
        # how many restart recoveries this store has seen (0 = first life).
        # Chaos keys that are per-process sequences (scheduler.crash) fold
        # the generation in, so a restarted scheduler draws FRESH verdicts
        # instead of deterministically re-crashing at the same point.
        self.generation = 0  # durability: durable(meta)
        # -- multi-tenant bookkeeping (ISSUE 7) -----------------------------
        # read-through cache of the durable tenants/{job} records (a job's
        # tenant is immutable, so cached entries never go stale) and the
        # per-tenant assignment totals behind bench's fairness report.
        # Both are touched from PollWork (under the global KV lock) AND from
        # ExecuteQuery / test probes, so they carry their own lock.
        self._tenant_mu = make_lock("scheduler.state._tenant_mu")  # durability: ephemeral(a lock guards state, it is not state)
        # job -> (tenant, priority, created_at); guarded-by: self._tenant_mu
        self._tenant_cache: Dict[str, Tuple[str, int, float]] = {}  # durability: derived(_job_tenant_full)
        self.tenant_assigned: Dict[str, int] = {}  # durability: ephemeral(fairness telemetry, re-accumulates from live flow)  # guarded-by: self._tenant_mu
        # scheduler.admit chaos rotation: like _chaos_puts, a per-process
        # admission sequence so a faulted admission's retry (the executor's
        # next poll) draws a fresh deterministic verdict
        self._admit_seq = 0  # under the kv lock (PollWork body)  # durability: ephemeral(per-process chaos sequence)
        # parse the tenancy config ONCE, here: a malformed weights string
        # (or quota) must fail scheduler construction with a clear error,
        # not raise inside every assignment scan and wedge all scheduling
        self._tenant_weights = self.config.tenant_weights()  # durability: ephemeral(parsed once from config at construction)
        self._tenant_quota = self.config.tenant_max_inflight()  # durability: ephemeral(parsed once from config at construction)
        self._tenant_slos = self.config.tenant_slos()  # durability: ephemeral(parsed once from config at construction)
        # -- speculative execution (ISSUE 11) ------------------------------
        # the scheduler is also a cost-model CLIENT now: completed task
        # durations are observed under job-independent task.run ops and the
        # straggler monitor predicts from them, so configure the store from
        # this config (idempotent beside the executor-side configures — a
        # standalone cluster shares one process-global store)
        from ballista_tpu_torch.ops import costmodel

        costmodel.configure(self.config)
        self._spec_enabled = self.config.speculation()  # durability: ephemeral(config snapshot)
        self._spec_multiplier = self.config.speculation_multiplier()  # durability: ephemeral(config snapshot)
        self._spec_floor_s = self.config.speculation_min_runtime_s()  # durability: ephemeral(config snapshot)
        # re-speculation bound (ISSUE 15 satellite, PR 11 residue): a
        # duplicate that itself straggles past the same threshold may be
        # superseded by a fresh duplicate, up to this many launches per
        # task. _spec_launches counts them; _spec_superseded remembers the
        # ABANDONED duplicates' attempt numbers so their late reports are
        # retired without touching the task (a superseded completion still
        # wins — first completion wins, whoever crosses the line). Both
        # in-memory, under the global KV lock like the ledger map; a
        # restarted scheduler rebuilds the launch count from the ledger
        # record (attempt arithmetic) and forgets the superseded set — the
        # attempt-numbering floor in requeue_task keeps late reports from
        # ever impersonating a fresh attempt regardless.
        self._spec_max = self.config.speculation_max_attempts()  # durability: ephemeral(config snapshot)
        self._spec_launches: Dict[Tuple[str, int, int], int] = {}  # durability: derived(recover)
        self._spec_superseded: Dict[Tuple[str, int, int], set] = {}  # durability: ephemeral(superseded-attempt memory, the attempt floor retires late reports regardless)
        # running-task watch: (job, stage, part) -> (executor, attempt,
        # monotonic start). Maintained by save_task_status (the single task
        # write path), consumed by the straggler monitor and by the
        # completion-duration observation. In-memory only — a restarted
        # scheduler re-learns durations from fresh completions.
        self._running_since: Dict[  # durability: ephemeral(monotonic watch, re-learned from live polls)
            Tuple[str, int, int], Tuple[str, int, float]
        ] = {}
        # active speculative duplicates: (job, stage, part) -> (executor,
        # attempt, monotonic launch, vouched, restored). Write-through to
        # speculation/{job}/{stage}/{part} (pb.Assignment) so a scheduler
        # restart recovers BOTH attempts of an in-flight pair — the primary
        # from its tasks/ running status, the duplicate from here.
        self._speculative: Dict[  # durability: durable(speculation)
            Tuple[str, int, int], Tuple[str, int, float, bool, bool]
        ] = {}
        # elapsed-ordered straggler heap (ISSUE 13 satellite, PR 11
        # residue): (monotonic start, key3) entries mirroring
        # _running_since, so the straggler monitor scans ONLY tasks past
        # the speculation floor instead of every running task under the
        # global KV lock on each idle slot. Lazily invalidated — an entry
        # whose start time no longer matches the watch map is a superseded
        # attempt and drops on sight. Access under the global KV lock like
        # _running_since.
        self._running_heap: List[Tuple[float, Tuple[str, int, int]]] = []  # durability: ephemeral(scan accelerator mirroring _running_since, lazily invalidated)
        # -- shared-scan batching (ISSUE 13) --------------------------------
        self._shared_scan = self.config.shared_scan()  # durability: ephemeral(config snapshot)
        self._shared_max_batch = self.config.shared_scan_max_batch()  # durability: ephemeral(config snapshot)
        # scheduler.batch chaos rotation (like _admit_seq): a torn batch
        # formation degrades THAT dispatch to solo; the next formation
        # draws a fresh deterministic verdict
        self._batch_seq = 0  # under the kv lock (dispatch paths)  # durability: ephemeral(per-process chaos sequence)
        # batched-task accounting: member key3 -> batch id, and batch id ->
        # {k, t0, remaining, predicted, dirty}. In-memory only (pure
        # cost-model learning; a restarted scheduler just re-learns), all
        # access under the global KV lock.
        self._batch_members: Dict[Tuple[str, int, int], int] = {}  # durability: ephemeral(cost-model learning, a restarted scheduler re-learns)
        self._batches: Dict[int, dict] = {}  # durability: ephemeral(cost-model learning, a restarted scheduler re-learns)
        self._batch_next_id = 0  # durability: ephemeral(batch ids are process-local handles)
        # (job, stage) -> scan-sharing signature (or None): stage plans are
        # immutable once planned, so the signature is computed once — the
        # candidate scan must not re-deserialize every co-pending stage
        # plan on every dispatch. Bounded like _task_op_cache.
        self._shared_sig_cache: Dict[Tuple[str, int], Optional[tuple]] = {}  # durability: ephemeral(content-keyed memo over immutable stage plans, misses recompute)
        # per-(job, stage) cache of the job-independent task.run cost op
        self._task_op_cache: Dict[Tuple[str, int], str] = {}  # durability: ephemeral(content-keyed memo, misses recompute)
        # scheduler-owned task.run rates (op -> (total seconds, n)): the
        # process-global cost store is cleared by ANY job whose merged
        # per-job settings carry a different cost_model_dir (configure()
        # drops the store on a dir change) — the straggler monitor must
        # not lose its rates to a client config quirk. Observations mirror
        # into the store too (observability + cross-restart persistence
        # when a dir is configured); predictions consult this first.
        self._task_rates: Dict[str, Tuple[float, int]] = {}  # durability: ephemeral(duration learning, re-learned from completions and mirrored to the cost store)
        # tenant -> last wall time its oldest pending job was seen overdue:
        # the admit_slo_boosted counter counts boost EPISODES (enter
        # overdue), not admission scans — the scan runs on every poll/pump
        # tick, and a momentary pending-set drain at a stage boundary must
        # not end (and re-count) a continuous episode
        self._slo_boosted: Dict[str, float] = {}  # durability: ephemeral(episode edge detector, restart starts a new episode)
        # jobs whose SLO outcome was already counted: restart_completed_job
        # can re-fold a job to completed; one job is one outcome
        self._slo_noted: set = set()  # durability: ephemeral(one-outcome-per-job memo, re-folds idempotently)
        # push job-status notifications (ISSUE 11): the server installs a
        # callback invoked on every job-status write; must never raise into
        # the write path
        self.on_job_status = None  # durability: ephemeral(callback installed by the owning server at construction)
        # best-effort live result-cache entry count (ISSUE 8): lets the
        # under-cap common case of result_cache_put skip the full prefix
        # scan (a 1024-key range read per job completion, under the global
        # lock, just to learn nothing needs evicting). Lazily seeded from
        # one scan; the at-cap eviction path re-derives it from the
        # authoritative scan, so drift (e.g. a peer scheduler's writes)
        # self-corrects exactly when it would matter. All mutation happens
        # under the global KV lock the cache paths already hold.
        self._rc_count: Optional[int] = None  # durability: derived(_ensure_rc_count)
        # -- replicated control plane (ISSUE 20) ----------------------------
        # this replica's identity. "" is the single-scheduler default: a
        # restarted singleton sees its predecessor's leases carry the same
        # (empty) replica id and reclaims them, so every pre-replication
        # restart test keeps its exact semantics.
        self.replica_id = ""  # durability: ephemeral(replica identity, assigned by the owning server)
        self.replica_addr = ""  # durability: ephemeral(advertised host:port, assigned by the owning server)
        # job -> the exact serialized JobLease WE minted (the fencing token).
        # Every job-scoped durable write CASes against this value; a mismatch
        # means a peer adopted the job and this entry drops (_deposed). The
        # durable truth is leases/{job} itself — minted atomically with the
        # planning commit, recovered by re-minting in recover()/adopt_job.
        self._owned: Dict[str, bytes] = {}  # durability: durable(leases)
        self._lease_ttl = float(self.config.scheduler_lease_ttl_s())  # durability: ephemeral(config snapshot)
        # kv.lease chaos rotation (like _chaos_puts): generation-folded so a
        # restarted scheduler draws fresh verdicts; under the kv lock
        self._lease_seq = 0  # durability: ephemeral(per-process chaos sequence)
        # fencing telemetry: stale writes rejected because a peer holds the
        # lease now. Counts REJECTIONS observed by this (deposed) replica.
        self.fence_rejected = 0  # durability: ephemeral(telemetry counter, meaningful per life)
        # jobs this replica was deposed FROM: they must not degrade to the
        # unfenced never-leased write path — every later write stays
        # rejected until adopt_job re-claims the lease for real. The
        # durable truth is leases/{job}; this only pins the local verdict.
        self._deposed_jobs: set = set()  # durability: ephemeral(local deposition memory; the lease row is the durable truth)
        # generation-stamped read-through views (ISSUE 20): the derived
        # task-index / rc-count caches were single-scheduler-fresh by
        # construction; with peers mutating the same KV they re-derive when
        # the durable epoch moves. None = never read the epoch yet.
        self._plan_epoch_seen: Optional[int] = None  # durability: derived(_ensure_task_index)
        self._rc_epoch_seen: Optional[int] = None  # durability: derived(_ensure_rc_count)

    def _key(self, *parts: str) -> str:
        return "/".join(("/ballista", self.namespace) + parts)

    # -- durable assignment ledger ------------------------------------------
    def _ledger_key(self, key: Tuple[str, int, int]) -> str:
        job_id, stage_id, partition = key
        return self._key("assignments", job_id, str(stage_id), str(partition))

    def _ledger_put(
        self, key: Tuple[str, int, int], executor_id: str, attempt: int
    ) -> None:
        """Record an in-flight assignment, write-through: memory carries the
        monotonic grace-window clock, the KV carries the restart truth."""
        self._assigned[key] = (executor_id, attempt, time.monotonic(), False)
        msg = pb.Assignment(executor_id=executor_id, attempt=attempt)
        # fenced (ISSUE 20): a rejected write means a peer adopted the job —
        # _fenced_put's deposition purge drops the entry just added above
        self._fenced_put(key[0], self._ledger_key(key), msg.SerializeToString())

    def _ledger_del(self, key: Tuple[str, int, int]) -> None:
        self._assigned.pop(key, None)
        self.kv.delete(self._ledger_key(key))

    # -- speculative-attempt ledger (ISSUE 11) ------------------------------
    def _spec_key(self, key: Tuple[str, int, int]) -> str:
        job_id, stage_id, partition = key
        return self._key("speculation", job_id, str(stage_id), str(partition))

    def _spec_put(
        self, key: Tuple[str, int, int], executor_id: str, attempt: int
    ) -> None:
        """Record an in-flight speculative duplicate, write-through like the
        assignment ledger: the KV carries the restart truth, memory the
        grace/accounting clocks."""
        self._speculative[key] = (
            executor_id, attempt, time.monotonic(), False, False,
        )
        msg = pb.Assignment(executor_id=executor_id, attempt=attempt)
        # fenced like _ledger_put: rejection purges the entry via _deposed
        self._fenced_put(key[0], self._spec_key(key), msg.SerializeToString())

    def _spec_del(self, key: Tuple[str, int, int]) -> None:
        if self._speculative.pop(key, None) is not None:
            self.kv.delete(self._spec_key(key))
        # the episode's launch budget resets with the ledger entry (a fresh
        # straggler signal may speculate again, as before ISSUE 15) — but
        # the SUPERSEDED set must outlive it: abandoned duplicates may
        # still be running, and their late reports are retired against it
        # until the task itself resolves (_spec_resolve).
        self._spec_launches.pop(key, None)

    def _spec_resolve(self, key: Tuple[str, int, int]) -> None:
        """The TASK resolved (completion accepted, requeue, or job done):
        close the whole speculation episode, superseded bookkeeping
        included. Requeues number past every minted speculative attempt
        (_spec_attempt_floor), so nothing retired here can impersonate a
        fresh attempt later."""
        self._spec_del(key)
        self._spec_superseded.pop(key, None)

    def _spec_attempt_floor(self, key: Tuple[str, int, int]) -> int:
        """Highest speculative attempt ever minted for the task (the live
        ledger entry and every superseded one): a requeue must number PAST
        it, or a late report from an abandoned duplicate could impersonate
        the fresh attempt and clobber its state."""
        spec = self._speculative.get(key)
        top = spec[1] if spec is not None else 0
        sup = self._spec_superseded.get(key)
        if sup:
            top = max(top, max(sup))
        return top

    def speculation_active(
        self, key: Tuple[str, int, int], executor_id: str, attempt: int
    ) -> bool:
        """True while (executor, attempt) is the live speculative duplicate
        of the task — the push-credit re-verification consults this (the
        duplicate has no tasks/ status of its own to vouch for it)."""
        s = self._speculative.get(key)
        return s is not None and s[0] == executor_id and s[1] == attempt

    def _notify_job_status(self, job_id: str, status: pb.JobStatus) -> None:
        """Invoke the push-status hook (ISSUE 11); a subscriber bug must
        never fail the status write it observes."""
        cb = self.on_job_status
        if cb is not None:
            try:
                cb(job_id, status)
            except Exception:
                log.debug("job-status notification failed", exc_info=True)

    # -- job-ownership leases + write fencing (ISSUE 20) --------------------
    def _lease_key(self, job_id: str) -> str:
        return self._key("leases", job_id)

    def _leasegen_key(self, job_id: str) -> str:
        return self._key("leasegen", job_id)

    def _lease_chaos(self) -> None:
        """kv.lease injection seam: the lease mint/claim op fails as if the
        store dropped the request. Keyed like kv.put on a generation-rotated
        per-process sequence (under the kv lock) so a retried mint draws a
        fresh deterministic verdict."""
        if self._chaos is not None:
            self._lease_seq += 1
            self._chaos.maybe_fail(
                "kv.lease", f"g{self.generation}/lease{self._lease_seq}"
            )

    def _mint_lease_items(self, job_id: str) -> Tuple[bytes, Tuple[str, bytes]]:
        """Next fencing generation for the job: read the durable
        `leasegen/{job}` counter and build (serialized JobLease to grant,
        the counter write that must ride the SAME atomic batch). The
        counter outlives each lease on purpose — fencing generations stay
        monotonic across any number of expiries and adoptions."""
        prior = self.kv.get(self._leasegen_key(job_id))
        fence = (int(prior) if prior else 0) + 1
        lease = pb.JobLease(
            replica_id=self.replica_id, fence=fence, addr=self.replica_addr
        )
        return (
            lease.SerializeToString(),
            (self._leasegen_key(job_id), str(fence).encode()),
        )

    def job_lease(self, job_id: str) -> Optional[pb.JobLease]:
        """The live ownership lease, or None (expired / never leased)."""
        raw = self.kv.get(self._lease_key(job_id))
        if raw is None:
            return None
        jl = pb.JobLease()
        jl.ParseFromString(raw)
        return jl

    def owns_job(self, job_id: str) -> bool:
        return job_id in self._owned

    def owned_jobs(self) -> List[str]:
        return list(self._owned)

    def renew_owned_leases(self) -> int:
        """Heartbeat: extend every owned job lease by one TTL. A renewal
        that finds the lease gone (expired, or a peer already claimed it)
        just drops — the next fenced write settles ownership truthfully.
        Returns how many leases were renewed."""
        n = 0
        for job_id in list(self._owned):
            if self.kv.lease_renew(self._lease_key(job_id), self._lease_ttl):
                n += 1
        return n

    def commit_plan_batch(self, job_id: str, items) -> None:
        """Publish a planned job's stages/tasks/running-flip atomically AND
        mint its ownership lease in the same batch (ISSUE 20): the lease is
        born with the commit marker, so there is no committed job without
        an owner and no owned job without a commit. The expect-absent CAS
        on the lease key makes two replicas racing the same job id lose
        cleanly (nothing from the loser's batch lands)."""
        lk = self._lease_key(job_id)
        self._lease_chaos()
        value, gen_item = self._mint_lease_items(job_id)
        ok = self.kv.put_all(
            list(items) + [gen_item],
            compare=(lk, None),
            leases=[(lk, value, self._lease_ttl)],
        )
        if not ok:
            raise RuntimeError(
                f"job {job_id}: planning commit lost the lease race — "
                "another replica already owns the job"
            )
        self._owned[job_id] = value
        self._bump_plan_epoch()

    def _fenced_put(self, job_id: str, key: str, value: bytes) -> bool:
        """The single job-scoped durable write seam (ISSUE 20). Owned jobs
        compare-and-swap against the remembered lease value: a mismatch
        means a peer adopted the job — this replica is DEPOSED, drops its
        ownership, and the write is REJECTED whole. An expired-but-
        unclaimed lease is lazily re-minted (fresh fencing generation) in
        the same batch: single-replica servers run no heartbeat thread, so
        their leases routinely expire mid-job and must self-heal. Jobs this
        replica never leased (hand-built test states, pre-ISSUE-20 rows)
        write straight through, exactly as before replication."""
        expected = self._owned.get(job_id)
        if expected is None:
            if job_id in self._deposed_jobs:
                return False  # deposed: never degrade to unfenced writes
            self.kv.put(key, value)
            return True
        lk = self._lease_key(job_id)
        if self.kv.put_all([(key, value)], compare=(lk, expected)):
            return True
        if self.kv.get(lk) is None:
            minted, gen_item = self._mint_lease_items(job_id)
            if self.kv.put_all(
                [(key, value), gen_item],
                compare=(lk, None),
                leases=[(lk, minted, self._lease_ttl)],
            ):
                self._owned[job_id] = minted
                _record_recovery("lease_reminted")
                return True
        self._deposed(job_id)
        return False

    def _deposed(self, job_id: str) -> None:
        """A peer's lease fenced out our write: drop ownership and every
        in-memory claim on the job. The DURABLE rows (assignment and
        speculation ledgers, statuses) now belong to the adopter — they are
        read here only to size the handoff, never deleted: the adopter's
        scoped recovery already reloaded them."""
        self._owned.pop(job_id, None)
        self._deposed_jobs.add(job_id)
        self.fence_rejected += 1
        _record_recovery("fence_rejected")
        holder = self.job_lease(job_id)
        handed_over = len(
            self.kv.get_prefix(self._key("assignments", job_id) + "/")
        ) + len(self.kv.get_prefix(self._key("speculation", job_id) + "/"))
        for key in [k for k in self._assigned if k[0] == job_id]:
            self._assigned.pop(key, None)
        for key in [k for k in self._speculative if k[0] == job_id]:
            self._speculative.pop(key, None)
            self._spec_launches.pop(key, None)
            self._spec_superseded.pop(key, None)
        for key in [k for k in self._running_since if k[0] == job_id]:
            self._running_since.pop(key, None)
        log.warning(
            "job %s: write fenced out — adopted by replica %r at %r "
            "(%d durable ledger entries handed over)",
            job_id,
            holder.replica_id if holder is not None else "?",
            holder.addr if holder is not None else "?",
            handed_over,
        )

    def adopt_job(self, job_id: str) -> bool:
        """Claim an expired job lease and run failover recovery scoped to
        the job (ISSUE 20): failover IS restart recovery run by a peer —
        the assignment/speculation ledgers reload with a fresh grace
        window, executors' running echoes re-adopt what still runs, and
        `restart_generation` stays untouched (no process died). Returns
        False when a peer won the claim race."""
        if job_id in self._owned:
            return True
        lk = self._lease_key(job_id)
        self._lease_chaos()
        minted, gen_item = self._mint_lease_items(job_id)
        if not self.kv.put_all(
            [gen_item], compare=(lk, None),
            leases=[(lk, minted, self._lease_ttl)],
        ):
            return False
        self._owned[job_id] = minted
        self._deposed_jobs.discard(job_id)
        _record_recovery("lease_adopted")
        self.recover(jobs={job_id})
        return True

    def _may_schedule(self, job_id: str) -> bool:
        """Ownership gate for the dispatch path: this replica schedules a
        job iff it holds (or can claim) the job's lease. Adopt-on-demand is
        the thread-free half of failover: any replica asked for work on a
        job whose owner's lease expired picks the job up on the spot."""
        if job_id in self._owned:
            return True
        if self.kv.get(self._lease_key(job_id)) is not None:
            return False  # a live peer owns it
        if self.kv.get(self._leasegen_key(job_id)) is None:
            return True  # never leased: legacy/hand-built state
        return self.adopt_job(job_id)

    def ensure_job_writable(self, job_id: str) -> Optional[pb.JobLease]:
        """Server admission gate: None when this replica may host work for
        the job (owned, adopted on the spot, or never leased), else the
        live FOREIGN lease carrying the owner's address to redirect to.
        Bounded retry: a foreign lease expiring between the two reads
        makes the job adoptable — loop back instead of returning a stale
        verdict either way."""
        for _ in range(3):
            if self._may_schedule(job_id):
                return None
            lease = self.job_lease(job_id)
            if lease is not None:
                return lease
        return None  # repeated expiry races: treat as writable (legacy path)

    def replica_heartbeat(self) -> None:
        """Renew (or re-grant) this replica's liveness key. The queued-
        grace sweep on PEERS reads it: a queued job whose submitting
        replica's heartbeat lapsed has no planner left to commit it."""
        if not self.replica_id:
            return
        k = self._key("replicas", self.replica_id)
        if not self.kv.lease_renew(k, self._lease_ttl):
            self.kv.lease_grant(k, self.replica_id.encode(), self._lease_ttl)

    def replica_alive(self, replica_id: str) -> bool:
        return self.kv.get(self._key("replicas", replica_id)) is not None

    def mark_job_planner(self, job_id: str) -> None:
        """Stamp queued-grace provenance on a freshly accepted submission:
        which replica owes this job its planning commit. Anonymous
        (single-replica) servers skip it — their restart recovery already
        sweeps torn queued jobs."""
        if self.replica_id:
            self.kv.put(
                self._key("planner", job_id), self.replica_id.encode()
            )

    def job_planner(self, job_id: str) -> Optional[str]:
        raw = self.kv.get(self._key("planner", job_id))
        return raw.decode() if raw is not None else None

    def _bump_plan_epoch(self) -> None:
        """Advance the durable task-set epoch (ISSUE 20): the derived task
        index used to be fresh by construction (single scheduler observes
        its own writes); with peers mutating the same namespace,
        _ensure_task_index re-seeds when the epoch it last saw moved. The
        wall-clock reseed stays as the backstop for non-epoch drift."""
        k = self._key("meta", "plan_epoch")
        prior = self.kv.get(k)
        nxt = (int(prior) if prior else 0) + 1
        self.kv.put(k, str(nxt).encode())
        self._plan_epoch_seen = nxt

    def _bump_rc_epoch(self) -> None:
        """Advance the durable result-cache epoch: peers re-derive their
        entry count (a capacity input, not truth) after any delete."""
        k = self._key("meta", "rc_epoch")
        prior = self.kv.get(k)
        nxt = (int(prior) if prior else 0) + 1
        self.kv.put(k, str(nxt).encode())
        self._rc_epoch_seen = nxt

    def _reclaim_lease(self, job_id: str, raw) -> bool:
        """Restart path: re-mint the lease a predecessor with OUR replica
        id held — CAS against its exact surviving value, or expect-absent
        when it already expired. Jobs never leased at all (pre-ISSUE-20
        rows, hand-built test states) are reclaimed as unleased legacy
        jobs. False = a peer claimed the job meanwhile."""
        lk = self._lease_key(job_id)
        if raw is None and self.kv.get(self._leasegen_key(job_id)) is None:
            return True
        minted, gen_item = self._mint_lease_items(job_id)
        if self.kv.put_all(
            [gen_item],
            compare=(lk, raw),
            leases=[(lk, minted, self._lease_ttl)],
        ):
            self._owned[job_id] = minted
            return True
        return False

    def _restore_ledger_rows(self, rows, now: float, bump) -> None:
        """Reload surviving assignment-ledger rows with a FRESH grace
        window (restart and failover share this): entries whose KV task
        status no longer matches (resolved or superseded before the owner
        died) are dropped; the rest wait for their owner's running_echo."""
        for k, v in rows:
            tail = k.rsplit("/", 3)
            key = (tail[1], int(tail[2]), int(tail[3]))
            a = pb.Assignment()
            a.ParseFromString(v)
            cur = self.get_task_status(*key)
            if (
                cur is None
                or cur.WhichOneof("status") != "running"
                or cur.attempt != a.attempt
                or cur.running.executor_id != a.executor_id
            ):
                # resolved or superseded before the crash; drop the entry
                self.kv.delete(self._ledger_key(key))
                continue
            self._assigned[key] = (a.executor_id, a.attempt, now, True)
            bump("restart_assignment_restored")

    def _restore_spec_rows(self, rows, now: float, bump) -> None:
        """Reload surviving speculation-ledger rows (ISSUE 11): a duplicate
        is valid while the primary is still RUNNING at a LOWER attempt
        (exactly attempt-1 for a single speculation; further behind after
        re-speculation, ISSUE 15) — the pair's completions then resolve
        through the normal first-completion-wins path. Anything else is a
        leftover record to sweep."""
        for k, v in rows:
            tail = k.rsplit("/", 3)
            key = (tail[1], int(tail[2]), int(tail[3]))
            a = pb.Assignment()
            a.ParseFromString(v)
            cur = self.get_task_status(*key)
            if (
                cur is None
                or cur.WhichOneof("status") != "running"
                or cur.attempt >= a.attempt
            ):
                self.kv.delete(self._spec_key(key))
                continue
            self._speculative[key] = (a.executor_id, a.attempt, now, False, True)
            # rebuild the launch bound from attempt arithmetic (the
            # superseded set died with the old process; the requeue
            # numbering floor covers its late reports regardless)
            self._spec_launches[key] = max(1, a.attempt - cur.attempt)
            _record_speculation("restored")
            bump("restart_speculation_restored")

    def recover(self, jobs=None) -> Dict[str, int]:
        """Scheduler-restart recovery — and, scoped by `jobs`, peer
        FAILOVER (ISSUE 20: adopting a dead replica's jobs runs exactly
        this, restricted to them, with no generation bump — no process
        died, the store's restart count is unchanged).

        Full mode (jobs=None), called once before serving (the caller
        holds no lock yet — nothing else can touch this state):

        - A job still QUEUED was never committed: planning publishes
          stages, tasks, and the `running` flip in ONE atomic put_all, and
          the logical plan lived only in the dead scheduler's memory — so
          the job is failed cleanly ("resubmit") instead of hanging the
          client forever. With live PEER leases in the namespace the
          queued job may be a peer's in-flight planning, so it is left
          alone — the housekeeping queued-grace sweep fails truly
          abandoned ones after a couple of lease TTLs.
        - RUNNING jobs owned by a LIVE peer lease are skipped entirely
          (theirs to run); our own surviving or expired leases are
          re-minted with a fresh fencing generation.
        - The assignment ledger reloads with a FRESH grace window: entries
          whose KV task status no longer matches are dropped; the rest
          wait for their owner's running_echo — re-adopted on the first
          vouching poll, requeued through the normal retry path if nobody
          vouches in time.

        Returns the recovery counters (also fed into ops.runtime so
        bench.py's `recovery` field picks them up). A fresh store returns
        {} without recording anything."""
        stats: Dict[str, int] = {}

        def bump(event: str) -> None:
            _record_recovery(event)
            stats[event] = stats.get(event, 0) + 1

        now = time.monotonic()
        if jobs is not None:
            # scoped failover: adopt exactly these (already re-leased) jobs
            for job_id in sorted(jobs):
                js = self.get_job_metadata(job_id)
                if js is None or js.WhichOneof("status") != "running":
                    continue
                bump("restart_job_resumed")
                self._restore_ledger_rows(
                    list(self.kv.get_prefix(self._key("assignments", job_id) + "/")),
                    now, bump,
                )
                self._restore_spec_rows(
                    list(self.kv.get_prefix(self._key("speculation", job_id) + "/")),
                    now, bump,
                )
                self._job_tenant_full(job_id)
            # adopted tasks enter this replica's (and every peer's) task
            # index through the epoch read-through, not a private reseed
            self._bump_plan_epoch()
            if stats:
                log.warning("failover adoption recovery: %s", stats)
            return stats
        job_rows = list(self.kv.get_prefix(self._key("jobs")))
        ledger = list(self.kv.get_prefix(self._key("assignments")))
        spec_ledger = list(self.kv.get_prefix(self._key("speculation")))
        if not job_rows and not ledger and not spec_ledger:
            return {}
        bump("scheduler_restart")
        gen_key = self._key("meta", "restart_generation")
        prior = self.kv.get(gen_key)
        self.generation = (int(prior) if prior else 0) + 1
        self.kv.put(gen_key, str(self.generation).encode())
        lease_rows: Dict[str, bytes] = {
            k.rsplit("/", 1)[1]: v
            for k, v in self.kv.get_prefix(self._key("leases"))
        }
        peers_alive = False
        for raw in lease_rows.values():
            jl = pb.JobLease()
            jl.ParseFromString(raw)
            if jl.replica_id != self.replica_id:
                peers_alive = True
                break
        running_jobs: List[str] = []
        foreign: set = set()
        for k, v in job_rows:
            job_id = k.rsplit("/", 1)[1]
            js = pb.JobStatus()
            js.ParseFromString(v)
            w = js.WhichOneof("status")
            if w == "queued":
                if peers_alive:
                    # plausibly a live peer's planning in flight; the
                    # housekeeping queued-grace sweep owns the verdict
                    continue
                failed = pb.JobStatus()
                failed.failed.error = (
                    "scheduler restarted before planning committed; the job "
                    "was never submitted to executors — resubmit it"
                )
                self.save_job_metadata(job_id, failed)
                self.kv.delete(self._key("settings", job_id))
                self.kv.delete(self._key("tenants", job_id))
                self.kv.delete(self._key("jobfp", job_id))
                self.kv.delete_prefix(self._key("stages", job_id) + "/")
                self.kv.delete_prefix(self._key("tasks", job_id) + "/")
                bump("torn_job_discarded")
                log.warning("discarded torn (uncommitted) job %s", job_id)
            elif w == "running":
                raw = lease_rows.get(job_id)
                if raw is not None:
                    jl = pb.JobLease()
                    jl.ParseFromString(raw)
                    if jl.replica_id != self.replica_id:
                        foreign.add(job_id)  # a live peer's job; not ours
                        continue
                if self._reclaim_lease(job_id, raw):
                    running_jobs.append(job_id)
                    bump("restart_job_resumed")
                else:
                    foreign.add(job_id)  # a peer claimed it meanwhile
        self._restore_ledger_rows(
            [(k, v) for k, v in ledger if k.rsplit("/", 3)[1] not in foreign],
            now, bump,
        )
        self._restore_spec_rows(
            [(k, v) for k, v in spec_ledger if k.rsplit("/", 3)[1] not in foreign],
            now, bump,
        )
        # warm every derived structure from KV truth before serving
        # (ISSUE 18: each derived(<rebuild-fn>) classification promises its
        # rebuild is reachable from here — the durability analyzer checks
        # that promise statically, the crash-recovery property test checks
        # it at runtime): the task index reseeds from the tasks/ scan, the
        # resumed jobs' immutable tenant records re-enter the read-through
        # cache, and the result-cache count reseeds from its authoritative
        # prefix scan instead of on the first at-cap put.
        self._ensure_task_index()
        for job_id in running_jobs:
            self._job_tenant_full(job_id)
        self._ensure_rc_count()
        if stats:
            log.warning("scheduler restart recovery: %s", stats)
        return stats

    # -- executors ----------------------------------------------------------
    def save_executor_metadata(self, meta: pb.ExecutorMetadata) -> None:
        self.kv.put(
            self._key("executors", meta.id),
            meta.SerializeToString(),
            lease_seconds=EXECUTOR_LEASE_SECS,
        )

    def get_executors_metadata(self) -> List[pb.ExecutorMetadata]:
        out = []
        for _k, v in self.kv.get_prefix(self._key("executors")):
            m = pb.ExecutorMetadata()
            m.ParseFromString(v)
            out.append(m)
        return out

    def get_executor_metadata(self, executor_id: str) -> Optional[pb.ExecutorMetadata]:
        v = self.kv.get(self._key("executors", executor_id))
        if v is None:
            return None
        m = pb.ExecutorMetadata()
        m.ParseFromString(v)
        return m

    # -- jobs -----------------------------------------------------------------
    def save_job_metadata(self, job_id: str, status: pb.JobStatus) -> bool:
        """Write the job status, fenced by the ownership lease (ISSUE 20).
        False = a peer adopted the job and the write was rejected whole;
        subscribers are only notified of writes that actually landed."""
        if not self._fenced_put(
            job_id, self._key("jobs", job_id), status.SerializeToString()
        ):
            return False
        self._notify_job_status(job_id, status)
        return True

    def get_job_metadata(self, job_id: str) -> Optional[pb.JobStatus]:
        v = self.kv.get(self._key("jobs", job_id))
        if v is None:
            return None
        s = pb.JobStatus()
        s.ParseFromString(v)
        return s

    def save_job_settings(self, job_id: str, settings: Dict[str, str]) -> None:
        """Client-supplied per-job settings, attached to every
        TaskDefinition for this job so executors honor them."""
        msg = pb.JobSettings()
        for k, v in settings.items():
            msg.settings.add(key=k, value=v)
        self.kv.put(self._key("settings", job_id), msg.SerializeToString())

    def get_job_settings(self, job_id: str) -> Dict[str, str]:
        v = self.kv.get(self._key("settings", job_id))
        if v is None:
            return {}
        msg = pb.JobSettings()
        msg.ParseFromString(v)
        return {kv.key: kv.value for kv in msg.settings}

    # -- tenancy (ISSUE 7) ----------------------------------------------------
    def save_job_tenant(
        self, job_id: str, tenant: str, priority: int,
        created_at: Optional[float] = None,
    ) -> None:
        """Durable per-job tenant record: admission quotas, fair-share
        accounting, priority ordering, and the SLO-deadline anchor
        (created_at, ISSUE 11) survive a scheduler restart."""
        created = time.time() if created_at is None else created_at
        msg = pb.JobTenant(tenant=tenant, priority=priority, created_at=created)
        self.kv.put(self._key("tenants", job_id), msg.SerializeToString())
        with self._tenant_mu:
            self._tenant_cache[job_id] = (tenant, priority, created)

    def _job_tenant_full(self, job_id: str) -> Tuple[str, int, float]:
        """(tenant, priority, created_at) of a job; ("", 0, 0.0) for
        pre-tenancy jobs. Read-through cached — the record is immutable."""
        with self._tenant_mu:
            hit = self._tenant_cache.get(job_id)
            if hit is not None:
                return hit
            if len(self._tenant_cache) > 10_000:
                # jobs are short-lived; a long-lived scheduler must not
                # accumulate every job id it ever saw
                self._tenant_cache.clear()
        v = self.kv.get(self._key("tenants", job_id))
        out = ("", 0, 0.0)
        if v is not None:
            msg = pb.JobTenant()
            msg.ParseFromString(v)
            out = (msg.tenant, msg.priority, msg.created_at)
        with self._tenant_mu:
            self._tenant_cache[job_id] = out
        return out

    def job_tenant(self, job_id: str) -> Tuple[str, int]:
        """(tenant, priority) of a job; ("", 0) for pre-tenancy jobs."""
        return self._job_tenant_full(job_id)[:2]

    def job_created_at(self, job_id: str) -> float:
        """Submission time (unix seconds; 0.0 when unknown) — the anchor
        for the per-tenant SLO deadline (ISSUE 11)."""
        return self._job_tenant_full(job_id)[2]

    def note_tenant_assigned(self, tenant: str) -> None:
        with self._tenant_mu:
            self.tenant_assigned[tenant] = self.tenant_assigned.get(tenant, 0) + 1

    def tenant_task_shares(self) -> Dict[str, int]:
        """Per-tenant totals of tasks assigned by this scheduler instance —
        the fairness denominator bench's multi-tenant scenario reports."""
        with self._tenant_mu:
            return dict(self.tenant_assigned)

    # -- plan-fingerprint result cache (ISSUE 7) ------------------------------
    def save_job_fingerprint(self, job_id: str, fingerprint: str) -> None:
        """Remember which result-cache key a job completes into (and which
        entry a lost cached result invalidates)."""
        self.kv.put(self._key("jobfp", job_id), fingerprint.encode())

    def get_job_fingerprint(self, job_id: str) -> Optional[str]:
        v = self.kv.get(self._key("jobfp", job_id))
        return v.decode() if v is not None else None

    # -- incremental execution (ISSUE 19) -------------------------------------
    def save_job_facts(
        self, job_id: str, content_key: str, facts: List[str]
    ) -> None:
        """The plan's content key + the scan-file facts its result_key was
        built over, recorded at submission so the completion-time cache put
        can stamp them onto the entry — the identity a LATER submission's
        advancement probe matches against."""
        body = "\n".join([content_key] + list(facts))
        self.kv.put(self._key("jobfacts", job_id), body.encode())

    def get_job_facts(self, job_id: str) -> Optional[Tuple[str, List[str]]]:
        v = self.kv.get(self._key("jobfacts", job_id))
        if v is None:
            return None
        lines = v.decode().split("\n")
        return lines[0], lines[1:]

    def result_cache_put(
        self, fingerprint: str, completed, job_id: Optional[str] = None
    ) -> bool:
        """Best-effort publish of a completed job's result partition
        locations under resultcache/{fingerprint}. The write passes the
        `cache.put` chaos site (keyed on the content-derived fingerprint —
        a plan coordinate, never a job id): a torn write is recorded and
        SKIPPED, never retried here — the cache is an accelerator, and the
        job completion that triggered the put stands either way. The
        size-bound eviction (ISSUE 8) runs BEFORE the insert, so the cache
        never exceeds max_entries even transiently."""
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        entry = pb.ResultCacheEntry(
            fingerprint=fingerprint, created_at=time.time()
        )
        for pl in completed.partition_location:
            entry.partition_location.add().CopyFrom(pl)
        if job_id is not None:
            # advancement identity (ISSUE 19): stamp the content key + the
            # scan-file facts recorded at submission, so a later submission
            # over a GROWN file set can find this entry as its fold base
            jf = self.get_job_facts(job_id)
            if jf is not None:
                entry.content_key = jf[0]
                entry.scan_fact.extend(jf[1])
        try:
            if self._chaos is not None:
                self._chaos.maybe_fail("cache.put", f"fp:{fingerprint[:16]}")
            self._result_cache_evict_for(fingerprint)
            key = self._key("resultcache", fingerprint)
            # an overwrite orphans the PRIOR job's result pieces: sweep
            # them once the new entry is durably in (ISSUE 16 GC), keeping
            # anything the replacement still points at
            prior = self.kv.get(key)
            self.kv.put(key, entry.SerializeToString())
            if prior is not None:
                self._gc_cached_result(
                    prior,
                    keep_uris=[
                        pl.storage_uri for pl in entry.partition_location
                    ],
                )
        except ChaosInjected:
            _record_recovery("chaos_injected")
            _record_tenancy("cache_put_torn")
            log.warning("result-cache put torn by chaos (fp=%s...)",
                        fingerprint[:16])
            return False
        _record_tenancy("cache_put")
        return True

    def _ensure_rc_count(self) -> int:
        """Seed the best-effort result-cache entry count from one
        authoritative prefix scan (idempotent; the at-cap eviction path
        re-derives it). The derived(_ensure_rc_count) rebuild recover()
        runs so a restarted replica starts with a true count instead of
        paying the seed scan on its first at-cap put.

        Generation-stamped read-through (ISSUE 20): peers deleting entries
        bump the durable rc epoch; seeing it move invalidates the cached
        count, so the next capacity check re-derives instead of trusting a
        figure a peer already made stale."""
        epoch_raw = self.kv.get(self._key("meta", "rc_epoch"))
        epoch = int(epoch_raw) if epoch_raw else 0
        if self._rc_epoch_seen is not None and epoch != self._rc_epoch_seen:
            self._rc_count = None
        self._rc_epoch_seen = epoch
        if self._rc_count is None:
            self._rc_count = len(
                self.kv.get_prefix(self._key("resultcache") + "/")
            )
        return self._rc_count

    def _result_cache_delete(self, fingerprint: str) -> None:
        """Delete one entry, keeping the best-effort count in step (and
        sweeping its storage-homed result pieces, ISSUE 16 GC)."""
        key = self._key("resultcache", fingerprint)
        self._gc_cached_result(self.kv.get(key))
        self.kv.delete(key)
        if self._rc_count is not None:
            self._rc_count = max(0, self._rc_count - 1)
        self._bump_rc_epoch()

    def _result_cache_evict_for(self, incoming_fp: str) -> int:
        """Make room for one incoming entry under the
        ballista.cache.results.max_entries bound: evict least-recently-HIT
        entries (never-hit entries rank by created_at) until the insert
        fits. The recency lives in the KV value (ResultCacheEntry.last_hit,
        refreshed on every lookup hit), so eviction order survives a
        scheduler restart. 0 = unbounded. Returns the eviction count.

        The full prefix scan runs only when the maintained count says the
        cap is actually reached; under-cap puts pay at most one extra
        kv.get (is this an overwrite?)."""
        cap = self.config.result_cache_max_entries()
        if cap <= 0:
            return 0
        incoming_key = self._key("resultcache", incoming_fp)
        self._ensure_rc_count()
        overwrite = self.kv.get(incoming_key) is not None
        if not overwrite and self._rc_count < cap:
            self._rc_count += 1  # the caller's put inserts a fresh key
            return 0
        if overwrite and self._rc_count <= cap:
            return 0  # in-place refresh; no new slot consumed
        live = []
        for k, v in self.kv.get_prefix(self._key("resultcache") + "/"):
            if k == incoming_key:
                continue  # overwrite in place; no eviction needed for it
            e = pb.ResultCacheEntry()
            try:
                e.ParseFromString(v)
            except Exception:
                self.kv.delete(k)  # unreadable entry: reclaim the slot
                continue
            live.append((e.last_hit or e.created_at, k, v))
        evicted = 0
        if len(live) >= cap:
            live.sort(key=lambda t: t[:2])
            for _recency, k, v in live[: len(live) - cap + 1]:
                # evicted entry = last reference to its storage-homed
                # result pieces (ISSUE 16 GC)
                self._gc_cached_result(v)
                self.kv.delete(k)
                evicted += 1
                _record_tenancy("cache_evicted")
        # authoritative re-derivation: surviving others + the incoming entry
        self._rc_count = (len(live) - evicted) + 1
        if evicted:
            self._bump_rc_epoch()
            log.info("result cache evicted %d entries (cap %d)", evicted, cap)
        return evicted

    def _result_cache_expired(self, entry: pb.ResultCacheEntry) -> bool:
        ttl = self.config.result_cache_ttl_s()
        return ttl > 0 and time.time() - entry.created_at > ttl

    def result_cache_lookup(self, fingerprint: str):
        """CompletedJob (cached=True) for a live entry, else None.

        Liveness: every executor referenced by the entry must still hold a
        live lease — the result partitions live in executor work dirs, so
        an entry naming a dead executor is deleted and reported as a miss
        (the lazy half of invalidation; the eager half is the
        ReportLostPartition path for leases that outlive the data)."""
        key = self._key("resultcache", fingerprint)
        v = self.kv.get(key)
        if v is None:
            _record_tenancy("cache_miss")
            return None
        entry = pb.ResultCacheEntry()
        entry.ParseFromString(v)
        if self._result_cache_expired(entry):
            # TTL bound (ISSUE 8): age is measured from creation, not last
            # hit — a hot entry over stale-but-mtime-identical data still
            # re-executes once per TTL window
            self._result_cache_delete(fingerprint)
            _record_tenancy("cache_expired")
            log.info("result-cache entry %s... expired (ttl %.0fs)",
                     fingerprint[:16], self.config.result_cache_ttl_s())
            return None
        # advanced entries (ISSUE 19) are self-contained: the folded
        # aggregate state rides the KV value itself, so no executor lease
        # (or storage mount) gates serving them
        if entry.state_ipc:
            completed = pb.CompletedJob(
                cached=True, inline_result=entry.state_ipc
            )
            entry.last_hit = time.time()
            self.kv.put(key, entry.SerializeToString())
            _record_tenancy("cache_hit")
            return completed
        # storage-homed locations (ISSUE 15) outlive their producer: only
        # locations whose pieces live in an executor work dir need the
        # owner's lease alive for the entry to stay servable
        for eid in {
            pl.executor_meta.id
            for pl in entry.partition_location
            if not pl.storage_uri
        }:
            if self.get_executor_metadata(eid) is None:
                self._result_cache_delete(fingerprint)
                _record_tenancy("cache_invalidated")
                log.info(
                    "result-cache entry %s... invalidated (executor %s gone)",
                    fingerprint[:16], eid,
                )
                return None
        completed = pb.CompletedJob(cached=True)
        for pl in entry.partition_location:
            completed.partition_location.add().CopyFrom(pl)
        # refresh LRU recency IN the KV value so the eviction order is as
        # durable as the cache itself (scheduler restarts keep it)
        entry.last_hit = time.time()
        self.kv.put(key, entry.SerializeToString())
        _record_tenancy("cache_hit")
        return completed

    def result_cache_invalidate(self, fingerprint: str) -> None:
        self._result_cache_delete(fingerprint)
        _record_tenancy("cache_invalidated")

    # -- result-cache advancement (ISSUE 19) ----------------------------------
    def result_cache_probe_advance(self, content_key: str, facts: List[str]):
        """Best advancement base for a submission whose result_key missed:
        a live same-content entry whose scan-fact set is a strict subset
        of `facts` (the file set GREW — a moved base-file identity
        disqualifies). Among candidates the one covering the most files
        wins (smallest delta). Returns the ResultCacheEntry or None.

        O(entries ≤ max_entries) scan — it runs only on a result-cache
        MISS with advancement enabled, never on the hit path."""
        from ballista_tpu_torch.scheduler.delta import new_scan_files

        best = None
        best_n = -1
        for k, v in self.kv.get_prefix(self._key("resultcache") + "/"):
            e = pb.ResultCacheEntry()
            try:
                e.ParseFromString(v)
            except Exception:
                continue
            if e.content_key != content_key or not e.scan_fact:
                continue
            if self._result_cache_expired(e):
                continue
            if new_scan_files(facts, list(e.scan_fact)) is None:
                continue
            # same liveness rule as lookup: an entry whose work-dir-homed
            # pieces lost their executor cannot be fetched as a fold base
            # (state-carrying entries are self-contained)
            if not e.state_ipc and any(
                self.get_executor_metadata(pl.executor_meta.id) is None
                for pl in e.partition_location
                if not pl.storage_uri
            ):
                continue
            if len(e.scan_fact) > best_n:
                best, best_n = e, len(e.scan_fact)
        return best

    def result_cache_put_advanced(
        self,
        result_key: str,
        content_key: str,
        facts: List[str],
        state_ipc: bytes,
        base_epoch: int,
    ) -> bool:
        """Publish an ADVANCED entry: the folded aggregate state inline
        under the grown file set's result_key. Passes the `cache.advance`
        chaos site — a torn publish is recorded and declined (the caller
        falls back to a full recompute), never retried here and never
        half-written: like cache.put, the site fires before any KV write."""
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        entry = pb.ResultCacheEntry(
            fingerprint=result_key,
            created_at=time.time(),
            content_key=content_key,
            state_ipc=state_ipc,
            advance_epoch=base_epoch + 1,
        )
        entry.scan_fact.extend(facts)
        try:
            if self._chaos is not None:
                self._chaos.maybe_fail("cache.advance", f"fp:{result_key[:16]}")
            self._result_cache_evict_for(result_key)
            key = self._key("resultcache", result_key)
            prior = self.kv.get(key)
            self.kv.put(key, entry.SerializeToString())
            if prior is not None:
                self._gc_cached_result(prior)
        except ChaosInjected:
            _record_recovery("chaos_injected")
            log.warning("result-cache advancement torn by chaos (fp=%s...)",
                        result_key[:16])
            return False
        _record_tenancy("cache_put")
        return True

    # -- shared-store GC (ISSUE 16 satellite) -------------------------------
    @staticmethod
    def _gc_piece_dir(uri: str, stage_id: int, partition: int,
                      job_id: Optional[str] = None) -> int:
        """rmtree ONE published piece-set dir — but only when the path's
        tail spells the scheduler-known plan coordinates
        (<job>/)<stage>/<partition>, the layout shuffle_output_base
        publishes under. The uri is executor-reported: the structural
        check means a report can only ever steer a delete to the piece
        home it announced at completion, never an arbitrary host path.
        Empty stage/job parents prune with it."""
        d = os.path.normpath(uri)
        tail = [str(stage_id), str(partition)]
        if job_id is not None:
            tail.insert(0, job_id)
        if d.split(os.sep)[-len(tail):] != tail or not os.path.isdir(d):
            return 0
        shutil.rmtree(d, ignore_errors=True)
        for parent in (os.path.dirname(d),
                       os.path.dirname(os.path.dirname(d))):
            try:
                os.rmdir(parent)
            except OSError:
                break
        return 1

    def _gc_shared_store_job(
        self, job_id: str, keep_final: Optional[int], tasks
    ) -> int:
        """Sweep a terminal job's storage-homed shuffle pieces — the dirs
        its own completed tasks REPORTED as their storage_uri homes, so
        per-job tier opt-ins GC without the scheduler needing the mount
        configured itself.

        Refcount view: every intermediate stage's pieces are referenced
        only by the job's own downstream tasks, so the job's terminal
        transition IS the refcount release for them — they sweep
        immediately. The FINAL stage is still referenced by the client
        fetch and (when fingerprintable) the result cache, so it stays
        behind `keep_final` until its cache entry leaves the cache
        (_gc_cached_result); never-cached finals are the ISSUE 15 TTL
        sweeper's to reclaim — it stays on as the backstop for everything
        this eager path misses. A failed job releases every stage at once
        (keep_final None), and a completed-job restart
        (restart_completed_job) recomputes swept intermediates through
        the ordinary fetch_failed lineage ladder."""
        swept = 0
        for t in tasks:
            if t.WhichOneof("status") != "completed":
                continue
            uri = t.completed.storage_uri
            stage = t.partition_id.stage_id
            if not uri or (keep_final is not None and stage == keep_final):
                continue
            swept += self._gc_piece_dir(
                uri, stage, t.partition_id.partition_id, job_id=job_id
            )
        if swept:
            _record_shuffle_tier("gc_stage_swept", swept)
            log.info(
                "shared-store GC: swept %d piece dir(s) of job %s", swept,
                job_id,
            )
        return swept

    def _gc_cached_result(self, raw, keep_uris=()) -> None:
        """A result-cache entry leaving the cache (TTL expiry, LRU
        eviction, invalidation, or overwrite by a newer same-fingerprint
        job) drops the last reference to its storage-homed final-stage
        pieces — sweep them (same structural check as above; the job
        component is unknown here, the stage/partition coordinates are
        the entry's own). `raw` is the serialized ResultCacheEntry
        (None/unparseable = nothing to do); `keep_uris` names
        storage_uris a replacing entry still references (the overwrite
        case must not sweep its successor's pieces). Work-dir-homed
        locations are untouched — executor work dirs are their owners'
        to reclaim."""
        if not raw:
            return
        entry = pb.ResultCacheEntry()
        try:
            entry.ParseFromString(raw)
        except Exception:
            return
        keep = {os.path.normpath(u) for u in keep_uris if u}
        swept = 0
        for pl in entry.partition_location:
            uri = pl.storage_uri
            if not uri or os.path.normpath(uri) in keep:
                continue
            swept += self._gc_piece_dir(
                uri, pl.partition_id.stage_id, pl.partition_id.partition_id
            )
        if swept:
            _record_shuffle_tier("gc_result_swept", swept)
            log.info(
                "shared-store GC: swept %d cached-result piece dir(s)", swept
            )

    # -- stage plans ----------------------------------------------------------
    def stage_job_plan(self, job_id: str, attempt: int = 0) -> JobPlanBatch:
        """Start an atomic planning publish for job_id (see JobPlanBatch)."""
        return JobPlanBatch(self, job_id, attempt)

    def save_stage_plan(self, job_id: str, stage_id: int, plan) -> None:
        msg = phys_plan_to_proto(plan)
        self.kv.put(
            self._key("stages", job_id, str(stage_id)), msg.SerializeToString()
        )

    def get_stage_plan(self, job_id: str, stage_id: int):
        v = self.kv.get(self._key("stages", job_id, str(stage_id)))
        if v is None:
            return None
        n = pb.PhysicalPlanNode()
        n.ParseFromString(v)
        return phys_plan_from_proto(n)

    # -- tasks ------------------------------------------------------------------
    def save_task_status(self, status: pb.TaskStatus) -> bool:
        """Write the task status, fenced by the job's ownership lease
        (ISSUE 20). False = a peer adopted the job and the write was
        rejected whole — the index observes only writes that landed (the
        watch maps were already purged by the deposition)."""
        pid = status.partition_id
        key = self._key("tasks", pid.job_id, str(pid.stage_id), str(pid.partition_id))
        # maintain the running-task watch (ISSUE 11): the straggler monitor
        # compares each entry's elapsed time against its cost prediction,
        # and completions observe their duration into the cost store
        key3 = (pid.job_id, pid.stage_id, pid.partition_id)
        if status.WhichOneof("status") == "running":
            cur = self._running_since.get(key3)
            if (
                cur is None
                or cur[0] != status.running.executor_id
                or cur[1] != status.attempt
            ):
                import heapq

                t0 = time.monotonic()
                self._running_since[key3] = (
                    status.running.executor_id, status.attempt, t0,
                )
                # elapsed-ordered straggler heap: superseded entries for
                # the same key invalidate lazily (start-time mismatch)
                heapq.heappush(self._running_heap, (t0, key3))
        else:
            self._running_since.pop(key3, None)
        if not self._fenced_put(pid.job_id, key, status.SerializeToString()):
            return False
        if self._task_index is not None:
            self._task_index.observe(status)
        return True

    def accept_task_status(self, status: pb.TaskStatus) -> bool:
        """Gate for executor-reported statuses: drop stale reports from
        attempts the scheduler already reset (a requeued task's old executor
        completing late must not clobber the retry's state), and carry the
        KV-side attempt history forward over the report (executors don't
        know it). Returns True when the status was applied."""
        if self._chaos is not None:
            # the kv.put site lives HERE (the executor-report path, not the
            # planning writes): a faulted write raises out of PollWork, the
            # executor requeues the report, and the next poll retries the
            # delivery. Keyed on a write counter because a same-key verdict
            # would fail that redelivery forever; the seeded verdict
            # SEQUENCE (which k-th report write faults) stays reproducible.
            self._chaos_puts += 1
            self._chaos.maybe_fail("kv.put", f"put{self._chaos_puts}")
        pid = status.partition_id
        key3 = (pid.job_id, pid.stage_id, pid.partition_id)
        current = self.get_task_status(pid.job_id, pid.stage_id, pid.partition_id)
        w = status.WhichOneof("status")
        spec = self._speculative.get(key3)
        if current is not None and current.WhichOneof("status") == "completed":
            # first completion wins (ISSUE 11): once any attempt's result
            # stands, every DIFFERENT later report — a speculation pair's
            # losing sibling included — is stale, whatever its attempt
            # number (the duplicate runs attempt N+1, so the numeric guard
            # below alone would let it clobber the primary's published
            # locations). A redelivery of the SAME completion (same
            # attempt, same executor) stays accepted: PollWork requeues
            # undelivered statuses after a crash, and the accept must stay
            # idempotent or the redelivery never re-enters the job-sync
            # set and the job wedges in running.
            if not (
                w == "completed"
                and status.attempt == current.attempt
                and status.completed.executor_id == current.completed.executor_id
            ):
                _record_recovery("stale_status_dropped")
                log.info(
                    "dropping late status for resolved task %s/%s/%s "
                    "(attempt %d%s; completion already stands)",
                    pid.job_id, pid.stage_id, pid.partition_id,
                    status.attempt,
                    " speculative" if status.speculative else "",
                )
                return False
        if current is not None and status.attempt < current.attempt:
            _record_recovery("stale_status_dropped")
            log.info(
                "dropping stale status for %s/%s/%s (attempt %d < %d)",
                pid.job_id, pid.stage_id, pid.partition_id,
                status.attempt, current.attempt,
            )
            return False
        sup = self._spec_superseded.get(key3)
        superseded_completion = False
        if (
            sup
            and status.attempt in sup
            and (spec is None or status.attempt != spec[1])
        ):
            # a report from an ABANDONED (re-speculated-over) duplicate
            # (ISSUE 15 satellite): its failure touches nothing — the
            # primary (and possibly a live successor duplicate) still runs
            # — while its completion is as good as anyone's (first
            # completion wins, whoever crosses the line) and falls through
            # to the normal accept below.
            sup.discard(status.attempt)
            if not sup:
                self._spec_superseded.pop(key3, None)
            if w in ("failed", "fetch_failed"):
                _record_speculation("superseded_failed")
                if w == "fetch_failed":
                    # like a live duplicate's fetch failure: the named map
                    # output is gone for EVERY future consumer — recompute
                    # it now (the reporter itself needs no requeue)
                    self._recompute_lost_map(
                        pid.job_id, status.fetch_failed,
                        self.retry_limit(pid.job_id),
                        "superseded speculative attempt",
                    )
                log.info(
                    "superseded speculative attempt %d of %s/%s/%s failed; "
                    "nothing to do", status.attempt,
                    pid.job_id, pid.stage_id, pid.partition_id,
                )
                return False
            if w == "completed":
                superseded_completion = True
                _record_speculation("superseded_won")
        if spec is not None:
            spec_exec, spec_attempt, spec_t0, _v, _r = spec
            if status.attempt == spec_attempt and w in ("failed", "fetch_failed"):
                # the DUPLICATE itself died; the primary still runs — retire
                # the speculation without touching the task (a failed
                # duplicate never consumes the task's retry budget)
                self._spec_del(key3)
                _record_speculation("failed")
                if w == "fetch_failed":
                    # the report still carries actionable lineage: the named
                    # map output is gone for EVERY future consumer. Recompute
                    # it now instead of waiting for the next consumer (the
                    # primary included) to trip on it a full failure
                    # round-trip later. The reporter itself needs no requeue
                    # — the primary still runs.
                    self._recompute_lost_map(
                        pid.job_id, status.fetch_failed,
                        self.retry_limit(pid.job_id),
                        f"speculative attempt on {spec_exec}",
                    )
                log.warning(
                    "speculative attempt %d of %s/%s/%s failed on %s; "
                    "primary continues", spec_attempt,
                    pid.job_id, pid.stage_id, pid.partition_id, spec_exec,
                )
                return False
            if w == "completed":
                # a completion resolves the race NOW; the sibling's late
                # report is dropped by the guards above
                now = time.monotonic()
                if status.attempt == spec_attempt:
                    prim = self._running_since.get(key3)
                    _record_speculation("won")
                    _record_speculation(
                        "wasted_seconds",
                        now - (prim[2] if prim is not None else spec_t0),
                    )
                elif superseded_completion:
                    # an ABANDONED duplicate crossed the line first: still
                    # a speculative WIN (the duplicate rescued the task) —
                    # the live successor's effort is what got wasted
                    _record_speculation("won")
                    _record_speculation("wasted_seconds", now - spec_t0)
                else:
                    _record_speculation("lost")
                    _record_speculation("wasted_seconds", now - spec_t0)
                self._spec_del(key3)
                log.info(
                    "speculation resolved for %s/%s/%s: %s attempt %d won",
                    pid.job_id, pid.stage_id, pid.partition_id,
                    "speculative"
                    if status.attempt == spec_attempt or superseded_completion
                    else "primary", status.attempt,
                )
        if w == "completed":
            # observe the attempt's duration under the stage's
            # job-independent task.run op — the rates the straggler monitor
            # predicts from (sibling completions warm it within one job).
            # A shared-scan batch member (ISSUE 13) instead folds into its
            # batch's stage.batch observation: its own wall time IS the
            # batch's wall time and would corrupt the solo rates the
            # evidence gate compares against.
            batched = key3 in self._batch_members
            self._note_batch_member_done(key3, clean=True)
            rs = self._running_since.get(key3)
            if not batched and rs is not None and rs[1] == status.attempt:
                self._observe_task_run(
                    pid.job_id, pid.stage_id, time.monotonic() - rs[2]
                )
        merged = pb.TaskStatus()
        merged.CopyFrom(status)
        if current is not None and current.history:
            merged.ClearField("history")
            merged.history.MergeFrom(current.history)
        if not self.save_task_status(merged):
            # fenced out (ISSUE 20): a peer adopted the job mid-report. The
            # durable ledger rows below are the ADOPTER's now — bail before
            # the deletes, and report the status as not-applied so the
            # server never folds it into job synchronization.
            return False
        if merged.WhichOneof("status") in ("completed", "failed", "fetch_failed"):
            # the assignment resolved; stop watching for orphaning
            self._ledger_del((pid.job_id, pid.stage_id, pid.partition_id))
        if merged.WhichOneof("status") == "completed":
            # an accepted completion ends the speculation episode for good:
            # superseded bookkeeping included (their late reports are
            # dropped by the completion-stands guard from here on)
            self._spec_resolve(key3)
        return True

    def _ensure_task_index(self) -> _TaskIndex:
        """Seed the per-stage task index from one full scan, then keep it
        current through save_task_status — and RE-seed at most every
        TASK_INDEX_RESEED_SECS so peer-scheduler writes (new jobs, lost-task
        resets) are discovered with bounded delay instead of never.
        Assignment additionally re-verifies the chosen task's pending state
        and every upstream status from the KV before acting on them.

        Generation-stamped read-through (ISSUE 20): peer task-set mutations
        (plan commits, failover adoptions) bump the durable plan epoch, and
        seeing it move forces a reseed NOW instead of after the wall-clock
        backstop — a replica's index lags a peer's commit by one epoch
        read, not by up to TASK_INDEX_RESEED_SECS."""
        now = time.monotonic()
        epoch_raw = self.kv.get(self._key("meta", "plan_epoch"))
        epoch = int(epoch_raw) if epoch_raw else 0
        if self._plan_epoch_seen is not None and epoch != self._plan_epoch_seen:
            self._task_index = None
        self._plan_epoch_seen = epoch
        if (
            self._task_index is None
            or now - self._task_index_seeded_at > TASK_INDEX_RESEED_SECS
        ):
            idx = _TaskIndex()
            for t in self.get_all_tasks():
                idx.observe(t)
            self._task_index = idx
            self._task_index_seeded_at = now
        return self._task_index

    def get_task_status(self, job_id: str, stage_id: int, partition: int) -> Optional[pb.TaskStatus]:
        v = self.kv.get(self._key("tasks", job_id, str(stage_id), str(partition)))
        if v is None:
            return None
        t = pb.TaskStatus()
        t.ParseFromString(v)
        return t

    def get_job_tasks(self, job_id: str) -> List[pb.TaskStatus]:
        out = []
        for _k, v in self.kv.get_prefix(self._key("tasks", job_id)):
            t = pb.TaskStatus()
            t.ParseFromString(v)
            out.append(t)
        return out

    def get_stage_tasks(self, job_id: str, stage_id: int) -> List[pb.TaskStatus]:
        # trailing "/": the bare prefix "tasks/j/2" would also match stage 20
        out = []
        for _k, v in self.kv.get_prefix(self._key("tasks", job_id, str(stage_id)) + "/"):
            t = pb.TaskStatus()
            t.ParseFromString(v)
            out.append(t)
        return out

    def get_all_tasks(self) -> List[pb.TaskStatus]:
        out = []
        for _k, v in self.kv.get_prefix(self._key("tasks")):
            t = pb.TaskStatus()
            t.ParseFromString(v)
            out.append(t)
        return out

    # -- failure recovery ---------------------------------------------------
    def retry_limit(self, job_id: str) -> int:
        """Max requeues per task: the job's own setting if the client sent
        one, else the scheduler's config default."""
        settings = self.get_job_settings(job_id)
        raw = settings.get(BALLISTA_MAX_TASK_RETRIES)
        if raw is not None:
            try:
                return max(0, int(raw))
            except ValueError:
                log.warning("job %s: bad %s=%r, using scheduler default",
                            job_id, BALLISTA_MAX_TASK_RETRIES, raw)
        return self.config.max_task_retries()

    def requeue_task(
        self, t: pb.TaskStatus, executor_id: str, error: str, limit: int,
        promote: bool = True,
    ) -> bool:
        """Put a failed/lost task back to pending for attempt N+1, recording
        attempt N (executor + error) in the history. Returns False without
        writing when the retry budget is exhausted — the caller fails the
        job with the full history instead.

        Speculation-aware (ISSUE 11): when the PRIMARY attempt dies while
        its speculative duplicate is still in flight, the duplicate IS the
        retry — it is promoted to the task's current attempt (running, on
        its executor, with the failure recorded in the history) instead of
        requeueing fresh work. A promotion consumes no retry budget: the
        duplicate was already dispatched and attempt numbering already
        advanced when it launched. Callers requeueing because the task's
        UPSTREAM locations went stale (lineage invalidation, fetch_failed)
        pass promote=False — the duplicate was bound to the same dead
        locations, so it is retired below instead of promoted into a
        doomed attempt."""
        pid0 = t.partition_id
        key3 = (pid0.job_id, pid0.stage_id, pid0.partition_id)
        # a batched member leaving its attempt (failure, loss, lineage
        # reset) dirties its batch accounting: a partial batch's wall time
        # is not a clean stage.batch observation (ISSUE 13)
        self._note_batch_member_done(key3, clean=False)
        spec = self._speculative.get(key3)
        if (
            promote
            and spec is not None
            # any LATER attempt qualifies: re-speculation (ISSUE 15) may
            # have advanced the duplicate past attempt+1
            and spec[1] > t.attempt
            and spec[0] != executor_id
            # same budget bound as a normal requeue: a task already AT its
            # final allowed attempt must fail the job, not ride promotion
            # to attempt numbers past the configured limit
            and t.attempt < limit
            and t.WhichOneof("status") in ("running", "failed", "fetch_failed")
        ):
            promoted = pb.TaskStatus()
            promoted.partition_id.CopyFrom(t.partition_id)
            promoted.attempt = spec[1]
            promoted.speculative = True
            promoted.history.MergeFrom(t.history)
            h = promoted.history.add()
            h.attempt = t.attempt
            h.executor_id = executor_id
            h.error = error
            promoted.running.executor_id = spec[0]
            if not self.save_task_status(promoted):
                # fenced out (ISSUE 20): the adopter owns the retry now —
                # leave its durable ledger rows alone and report the task
                # as handled (nothing for the caller to fail)
                return True
            self._ledger_del(key3)  # superseded primary assignment
            # the duplicate has been RUNNING since its launch, not since
            # this promotion — keep the watch clock honest (save_task_
            # status just re-stamped it with now) or its completion would
            # observe an understated duration into the task.run rates and
            # teach the monitor to over-speculate on this shape
            import heapq

            self._running_since[key3] = (spec[0], spec[1], spec[2])
            # re-stamping orphans the heap entry save_task_status just
            # pushed (start-time mismatch); push the honest clock so the
            # promoted attempt stays visible to the straggler monitor
            heapq.heappush(self._running_heap, (spec[2], key3))
            # the promoted attempt enters the normal assignment ledger:
            # its owner's next echo vouches for it, and a restart re-adopts
            # it like any in-flight assignment
            self._ledger_put(key3, spec[0], spec[1])
            self._spec_del(key3)
            _record_speculation("promoted")
            log.warning(
                "promoted speculative attempt %d of %s/%s/%s on %s "
                "(primary attempt %d lost: %s)",
                promoted.attempt, pid0.job_id, pid0.stage_id,
                pid0.partition_id, promoted.running.executor_id,
                t.attempt, error,
            )
            return True
        if t.attempt >= limit:
            # exhausted: the job fails — retire any in-flight duplicate's
            # record with it (its late report is dropped by the guards)
            if spec is not None:
                _record_speculation("failed")
            self._spec_resolve(key3)
            return False
        # any in-flight assignment of the superseded attempt is now stale;
        # clearing it here keeps the durable ledger from carrying entries a
        # restarted scheduler would have to re-validate and discard — a
        # stale speculation record included (the requeued attempt would
        # collide with the duplicate's attempt number). The fresh attempt
        # numbers PAST every speculative attempt ever minted for the task
        # (the abandoned ones included), so no late duplicate report can
        # impersonate it.
        floor = self._spec_attempt_floor(key3)
        pending = pb.TaskStatus()
        pending.partition_id.CopyFrom(t.partition_id)
        pending.attempt = max(t.attempt, floor) + 1
        pending.history.MergeFrom(t.history)
        h = pending.history.add()
        h.attempt = t.attempt
        h.executor_id = executor_id
        h.error = error
        # the fenced status write goes FIRST (ISSUE 20): a rejected write
        # means a peer adopted the job, and its restored ledger rows must
        # not be deleted by this (deposed) replica's cleanup below
        if not self.save_task_status(pending):
            return True
        self._ledger_del((pid0.job_id, pid0.stage_id, pid0.partition_id))
        if spec is not None:
            _record_speculation("failed")
        self._spec_resolve(key3)
        _record_recovery("task_retry")
        pid = t.partition_id
        log.warning(
            "requeued task %s/%s/%s for attempt %d (%s)",
            pid.job_id, pid.stage_id, pid.partition_id, pending.attempt, error,
        )
        return True

    def _fail_job(self, job_id: str, error: str) -> None:
        failed = pb.JobStatus()
        failed.failed.error = error
        self.save_job_metadata(job_id, failed)
        _record_recovery("job_failed_exhausted")
        log.error("job %s failed: %s", job_id, error)

    def get_job_stage_ids(self, job_id: str) -> List[int]:
        out = []
        for k, _v in self.kv.get_prefix(self._key("stages", job_id) + "/"):
            try:
                out.append(int(k.rsplit("/", 1)[1]))
            except ValueError:
                continue
        return out

    def _downstream_stages(self, job_id: str, lost_stages: Set[int]) -> Set[int]:
        """Stage ids whose plans read (via UnresolvedShuffle) any stage in
        lost_stages — the consumers a lost map output invalidates."""
        out: Set[int] = set()
        for sid in self.get_job_stage_ids(job_id):
            plan = self.get_stage_plan(job_id, sid)
            if plan is None:
                continue
            if any(u.stage_id in lost_stages for u in find_unresolved_shuffles(plan)):
                out.add(sid)
        return out

    def reset_lost_tasks(self) -> int:
        """Re-schedule work lost to dead executors (beyond the reference,
        which loses in-flight work permanently — SURVEY §5 'no retry').

        A task RUNNING on an executor whose lease expired goes back to
        pending; a COMPLETED task whose output lives on a dead executor also
        goes back to pending (its shuffle files are unreachable). Lineage
        pass: downstream stage tasks RUNNING against those lost locations
        are invalidated too (their in-flight fetches would only fetch_fail
        later), and the normal runnability check blocks them until the map
        partitions are recomputed. Every reset consumes one retry from the
        task's budget; a task out of budget fails the job with its full
        attempt history. Returns the number of tasks reset."""
        alive = {m.id for m in self.get_executors_metadata()}
        finished_jobs: Dict[str, bool] = {}
        limits: Dict[str, int] = {}
        # job -> stages whose COMPLETED outputs were lost (lineage roots)
        lost_outputs: Dict[str, Set[int]] = {}
        reset = 0

        def job_finished(job_id: str) -> bool:
            if job_id not in finished_jobs:
                js = self.get_job_metadata(job_id)
                finished_jobs[job_id] = js is not None and js.WhichOneof(
                    "status"
                ) in ("completed", "failed")
            return finished_jobs[job_id]

        def limit_of(job_id: str) -> int:
            if job_id not in limits:
                limits[job_id] = self.retry_limit(job_id)
            return limits[job_id]

        touch_memo: Dict[str, bool] = {}

        def may_touch(job_id: str) -> bool:
            # ownership filter (ISSUE 20): leased jobs are reset by their
            # owner — a live foreign lease means a peer's sweep covers it,
            # an expired one means adoption (not this sweep) picks it up.
            # Never-leased jobs keep the legacy single-scheduler behavior.
            if job_id in self._owned:
                return True
            if job_id not in touch_memo:
                touch_memo[job_id] = (
                    self.kv.get(self._lease_key(job_id)) is None
                    and self.kv.get(self._leasegen_key(job_id)) is None
                )
            return touch_memo[job_id]

        for t in self.get_all_tasks():
            job_id = t.partition_id.job_id
            if job_finished(job_id):
                continue  # don't resurrect finished jobs
            if not may_touch(job_id):
                continue  # a peer replica's job (ISSUE 20)
            w = t.WhichOneof("status")
            owner = None
            if w == "running":
                owner = t.running.executor_id
            elif w == "completed":
                owner = t.completed.executor_id
            if owner is None or owner in alive:
                continue
            if w == "completed" and t.completed.storage_uri:
                # disaggregated tier (ISSUE 15): the output's home is a
                # PATH in shared storage, not the dead executor — the
                # pieces are still readable, so executor death after map
                # completion is a NON-EVENT: no requeue, no lineage
                # invalidation, no task retries. (A piece that really did
                # vanish from storage surfaces later as a reader's
                # fetch_failed and recovers through lineage as usual.)
                _record_recovery("storage_home_retained")
                continue
            error = (
                f"executor {owner} lease expired while the task ran"
                if w == "running"
                else f"completed shuffle output lost with executor {owner}"
            )
            if not self.requeue_task(t, owner, error, limit_of(job_id)):
                exhausted = pb.TaskStatus()
                exhausted.CopyFrom(t)
                exhausted.failed.error = error
                exhausted.failed.executor_id = owner
                self._fail_job(job_id, _attempts_error(exhausted))
                finished_jobs[job_id] = True
                continue
            _record_recovery("lost_task_reset")
            reset += 1
            if w == "completed":
                lost_outputs.setdefault(job_id, set()).add(t.partition_id.stage_id)

        # lineage invalidation: running consumers of the lost outputs
        for job_id, stages in lost_outputs.items():
            for sid in self._downstream_stages(job_id, stages):
                # an exhausted requeue below fails the job; stop touching
                # its remaining stages/tasks (a failed job must not keep
                # accumulating fresh pending work)
                if job_finished(job_id):
                    break
                for t in self.get_stage_tasks(job_id, sid):
                    if t.WhichOneof("status") != "running":
                        continue
                    error = (
                        f"upstream shuffle locations of stage(s) "
                        f"{sorted(stages)} lost mid-run"
                    )
                    if not self.requeue_task(
                        t, t.running.executor_id, error, limit_of(job_id),
                        # the task's upstream bindings are what died — a
                        # speculative duplicate carries the same dead
                        # locations and must not be promoted into them
                        promote=False,
                    ):
                        exhausted = pb.TaskStatus()
                        exhausted.CopyFrom(t)
                        exhausted.failed.error = error
                        exhausted.failed.executor_id = t.running.executor_id
                        self._fail_job(job_id, _attempts_error(exhausted))
                        finished_jobs[job_id] = True
                        break
                    _record_recovery("downstream_invalidated")
                    reset += 1
        # prune watch entries of finished jobs (ISSUE 11): a job that
        # failed with tasks still marked running would otherwise pin its
        # entries (and any speculation records) forever
        for key in list(self._running_since):
            if job_finished(key[0]):
                self._running_since.pop(key, None)
        for key in list(self._speculative):
            if job_finished(key[0]):
                self._spec_resolve(key)
        for key in list(self._spec_superseded):
            if job_finished(key[0]):
                self._spec_superseded.pop(key, None)
        for key in list(self._batch_members):
            if job_finished(key[0]):
                self._note_batch_member_done(key, clean=False)
        return reset

    def handle_fetch_failed(self, t: pb.TaskStatus, limit: int) -> bool:
        """Lineage-based recovery for one fetch_failed report: requeue the
        reporting (reduce) task AND recompute the named lost map partition,
        instead of failing the job. Returns False when the reporter's retry
        budget is exhausted (caller fails the job)."""
        ff = t.fetch_failed
        pid = t.partition_id
        _record_recovery("fetch_failed")
        reporter_error = (
            f"fetch_failed: shuffle output {ff.map_executor_id}:{ff.path} "
            f"(map {ff.map_stage_id}/{ff.map_partition_id}) unreachable: {ff.error}"
        )
        # promote=False: the reporter's duplicate (if any) was bound to the
        # same lost shuffle location — retire it rather than promote it
        # into a fetch that is known to fail
        if not self.requeue_task(
            t, ff.executor_id, reporter_error, limit, promote=False
        ):
            return False
        self._recompute_lost_map(pid.job_id, ff, limit, ff.executor_id)
        return True

    def _recompute_lost_map(self, job_id: str, ff, limit: int,
                            reporter: str) -> None:
        """Recompute ONLY the named lost map partition — and only if its
        current completed output is the one reported lost (a concurrent
        reset or recompute may already have moved it). Shared by the
        primary fetch_failed path and the speculative-duplicate report
        (ISSUE 11), so the recompute rule cannot silently diverge. When
        the map partition is out of budget its data is gone for good: the
        consumers' retries will exhaust and fail the job with the full
        lineage in the error."""
        mt = self.get_task_status(job_id, ff.map_stage_id, ff.map_partition_id)
        if (
            mt is not None
            and mt.WhichOneof("status") == "completed"
            and mt.completed.executor_id == ff.map_executor_id
        ):
            if self.requeue_task(
                mt,
                ff.map_executor_id,
                f"shuffle output lost (fetch_failed reported by {reporter})",
                limit,
            ):
                _record_recovery("map_recomputed")

    def restart_completed_job(self, job_id: str, executor_id: str) -> int:
        """Restart a job whose result partitions died with their executor
        before the client fetched them (PR 5 residue): the client reports
        the lost location (ReportLostPartition) and the final-stage tasks
        completed on that executor requeue through the normal retry/lineage
        machinery — upstream outputs lost with the same executor recover
        via the fetch_failed path when the re-run fetches them. For a
        COMPLETED job the status flips back to running so the client's
        GetJobStatus poll waits for the fresh locations; a job still
        RUNNING (ISSUE 8: a streaming client fetches partial_location
        entries mid-job, and one died) requeues the named tasks the same
        way — without it the dead location would be republished on every
        status fold until the lease machinery caught up, and the streaming
        client would spin on it. Each restart consumes retry budget;
        exhaustion fails the job (the client gets an error instead of an
        eternal fetch loop). Returns the number of restarted tasks; 0
        declines the report (job terminal-failed/queued, or nothing on
        that executor — e.g. a concurrent restart already moved the
        partitions)."""
        js = self.get_job_metadata(job_id)
        if js is None or js.WhichOneof("status") not in ("completed", "running"):
            return 0
        was_completed = js.WhichOneof("status") == "completed"
        tasks = self.get_job_tasks(job_id)
        if not tasks:
            return 0
        final_stage = max(t.partition_id.stage_id for t in tasks)
        limit = self.retry_limit(job_id)
        restarted = 0
        for t in tasks:
            if (
                t.partition_id.stage_id != final_stage
                or t.WhichOneof("status") != "completed"
                or t.completed.executor_id != executor_id
            ):
                continue
            error = (
                f"result partition lost with executor {executor_id} "
                "before the client fetched it"
            )
            if not self.requeue_task(t, executor_id, error, limit):
                exhausted = pb.TaskStatus()
                exhausted.CopyFrom(t)
                exhausted.failed.error = error
                exhausted.failed.executor_id = executor_id
                self._fail_job(job_id, _attempts_error(exhausted))
                return restarted
            _record_recovery("result_partition_restarted")
            restarted += 1
        if restarted and was_completed:
            running = pb.JobStatus()
            running.running.SetInParent()
            self.save_job_metadata(job_id, running)
            _record_recovery("completed_job_restarted")
        if restarted:
            log.warning(
                "restarting job %s: %d result partition(s) lost with "
                "executor %s", job_id, restarted, executor_id,
            )
        return restarted

    # -- scheduling ---------------------------------------------------------
    def _bound_stage_plan(self, job_id: str, stage_id: int, idx: _TaskIndex):
        """The stage plan with upstream shuffle locations bound, or None
        while any upstream stage is incomplete (or the plan is missing).
        Factored out of assign_next_schedulable_task so speculative
        duplicates (ISSUE 11) bind EXACTLY like first attempts."""
        plan = self.get_stage_plan(job_id, stage_id)
        if plan is None:
            return None
        unresolved = find_unresolved_shuffles(plan)
        locations: Dict[int, List[ShuffleLocation]] = {}
        for u in unresolved:
            # O(1) screen: stages the index knows are incomplete skip
            # the KV read entirely (staleness toward "peer completed
            # it" is bounded by the periodic reseed)
            if not idx.stage_done(job_id, u.stage_id):
                return None
            # the locations are built from FRESH KV statuses with a
            # final completeness check — a peer's lost-task reset
            # (completed -> pending, unseen by this index) must block
            # the stage, not hand out empty executor/path locations
            upstream = self.get_stage_tasks(job_id, u.stage_id)
            for t in upstream:
                idx.observe(t)
            if not upstream or any(
                t.WhichOneof("status") != "completed" for t in upstream
            ):
                return None
            locs = []
            for t in sorted(upstream, key=lambda t: t.partition_id.partition_id):
                meta = self.get_executor_metadata(t.completed.executor_id)
                host, port = (meta.host, meta.port) if meta else ("", 0)
                locs.append(
                    ShuffleLocation(
                        t.completed.executor_id,
                        host,
                        port,
                        t.completed.path,
                        stage_id=u.stage_id,
                        map_partition=t.partition_id.partition_id,
                        # shared tier (ISSUE 15): a storage-homed piece set
                        # binds even when its producer's lease lapsed —
                        # readers resolve it from the mount (host/port stay
                        # the fallback transport while the producer lives)
                        storage_uri=t.completed.storage_uri,
                        # HBM-resident exchange hint + size (ISSUE 16):
                        # advisory — a consumer landing elsewhere (or after
                        # eviction) just walks the ordinary piece ladder
                        resident=t.completed.resident,
                        nbytes=t.completed.stats.num_bytes,
                    )
                )
            locations[u.stage_id] = locs
        return remove_unresolved_shuffles(plan, locations) if unresolved else plan

    def _locality_partition_order(
        self, bound, parts, executor_id: str
    ) -> Tuple[list, Set]:
        """Visit order for a chosen stage's pending partitions, preferring
        partitions whose HBM-resident shuffle inputs live on THIS executor
        (ISSUE 16). Strictly a reorder WITHIN the stage the fair-share /
        SLO / blacklist machinery already chose — tenant order, quota, and
        the per-task executor blacklist all apply before and after exactly
        as without residency. The preference is cost-model-sized: each
        resident input contributes its predicted readback+re-upload saving
        (exchange.predicted_transfer_saving_s over the producer-reported
        piece bytes), so a partition backed by large resident pieces beats
        one backed by crumbs. Only identity readers differentiate
        partitions (consumer p reads exactly map output p); a hash reader
        consumes a slice of EVERY map output, so its saving is uniform
        across partitions and cannot reorder anything. Ties (and the
        no-residency case) keep the deterministic sorted-by-str order the
        fair-share identity tests pin. Returns (ordered partitions, the
        set with a positive predicted saving on this executor)."""
        saving: Dict[object, float] = {}
        stack = [bound]
        while stack:
            node = stack.pop()
            if isinstance(node, ShuffleReaderExec) and node.identity:
                from ballista_tpu_torch.ops import exchange

                for p in parts:
                    if not isinstance(p, int) or p >= len(node.locations):
                        continue
                    loc = node.locations[p]
                    if loc.resident and loc.executor_id == executor_id:
                        saving[p] = saving.get(p, 0.0) + (
                            exchange.predicted_transfer_saving_s(loc.nbytes)
                        )
            # getattr: scheduler tests bind stub plans with no tree API —
            # no residency signal there means no reorder, by construction
            stack.extend(getattr(node, "children", list)())
        base = sorted(parts, key=str)
        preferred = {p for p, s in saving.items() if s > 0.0}
        if not preferred:
            return base, preferred
        return sorted(base, key=lambda p: -saving.get(p, 0.0)), preferred

    # -- speculative execution (ISSUE 11) -----------------------------------
    def _task_run_op(self, job_id: str, stage_id: int) -> str:
        """Job-independent cost-store op for this stage's task durations:
        sha1 of the stage plan's display with the job id scrubbed, so
        repeated queries of the same shape share one rate across jobs (and
        sibling tasks within one job warm it past MIN_OBSERVATIONS)."""
        k = (job_id, stage_id)
        op = self._task_op_cache.get(k)
        if op is None:
            from ballista_tpu_torch.ops import costmodel

            plan = self.get_stage_plan(job_id, stage_id)
            shape = (
                plan.display_indent() if plan is not None else f"s{stage_id}"
            ).replace(job_id, "")
            op = costmodel.task_run_op(shape)
            if len(self._task_op_cache) > 10_000:
                self._task_op_cache.clear()
            self._task_op_cache[k] = op
        return op

    def _observe_task_run(self, job_id: str, stage_id: int, seconds: float) -> None:
        from ballista_tpu_torch.ops import costmodel

        op = self._task_run_op(job_id, stage_id)
        s_, n_ = self._task_rates.get(op, (0.0, 0))
        if n_ >= 32:  # forget like the store: follow the current cluster
            s_, n_ = s_ / 2.0, n_ // 2
        if len(self._task_rates) > 10_000:
            self._task_rates.clear()
        self._task_rates[op] = (s_ + seconds, n_ + 1)
        costmodel.observe(op, 1.0, seconds, engine="task")

    def _predict_task_run(self, job_id: str, stage_id: int) -> Optional[float]:
        """Predicted seconds for one task of this stage shape: the
        scheduler-owned rates first (immune to cost-store rebinds), the
        cost store as fallback (a restarted scheduler reloads persisted
        rates before re-learning its own)."""
        from ballista_tpu_torch.ops import costmodel

        op = self._task_run_op(job_id, stage_id)
        local = self._task_rates.get(op)
        if local is not None and local[1] >= costmodel.MIN_OBSERVATIONS:
            return local[0] / local[1]
        return costmodel.predict(op, 1.0, engine="task")

    def has_running_tasks(self) -> bool:
        """True while any task is RUNNING in a live job — the autoscaler's
        idle check (a drain must never start under in-flight work it can
        see coming). Caller holds the global KV lock, like every index
        consumer."""
        idx = self._ensure_task_index()
        return any(parts for parts in idx.running.values())

    def predicted_backlog_seconds(self) -> float:
        """Cost-model-predicted seconds of PENDING work across live jobs —
        the autoscaling signal (ISSUE 15): the same task.run rates the
        straggler monitor predicts from, summed over every pending task of
        every non-terminal job. Stages the model has never observed count a
        small cold prior each (a deep cold queue still registers as
        backlog; the prior is deliberately below any task worth scaling
        for, so an idle-ish cluster never grows on priors alone). Caller
        holds the global KV lock, like every index consumer."""
        idx = self._ensure_task_index()
        job_live: Dict[str, bool] = {}
        total = 0.0
        for (job_id, stage_id), parts in list(idx.pending.items()):
            if not parts:
                continue
            if job_id not in job_live:
                js = self.get_job_metadata(job_id)
                job_live[job_id] = js is not None and js.WhichOneof(
                    "status"
                ) == "running"
            if not job_live[job_id]:
                continue
            pred = self._predict_task_run(job_id, stage_id)
            total += (
                pred if pred is not None else BACKLOG_COLD_TASK_SECONDS
            ) * len(parts)
        return total

    def _straggler_candidates(
        self, now: float
    ) -> List[Tuple[str, int, int]]:
        """Running-task keys past the speculation floor, MOST-ELAPSED
        first, from the elapsed-ordered heap (ISSUE 13 satellite, PR 11
        residue: the monitor used to linearly scan EVERY running task under
        the global KV lock on each idle slot). The watch map is the
        authority: a heap entry for a resolved task drops on sight, and an
        entry whose start time disagrees with the map (superseded attempt,
        or a re-stamped clock) RECONCILES in place — replaced with the
        map's time so it re-sorts correctly. Because the heap orders by
        start time, the walk stops at the first entry younger than the
        floor — the common idle-slot case (every running task young) does
        O(1) work instead of a 10k-entry sweep. Floor-passing entries pop
        and re-push, so the heap stays consistent for the next slot.

        INVARIANT the early exit relies on: every watch-map entry has at
        least one heap entry carrying its EXACT clock — save_task_status
        pushes at stamp time and the promotion re-stamp pushes the
        corrected clock, so code that rewrites a watch clock directly must
        push the corrected entry too (the reconcile above only repairs
        entries the walk reaches before the break).
        tests/test_speculation.py asserts the heap and a linear scan
        agree."""
        import heapq

        heap = self._running_heap
        if len(heap) > 4 * len(self._running_since) + 64:
            # compact: superseded-attempt entries accumulate on busy
            # schedulers; rebuild from the authoritative watch map
            heap = self._running_heap = [
                (e[2], k) for k, e in self._running_since.items()
            ]
            heapq.heapify(heap)
        out: List[Tuple[str, int, int]] = []
        seen: set = set()
        popped: List[Tuple[float, Tuple[str, int, int]]] = []
        while heap:
            t0, key = heap[0]
            cur = self._running_since.get(key)
            if cur is None or key in seen:
                heapq.heappop(heap)  # resolved, or a duplicate entry
                continue
            if cur[2] != t0:
                # reconcile to the authoritative clock and re-sort
                heapq.heapreplace(heap, (cur[2], key))
                continue
            if now - t0 < self._spec_floor_s:
                break  # t0-ordered: everything below is younger still
            heapq.heappop(heap)
            seen.add(key)
            popped.append((t0, key))
            out.append(key)
        for item in popped:
            heapq.heappush(heap, item)
        return out

    # -- shared-scan batching (ISSUE 13) ------------------------------------
    def _note_batch_member_done(self, key3: Tuple[str, int, int],
                                clean: bool) -> None:
        """Fold one member's outcome into its batch's accounting. When the
        LAST member completes cleanly, the batch's wall duration lands in
        the cost store as a `stage.batch` observation (units = member
        count) and the decision is recorded against the formation-time
        prediction — the evidence form_shared_batch's gate consults. A
        member failing or requeueing dirties the batch: a partial batch's
        wall time is not a batch cost."""
        bid = self._batch_members.pop(key3, None)
        if bid is None:
            return
        b = self._batches.get(bid)
        if b is None:
            return
        b["remaining"].discard(key3)
        if not clean:
            b["dirty"] = True
        if b["remaining"]:
            return
        del self._batches[bid]
        if b["dirty"]:
            _record_routing("batch", "stage.batch")
            return
        wall = time.monotonic() - b["t0"]
        from ballista_tpu_torch.ops import costmodel

        costmodel.observe("stage.batch", float(b["k"]), wall, engine="task")
        _record_routing("batch", "stage.batch", b["predicted"], wall)

    def _shared_scan_signature(self, plan) -> Optional[tuple]:
        """Cheap scan-sharing signature of one bound stage plan: non-None
        for a fused-aggregate-shaped stage over a file-backed scan, keyed
        on (scan type, file list, merge coverage, scan partition count) —
        two stages with equal signatures dispatched for the same partition
        read the same rows. A HEURISTIC only: the executor re-derives
        compatibility authoritatively (mtimes, dtypes, dictionaries,
        cardinality) and degrades mismatches to solo execution, so a false
        positive here costs a little batching overhead, never a wrong
        answer."""
        from ballista_tpu_torch.ops.sharedscan import _find_aggregate
        from ballista_tpu_torch.physical.basic import (
            CoalesceBatchesExec,
            FilterExec,
            MergeExec,
            ProjectionExec,
        )
        from ballista_tpu_torch.physical.scan import CsvScanExec, ParquetScanExec

        # the ONE spine walk (ops/sharedscan.py): the executor's
        # authoritative compatibility check and this heuristic must find
        # the same aggregate or batches silently stop grouping
        node = _find_aggregate(plan)
        if node is None:
            return None
        n = node.input
        merged = False
        while isinstance(n, (FilterExec, ProjectionExec, CoalesceBatchesExec,
                             MergeExec)):
            merged = merged or isinstance(n, MergeExec)
            n = n.input
        if not isinstance(n, (ParquetScanExec, CsvScanExec)):
            return None
        files = tuple(getattr(n.source, "files", ()) or ())
        if not files:
            return None
        return (
            type(n).__name__, files, merged,
            n.output_partitioning().partition_count(),
        )

    def _cached_stage_signature(self, job_id: str, stage_id: int):
        """Scan-sharing signature of a PLANNED stage, computed once per
        (job, stage) from the stored stage plan — leaf fused-aggregate
        stages read no shuffles, so the raw plan and the bound plan carry
        the same signature. None = not batchable (cached too)."""
        k = (job_id, stage_id)
        if k in self._shared_sig_cache:
            return self._shared_sig_cache[k]
        try:
            plan = self.get_stage_plan(job_id, stage_id)
            sig = None if plan is None else self._shared_scan_signature(plan)
        except Exception:
            sig = None
        if len(self._shared_sig_cache) > 10_000:
            self._shared_sig_cache.clear()
        self._shared_sig_cache[k] = sig
        return sig

    def form_shared_batch(
        self, primary: pb.TaskStatus, plan, executor_id: str
    ) -> List[Tuple[pb.TaskStatus, object]]:
        """Scan-sharing pass (ISSUE 13): after `primary` was assigned, pull
        OTHER jobs' co-pending compatible stage tasks for the SAME
        partition into one batched dispatch. Each sibling flips to Running
        through the exact assignment machinery (status write, durable
        ledger entry, tenant accounting), so every recovery path — orphan
        reconciliation, lease expiry, scheduler restart — sees N ordinary
        in-flight tasks. Returns the (status, bound plan) siblings to ride
        the primary's TaskDefinition; [] dispatches solo.

        Evidence gate: with warm `stage.batch` rates AND solo task.run
        predictions for every member, a batch predicted no faster than the
        members' solo sum dispatches solo (recorded, never silent). Cold
        models batch optimistically — the batch is bit-identical to solo
        by construction, so the only risk is time, which the observation
        then measures. The `scheduler.batch` chaos site tears formation
        BEFORE any sibling is flipped: a torn formation degrades to solo
        dispatch with nothing written. Never raises; any failure degrades
        to solo."""
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        if not self._shared_scan:
            return []
        pid = primary.partition_id
        sig = self._cached_stage_signature(pid.job_id, pid.stage_id)
        if sig is None:
            return []
        partition = pid.partition_id
        idx = self._ensure_task_index()
        if len(self._batch_members) > 100_000:
            # safety valve for a leak (normal resolution + the finished-job
            # prune keep this at the in-flight batched count). Clearing
            # mid-flight members means their completions observe their
            # batch wall time into the SOLO task.run rates — a one-time
            # pollution the store's forgetting/retier self-heals — so the
            # bound sits far above any real in-flight population and the
            # drop is counted, never silent.
            _record_routing("batch", "stage.batch.accounting_dropped")
            log.warning(
                "shared-scan batch accounting overflowed (%d members); "
                "dropped — solo task.run rates may be briefly polluted",
                len(self._batch_members),
            )
            self._batch_members.clear()
            self._batches.clear()
        job_live: Dict[str, bool] = {}
        alive_others = {
            m.id for m in self.get_executors_metadata()
        } - {executor_id}
        candidates: List[Tuple[str, int, object]] = []
        # weighted fair-share sibling ordering (ISSUE 14 satellite, PR 13
        # residue): candidates are visited lightest-tenant-first by the
        # SAME smallest in_flight/weight key assign_next_schedulable_task
        # uses, re-ranked as this batch claims slots — one heavy tenant
        # can no longer fill every sibling slot of a shared batch while a
        # lighter tenant has co-pending compatible work. Untenanted
        # deployments (one "" tenant) reduce to a stable (job, stage)
        # order. The same running+claimed counts enforce the in-flight
        # quota, so a whole batch can never claim past the bound.
        weights = self._tenant_weights
        rank_inflight = self._tenant_inflight(idx)
        remaining = [
            (key, parts) for key, parts in idx.pending.items()
            if key[0] != pid.job_id and partition in parts
        ]

        def fair_key(item):
            (job_id, stage_id), _parts = item
            tenant = self.job_tenant(job_id)[0]
            return (
                rank_inflight.get(tenant, 0) / weights.get(tenant, 1),
                tenant, job_id, str(stage_id),
            )

        while remaining and len(candidates) < self._shared_max_batch - 1:
            remaining.sort(key=fair_key)
            (job_id, stage_id), parts = remaining.pop(0)
            if job_id not in job_live:
                js = self.get_job_metadata(job_id)
                job_live[job_id] = js is not None and js.WhichOneof(
                    "status"
                ) == "running"
            if not job_live[job_id]:
                continue
            tenant = self.job_tenant(job_id)[0]
            if self._tenant_quota > 0 and \
                    rank_inflight.get(tenant, 0) >= self._tenant_quota:
                continue
            # cheap screen first: the cached per-(job, stage) signature —
            # only a MATCH pays the plan bind (which the dispatched
            # sibling TaskDefinition needs anyway)
            if self._cached_stage_signature(job_id, stage_id) != sig:
                continue
            try:
                bound = self._bound_stage_plan(job_id, stage_id, idx)
                if bound is None:
                    continue
            except Exception:
                continue
            candidates.append((job_id, stage_id, bound))
            rank_inflight[tenant] = rank_inflight.get(tenant, 0) + 1
        if not candidates:
            return []
        # evidence gate (cost model, ISSUE 13): predicted batch wall vs the
        # members' predicted solo sum — both under engine "task" beside the
        # straggler monitor's rates
        from ballista_tpu_torch.ops import costmodel

        k = len(candidates) + 1
        predicted = costmodel.predict("stage.batch", float(k), engine="task")
        solo = [self._predict_task_run(pid.job_id, pid.stage_id)] + [
            self._predict_task_run(j, s) for j, s, _b in candidates
        ]
        if predicted is not None and all(s is not None for s in solo):
            if predicted >= sum(solo):
                _record_shared_scan("batch_gate_solo")
                _record_routing("solo", "stage.batch")
                log.info(
                    "shared-scan gate: batch of %d predicted %.4fs >= solo "
                    "sum %.4fs; dispatching solo", k, predicted, sum(solo),
                )
                return []
        if self._chaos is not None:
            self._batch_seq += 1
            try:
                self._chaos.maybe_fail(
                    "scheduler.batch",
                    f"g{self.generation}/batch{self._batch_seq}",
                )
            except ChaosInjected:
                # torn BEFORE any write: the primary dispatches solo and
                # the would-be siblings stay pending for the next slot
                _record_shared_scan("batch_chaos_solo")
                log.warning(
                    "chaos[scheduler.batch]: batch formation torn; "
                    "dispatching %s/%s/%s solo",
                    pid.job_id, pid.stage_id, partition,
                )
                return []
        out: List[Tuple[pb.TaskStatus, object]] = []
        keys = [(pid.job_id, pid.stage_id, partition)]
        for job_id, stage_id, bound in candidates:
            # re-verify from the KV before claiming, exactly like
            # assignment (the index is local; a peer may have moved on)
            current = self.get_task_status(job_id, stage_id, partition)
            if current is None or current.WhichOneof("status") is not None:
                if current is not None:
                    idx.observe(current)
                continue
            if (
                current.history
                and current.history[-1].executor_id == executor_id
                and alive_others
            ):
                continue  # blacklist: this executor failed its last attempt
            running = pb.TaskStatus()
            running.CopyFrom(current)  # keep attempt + history
            running.running.executor_id = executor_id
            if not self.save_task_status(running):
                continue  # fenced out: a peer adopted the sibling's job
            self._ledger_put(
                (job_id, stage_id, partition), executor_id, running.attempt
            )
            self.note_tenant_assigned(self.job_tenant(job_id)[0])
            keys.append((job_id, stage_id, partition))
            out.append((running, bound))
        if not out:
            return []
        bid = self._batch_next_id
        self._batch_next_id += 1
        k = len(out) + 1
        self._batches[bid] = {
            "k": k,
            "t0": time.monotonic(),
            "remaining": set(keys),
            "predicted": costmodel.predict(
                "stage.batch", float(k), engine="task"
            ),
            "dirty": False,
        }
        for key in keys:
            self._batch_members[key] = bid
        _record_shared_scan("batches_formed")
        _record_shared_scan("batched_stages", k)
        log.info(
            "shared-scan batch %d: %d stages over one scan -> %s "
            "(primary %s/%s/%s)", bid, k, executor_id,
            pid.job_id, pid.stage_id, partition,
        )
        return out

    def maybe_speculate(
        self, executor_id: str
    ) -> Optional[Tuple[pb.TaskStatus, object]]:
        """Cost-model straggler detection (ISSUE 11): pick ONE running task
        whose elapsed time grossly exceeds its task.run prediction (slack
        multiplier x predicted, past the minimum-runtime floor) and whose
        owner is NOT `executor_id`, and hand back a speculative duplicate
        (attempt N+1) for dispatch to this executor — recorded in the
        durable speculation ledger, never in the task's own status (the
        primary stays the current attempt; first completion wins). Returns
        (status, bound plan) like assign_next_schedulable_task, or None.

        Never speculates twice on one task, never on an executor that
        failed a previous attempt of it, and never while the model has no
        prediction (a cold store reproduces pre-speculation scheduling
        exactly — which is also why fault-free runs with the default floor
        launch nothing)."""
        if not self._spec_enabled or not self._running_since:
            return None
        now = time.monotonic()
        if self._speculative:
            # sweep: a duplicate whose executor's lease lapsed is dead
            # weight — the primary still runs, so just drop the record
            alive = {m.id for m in self.get_executors_metadata()}
            for k, entry in list(self._speculative.items()):
                if entry[0] not in alive:
                    self._spec_del(k)
                    _record_speculation("executor_lost")
        job_live: Dict[str, bool] = {}
        inflight: Optional[Dict[str, int]] = None
        for key3 in self._straggler_candidates(now):
            entry = self._running_since.get(key3)
            if entry is None:
                continue
            owner, attempt, t0 = entry
            if owner == executor_id:
                continue
            spec = self._speculative.get(key3)
            if spec is not None:
                # re-speculation (ISSUE 15 satellite, PR 11 residue): the
                # live duplicate may ITSELF straggle past the same
                # cost-model threshold (floor included — its own clock,
                # not the primary's). Bounded by speculation.max_attempts
                # launches per episode; the straggler is superseded in the
                # ledger, its late reports retired via _spec_superseded.
                if spec[0] == executor_id:
                    continue
                if self._spec_launches.get(key3, 1) >= self._spec_max:
                    continue
                if now - spec[2] < self._spec_floor_s:
                    continue
            if key3 in self._batch_members:
                # a shared-scan batch member (ISSUE 13) is co-scheduled
                # with its siblings: its wall time is the BATCH's, not a
                # straggler signal against its solo task.run rate —
                # duplicating it would re-run work the batch is already
                # finishing (real batch loss is covered by the normal
                # lease/orphan machinery)
                continue
            # the straggler under judgment: the primary on a first
            # speculation, the LIVE DUPLICATE on a re-speculation
            elapsed = now - (t0 if spec is None else spec[2])
            pred = self._predict_task_run(key3[0], key3[1])
            if pred is None or elapsed <= self._spec_multiplier * max(pred, 1e-6):
                continue
            job_id, stage_id, partition = key3
            if job_id not in job_live:
                js = self.get_job_metadata(job_id)
                job_live[job_id] = (
                    js is not None and js.WhichOneof("status") == "running"
                )
            if not job_live[job_id]:
                continue
            if self._tenant_quota > 0:
                # the rescue must not grant a saturated tenant an extra
                # physical slot past its max_inflight bound (the duplicate
                # writes no tasks/ status, so it is invisible to the
                # in-flight accounting — gate on the primaries' count)
                tenant = self.job_tenant(job_id)[0]
                if inflight is None:
                    inflight = self._tenant_inflight(self._ensure_task_index())
                if inflight.get(tenant, 0) >= self._tenant_quota:
                    _record_tenancy("speculate_quota_deferred")
                    continue
            # re-verify from the KV before dispatching: the watch map is
            # in-memory and a peer (or a racing status) may have moved on
            cur = self.get_task_status(*key3)
            if (
                cur is None
                or cur.WhichOneof("status") != "running"
                or cur.attempt != attempt
                or cur.running.executor_id != owner
            ):
                self._running_since.pop(key3, None)
                continue
            if any(h.executor_id == executor_id for h in cur.history):
                # this executor already failed an attempt of the task;
                # don't bet the tail-latency rescue on it
                continue
            idx = self._ensure_task_index()
            bound = self._bound_stage_plan(job_id, stage_id, idx)
            if bound is None:
                continue
            dup = pb.TaskStatus()
            dup.partition_id.CopyFrom(cur.partition_id)
            dup.speculative = True
            if spec is not None:
                # supersede the straggling duplicate: it keeps running
                # (first completion wins, whoever crosses the line), but
                # the ledger now tracks its successor and its own late
                # reports retire against the superseded set
                dup.attempt = spec[1] + 1
                self._spec_superseded.setdefault(key3, set()).add(spec[1])
                self._spec_launches[key3] = self._spec_launches.get(key3, 1) + 1
                _record_speculation("relaunched")
            else:
                dup.attempt = cur.attempt + 1
                self._spec_launches[key3] = 1
            self._spec_put(key3, executor_id, dup.attempt)
            self.note_tenant_assigned(self.job_tenant(job_id)[0])
            _record_speculation("launched")
            log.warning(
                "speculating %s/%s/%s on %s (attempt %d%s): elapsed %.3fs > "
                "%.1fx predicted %.3fs (primary %s)",
                job_id, stage_id, partition, executor_id, dup.attempt,
                " re-speculated" if spec is not None else "",
                elapsed, self._spec_multiplier, pred, owner,
            )
            return dup, bound
        return None

    def _note_job_slo(self, job_id: str) -> None:
        """SLO accounting at job completion (ISSUE 11): a job finishing
        past its tenant's ballista.tenant.slo_ms deadline counts one
        slo_misses event. Once per job, enforced here — restart_completed_
        job can un-terminate a job (lost result partitions), and the
        second fold must not count the same job's outcome twice."""
        if not self._tenant_slos:
            return
        if job_id in self._slo_noted:
            return
        if len(self._slo_noted) > 10_000:
            self._slo_noted.clear()
        self._slo_noted.add(job_id)
        tenant, _prio, created = self._job_tenant_full(job_id)
        slo = self._tenant_slos.get(tenant)
        if slo is None or created <= 0.0:
            return
        if (time.time() - created) * 1000.0 > slo:
            _record_speculation("slo_misses")
            log.warning(
                "job %s (tenant %s) missed its %.0fms SLO", job_id, tenant, slo
            )
        else:
            _record_speculation("slo_met")

    def _tenant_inflight(self, idx: _TaskIndex) -> Dict[str, int]:
        """Per-tenant totals of currently RUNNING tasks, via the index's
        per-stage running sets and the job->tenant map."""
        out: Dict[str, int] = {}
        for (job_id, _stage), parts in idx.running.items():
            if not parts:
                continue
            tenant, _prio = self.job_tenant(job_id)
            out[tenant] = out.get(tenant, 0) + len(parts)
        return out

    def _tenant_candidate_order(
        self, idx: _TaskIndex
    ) -> List[Tuple[str, int]]:
        """Pending (job, stage) candidates in admission order (ISSUE 7).

        Tenants are visited by weighted fair share — smallest
        in_flight/weight first (ties by tenant name), so a tenant hogging
        the cluster yields the next slot to lighter tenants the moment they
        have runnable work. A tenant at its in-flight quota
        (ballista.tenant.max_inflight > 0) is skipped entirely: its pending
        work stays queued until its running tasks drain, which is exactly
        the starvation bound the quota promises other tenants. Within a
        tenant, higher-priority jobs come first; the final tie-break is the
        pre-tenancy (job, str(stage)) KV order, so single-tenant
        deployments see the EXACT historical candidate order
        (tests/test_scheduler_state.py asserts identity vs the linear
        scan)."""
        quota = self._tenant_quota
        weights = self._tenant_weights
        inflight = self._tenant_inflight(idx)
        by_tenant: Dict[str, List[Tuple[str, int]]] = {}
        prios: Dict[str, int] = {}
        for key in idx.pending:
            tenant, prio = self.job_tenant(key[0])
            by_tenant.setdefault(tenant, []).append(key)
            prios[key[0]] = prio
        order: List[Tuple[str, int]] = []
        # deadline-aware layer (ISSUE 11): a tenant whose oldest pending
        # job has blown its ballista.tenant.slo_ms deadline jumps ahead of
        # the fair-share order (most overdue first); everyone else — and
        # every deployment with no SLOs configured — keeps the exact
        # weighted fair-share ranking below.
        overdue: Dict[str, float] = {}
        if self._tenant_slos:
            now = time.time()
            for tenant, keys in by_tenant.items():
                slo = self._tenant_slos.get(tenant)
                if slo is None:
                    continue
                headrooms = [
                    created + slo / 1000.0 - now
                    for created in (
                        self.job_created_at(j) for j in {k[0] for k in keys}
                    )
                    if created > 0.0
                ]
                if headrooms and min(headrooms) <= 0.0:
                    overdue[tenant] = min(headrooms)
                    last = self._slo_boosted.get(tenant)
                    if last is None or now - last > 5.0:
                        # a fresh episode: never boosted, or unseen for
                        # long enough that the prior episode ended (a
                        # sub-5s gap is a stage boundary draining the
                        # pending set, not relief)
                        _record_tenancy("admit_slo_boosted")
                    self._slo_boosted[tenant] = now
            for t in by_tenant:
                # evaluated this scan and NOT overdue: episode over
                if t not in overdue:
                    self._slo_boosted.pop(t, None)
        tenant_rank = sorted(
            by_tenant,
            key=lambda t: (
                (0, overdue[t]) if t in overdue
                else (1, inflight.get(t, 0) / weights.get(t, 1)),
                t,
            ),
        )
        for tenant in tenant_rank:
            if quota > 0 and inflight.get(tenant, 0) >= quota:
                _record_tenancy("admit_quota_deferred")
                continue
            order.extend(sorted(
                by_tenant[tenant],
                key=lambda k: (-prios[k[0]], k[0], str(k[1])),
            ))
        return order

    def assign_next_schedulable_task(
        self, executor_id: str
    ) -> Optional[Tuple[pb.TaskStatus, object]]:
        """Index-driven pick of a runnable pending task: a task is runnable
        when every upstream stage it reads from has all tasks completed
        (ref state/mod.rs:182-260 does this as a linear scan over every
        task). The per-stage index narrows the work to stages that actually
        have pending tasks, with O(1) upstream-completeness checks; only a
        chosen stage's upstream statuses are read back from the KV (for
        shuffle locations). Candidates are visited in weighted fair-share
        tenant order with per-tenant in-flight quotas (ISSUE 7,
        _tenant_candidate_order); with no tenants configured this reduces
        to the linear scan's KV key order — tests/test_scheduler_state.py
        asserts identity on randomized DAGs. Marks the pick Running and
        returns (status, bound plan)."""
        idx = self._ensure_task_index()
        # per-task executor blacklist: attempt N+1 must not land on the
        # executor that failed attempt N — unless it is the only executor
        # left alive (progress beats placement when there is no choice)
        alive_others = {
            m.id for m in self.get_executors_metadata()
        } - {executor_id}
        # pending tasks of a terminal job must not be handed out (a failed
        # job can leave requeued-then-exhausted pending work behind)
        job_live: Dict[str, bool] = {}
        for job_id, stage_id in self._tenant_candidate_order(idx):
            # .get: an earlier iteration's upstream KV refresh may have
            # drained (and dropped) this stage's entry mid-iteration
            parts = idx.pending.get((job_id, stage_id))
            if not parts:
                continue
            if job_id not in job_live:
                js = self.get_job_metadata(job_id)
                # queued = planning not yet COMMITTED (the atomic publish
                # flips the job to running with its tasks): tasks visible
                # under a queued job can only be leakage from a torn write
                # on a non-transactional backend and must not be handed out
                job_live[job_id] = (
                    js is None
                    or js.WhichOneof("status") not in (
                        "completed", "failed", "queued",
                    )
                    # ownership gate (ISSUE 20): only the lease holder hands
                    # the job's tasks out — adopting on the spot when the
                    # previous owner's lease expired (thread-free failover)
                ) and self._may_schedule(job_id)
            if not job_live[job_id]:
                continue
            bound = self._bound_stage_plan(job_id, stage_id, idx)
            if bound is None:
                continue
            ordered, resident_pref = self._locality_partition_order(
                bound, parts, executor_id
            )
            for partition in ordered:
                # re-verify from the KV before claiming: the index is local
                # to this SchedulerState; a peer scheduler (or an expired
                # write) must not lead to a double assignment
                current = self.get_task_status(job_id, stage_id, partition)
                if current is None or current.WhichOneof("status") is not None:
                    if current is None:
                        idx.pending[(job_id, stage_id)].discard(partition)
                    else:
                        idx.observe(current)
                    continue
                if (
                    current.history
                    and current.history[-1].executor_id == executor_id
                    and alive_others
                ):
                    # blacklist: this executor failed the previous attempt;
                    # leave the task for a peer (another partition may still
                    # fit this executor)
                    continue
                if self._chaos is not None:
                    # admission chaos (ISSUE 7): abort the PollWork BEFORE
                    # the Running flip — nothing is written, the executor's
                    # poll fails transiently and retries, and the rotated
                    # sequence key gives the retry a fresh verdict. Keyed on
                    # a per-process admission counter (like kv.put's write
                    # counter): the seeded verdict SEQUENCE is reproducible,
                    # while a same-key verdict would refuse this admission
                    # forever.
                    self._admit_seq += 1
                    self._chaos.maybe_fail(
                        "scheduler.admit", f"admit{self._admit_seq}"
                    )
                running = pb.TaskStatus()
                running.CopyFrom(current)  # keep attempt + history
                running.running.executor_id = executor_id
                if partition in resident_pref:
                    # the pick landed where its inputs are HBM-resident
                    from ballista_tpu_torch.ops.runtime import record_exchange

                    record_exchange("locality_preferred")
                if not self.save_task_status(running):
                    # fenced out mid-assignment (ISSUE 20): a peer adopted
                    # the job between the liveness check and the claim —
                    # nothing was written; stop offering this job's tasks
                    job_live[job_id] = False
                    break
                self._ledger_put(
                    (job_id, stage_id, partition), executor_id, running.attempt
                )
                self.note_tenant_assigned(self.job_tenant(job_id)[0])
                return running, bound
        return None

    def reconcile_running_tasks(self, executor_id: str, running) -> int:
        """Fold one executor's in-flight echo against the assignment ledger.

        An entry the owner echoes (with a matching attempt when the echo
        carries one) is CONFIRMED: the assignment reached the executor, so
        the entry retires from the ledger and the normal status/lease
        machinery takes over — after a scheduler restart this is the
        re-adoption path (the restarted scheduler never re-executes a task
        an executor still owns). An entry past the grace period that the
        owner's poll does not echo means the PollWork response carrying the
        assignment never arrived — requeue it through the retry path
        (without this the task is orphaned forever: the owner's lease stays
        fresh, so reset_lost_tasks never fires).

        `running` accepts both echo forms: RunningTaskEcho (partition +
        attempt) and bare PartitionId (wire compat; vouches for whatever
        attempt the ledger holds). Returns the number of RECLAIMED
        (requeued) assignments."""
        now = time.monotonic()
        echo: Dict[Tuple[str, int, int], Optional[int]] = {}
        for p in running:
            if hasattr(p, "job_id"):  # bare PartitionId
                echo[(p.job_id, p.stage_id, p.partition_id)] = None
            else:  # RunningTaskEcho
                pid = p.partition_id
                echo[(pid.job_id, pid.stage_id, pid.partition_id)] = p.attempt
        reclaimed = 0
        # speculative-duplicate reconciliation (ISSUE 11): the duplicate
        # has no tasks/ status, so the ledger entry under speculation/ is
        # the only thing that notices a lost-in-transit delivery. The
        # owner's echo with the speculative attempt confirms it (and, after
        # a restart, re-adopts it); an unvouched entry past the grace
        # window is simply dropped — the primary still runs, so there is
        # nothing to requeue.
        for key, entry in list(self._speculative.items()):
            if key not in self._speculative:
                continue  # purged mid-loop (deposition, ISSUE 20)
            ex, at, t0, vouched, restored = entry
            if ex != executor_id:
                continue
            if key in echo and echo[key] in (None, at):
                if not vouched:
                    self._speculative[key] = (ex, at, t0, True, restored)
                    if restored:
                        _record_recovery("restart_speculation_readopted")
                continue
            if not vouched and now - t0 > ORPHANED_ASSIGNMENT_GRACE_SECS:
                self._spec_del(key)
                _record_speculation("orphaned")
                log.warning(
                    "speculative attempt %d of %s/%s/%s never reached %s; "
                    "dropped (primary still runs)",
                    at, key[0], key[1], key[2], ex,
                )
        # in-memory screens first (owner, echo confirmation, grace window):
        # the KV read + proto parse happens ONLY for entries actually up
        # for requeue — this loop runs under the global lock on every poll,
        # so O(in-flight) KV reads per heartbeat would tax every executor.
        # Entries of other owners (incl. ones superseded elsewhere) are
        # cleaned on their owner's polls or by accept_task_status.
        for key, (owner, attempt, t0, restored) in list(self._assigned.items()):
            if key not in self._assigned:
                continue  # purged mid-loop (deposition, ISSUE 20)
            if owner != executor_id:
                continue  # only the owner's polls can vouch for it
            if key in echo and echo[key] in (None, attempt):
                # confirmed started (a stale-attempt echo does NOT count);
                # status/lease machinery takes over from here
                self._ledger_del(key)
                if restored:
                    _record_recovery("restart_readopted")
                    log.info(
                        "restart reconciliation: executor %s re-adopted "
                        "task %s/%s/%s (attempt %d)",
                        owner, key[0], key[1], key[2], attempt,
                    )
                continue
            if now - t0 < ORPHANED_ASSIGNMENT_GRACE_SECS:
                continue
            # destructive path ahead: re-verify the ownership lease first
            # (ISSUE 20). A peer may have adopted the job while this
            # replica sat paused past its TTL — its restored ledger rows
            # must not be deleted by the deposed owner's reconciliation.
            if key[0] in self._owned:
                held = self.kv.get(self._lease_key(key[0]))
                if held is not None and held != self._owned[key[0]]:
                    self._deposed(key[0])
                    continue
            cur = self.get_task_status(*key)
            if (
                cur is None
                or cur.WhichOneof("status") != "running"
                or cur.attempt != attempt
                or cur.running.executor_id != owner
            ):
                self._ledger_del(key)  # resolved or superseded elsewhere
                continue
            self._ledger_del(key)
            error = (
                f"assignment never reached executor {owner} "
                "(PollWork response lost in transit)"
            )
            if self.requeue_task(cur, owner, error, self.retry_limit(key[0])):
                _record_recovery("orphan_reassigned")
                reclaimed += 1
            else:
                exhausted = pb.TaskStatus()
                exhausted.CopyFrom(cur)
                exhausted.failed.error = error
                exhausted.failed.executor_id = owner
                self._fail_job(key[0], _attempts_error(exhausted))
        return reclaimed

    # -- job status fold ------------------------------------------------------
    def synchronize_job_status(self, job_id: str) -> None:
        """Fold task statuses into the job status (ref state/mod.rs:267-358)
        — through the retry policy: a failed task inside its retry budget is
        requeued (with the attempt recorded in its history) instead of
        failing the job, a fetch_failed task additionally recomputes the
        lost map partition (lineage), and only an exhausted task fails the
        job — with every attempt listed in the error."""
        current = self.get_job_metadata(job_id)
        which_job = current.WhichOneof("status") if current is not None else None
        if which_job == "queued":
            # still being planned; tasks not yet created
            return
        if which_job in ("completed", "failed"):
            # terminal: late task reports must not resurrect the job
            return
        tasks = self.get_job_tasks(job_id)
        if not tasks:
            return
        limit = self.retry_limit(job_id)
        status = pb.JobStatus()
        any_failed = None
        all_completed = True
        for t in tasks:
            w = t.WhichOneof("status")
            if w == "failed":
                if self.requeue_task(
                    t, t.failed.executor_id, t.failed.error, limit
                ):
                    all_completed = False
                    continue
                any_failed = _attempts_error(t)
                break
            if w == "fetch_failed":
                if self.handle_fetch_failed(t, limit):
                    all_completed = False
                    continue
                any_failed = _attempts_error(t)
                break
            if w != "completed":
                all_completed = False
        if any_failed is not None:
            status.failed.error = any_failed
            _record_recovery("job_failed_exhausted")
        elif all_completed:
            final_stage = max(t.partition_id.stage_id for t in tasks)
            for t in sorted(tasks, key=lambda t: t.partition_id.partition_id):
                if t.partition_id.stage_id != final_stage:
                    continue
                pl = status.completed.partition_location.add()
                pl.partition_id.CopyFrom(t.partition_id)
                meta = self.get_executor_metadata(t.completed.executor_id)
                if meta is not None:
                    pl.executor_meta.CopyFrom(meta)
                pl.path = t.completed.path
                pl.partition_stats.CopyFrom(t.completed.stats)
                pl.storage_uri = t.completed.storage_uri
                pl.resident = t.completed.resident
        else:
            status.running.SetInParent()
            # per-partition completion notifications (ISSUE 8): publish the
            # final-stage result partitions completed SO FAR on the running
            # status, so a streaming client starts fetching before the last
            # partition lands. Built exactly like the completed list above —
            # same location shape, same partition order — and re-derived on
            # every fold, so a requeued partition simply drops out until its
            # retry completes again.
            final_stage = max(t.partition_id.stage_id for t in tasks)
            for t in sorted(tasks, key=lambda t: t.partition_id.partition_id):
                if (
                    t.partition_id.stage_id != final_stage
                    or t.WhichOneof("status") != "completed"
                ):
                    continue
                pl = status.running.partial_location.add()
                pl.partition_id.CopyFrom(t.partition_id)
                meta = self.get_executor_metadata(t.completed.executor_id)
                if meta is not None:
                    pl.executor_meta.CopyFrom(meta)
                pl.path = t.completed.path
                pl.partition_stats.CopyFrom(t.completed.stats)
                pl.storage_uri = t.completed.storage_uri
                pl.resident = t.completed.resident
        if not self.save_job_metadata(job_id, status):
            # fenced out (ISSUE 20): a peer adopted the job mid-fold — its
            # own synchronization owns the terminal transition, the GC
            # release, the SLO note, and the result-cache publish
            return
        which_new = status.WhichOneof("status")
        if which_new in ("completed", "failed"):
            # shared-store GC (ISSUE 16 satellite): the terminal transition
            # happens exactly ONCE (the already-terminal early return above
            # guards re-entry), so this is the refcount-release point for
            # the job's intermediate shuffle pieces — completed keeps its
            # final stage for the client/result cache, failed releases all
            self._gc_shared_store_job(
                job_id,
                max(t.partition_id.stage_id for t in tasks)
                if which_new == "completed" else None,
                tasks,
            )
        if which_new == "completed":
            self._note_job_slo(job_id)
            # publish into the plan-fingerprint result cache (ISSUE 7).
            # jobfp/{job} exists only when the submission was fingerprintable
            # AND caching was enabled for it — so this is already gated.
            fp = self.get_job_fingerprint(job_id)
            if fp is not None:
                self.result_cache_put(fp, status.completed, job_id=job_id)
