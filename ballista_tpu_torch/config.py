"""Session / executor configuration.

The reference flows a free-form string settings map from clients
(KeyValuePair settings, reference rust/core/proto/ballista.proto:428-447;
``batch.size`` set by the TPC-H harness, rust/benchmarks/tpch/src/main.rs:120-121)
and configures daemons via configure_me specs
(rust/executor/executor_config_spec.toml, rust/scheduler/scheduler_config_spec.toml).

Here both collapse into one typed-view-over-strings config object. The
executor-selection boundary (cpu | cuda backend) lives here. In this package
the device backend "cuda" is the default; the Arrow host backend stays
"cpu". Setting keys keep their ``ballista.tpu.*`` names, so one settings dict
configures both this package and the JAX reference package.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional

BALLISTA_BATCH_SIZE = "ballista.batch.size"
BALLISTA_BACKEND = "ballista.executor.backend"  # "cpu" (Arrow host kernels) | "cuda" (PyTorch + CUDA kernels)
BALLISTA_STAGE_FUSION = "ballista.tpu.stage_fusion"  # whole-stage SPMD compilation on/off
BALLISTA_MESH_SHAPE = "ballista.tpu.mesh"  # e.g. "data:8" or "data:4,model:2"
BALLISTA_SHUFFLE_PARTITIONS = "ballista.shuffle.partitions"
# compression for materialized shuffle pieces: "" (none) | "zstd" | "lz4"
BALLISTA_SHUFFLE_CODEC = "ballista.shuffle.codec"
# -- disaggregated shuffle tier (ISSUE 15) ----------------------------------
# where materialized shuffle pieces live:
#   "local"  — the producing executor's private work dir, served to peers
#              over Flight (the reference design; executor death loses the
#              pieces and lineage recompute recovers them)
#   "shared" — a shared-storage directory rooted at ballista.shuffle.dir
#              (NFS/fuse mount, or any path every node sees). A piece's
#              home becomes a PATH, not a process: executor death after map
#              completion is a non-event (no lineage recompute, no task
#              retries), and scaling the fleet in destroys no data.
# Readers resolve storage-homed pieces from the shared dir first; the
# Flight peer fetch stays as the local-tier path and the fallback ladder.
BALLISTA_SHUFFLE_TIER = "ballista.shuffle.tier"
BALLISTA_SHUFFLE_DIR = "ballista.shuffle.dir"
# -- elastic executor fleet (ISSUE 15, executor/runtime.py) -----------------
# StandaloneCluster autoscaler: grows/shrinks the executor fleet against
# the admission queue's cost-model-predicted backlog seconds. max = 0
# disables autoscaling entirely (the fixed-fleet default); with max > 0
# the fleet floats in [min, max] — scale-OUT adds executors while the
# predicted backlog exceeds target_backlog_s, scale-IN gracefully drains
# one executor per evaluation (stop offering slots, finish running tasks,
# retire) once the cluster is idle. On the shared shuffle tier a drain
# destroys no data, so scale-in completes running jobs with zero retries.
BALLISTA_FLEET_MIN = "ballista.fleet.min"
BALLISTA_FLEET_MAX = "ballista.fleet.max"
BALLISTA_FLEET_INTERVAL_S = "ballista.fleet.interval_s"
# predicted backlog seconds one evaluation tolerates before growing the
# fleet; also the growth denominator (desired extra executors ~= backlog /
# target), so a deep queue grows the fleet in one evaluation, not one
# executor per tick
BALLISTA_FLEET_TARGET_BACKLOG_S = "ballista.fleet.target_backlog_s"
BALLISTA_DEVICE_CACHE = "ballista.tpu.device_cache"  # keep encoded columns resident in HBM
# total bytes of cached device residency across stages; partitions beyond
# the budget stream (upload, compute, free) instead of pinning — how SF=100
# fact layouts run on a 16GB-HBM chip
BALLISTA_TPU_HBM_BUDGET = "ballista.tpu.hbm_budget_bytes"
# HBM-resident cross-stage exchange (ISSUE 16): a completed shuffle write
# ALSO registers its pieces in the executor's residency registry so a
# same-executor consumer resolves them with zero decode and zero re-upload.
# The disk/storage piece stays the authoritative home — eviction or
# executor death degrades to the storage -> Flight peer -> lineage ladder.
BALLISTA_TPU_EXCHANGE = "ballista.tpu.exchange"
# byte budget for registered exchange pieces per executor process; pieces
# past it are skipped (or evict colder entries when the cost model says the
# incomer saves more transfer time than the victims would)
BALLISTA_TPU_RESIDENCY_BUDGET = "ballista.tpu.residency_budget_bytes"
BALLISTA_SCAN_CACHE = "ballista.scan.cache"  # host-side decoded-table cache (parquet)
BALLISTA_SCAN_CACHE_CAP = "ballista.scan.cache_cap_bytes"
# experimental per-operator device offload (filter/projection masks, PK-FK
# join). Whole-stage fusion is the default TPU path; per-op offload only pays
# when host<->device latency is low, so it is opt-in.
BALLISTA_TPU_PER_OP = "ballista.tpu.per_op_dispatch"
BALLISTA_TPU_DEVICE_JOIN = "ballista.tpu.device_join"
BALLISTA_TPU_FUSE_VOLATILE = "ballista.tpu.fuse_volatile_sources"  # aggregate over non-scan sources
# distributed planner: collapse Partial->hash shuffle->Final aggregations
# into ONE mesh program (shard_map + psum over ICI, parallel/spmd_stage.py)
BALLISTA_TPU_SPMD = "ballista.tpu.spmd_stages"
# plan multi-partition aggregations as ONE SINGLE-mode aggregate over merged
# input instead of Partial/Final. On a single chip the partial/final split
# buys no parallelism and costs one d2h readback of partial states PER
# partition (~65ms latency + bandwidth each through the relay); coalescing
# restores the top-k readback pushdown (SINGLE-mode only) and makes the
# whole aggregation one dispatch + one small readback. "auto" = on when the
# backend is tpu and SPMD stage fusion is off (the distributed scheduler
# and the mesh dryrun keep the exchange shape).
BALLISTA_TPU_COALESCE_AGG = "ballista.tpu.coalesce_aggregates"
# byte cap (sum of leaf scan file sizes) above which coalescing is skipped:
# one driven partition materializes the whole chain, so huge inputs keep the
# Partial/Final split and stream file-by-file within the HBM budget
BALLISTA_TPU_COALESCE_MAX = "ballista.tpu.coalesce_max_bytes"
# high-cardinality sorted aggregation kernel: "layout" (chunked-segment
# tiles, default) | "pallas" (MXU one-hot matmul with RMW DMA windows,
# sum/count/avg only — measured slower on v5e, kept selectable)
BALLISTA_TPU_SORTED_KERNEL = "ballista.tpu.sorted_kernel"
# persisted device-layout cache (ops/layout_cache.py): warm starts skip the
# O(N log N) host prepare (decode/encode/rank/sort/materialize) for
# file-backed stages. "" disables; entries keyed by plan + file mtimes
BALLISTA_TPU_LAYOUT_CACHE_DIR = "ballista.tpu.layout_cache_dir"
BALLISTA_TPU_LAYOUT_CACHE_CAP = "ballista.tpu.layout_cache_cap_bytes"
# pipelined host->device ingestion (ops/stage.py, distributed/stages.py):
# worker threads for the prefetch stage (parquet read + dictionary decode +
# group ranking, and parallel shuffle-piece fetches). 0 = fully serial
# (the pre-pipeline path); the encode/upload consume stage stays ordered
# regardless, so results are bit-identical at any worker count.
BALLISTA_TPU_INGEST_WORKERS = "ballista.tpu.ingest_workers"
# max prefetched items in flight beyond the one being consumed, per
# pipeline stage. The file-read stage (whole decoded tables) and the
# prepare pipeline (ranked batches) each hold up to `depth` items, and the
# shuffle reader up to `depth` materialized pieces — so the worst-case
# host RSS bound is ~2*depth decoded tables, not depth batches
BALLISTA_TPU_INGEST_DEPTH = "ballista.tpu.ingest_depth"
# comma-separated directory allowlist for scan paths in plans arriving over
# the wire ("" = unrestricted, the standalone/local default). The reference
# executes any deserialized plan (rust/executor/src/flight_service.rs:90-192);
# a rewrite should not let an unauthenticated peer scan arbitrary host files.
BALLISTA_DATA_ROOTS = "ballista.executor.data_roots"
# -- failure recovery (scheduler/state.py, executor/execution_loop.py) ------
# how many times a failed task is requeued before the job fails with the
# full attempt history (the reference fails the job on the FIRST task
# failure, SURVEY §5 "no retry"). Counts ALL requeue causes: task errors,
# executor death, lost shuffle outputs, fetch failures.
BALLISTA_MAX_TASK_RETRIES = "ballista.shuffle.max_task_retries"
# transient-RPC resilience: attempts beyond the first for UNAVAILABLE /
# connect failures (execution errors surface immediately), and the jittered
# exponential backoff base between them
BALLISTA_RPC_RETRIES = "ballista.rpc.retries"
BALLISTA_RPC_BACKOFF_MS = "ballista.rpc.backoff_ms"
# -- multi-tenant serving (ISSUE 7) -----------------------------------------
# which tenant this client submits as ("" = the default unnamed tenant) and
# the optional per-job priority (higher schedules first within the tenant).
# Both ride ExecuteQueryParams as first-class fields; the scheduler persists
# them per job (tenants/{job}) so admission survives a restart.
BALLISTA_TENANT = "ballista.tenant.name"
BALLISTA_TENANT_PRIORITY = "ballista.tenant.priority"
# scheduler-side admission control: max tasks a single tenant may have
# in flight across the cluster (0 = unlimited). A tenant at its quota is
# skipped by assignment until its running tasks drain — a saturating
# tenant's SF=100 scan cannot starve another tenant's point query.
BALLISTA_TENANT_MAX_INFLIGHT = "ballista.tenant.max_inflight"
# weighted fair share: "alice:4,bob:1" gives alice 4x bob's share of
# assignment slots when both have pending work; unlisted tenants weigh 1.
BALLISTA_TENANT_WEIGHTS = "ballista.tenant.weights"
# plan-fingerprint result cache (scheduler-side): a completed job's result
# partition locations are indexed under sha256(normalized logical plan +
# input file mtimes + result-affecting settings); a repeated identical
# query over unchanged inputs completes instantly with ZERO executor tasks.
BALLISTA_RESULT_CACHE = "ballista.cache.results"
# result-cache bounds (ISSUE 8): max live resultcache/{fp} entries (0 =
# unbounded; past the cap the least-recently-HIT entries are deleted from
# the KV) and a TTL in seconds (0 = no expiry; an entry older than this is
# treated as a miss and deleted on lookup). Entries are location-only and
# tiny, but an unbounded long-lived scheduler would accumulate every
# distinct query it ever served.
BALLISTA_RESULT_CACHE_MAX_ENTRIES = "ballista.cache.results.max_entries"
BALLISTA_RESULT_CACHE_TTL_S = "ballista.cache.results.ttl_s"
# result-cache delta advancement (ISSUE 19): on a fingerprint miss whose
# content_key matches a cached entry and whose scan-file set is a strict
# SUPERSET of the entry's, plan a delta job over only the NEW files and
# fold its partials into the entry's stored resumable state instead of
# recomputing the full scan. Only order-insensitive aggregate shapes are
# eligible (integer sums, counts, min/max — f32-arithmetic sums and
# anything non-associative decline to the full run, recorded, never
# silent); the advanced result is bit-identical to a cold full run.
BALLISTA_CACHE_ADVANCE = "ballista.cache.advance"
# internal (scheduler-set, never client-set): present in a delta job's
# per-job settings, naming the user job whose cached result the delta's
# output advances. Rides TaskDefinition.settings AND the proto's
# delta_for field — provenance for logs/telemetry; executors run the
# task like any other.
BALLISTA_DELTA_FOR = "ballista.internal.delta_for"
# cross-job physical-plan sharing (scheduler-side): optimize+physical
# planning output is content-keyed (fingerprint sans mtimes), so N tenants
# submitting the same dashboard query plan it once.
BALLISTA_PLAN_CACHE = "ballista.cache.plans"
# per-tenant HBM-residency budget (ISSUE 19 satellite, PR 16 residue): max
# bytes of exchange-registry residency one tenant's published pieces may
# hold on a chip (0 = unlimited). Enforced BEFORE the cluster-global
# residency budget, with per-tenant LRU eviction among that tenant's own
# entries — one tenant's SF=100 shuffle cannot monopolize the registry
# that another tenant's dashboard queries rely on.
BALLISTA_TENANT_RESIDENCY_BUDGET = "ballista.tenant.residency_budget_bytes"
# per-tenant latency SLO deadlines (ISSUE 11): "alice:250,bob:2000" gives
# alice's jobs a 250ms target. Feeds admission ordering — a tenant whose
# oldest pending job has blown (or is past) its deadline is visited BEFORE
# the weighted fair-share order (deadline-aware fair share), and a job
# completing past its deadline counts an `slo_misses` speculation event.
# Unlisted tenants carry no SLO and keep the pure fair-share order.
BALLISTA_TENANT_SLO_MS = "ballista.tenant.slo_ms"
# -- speculative execution (ISSUE 11, scheduler/state.py) -------------------
# cost-model straggler detection: when a RUNNING task's elapsed time
# exceeds `multiplier` x its predicted cost (ops/costmodel.py task.run
# rates, warmed by sibling completions) AND the minimum-runtime floor, the
# scheduler dispatches a duplicate attempt to a DIFFERENT executor through
# the normal assignment + ledger path. First completion wins; the losing
# attempt's report is dropped by the stale-attempt guard. Results are
# bit-identical with speculation on or off.
BALLISTA_SPECULATION = "ballista.speculation"
BALLISTA_SPECULATION_MULTIPLIER = "ballista.speculation.multiplier"
# floor below which a task never speculates (cheap tasks finish before a
# duplicate could help; this is also why fault-free runs launch nothing
# under the defaults)
BALLISTA_SPECULATION_MIN_RUNTIME_MS = "ballista.speculation.min_runtime_ms"
# re-speculation bound (ISSUE 15 satellite, PR 11 residue): how many
# speculative duplicates one task may accumulate. A duplicate that ITSELF
# straggles past the same cost-model threshold may be re-speculated
# (superseding the straggling duplicate in the ledger) until this many
# have launched; 1 restores the old launch-once behavior.
BALLISTA_SPECULATION_MAX_ATTEMPTS = "ballista.speculation.max_attempts"
# -- shared-scan multi-query execution (ISSUE 13) ---------------------------
# scheduler-side scan sharing: concurrent DISTINCT jobs whose pending
# fused-aggregate stages read the same persisted layout (same scan files,
# same chunk cover) are grouped into one batched task — the executor runs
# the group as ONE device launch over ONE resident upload, each member's
# readback routed to its own job's shuffle piece, bit-identical to solo
# execution. Evidence-gated through the cost model's `stage.batch` rates (a
# batch predicted slower than the members' solo sum dispatches solo), and
# any incompatibility at the executor degrades the member to solo, never to
# a wrong answer.
BALLISTA_SHARED_SCAN = "ballista.shared_scan"
# most member tasks one batched dispatch may carry (the primary included)
BALLISTA_SHARED_SCAN_MAX_BATCH = "ballista.shared_scan.max_batch"
# client-side server-push job-status notifications (ISSUE 11 satellite): a
# server-streaming SubscribeJobStatus RPC mirroring SubscribeWork replaces
# the 5ms-floor adaptive status poll on the wait/stream paths; the poll
# stays as the automatic fallback whenever the stream is down or refused.
BALLISTA_PUSH_STATUS = "ballista.client.push_status"
# -- low-latency serving tier (ISSUE 8) -------------------------------------
# push-based task dispatch: executors open a server-streaming SubscribeWork
# stream and the scheduler pushes TaskDefinitions the moment assignment
# picks them. The PollWork loop stays as heartbeat + automatic dispatch
# fallback when the stream is down. Governs BOTH sides: an executor with it
# off never subscribes, a scheduler with it off refuses subscriptions.
BALLISTA_PUSH_DISPATCH = "ballista.executor.push_dispatch"
# adaptive idle poll backoff: while the push stream is healthy the PollWork
# heartbeat interval decays from 250ms toward this ceiling (seconds) and
# snaps back to 250ms the moment the stream drops — the steady-state RPC
# load of a large idle fleet falls ~8x without touching crash-tolerance
# semantics (the echo/lease machinery rides whatever polls happen).
BALLISTA_IDLE_POLL_MAX_S = "ballista.executor.idle_poll_max_s"
# persistent compiled-program (AOT) cache directory beside the layout
# cache: jitted device-stage programs are exported (jax.export), serialized
# to disk keyed on stage identity + shape bucket + jax/jaxlib/backend
# fingerprint, and reloaded by later processes — a warm disk tier under the
# in-memory jit cache, so a cold executor skips the Python trace (and, with
# the persistent XLA cache, the compile). "" disables.
BALLISTA_TPU_AOT_CACHE_DIR = "ballista.tpu.aot_cache"
# pre-warm at executor start: load every manifest entry of the AOT cache
# and compile it BEFORE the first task arrives, so a cold executor's first
# small query pays zero trace/compile. Off by default — interactive/test
# processes should not pay a bulk warm-up they may never amortize.
BALLISTA_TPU_PREWARM = "ballista.tpu.prewarm"
# client-side streaming result fetch: collect() starts fetching (and
# consuming) final-stage result partitions AS THEY COMPLETE, via the
# per-partition completion notifications on the running job status, instead
# of waiting for the whole job — time-to-first-batch drops to the first
# partition's latency. Results are bit-identical to the buffered path.
BALLISTA_STREAM_RESULTS = "ballista.client.stream_results"
# -- adaptive execution (ISSUE 10, ops/costmodel.py) ------------------------
# measured cost model behind device-vs-host routing: tier selection past
# the static ladder, partial offload (split a batch at the tier boundary
# instead of declining it wholesale), the general skew handler, and
# build-side switching on observed cardinality misestimates. OFF restores
# the pure static decline ladder exactly; routing never changes results —
# bit-identity to the host oracle is the invariant either way.
BALLISTA_TPU_COST_MODEL = "ballista.tpu.cost_model"
# persisted per-shape-bucket cost store beside the layout cache, keyed like
# the AOT cache on op/stage identity + shape bucket + backend fingerprint.
# "" keeps the store in-memory only (observations still steer routing
# within the process, nothing survives it).
BALLISTA_TPU_COST_MODEL_DIR = "ballista.tpu.cost_model_dir"
# -- concurrency analysis (ISSUE 14, utils/locks.py) ------------------------
# dynamic lock witness: project locks record acquired-while-held edges at
# runtime, assert the moment an acquisition inverts the canonical order in
# dev/analysis/lockorder.toml (both stacks attached), and dump a witness
# file for `python -m dev.analysis --check-witness`. Debug/CI mode —
# enabling is process-global and sticky. Env equivalents:
# BALLISTA_LOCK_WITNESS=1 / BALLISTA_LOCK_WITNESS_OUT=<path>.
BALLISTA_DEBUG_LOCK_WITNESS = "ballista.debug.lock_witness"
# -- replicated control plane (ISSUE 20) ------------------------------------
# TTL of the per-job ownership lease (leases/{job}) a scheduler replica
# mints with the planning commit and renews from its heartbeat thread at
# ttl/3. Expiry is the failover trigger: an idle peer adopts the dead
# replica's jobs by running restart recovery scoped to them, so this bounds
# the ownership-migration latency after a replica dies. Fencing (the CAS on
# the lease value in every owner write) makes a TOO-short TTL safe — a
# spurious expiry costs a migration, never corruption — but each migration
# re-runs scoped recovery, so production deployments want seconds, not
# milliseconds.
BALLISTA_SCHEDULER_LEASE_TTL_S = "ballista.scheduler.lease_ttl_s"
# -- deterministic fault injection (utils/chaos.py) -------------------------
# rate > 0 arms the registered injection sites; each (site, key) pair draws
# a DETERMINISTIC verdict from sha256(seed, site, key), so a chaos run is
# reproducible and recovery must deliver results bit-identical to the
# fault-free run. sites: comma-separated subset of chaos.SITES ("" = all).
BALLISTA_CHAOS_SEED = "ballista.chaos.seed"
BALLISTA_CHAOS_RATE = "ballista.chaos.rate"
BALLISTA_CHAOS_SITES = "ballista.chaos.sites"
# injected delay for the `task.slow` straggler site (ISSUE 11): a task
# whose (stage, partition, attempt) coordinate draws a slow verdict sleeps
# this long before executing — deterministic stragglers for the
# p99-under-chaos bench metric. The duplicate attempt is keyed on a
# DIFFERENT attempt number, so it draws a fresh verdict.
BALLISTA_CHAOS_SLOW_MS = "ballista.chaos.slow_ms"

DEFAULT_SETTINGS: Dict[str, str] = {
    # 32768 is the reference's hard-coded default batch size
    # (rust/core/src/serde/physical_plan/from_proto.rs:100-102).
    BALLISTA_BATCH_SIZE: "32768",
    BALLISTA_BACKEND: "cuda",
    BALLISTA_STAGE_FUSION: "true",
    BALLISTA_MESH_SHAPE: "data:1",
    BALLISTA_SHUFFLE_PARTITIONS: "16",
    BALLISTA_SHUFFLE_CODEC: "",
    # local tier = the reference design (peer-served work-dir pieces);
    # "shared" requires ballista.shuffle.dir to name the storage root
    BALLISTA_SHUFFLE_TIER: "local",
    BALLISTA_SHUFFLE_DIR: "",
    # autoscaling off by default: a fixed fleet behaves exactly as before
    BALLISTA_FLEET_MIN: "1",
    BALLISTA_FLEET_MAX: "0",
    BALLISTA_FLEET_INTERVAL_S: "0.5",
    BALLISTA_FLEET_TARGET_BACKLOG_S: "1.0",
    BALLISTA_DEVICE_CACHE: "true",
    BALLISTA_TPU_HBM_BUDGET: str(12 << 30),
    # on by default: the exchange tier is bit-identical by construction
    # (registry entries are the exact batches the authoritative piece
    # holds) and every degradation path is the pre-existing ladder
    BALLISTA_TPU_EXCHANGE: "true",
    # sized well below the HBM budget: exchange pieces are transient
    # stage-boundary intermediates, not the working set
    BALLISTA_TPU_RESIDENCY_BUDGET: str(1 << 30),
    BALLISTA_SCAN_CACHE: "true",
    BALLISTA_SCAN_CACHE_CAP: str(4 << 30),
    BALLISTA_TPU_PER_OP: "false",
    # on by default since the M:N multiplicity kernel (ops/join.py): the
    # device join is bit-identical to the host oracle for any build-key
    # multiplicity and steps aside with a reason past the admission tiers
    BALLISTA_TPU_DEVICE_JOIN: "true",
    BALLISTA_TPU_FUSE_VOLATILE: "false",
    BALLISTA_TPU_SPMD: "false",
    BALLISTA_TPU_COALESCE_AGG: "auto",
    # sized for TPC-H SF=100 (leaf parquet ~18 GB): narrow residency keeps
    # the DEVICE footprint at roughly on-disk scale (~2.2x below decoded
    # int32/f32), and the fact-agg top-k epilogue only exists on the
    # SINGLE-mode plan — a smaller cap silently pushed q3/q5 onto the
    # partial/final host path at exactly the scale the ≥5x target names
    BALLISTA_TPU_COALESCE_MAX: str(24 << 30),
    BALLISTA_TPU_SORTED_KERNEL: "layout",
    # cwd-relative by default (like .pytest_cache) so warm starts survive
    # process restarts without writing outside the working tree; set an
    # absolute path for daemons with volatile cwds, "" disables persistence
    BALLISTA_TPU_LAYOUT_CACHE_DIR: ".ballista_cache/layouts",
    BALLISTA_TPU_LAYOUT_CACHE_CAP: str(48 << 30),
    BALLISTA_TPU_INGEST_WORKERS: "2",
    BALLISTA_TPU_INGEST_DEPTH: "2",
    BALLISTA_DATA_ROOTS: "",
    BALLISTA_MAX_TASK_RETRIES: "3",
    BALLISTA_TENANT: "",
    BALLISTA_TENANT_PRIORITY: "0",
    BALLISTA_TENANT_MAX_INFLIGHT: "0",
    BALLISTA_TENANT_WEIGHTS: "",
    BALLISTA_RESULT_CACHE: "true",
    BALLISTA_RESULT_CACHE_MAX_ENTRIES: "1024",
    BALLISTA_RESULT_CACHE_TTL_S: "0",
    # advancement defaults OFF: it changes how a repeated query over grown
    # inputs executes (delta job + fold instead of a full run); the
    # bit-identity invariant is fuzz-checked but the workload class is
    # opt-in like streaming ingestion itself
    BALLISTA_CACHE_ADVANCE: "false",
    BALLISTA_TENANT_RESIDENCY_BUDGET: "0",
    BALLISTA_PLAN_CACHE: "true",
    BALLISTA_PUSH_DISPATCH: "true",
    BALLISTA_IDLE_POLL_MAX_S: "2",
    # cwd-relative beside the layout cache (same rationale: warm starts
    # survive process restarts without writing outside the working tree)
    BALLISTA_TPU_AOT_CACHE_DIR: ".ballista_cache/aot",
    BALLISTA_TPU_PREWARM: "false",
    BALLISTA_STREAM_RESULTS: "false",
    # default ON with the static ladder as cold-start prior + safety cap: a
    # cold (or absent, or corrupt) store reproduces pre-adaptive routing
    BALLISTA_TPU_COST_MODEL: "true",
    # cwd-relative beside the layout/AOT caches (same rationale)
    BALLISTA_TPU_COST_MODEL_DIR: ".ballista_cache/costmodel",
    BALLISTA_RPC_RETRIES: "3",
    BALLISTA_RPC_BACKOFF_MS: "50",
    BALLISTA_SCHEDULER_LEASE_TTL_S: "5",
    BALLISTA_DEBUG_LOCK_WITNESS: "false",
    BALLISTA_CHAOS_SEED: "0",
    BALLISTA_CHAOS_RATE: "0",
    BALLISTA_CHAOS_SITES: "",
    BALLISTA_CHAOS_SLOW_MS: "1000",
    BALLISTA_TENANT_SLO_MS: "",
    # speculation defaults ON: the 500ms floor + 4x slack mean fault-free
    # runs (tasks well under the floor, or within slack of prediction)
    # never launch a duplicate — only genuine stragglers do
    BALLISTA_SPECULATION: "true",
    BALLISTA_SPECULATION_MULTIPLIER: "4",
    BALLISTA_SPECULATION_MIN_RUNTIME_MS: "500",
    BALLISTA_SPECULATION_MAX_ATTEMPTS: "2",
    BALLISTA_PUSH_STATUS: "true",
    # shared-scan batching defaults ON: a batch is only formed from
    # co-pending compatible stages, degrades to solo on any doubt, and is
    # bit-identical to solo execution by construction
    BALLISTA_SHARED_SCAN: "true",
    BALLISTA_SHARED_SCAN_MAX_BATCH: "8",
}


class BallistaConfig(Mapping[str, str]):
    """Immutable string->string settings map with typed accessors."""

    def __init__(self, settings: Optional[Mapping[str, str]] = None) -> None:
        merged = dict(DEFAULT_SETTINGS)
        if settings:
            merged.update({str(k): str(v) for k, v in settings.items()})
        self._settings = merged

    # Mapping interface ----------------------------------------------------
    def __getitem__(self, key: str) -> str:
        return self._settings[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._settings)

    def __len__(self) -> int:
        return len(self._settings)

    # Typed accessors ------------------------------------------------------
    def batch_size(self) -> int:
        return int(self._settings[BALLISTA_BATCH_SIZE])

    def backend(self) -> str:
        return self._settings[BALLISTA_BACKEND]

    def stage_fusion(self) -> bool:
        return self._settings[BALLISTA_STAGE_FUSION].lower() in ("1", "true", "yes")

    def shuffle_codec(self) -> str:
        c = self._settings[BALLISTA_SHUFFLE_CODEC].strip().lower()
        if c in ("", "none", "off"):
            return ""
        if c not in ("zstd", "lz4"):
            raise ValueError(f"unsupported shuffle codec {c!r} (zstd|lz4)")
        return c

    def shuffle_partitions(self) -> int:
        return int(self._settings[BALLISTA_SHUFFLE_PARTITIONS])

    def shuffle_tier(self) -> str:
        """Where shuffle pieces live: "local" (executor work dirs, peer-
        served over Flight) or "shared" (the disaggregated storage tier,
        ISSUE 15)."""
        t = self._settings[BALLISTA_SHUFFLE_TIER].strip().lower()
        if t not in ("local", "shared"):
            raise ValueError(f"unknown shuffle tier {t!r} (local|shared)")
        return t

    def shuffle_dir(self) -> str:
        """Expanded shared-storage root for the "shared" shuffle tier;
        "" = unset (required when the tier is shared)."""
        import os

        d = self._settings[BALLISTA_SHUFFLE_DIR].strip()
        return os.path.expanduser(d) if d else ""

    def shuffle_storage_root(self) -> str:
        """The shared-storage root when the shared tier is ACTIVE, else "".
        The one check writers/readers consult: a shared tier without a
        configured directory is a misconfiguration and raises here (never
        silently degrades to local — the operator asked for durability)."""
        if self.shuffle_tier() != "shared":
            return ""
        d = self.shuffle_dir()
        if not d:
            raise ValueError(
                "ballista.shuffle.tier=shared requires ballista.shuffle.dir"
            )
        return d

    def fleet_min(self) -> int:
        """Autoscaler floor (ISSUE 15): the fleet never drains below this."""
        return max(1, int(self._settings[BALLISTA_FLEET_MIN]))

    def fleet_max(self) -> int:
        """Autoscaler ceiling; 0 disables autoscaling (fixed fleet)."""
        return max(0, int(self._settings[BALLISTA_FLEET_MAX]))

    def fleet_interval_s(self) -> float:
        """Seconds between autoscaler evaluations."""
        return max(0.05, float(self._settings[BALLISTA_FLEET_INTERVAL_S]))

    def fleet_target_backlog_s(self) -> float:
        """Predicted backlog seconds one evaluation tolerates before the
        fleet grows (also the growth denominator)."""
        return max(
            1e-3, float(self._settings[BALLISTA_FLEET_TARGET_BACKLOG_S])
        )

    def device_cache(self) -> bool:
        return self._settings[BALLISTA_DEVICE_CACHE].lower() in ("1", "true", "yes")

    def scan_cache(self) -> bool:
        return self._settings[BALLISTA_SCAN_CACHE].lower() in ("1", "true", "yes")

    def scan_cache_cap(self) -> int:
        return int(self._settings[BALLISTA_SCAN_CACHE_CAP])

    def tpu_per_op(self) -> bool:
        return self._settings[BALLISTA_TPU_PER_OP].lower() in ("1", "true", "yes")

    def tpu_device_join(self) -> bool:
        return self._settings[BALLISTA_TPU_DEVICE_JOIN].lower() in ("1", "true", "yes")

    def tpu_fuse_volatile(self) -> bool:
        return self._settings[BALLISTA_TPU_FUSE_VOLATILE].lower() in ("1", "true", "yes")

    def tpu_spmd(self) -> bool:
        return self._settings[BALLISTA_TPU_SPMD].lower() in ("1", "true", "yes")

    def tpu_coalesce_aggregates(self) -> bool:
        v = self._settings[BALLISTA_TPU_COALESCE_AGG].strip().lower()
        if v == "auto":
            return self.backend() == "cuda" and not self.tpu_spmd()
        return v in ("1", "true", "yes")

    def tpu_coalesce_max_bytes(self) -> int:
        return int(self._settings[BALLISTA_TPU_COALESCE_MAX])

    def tpu_layout_cache_dir(self) -> str:
        """Expanded layout-cache directory; "" = persistence disabled."""
        import os

        d = self._settings[BALLISTA_TPU_LAYOUT_CACHE_DIR].strip()
        return os.path.expanduser(d) if d else ""

    def tpu_layout_cache_cap(self) -> int:
        return int(self._settings[BALLISTA_TPU_LAYOUT_CACHE_CAP])

    def tpu_sorted_kernel(self) -> str:
        k = self._settings[BALLISTA_TPU_SORTED_KERNEL].strip().lower()
        if k not in ("layout", "pallas"):
            raise ValueError(f"unknown sorted kernel {k!r} (layout|pallas)")
        return k

    def tpu_hbm_budget(self) -> int:
        return int(self._settings[BALLISTA_TPU_HBM_BUDGET])

    def tpu_exchange(self) -> bool:
        """HBM-resident cross-stage exchange tier (ISSUE 16)."""
        return self._settings[BALLISTA_TPU_EXCHANGE].lower() in (
            "1", "true", "yes"
        )

    def residency_budget(self) -> int:
        """Byte budget for registered exchange pieces per executor."""
        return int(self._settings[BALLISTA_TPU_RESIDENCY_BUDGET])

    def tpu_ingest_workers(self) -> int:
        """Prefetch-stage worker threads; 0 = serial ingest (no threads)."""
        return max(0, int(self._settings[BALLISTA_TPU_INGEST_WORKERS]))

    def tpu_ingest_depth(self) -> int:
        """Bound on prefetched items in flight (host-RSS cap)."""
        return max(1, int(self._settings[BALLISTA_TPU_INGEST_DEPTH]))

    def max_task_retries(self) -> int:
        """Requeues allowed per task before the job fails (0 = reference
        behavior: first failure kills the job)."""
        return max(0, int(self._settings[BALLISTA_MAX_TASK_RETRIES]))

    def tenant(self) -> str:
        """Submitting tenant name; "" = the default (unnamed) tenant."""
        return self._settings[BALLISTA_TENANT].strip()

    def tenant_priority(self) -> int:
        """Per-job priority within the tenant (higher schedules first)."""
        return max(0, int(self._settings[BALLISTA_TENANT_PRIORITY]))

    def tenant_max_inflight(self) -> int:
        """Per-tenant in-flight task quota (0 = unlimited)."""
        return max(0, int(self._settings[BALLISTA_TENANT_MAX_INFLIGHT]))

    def tenant_weights(self) -> Dict[str, int]:
        """Fair-share weights parsed from "alice:4,bob:1"; absent -> 1."""
        out: Dict[str, int] = {}
        for part in self._settings[BALLISTA_TENANT_WEIGHTS].split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.rpartition(":")
            if not name:
                raise ValueError(
                    f"bad {BALLISTA_TENANT_WEIGHTS} entry {part!r} "
                    "(expected tenant:weight)"
                )
            out[name.strip()] = max(1, int(w))
        return out

    def tenant_slos(self) -> Dict[str, float]:
        """Per-tenant latency SLO deadlines in ms parsed from
        "alice:250,bob:2000"; absent -> no SLO for that tenant."""
        out: Dict[str, float] = {}
        for part in self._settings[BALLISTA_TENANT_SLO_MS].split(","):
            part = part.strip()
            if not part:
                continue
            name, _, ms = part.rpartition(":")
            if not name:
                raise ValueError(
                    f"bad {BALLISTA_TENANT_SLO_MS} entry {part!r} "
                    "(expected tenant:milliseconds)"
                )
            out[name.strip()] = max(1.0, float(ms))
        return out

    def speculation(self) -> bool:
        """Speculative duplicate attempts for cost-model-flagged stragglers
        (ISSUE 11)."""
        return self._settings[BALLISTA_SPECULATION].lower() in ("1", "true", "yes")

    def speculation_multiplier(self) -> float:
        """Slack factor over the predicted task cost before a RUNNING task
        counts as a straggler."""
        return max(1.0, float(self._settings[BALLISTA_SPECULATION_MULTIPLIER]))

    def speculation_min_runtime_s(self) -> float:
        """Minimum elapsed seconds before any task may speculate — cheap
        tasks never do."""
        return max(
            0.0, float(self._settings[BALLISTA_SPECULATION_MIN_RUNTIME_MS])
        ) / 1000.0

    def speculation_max_attempts(self) -> int:
        """Most speculative duplicates one task may accumulate (ISSUE 15
        satellite): past the first, only a duplicate that itself straggles
        earns a successor. Minimum 1 (the launch-once behavior)."""
        return max(1, int(self._settings[BALLISTA_SPECULATION_MAX_ATTEMPTS]))

    def shared_scan(self) -> bool:
        """Shared-scan multi-query batching (ISSUE 13): concurrent jobs'
        compatible fused-aggregate stages dispatch as one batched task."""
        return self._settings[BALLISTA_SHARED_SCAN].lower() in ("1", "true", "yes")

    def shared_scan_max_batch(self) -> int:
        """Most member tasks per batched dispatch (minimum 2)."""
        return max(2, int(self._settings[BALLISTA_SHARED_SCAN_MAX_BATCH]))

    def push_status(self) -> bool:
        """Client-side server-push job-status notifications (ISSUE 11)."""
        return self._settings[BALLISTA_PUSH_STATUS].lower() in ("1", "true", "yes")

    def result_cache(self) -> bool:
        return self._settings[BALLISTA_RESULT_CACHE].lower() in ("1", "true", "yes")

    def result_cache_max_entries(self) -> int:
        """Live result-cache entry cap (0 = unbounded)."""
        return max(0, int(self._settings[BALLISTA_RESULT_CACHE_MAX_ENTRIES]))

    def result_cache_ttl_s(self) -> float:
        """Result-cache entry time-to-live in seconds (0 = no expiry)."""
        return max(0.0, float(self._settings[BALLISTA_RESULT_CACHE_TTL_S]))

    def cache_advance(self) -> bool:
        """Result-cache delta advancement over grown scan-file sets
        (ISSUE 19). Requires the result cache itself."""
        return self._settings[BALLISTA_CACHE_ADVANCE].lower() in ("1", "true", "yes")

    def tenant_residency_budget(self) -> int:
        """Per-tenant exchange-registry residency cap in bytes (0 =
        unlimited; ISSUE 19 satellite)."""
        return max(0, int(self._settings[BALLISTA_TENANT_RESIDENCY_BUDGET]))

    def plan_cache(self) -> bool:
        return self._settings[BALLISTA_PLAN_CACHE].lower() in ("1", "true", "yes")

    def push_dispatch(self) -> bool:
        """Push-based task dispatch over SubscribeWork (ISSUE 8)."""
        return self._settings[BALLISTA_PUSH_DISPATCH].lower() in ("1", "true", "yes")

    def idle_poll_max_s(self) -> float:
        """Ceiling of the adaptive idle-poll backoff while the push stream
        is healthy; the floor is the 250ms reference interval."""
        return max(0.25, float(self._settings[BALLISTA_IDLE_POLL_MAX_S]))

    def tpu_aot_cache_dir(self) -> str:
        """Expanded AOT program-cache directory; "" = disabled."""
        import os

        d = self._settings[BALLISTA_TPU_AOT_CACHE_DIR].strip()
        return os.path.expanduser(d) if d else ""

    def tpu_prewarm(self) -> bool:
        """Load + compile every AOT-cache manifest entry at executor start."""
        return self._settings[BALLISTA_TPU_PREWARM].lower() in ("1", "true", "yes")

    def stream_results(self) -> bool:
        """Client-side streaming result fetch (ISSUE 8)."""
        return self._settings[BALLISTA_STREAM_RESULTS].lower() in ("1", "true", "yes")

    def tpu_cost_model(self) -> bool:
        """Adaptive execution (ISSUE 10): measured-cost routing on top of
        the static decline ladder. False = pure static ladder."""
        return self._settings[BALLISTA_TPU_COST_MODEL].lower() in ("1", "true", "yes")

    def tpu_cost_model_dir(self) -> str:
        """Expanded cost-store directory; "" = in-memory only."""
        import os

        d = self._settings[BALLISTA_TPU_COST_MODEL_DIR].strip()
        return os.path.expanduser(d) if d else ""

    def rpc_retries(self) -> int:
        """Transient-RPC retry attempts beyond the first call."""
        return max(0, int(self._settings[BALLISTA_RPC_RETRIES]))

    def rpc_backoff_s(self) -> float:
        """Jittered-exponential backoff base, in seconds."""
        return max(0.0, float(self._settings[BALLISTA_RPC_BACKOFF_MS])) / 1000.0

    def scheduler_lease_ttl_s(self) -> float:
        """Job-ownership lease TTL (ISSUE 20); the failover detection bound."""
        ttl = float(self._settings[BALLISTA_SCHEDULER_LEASE_TTL_S])
        if ttl <= 0:
            raise ValueError(
                f"ballista.scheduler.lease_ttl_s must be > 0, got {ttl}"
            )
        return ttl

    def debug_lock_witness(self) -> bool:
        # ISSUE 14: arm the dynamic lock-order witness (utils/locks.py)
        return self._settings[BALLISTA_DEBUG_LOCK_WITNESS].lower() in ("1", "true", "yes")

    def chaos_seed(self) -> int:
        return int(self._settings[BALLISTA_CHAOS_SEED])

    def chaos_rate(self) -> float:
        r = float(self._settings[BALLISTA_CHAOS_RATE])
        if not 0.0 <= r <= 1.0:
            raise ValueError(f"ballista.chaos.rate must be in [0, 1], got {r}")
        return r

    def chaos_slow_ms(self) -> float:
        """Injected straggler delay for the task.slow chaos site."""
        return max(0.0, float(self._settings[BALLISTA_CHAOS_SLOW_MS]))

    def chaos_sites(self):
        """Enabled injection sites; [] = all registered sites."""
        return [
            s.strip()
            for s in self._settings[BALLISTA_CHAOS_SITES].split(",")
            if s.strip()
        ]

    def data_roots(self):
        """Directory allowlist for wire-plan scan paths; [] = unrestricted."""
        return [
            r.strip()
            for r in self._settings[BALLISTA_DATA_ROOTS].split(",")
            if r.strip()
        ]

    def mesh_shape(self) -> Dict[str, int]:
        """Parse "data:4,model:2" into {"data": 4, "model": 2}."""
        out: Dict[str, int] = {}
        for part in self._settings[BALLISTA_MESH_SHAPE].split(","):
            part = part.strip()
            if not part:
                continue
            name, _, n = part.partition(":")
            out[name.strip()] = int(n)
        return out

    def explicit_settings(self) -> Dict[str, str]:
        """Settings that differ from the defaults — what a client should
        transmit per job so it overrides only what the user actually set
        (sending the full map would clobber executor-local tuning with
        client-side defaults)."""
        return {
            k: v
            for k, v in self._settings.items()
            if DEFAULT_SETTINGS.get(k) != v
        }

    def with_setting(self, key: str, value: str) -> "BallistaConfig":
        s = dict(self._settings)
        s[key] = value
        return BallistaConfig(s)

    def to_dict(self) -> Dict[str, str]:
        return dict(self._settings)

    def __repr__(self) -> str:
        return f"BallistaConfig({self._settings!r})"
