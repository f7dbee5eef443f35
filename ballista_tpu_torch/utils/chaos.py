"""Deterministic fault-injection harness.

At "heavy traffic from millions of users" scale, transient executor death
and flaky fetches are the steady state — the recovery machinery
(scheduler/state.py retries + lineage recompute, rpc backoff) must be
exercisable in CI without wall-clock or RNG flake. Every injection point is

- **registered**: a site name from SITES, checked at call time (and by the
  ballista-lint failure-discipline rule: no ad-hoc `random` raises);
- **site-addressable**: enabled per-site via ``ballista.chaos.sites``;
- **deterministic**: the verdict for (seed, site, key) is a pure function —
  sha256 of the triple against ``ballista.chaos.rate`` — so a chaos run is
  reproducible regardless of thread interleaving, and retried attempts
  rotate the key (attempt number is part of it) to draw a fresh verdict.

Wired through the existing seams (TaskContext/config plumbing), never by
monkeypatching: chaos tests run whole SQL jobs under injected faults and
assert results are bit-identical to the fault-free run.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Optional

from ballista_tpu_torch.errors import RpcError
from ballista_tpu_torch.utils import counters

log = logging.getLogger("ballista.chaos")

# The registered injection sites. Adding a site means adding it HERE first;
# call sites naming anything else raise (and fail ballista-lint).
SITES = (
    "flight.fetch",          # shuffle piece fetch (distributed/stages.py)
    "rpc.call",              # scheduler gRPC client call (scheduler/rpc.py)
    "task.execute",          # task execution on the executor (execution_loop.py)
    "kv.put",                # scheduler KV write (scheduler/state.py)
    "executor.death",        # executor hard-death (execution_loop.py run loop)
    "scheduler.plan_write",  # staged planning write (scheduler/state.py
                             # JobPlanBatch) — aborts the whole atomic plan
                             # publish; planning retries with a rotated key
    "scheduler.crash",       # scheduler hard-death mid-PollWork
                             # (scheduler/server.py) — keyed on the accepted-
                             # status sequence so the crash lands mid-job
    "cache.put",             # result-cache publish (scheduler/state.py) —
                             # tears the cache write of a completed job; the
                             # job still completes (the cache is best-effort)
                             # and later identical queries just miss
    "scheduler.admit",       # admission decision (scheduler/state.py
                             # assignment) — aborts the PollWork handing a
                             # task out BEFORE the Running flip; the executor
                             # retries its poll and the next admission draws
                             # a fresh verdict (rotated sequence key)
    "scheduler.push",        # push-dispatch delivery (scheduler/server.py
                             # pump) — the assignment is ALREADY written when
                             # the delivery is torn, and the subscriber's
                             # stream is killed with it: exactly a stream
                             # drop after the Running flip. The executor
                             # falls back to polling + re-subscribes; the
                             # undelivered task requeues through the
                             # orphaned-assignment grace reconciliation.
    "aot.load",              # AOT program-cache disk load (ops/aotcache.py)
                             # — a torn load is recorded with a reason and
                             # falls back to a fresh trace/compile, like a
                             # corrupted or version-mismatched artifact
    "scheduler.batch",       # shared-scan batch formation (ISSUE 13,
                             # scheduler/state.py form_shared_batch): tears
                             # the grouping BEFORE any sibling's Running
                             # flip is written, so the primary dispatches
                             # SOLO — a degraded (unbatched) dispatch, never
                             # a torn one. Results are bit-identical by
                             # construction; keyed on a generation-rotated
                             # per-process sequence so a restarted scheduler
                             # draws fresh verdicts.
    "shuffle.store",         # shared-shuffle-storage tier (ISSUE 15,
                             # distributed/stages.py). Two seams, both keyed
                             # on plan coordinates + attempt: a WRITE verdict
                             # tears the atomic publish of a map task's piece
                             # set (the task fails and retries — a retried
                             # attempt draws fresh), and a READ verdict makes
                             # a published piece unreadable from storage for
                             # that consuming attempt — the reader degrades
                             # down the fallback ladder (Flight peer fetch,
                             # then fetch_failed -> lineage recompute),
                             # bit-identical by construction.
    "fleet.scale",           # autoscaler decision (ISSUE 15,
                             # executor/runtime.py): a torn verdict skips
                             # that evaluation's scale action entirely — the
                             # fleet stays at its current size and the next
                             # evaluation draws fresh (sequence-keyed). Never
                             # tears a drain mid-way: the decision aborts
                             # BEFORE any executor is touched.
    "exchange.evict",        # HBM-resident exchange registry (ISSUE 16,
                             # distributed/stages.py). A verdict at CONSUME
                             # time — keyed on plan coordinates + the
                             # consuming attempt, like flight.fetch — evicts
                             # the produced-but-not-yet-consumed registry
                             # entry, rehearsing "residency lost between
                             # produce and consume": the reader silently
                             # falls through to the authoritative piece
                             # (storage -> Flight peer -> lineage ladder),
                             # bit-identical by construction and with ZERO
                             # task retries (nothing failed, only a cache
                             # went cold).
    "cache.advance",         # result-cache advancement publish (ISSUE 19,
                             # scheduler/state.py result_cache_put_advanced).
                             # Fires BEFORE any KV write, keyed on the
                             # advanced entry's result_key: a torn publish
                             # declines the advancement — the user job falls
                             # back to a FULL recompute through the ordinary
                             # planning path, so results stay bit-identical
                             # by construction (the fold is an accelerator,
                             # never the only correct path).
    "scheduler.lease",       # ownership-lease heartbeat renewal (ISSUE 20,
                             # scheduler/server.py housekeeping): a torn
                             # renewal round skips renewing this replica's
                             # job leases, rehearsing a stalled heartbeat —
                             # the leases may expire and a peer may adopt
                             # the jobs mid-flight. Safe BY FENCING: the
                             # deposed owner's later writes carry the stale
                             # lease value and are rejected by the CAS in
                             # put_all, so a spurious expiry costs at most
                             # an ownership migration, never corruption.
                             # Keyed on a generation-rotated per-process
                             # renewal-round sequence (g{gen}/renew{n}).
    "kv.lease",              # lease write/renew KV op (ISSUE 20,
                             # scheduler/state.py lease mint + renewal
                             # seam): the op itself fails as if the store
                             # dropped the request — a torn MINT aborts the
                             # planning commit (retried like kv.put), a
                             # torn RENEWAL is indistinguishable from
                             # scheduler.lease's stalled round. Keyed like
                             # kv.put on a generation-rotated per-process
                             # op sequence.
    "task.slow",             # deterministic straggler injection (ISSUE 11,
                             # execution_loop.py): a task whose (stage,
                             # partition, attempt) coordinate draws a slow
                             # verdict sleeps ballista.chaos.slow_ms before
                             # executing — the seeded tail the speculation
                             # subsystem must beat. Non-raising: the task
                             # still completes correctly, just late, so
                             # results stay bit-identical by construction.
)

_DENOM = float(1 << 64)


class ChaosInjected(RpcError):
    """Synthetic fault raised by a registered injection site. Subclasses
    RpcError so transport-shaped seams treat it exactly like the real
    failure they are rehearsing."""

    def __init__(self, site: str, key: str) -> None:
        super().__init__(f"chaos[{site}] injected fault (key={key})")
        self.site = site
        self.key = key


class ChaosInjector:
    """Seeded, site-addressable fault decisions (see module docstring)."""

    def __init__(self, seed: int, rate: float, sites=None) -> None:
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"chaos rate must be in [0, 1], got {rate}")
        unknown = set(sites or ()) - set(SITES)
        if unknown:
            raise ValueError(
                f"unregistered chaos sites {sorted(unknown)}; known: {SITES}"
            )
        self.seed = int(seed)
        self.rate = float(rate)
        self.sites = frozenset(sites) if sites else frozenset(SITES)

    def should_inject(self, site: str, key: str) -> bool:
        """Deterministic verdict for (seed, site, key); no state mutated."""
        if site not in SITES:
            raise ValueError(f"unregistered chaos site {site!r}; known: {SITES}")
        if site not in self.sites or self.rate <= 0.0:
            return False
        h = hashlib.sha256(f"{self.seed}:{site}:{key}".encode()).digest()
        return int.from_bytes(h[:8], "big") / _DENOM < self.rate

    def maybe_fail(self, site: str, key: str) -> None:
        """Raise ChaosInjected iff should_inject — the one raising seam."""
        if self.should_inject(site, key):
            counters.recovery.record("chaos_injected")
            log.warning("chaos[%s] injecting fault (key=%s)", site, key)
            raise ChaosInjected(site, key)


def chaos_from_config(config) -> Optional[ChaosInjector]:
    """Build an injector from ballista.chaos.* settings; None when disarmed
    (rate == 0) so hot paths stay a single attribute check."""
    rate = config.chaos_rate()
    if rate <= 0.0:
        return None
    return ChaosInjector(config.chaos_seed(), rate, config.chaos_sites())
