"""HBM-resident cross-stage exchange registry (ISSUE 16).

When a shuffle-write task completes, the executor ALSO registers the piece
batches it just published in this in-process, byte-budgeted registry — the
Arrow piece on disk/shared storage remains the authoritative fault-tolerant
home, written exactly as before. A consuming shuffle reader on the SAME
executor then resolves the piece straight from the registry: zero IPC
decode, zero h2d re-upload. Anything else — eviction, budget pressure, a
chaos verdict, executor death (evict_executor drops a stopped or dead
executor's entries) — falls through silently to the existing storage ->
Flight peer -> lineage ladder, so bit-identity to the un-exchanged pipeline
holds at every decision point.

On this (CPU) image the registered entries are the host-side Arrow batches
the piece holds; on a device image the entry would additionally pin the
stage's device tiles (pod/ICI exchange is the ROADMAP residue). Entries are
keyed by (executor_id, job, stage, map partition, piece) — executor_id
because a StandaloneCluster runs several executors in one process, and a
piece is only "local" to the executor that produced it. The newest attempt
wins on re-publish: every attempt of a task produces bit-identical output
(the repo-wide invariant speculation already relies on), so any attempt's
entry is a valid serve.

Eviction under ``ballista.tpu.residency_budget_bytes`` is cost-model-gated
(ISSUE 16 tentpole): an incomer only displaces colder entries when its
predicted transfer saving — bytes priced at the OBSERVED h2d + readback
rates (ops/costmodel.py), bytes-proportional when cold — exceeds what the
evicted victims would have saved. Rates are read BEFORE the registry lock
is taken, so ``ops.exchange._reg_lock`` stays a leaf lock.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import pyarrow as pa

from ballista_tpu_torch.utils import counters
from ballista_tpu_torch.utils.locks import make_lock

_reg_lock = make_lock("ops.exchange._reg_lock")
# (executor_id, job_id, stage_id, map_partition, piece) -> _Entry
_entries: Dict[Tuple[str, str, int, int, int], "_Entry"] = {}  # guarded-by: _reg_lock
# published piece path -> entry key, for the Flight service's path-keyed
# FetchPartition lookups; guarded-by: _reg_lock
_by_path: Dict[str, Tuple[str, str, int, int, int]] = {}
_total_bytes: int = 0  # guarded-by: _reg_lock
# tenant -> resident bytes (ISSUE 19 satellite): the per-tenant half of
# the budget ledger, kept exactly in sync with _entries by every mutation
_tenant_bytes: Dict[str, int] = {}  # guarded-by: _reg_lock


class _Entry:
    __slots__ = ("batches", "schema", "nbytes", "attempt", "path",
                 "saving_s", "last_used", "tenant")

    def __init__(self, batches: List[pa.RecordBatch], schema: pa.Schema,
                 nbytes: int, attempt: int, path: str,
                 saving_s: float, tenant: str = "") -> None:
        self.batches = batches
        self.schema = schema
        self.nbytes = nbytes
        self.attempt = attempt
        self.path = path
        # predicted transfer seconds a serve of this entry avoids, priced
        # at publish time (entries carry it so eviction never has to call
        # into the cost model while holding the leaf _reg_lock)
        self.saving_s = saving_s
        self.last_used = time.monotonic()
        self.tenant = tenant


# holds-lock: _reg_lock
def _drop_entry_locked(key: Tuple[str, str, int, int, int]) -> "_Entry":
    """Remove one entry and settle BOTH byte ledgers (global + tenant)."""
    global _total_bytes
    e = _entries.pop(key)
    _by_path.pop(e.path, None)
    _total_bytes -= e.nbytes
    if e.tenant in _tenant_bytes:
        _tenant_bytes[e.tenant] -= e.nbytes
        if _tenant_bytes[e.tenant] <= 0:
            del _tenant_bytes[e.tenant]
    return e


def predicted_transfer_saving_s(nbytes: int) -> float:
    """Seconds of transfer a registry serve of `nbytes` avoids: one decode+
    re-upload (h2d-shaped) on the consumer plus one readback-shaped re-read
    on the producer side, priced at the cost model's OBSERVED per-bucket
    rates (ops/costmodel.py, bytes units — the same store upload_array and
    readback feed). Cold model: a nominal bytes-proportional rate (10 GB/s)
    so the keep/evict and locality decisions still order by size instead of
    collapsing to zero."""
    from ballista_tpu_torch.ops import costmodel

    fallback = float(nbytes) / (10 * 1024**3)
    h2d = costmodel.predict("h2d", float(nbytes))
    rb = costmodel.predict("readback", float(nbytes))
    return (h2d if h2d is not None else fallback) + (
        rb if rb is not None else fallback
    )


def publish(executor_id: str, job_id: str, stage_id: int, map_partition: int,
            piece: int, batches: List[pa.RecordBatch], schema: pa.Schema,
            attempt: int, path: str, budget: int,
            tenant: str = "", tenant_budget: int = 0) -> bool:
    """Register one published piece's batches; returns whether it was kept.

    Called only AFTER the authoritative os.replace publish, so the registry
    never advertises bytes the piece ladder cannot also produce. Under
    budget pressure the incomer displaces least-recently-used entries only
    when its predicted transfer saving exceeds the victims' combined saving
    — otherwise it is skipped and the consumer pays the ordinary ladder.

    ``tenant_budget`` > 0 caps this TENANT's resident bytes (ISSUE 19
    satellite), enforced BEFORE the global budget with the same
    cost-gated LRU policy restricted to the tenant's own entries — one
    tenant's giant shuffle evicts its own cold pieces first and can
    never displace another tenant's to fit itself.
    """
    nbytes = sum(b.nbytes for b in batches)
    if nbytes <= 0 or nbytes > budget or (
        0 < tenant_budget < nbytes
    ):
        counters.exchange.record("skipped_budget")
        return False
    # price the incomer BEFORE the lock: _reg_lock is a leaf and must not
    # reach into the cost model while held
    saving = predicted_transfer_saving_s(nbytes)
    key = (executor_id, job_id, int(stage_id), int(map_partition), int(piece))
    evicted = 0
    tenant_evicted = 0
    kept = True
    with _reg_lock:
        # leaf lock: nothing else (counters included) is taken while held
        global _total_bytes
        if key in _entries:
            # re-publish (retry/speculative duplicate): newest attempt wins
            _drop_entry_locked(key)

        def lru_plan(pool, need):
            """(victim keys, freed, their saving) — LRU-first over pool."""
            victims = sorted(pool, key=lambda kv: kv[1].last_used)
            freed, victim_saving, victim_keys = 0, 0.0, []
            for vk, ve in victims:
                if freed >= need:
                    break
                victim_keys.append(vk)
                freed += ve.nbytes
                victim_saving += ve.saving_s
            return victim_keys, freed, victim_saving

        # per-tenant cap first: the tenant may only displace ITSELF
        if tenant_budget > 0:
            t_need = _tenant_bytes.get(tenant, 0) + nbytes - tenant_budget
            if t_need > 0:
                own = [kv for kv in _entries.items() if kv[1].tenant == tenant]
                victim_keys, freed, victim_saving = lru_plan(own, t_need)
                if freed < t_need or victim_saving > saving:
                    kept = False
                else:
                    for vk in victim_keys:
                        _drop_entry_locked(vk)
                        tenant_evicted += 1
        if kept:
            need = _total_bytes + nbytes - budget
            if need > 0:
                victim_keys, freed, victim_saving = lru_plan(
                    _entries.items(), need
                )
                if freed < need or victim_saving > saving:
                    # cannot fit, or the victims' predicted transfer saving
                    # (priced at the observed h2d/readback rates when they
                    # published) exceeds the incomer's: keep what is warm
                    kept = False
                else:
                    for vk in victim_keys:
                        _drop_entry_locked(vk)
                        evicted += 1
        if kept:
            entry = _Entry(list(batches), schema, nbytes, attempt, path,
                           saving, tenant)
            _entries[key] = entry
            _by_path[path] = key
            _total_bytes += nbytes
            _tenant_bytes[tenant] = _tenant_bytes.get(tenant, 0) + nbytes
    if not kept:
        counters.exchange.record("skipped_budget")
        return False
    if tenant_evicted:
        counters.exchange.record("evicted_tenant_budget", tenant_evicted)
    if evicted:
        counters.exchange.record("evicted_budget", evicted)
    counters.exchange.record("published")
    counters.exchange.record("publish_bytes", nbytes)
    return True


def resolve(executor_id: str, job_id: str, stage_id: int, map_partition: int,
            piece: int) -> Optional[Tuple[List[pa.RecordBatch], int]]:
    """(batches, nbytes) when this executor holds the piece, else None.
    Counters are the CALLER's job — the consumer and the Flight service
    account a hit differently (h2d vs d2h saved)."""
    key = (executor_id, job_id, int(stage_id), int(map_partition), int(piece))
    with _reg_lock:
        e = _entries.get(key)
        if e is None:
            return None
        e.last_used = time.monotonic()
        return list(e.batches), e.nbytes


def resolve_path(path: str) -> Optional[Tuple[pa.Schema, List[pa.RecordBatch], int]]:
    """(schema, batches, nbytes) for a published piece path, else None —
    the Flight service's FetchPartition fast path (tickets carry paths,
    not plan coordinates)."""
    with _reg_lock:
        key = _by_path.get(path)
        if key is None:
            return None
        e = _entries[key]
        e.last_used = time.monotonic()
        return e.schema, list(e.batches), e.nbytes


def evict(executor_id: str, job_id: str, stage_id: int, map_partition: int,
          piece: int) -> bool:
    """Drop one entry (the exchange.evict chaos seam); True if it existed."""
    key = (executor_id, job_id, int(stage_id), int(map_partition), int(piece))
    with _reg_lock:
        if key not in _entries:
            return False
        _drop_entry_locked(key)
    return True


def _evict_where(field: int, value: str) -> int:
    """Drop every entry whose key holds `value` at `field`."""
    with _reg_lock:
        keys = [k for k in _entries if k[field] == value]
        for key in keys:
            _drop_entry_locked(key)
    return len(keys)


def evict_job(job_id: str) -> int:
    """Drop every entry of one job (the executor's TTL sweep rides this
    when it removes the job's work dir)."""
    return _evict_where(1, job_id)


def evict_executor(executor_id: str) -> int:
    """Drop every entry one executor published: once it stops or dies its
    Flight service is gone and no other executor resolves its keys, so the
    entries could only hold budget bytes (a StandaloneCluster keeps the
    registry alive across its executors' deaths)."""
    return _evict_where(0, executor_id)


def attempt_of(executor_id: str, job_id: str, stage_id: int,
               map_partition: int, piece: int) -> Optional[int]:
    """The registered attempt for one entry (tests pin newest-attempt-wins
    across speculation promotion)."""
    key = (executor_id, job_id, int(stage_id), int(map_partition), int(piece))
    with _reg_lock:
        e = _entries.get(key)
        return None if e is None else e.attempt


def stage_resident(executor_id: str, job_id: str, stage_id: int,
                   map_partition: int) -> bool:
    """Whether ANY piece of this map task's output is registered here —
    the `resident` hint the executor advertises on its CompletedTask."""
    with _reg_lock:
        return any(
            k[0] == executor_id and k[1] == job_id
            and k[2] == int(stage_id) and k[3] == int(map_partition)
            for k in _entries
        )


def resident_bytes() -> int:
    with _reg_lock:
        return _total_bytes


def tenant_resident_bytes(tenant: str) -> int:
    """One tenant's share of the registry (tests + budget observability)."""
    with _reg_lock:
        return _tenant_bytes.get(tenant, 0)


def reset() -> None:
    """Drop everything (tests)."""
    with _reg_lock:
        global _total_bytes
        _entries.clear()
        _by_path.clear()
        _tenant_bytes.clear()
        _total_bytes = 0
