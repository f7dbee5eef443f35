"""The port's event counters: one class, one named set per concern.

Every layer counts here (the scheduler, the client, the executors, the
device stages and the kernels), so the module imports nothing of the
package but `utils.locks` and any module may import it at module top:

    from ballista_tpu_torch.utils import counters

    counters.recovery.record("task_retry")

A set is in-process: a standalone cluster runs the scheduler, its
executors and the client in one process and counts them all here;
separate daemons each count their own share. The event names and their
meanings are the JAX package's (its ops/runtime.py counters).
`ops.runtime` reads each set under its `<set>_stats(reset)` name, with the
dict shape it has always returned; `utils.tracing.counters()` reads
`named`."""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, Mapping, Optional

from ballista_tpu_torch.utils.locks import make_lock


class Counts:
    """event -> count behind its own lock (one lock class for every set).
    `whole` sets add int(n) in `record`; the others add n as given
    (seconds, gauges). `zero` names the keys a set reports before anything
    was recorded, and what a reset restores."""

    def __init__(self, whole: bool = True,
                 zero: Optional[Mapping[Hashable, float]] = None) -> None:
        self._counts_lock = make_lock("utils.counters._counts_lock")
        self._zero = dict(zero or {})
        self._counts: Dict[Hashable, float] = dict(self._zero)  # guarded-by: self._counts_lock
        self._whole = whole

    def record(self, event: Hashable, n: float = 1) -> None:
        with self._counts_lock:
            self._counts[event] = self._counts.get(event, 0) + (int(n) if self._whole else n)

    def add(self, deltas: Mapping[Hashable, float]) -> None:
        """Add several counts, as given, under one acquisition."""
        with self._counts_lock:
            for k, n in deltas.items():
                self._counts[k] = self._counts.get(k, 0) + n

    def set(self, name: Hashable, value: float) -> None:
        with self._counts_lock:
            self._counts[name] = value

    def gauge(self, name: str, value: float) -> None:
        """Overwrite a gauge, keeping its `_peak` sibling."""
        with self._counts_lock:
            self._counts[name] = value
            peak = f"{name}_peak"
            self._counts[peak] = max(self._counts.get(peak, value), value)

    def stats(self, reset: bool = False) -> Dict[Hashable, float]:
        with self._counts_lock:
            out = dict(self._counts)
            if reset:
                self._counts = dict(self._zero)
        return out

    def grouped(self, parts: Iterable[str], reset: bool = False) -> Dict[str, object]:
        """stats() of a set keyed (part, name): {part: {name: n}} for every
        part in `parts`, empty ones included; a plain key stays as it is."""
        out: Dict[str, object] = {p: {} for p in parts}
        for key, n in self.stats(reset).items():
            if isinstance(key, tuple):
                out[key[0]][key[1]] = n
            else:
                out[key] = n
        return out


# recovery work after injected or real faults (task_retry,
# result_partition_restarted, scheduler_restart, ...)
recovery = Counts()
# multi-tenant serving: result-cache hits / misses / puts / invalidations,
# plan-cache hits, admission quota deferrals
tenancy = Counts()
# shared-scan batches: scheduler-side formation (batches_formed,
# batched_stages, ...) and the executor's solo members (member_solo)
shared_scan = Counts()
# disaggregated shuffle tier: storage_publish / local_publish, storage_fetch
# / peer_fetch, storage_fallback_peer, storage_publish_torn
shuffle_tier = Counts()
# the exchange registry (ops/exchange.py): published / publish_bytes,
# reupload_skipped / h2d_bytes_saved, served_from_registry /
# d2h_bytes_saved, skipped_budget / evicted_budget, evicted_chaos,
# locality_preferred, miss
exchange = Counts()
# speculative execution: launched / won / lost / failed / promoted /
# orphaned / executor_lost, wasted_seconds (a float), slo_misses / slo_met
speculation = Counts(whole=False)
# elastic fleet: scale_up / scale_down / drain_* counts and the fleet_size /
# backlog_ms gauges with their _peak siblings
fleet = Counts(whole=False)
# serving and dispatch: the kernel libraries (ops/cuda_kernels.py:
# compile_hit_memory, compile_hit_disk, compile_prewarmed, kernel_built),
# the scheduler's dispatch (dispatch_push / dispatch_poll, task_pushed,
# push_subscribed, push_stream_drop, push_withdrawn), early streamed
# partitions (stream_partition_early) and the client's job-status pushes
# (status_push, status_push_subscribed / _closed / _rehomed)
serving = Counts()
# incremental execution over the chunk-set delta store (ops/stage.py):
# "chunks_reused", "chunks_prepared", "bytes_reprepared_saved",
# "save_declined_midappend"; and the result cache's advancement
# ("advance_hits", "advance_declined")
delta = Counts()
# ingest timings across stage prepares: scan_s = prefetch work (parquet
# read + dictionary decode + group ranking), encode_s = host narrow/encode,
# upload_s = h2d enqueue, wall_s = end-to-end prepare; reused = partitions
# a stage bound from another stage's resident layout instead of preparing
# (ops/stage.py::bind_or_prepare: no prepare, no wall time)
ingest = Counts(zero={"scan_s": 0.0, "encode_s": 0.0, "upload_s": 0.0,
                      "wall_s": 0.0, "prepares": 0, "reused": 0})
# device->host result readbacks (ops/runtime.py::readback): rows =
# trailing-axis length of each fetched result, bytes = transfer size,
# readbacks = transfer count; a readback tagged with a site also counts as
# "<site>.rows" / "<site>.bytes" / "<site>.readbacks" (the device join's
# are "join.*")
readback = Counts(zero={"rows": 0, "bytes": 0, "readbacks": 0})
# join-path outcomes, keyed ("paths", path) and ("reasons", "path: reason")
# (ops/runtime.py::record_join_path)
join_paths = Counts()
# the stage ladder's and the cost model's routing, keyed ("routes", route),
# ("reasons", reason), ("events", event), ("step_asides", reason) and
# ("costs", ...), beside the last h2d chunk size upload() picked
# (ops/runtime.py::routing_stats)
routing = Counts(zero={("costs", "predicted_s"): 0.0, ("costs", "observed_s"): 0.0,
                       ("costs", "predictions"): 0, ("costs", "mispredicts"): 0,
                       "h2d_chunk_bytes": 0})
# named program-path counters (utils/tracing.py::incr: spmd.mesh against
# spmd.host_declined, device.count_join, ...)
named = Counts()
