"""Arrow <-> device runtime: column lowering, dictionary encoding, narrowing,
padding, host->device upload and device->host readback on PyTorch tensors.

Data discipline (the JAX package's ``ops/runtime.py`` contract, kept):
- strings never reach the device as bytes: each string column is encoded to
  int32 codes against a per-scan growing dictionary; predicates on strings
  become code comparisons / table gathers; group keys aggregate over codes
  and decode at the end
- float64 narrows to float32, int64 narrows to int32 after a range check,
  date32 is int32 days
- device-bound columns are stored narrow (int8/int16, or uint8 codes plus an
  f32 lookup table) and widened at the top of every device step

Device placement is explicit: every upload names its ``torch.device``. There
is no global device state and no silent move to the CPU.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


class UnsupportedOnDevice(Exception):
    """Raised when a column/expr can't lower to the device path; callers
    fall back to the host Arrow kernels."""


class ColumnDictionary:
    """Growing per-column dictionary mapping values -> stable int32 codes.

    Thread-safe: executor task threads can run different partitions of one
    cached stage concurrently, and both prepare-time encode() and
    aux-build-time code_of() extend the dictionary (read-modify-write on
    `values`); an unguarded interleaving would silently re-assign codes
    already baked into pinned device columns."""

    def __init__(self) -> None:
        self.values: Optional[pa.Array] = None  # distinct values; guarded-by: self._lock
        self._lock = threading.Lock()

    def encode(self, arr: pa.Array) -> np.ndarray:
        with self._lock:
            return self._encode(arr)

    # holds-lock: self._lock
    def _encode(self, arr: pa.Array) -> np.ndarray:
        """Encode an Arrow array to codes against this dictionary, extending
        it with novel values. Nulls -> -1."""
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if isinstance(arr, pa.DictionaryArray):
            d = arr  # parquet dictionary pages: codes come for free
        else:
            d = pc.dictionary_encode(arr)
        if isinstance(d, pa.ChunkedArray):
            d = d.combine_chunks()
        local_values = d.dictionary
        # nulls -> -1 BEFORE the numpy conversion (a null-carrying indices
        # array converts via float NaN, whose int cast is undefined)
        local_codes = (
            pc.fill_null(d.indices, -1)
            .to_numpy(zero_copy_only=False)
            .astype(np.int64)
        )
        if self.values is None:
            self.values = local_values
            remap = np.arange(len(local_values), dtype=np.int64)
        else:
            idx = pc.index_in(local_values, value_set=self.values)
            idx_np = idx.to_numpy(zero_copy_only=False).astype(np.float64)
            missing = np.isnan(idx_np)
            if missing.any():
                novel = local_values.filter(pa.array(missing))
                base = len(self.values)
                self.values = pa.concat_arrays(
                    [self.values.cast(novel.type), novel]
                )
                idx_np = np.where(
                    missing, base + np.cumsum(missing) - 1, idx_np
                )
            remap = idx_np.astype(np.int64)
        out = np.where(local_codes >= 0, remap[np.maximum(local_codes, 0)], -1)
        return out.astype(np.int32)

    def snapshot(self) -> Optional[pa.Array]:
        """Consistent point-in-time view of the accumulated values."""
        with self._lock:
            return self.values

    def code_of(self, value) -> int:
        """Code for a literal, extending the dictionary so it always exists."""
        with self._lock:
            if self.values is None:
                self.values = pa.array([value])
                return 0
            idx = pc.index_in(pa.scalar(value, type=self.values.type), value_set=self.values)
            if idx.as_py() is None:
                self.values = pa.concat_arrays([self.values, pa.array([value], type=self.values.type)])
                return len(self.values) - 1
            return int(idx.as_py())

    def __len__(self) -> int:
        with self._lock:
            return 0 if self.values is None else len(self.values)


class ScanDictionaries:
    """Per-scan registry of ColumnDictionary keyed by column index."""

    def __init__(self) -> None:
        self.dicts: Dict[int, ColumnDictionary] = {}

    def for_column(self, index: int) -> ColumnDictionary:
        if index not in self.dicts:
            self.dicts[index] = ColumnDictionary()
        return self.dicts[index]


# -- device residency accounting -------------------------------------------
# One card's memory is shared by every cached stage (the JAX package's
# policy, ops/runtime.py:125-361). When a new partition would push the total
# past ballista.tpu.hbm_budget_bytes, other stages' least recently used pins
# are evicted to make room (they re-prepare on their next touch); only an
# entry that cannot fit even after eviction streams (uploaded, run, dropped)
# per query. A stage the dispatcher drops releases its reservations.
_res_lock = threading.Lock()
_resident_bytes = 0  # guarded-by: _res_lock
_reservations: Dict[tuple, int] = {}  # (id(stage), partition) -> bytes; guarded-by: _res_lock
_pinned: Dict[tuple, tuple] = {}  # token -> (stage, partition); guarded-by: _res_lock
_last_used: Dict[tuple, float] = {}  # token -> monotonic last touch; guarded-by: _res_lock
# what reserve_and_pin decided: "pins" (a new reservation), "evictions"
# (another stage's partition dropped to make room) and "streams" (an entry
# that could not stay resident)
_residency_counts = {"pins": 0, "evictions": 0, "streams": 0}  # guarded-by: _res_lock

# refuse an eviction plan that frees more than this multiple of the bytes
# requested: re-uploading a large pin to admit a small one costs more than
# the newcomer streaming would, and two such stages alternating would thrash
_EVICT_COST_RATIO = 4
# a stage evicted within this window is immune from re-eviction: in an
# A, B, A, B pattern where A and B fit alone but not together, plain LRU
# would re-prepare on every query; after one thrash cycle the cooldown keeps
# the survivor pinned and the other streams
_EVICT_COOLDOWN_S = 60.0
_evicted_at: Dict[int, float] = {}  # id(stage) -> last eviction; guarded-by: _res_lock


def entry_device_bytes(obj) -> int:
    """Recursive nbytes of the tensors inside a prepared cache entry. Host
    metadata (Arrow key values, numpy arrays) is not counted."""
    import torch

    if isinstance(obj, torch.Tensor):
        return int(obj.numel() * obj.element_size())
    if isinstance(obj, dict):
        return sum(entry_device_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(entry_device_bytes(v) for v in obj)
    return 0


def check_budget(nbytes: int, budget: int, what: str) -> None:
    """Decline a stage whose device columns alone exceed the budget: it must
    run on the host, not exhaust the card's memory."""
    if nbytes > budget:
        raise UnsupportedOnDevice(
            f"{what} ({nbytes >> 20} MiB) exceed the HBM budget"
        )


def reserve_and_pin(stage, partition: int, entry, cache: dict, nbytes: int,
                    budget: int) -> bool:
    """Reserve budget for a prepared partition and insert it into the
    stage's cache dict, refusing retired stages. When the budget is full,
    other stages' pins are evicted least recently used first until the
    entry fits (_evict_lru_locked); the requesting stage's own pins are
    never victims. Returns False (the partition streams) when it cannot
    fit. The retired check, the reservation and the insert happen under the
    lock release_stage_residency holds, so no reservation can outlive its
    stage."""
    global _resident_bytes
    token = (id(stage), partition)
    with _res_lock:
        if getattr(stage, "_retired", False):
            _residency_counts["streams"] += 1
            return False
        if token not in _reservations:
            if nbytes > budget:
                # can never fit: do not disturb other pins
                _residency_counts["streams"] += 1
                return False
            if _resident_bytes + nbytes > budget:
                _evict_lru_locked(stage, nbytes, budget)
            if _resident_bytes + nbytes > budget:
                _residency_counts["streams"] += 1
                return False
            _reservations[token] = nbytes
            _resident_bytes += nbytes
            _pinned[token] = (stage, partition)
            _residency_counts["pins"] += 1
        _last_used[token] = time.monotonic()
        cache[partition] = entry
        return True


# holds-lock: _res_lock
def _evict_lru_locked(requesting_stage, nbytes: int, budget: int) -> None:
    """Evict other stages' pinned partitions, oldest touch first, until
    `nbytes` fits. The requesting stage's own entries are never victims,
    stages evicted within _EVICT_COOLDOWN_S are immune, and the plan is
    abandoned (nothing evicted) when it cannot fit the request or would
    free more than _EVICT_COST_RATIO times it. Eviction drops only the cache
    entry: a task thread inside the victim's step keeps its tensors."""
    global _resident_bytes
    now = time.monotonic()
    for sid in [s for s, ts in _evicted_at.items() if now - ts > _EVICT_COOLDOWN_S]:
        del _evicted_at[sid]
    candidates = sorted(
        (t for t, (s, _p) in _pinned.items()
         if s is not requesting_stage and id(s) not in _evicted_at),
        key=lambda t: _last_used.get(t, 0.0),
    )
    need = _resident_bytes + nbytes - budget
    chosen, freed = [], 0
    for t in candidates:
        if freed >= need:
            break
        size = _reservations.get(t, 0)
        if size > _EVICT_COST_RATIO * nbytes:
            continue  # a huge victim for a small need stays resident
        chosen.append(t)
        freed += size
    if freed < need or freed > _EVICT_COST_RATIO * nbytes:
        return
    for t in chosen:
        victim, p = _pinned.pop(t)
        _evicted_at[id(victim)] = now
        _last_used.pop(t, None)
        _resident_bytes -= _reservations.pop(t, 0)
        _residency_counts["evictions"] += 1
        # fused stages pin into _device_cache, fact stages into _prepared
        for attr in ("_device_cache", "_prepared"):
            c = getattr(victim, attr, None)
            if c is not None:
                c.pop(p, None)


def make_headroom(stage, nbytes: int, budget: int) -> None:
    """Best-effort LRU eviction before a large upload: reserve_and_pin
    evicts only after the transfer, too late when other stages' pins plus
    the incoming tensors would exceed the card's memory."""
    with _res_lock:
        if _resident_bytes + nbytes > budget:
            _evict_lru_locked(stage, nbytes, budget)


def touch_residency(stage, partition: int) -> None:
    """Record a cache hit for LRU ordering. Only live pins are refreshed: a
    racing eviction may have dropped the token already."""
    token = (id(stage), partition)
    with _res_lock:
        if token in _pinned:
            _last_used[token] = time.monotonic()


def release_residency(token) -> None:
    """Drop one reservation by its (id(stage), partition) token."""
    global _resident_bytes
    with _res_lock:
        _resident_bytes -= _reservations.pop(token, 0)
        _pinned.pop(token, None)
        _last_used.pop(token, None)


def release_stage_residency(stage) -> None:
    """Drop a stage's cached device entries and their reservations (the
    dispatcher calls this when it permanently declines or supersedes a
    stage). The retired flag and the sweep are one step under the lock."""
    global _resident_bytes
    with _res_lock:
        stage._retired = True
        for attr in ("_device_cache", "_prepared"):
            cache = getattr(stage, attr, None)
            if cache:
                for p in list(cache):
                    token = (id(stage), p)
                    _resident_bytes -= _reservations.pop(token, 0)
                    _pinned.pop(token, None)
                    _last_used.pop(token, None)
                cache.clear()


def resident_bytes() -> int:
    with _res_lock:
        return _resident_bytes


def residency_stats(reset: bool = False) -> Dict[str, int]:
    """{"pins", "evictions", "streams"}: reserve_and_pin's decisions."""
    with _res_lock:
        out = dict(_residency_counts)
        if reset:
            for k in _residency_counts:
                _residency_counts[k] = 0
    return out


def reset_residency() -> None:
    """Forget every reservation, pin, recency and cooldown (a fresh
    process; the stages' cache dicts are the caller's to clear)."""
    global _resident_bytes
    with _res_lock:
        _resident_bytes = 0
        _reservations.clear()
        _pinned.clear()
        _last_used.clear()
        _evicted_at.clear()
        for k in _residency_counts:
            _residency_counts[k] = 0


def bucket_rows(n: int, minimum: int = 1024) -> int:
    """Pad row counts to power-of-two buckets (the shapes the device steps
    see stay a small bounded set)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1


def column_to_numpy(
    arr: pa.Array, dtype: pa.DataType, dictionary: Optional[ColumnDictionary]
) -> np.ndarray:
    """Lower one Arrow column to a device-ready numpy array.

    String columns tolerate nulls: they ride as -1 dictionary codes, and
    every compiled code predicate applies SQL three-valued logic to code -1.
    Numeric/date/bool columns with nulls decline (no null representation)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_string(dtype) or pa.types.is_large_string(dtype):
        if dictionary is None:
            raise ValueError("string column lowered without a dictionary")
        return dictionary.encode(arr)
    if arr.null_count:
        raise UnsupportedOnDevice("null values in device column")
    if pa.types.is_floating(dtype):
        return arr.to_numpy(zero_copy_only=False).astype(np.float32)
    if pa.types.is_date(dtype):
        return arr.cast(pa.int32()).to_numpy(zero_copy_only=False)
    if pa.types.is_integer(dtype):
        vals = arr.to_numpy(zero_copy_only=False)
        if vals.dtype.itemsize > 4:
            if len(vals) and (vals.min() < _INT32_MIN or vals.max() > _INT32_MAX):
                raise UnsupportedOnDevice("int64 values exceed int32 range")
            vals = vals.astype(np.int32)
        return vals
    if pa.types.is_boolean(dtype):
        return arr.to_numpy(zero_copy_only=False).astype(np.bool_)
    raise UnsupportedOnDevice(f"unsupported device dtype {dtype}")


_LUT_MIN_ROWS = 4096
_LUT_MAX_VALUES = 256
_LUT_SAMPLE = 65536


def narrow_column(
    npcol: np.ndarray, prior: Optional[str] = None
) -> Tuple[np.ndarray, Optional[np.ndarray], str]:
    """Narrow a device-bound column for residency: (narrow array, optional
    f32 LUT, choice tag). int32 whose range fits goes int8/int16; a float32
    column with <=256 distinct values (TPC-H quantity/discount/tax are
    decimal grids) becomes uint8 codes plus an f32 lookup table. Compute
    dtypes after widening (widen_cols) are exactly the canonical int32/f32,
    so results are bit-equal to the wide path.

    `prior` is the choice an earlier batch of the SAME column made; a batch
    never narrows below it, so all batches of a column share one dtype."""
    if npcol.dtype == np.int32:
        if not len(npcol):
            return npcol, None, prior or "int32"
        mn, mx = int(npcol.min()), int(npcol.max())
        choice = "int32"
        if -128 <= mn and mx <= 127:
            choice = "int8"
        elif -32768 <= mn and mx <= 32767:
            choice = "int16"
        order = {"int8": 0, "int16": 1, "int32": 2}
        if prior in order and order[prior] > order[choice]:
            choice = prior
        if choice == "int32":
            return npcol, None, choice
        return npcol.astype(choice), None, choice
    if npcol.dtype == np.float32 and prior in (None, "lut"):
        if len(npcol) < _LUT_MIN_ROWS and prior != "lut":
            # too small to judge; stay undecided (a sticky "wide" verdict
            # would lock a large later batch out of LUT narrowing)
            return npcol, None, prior
        # cheap sample gate first: a high-cardinality column must not pay a
        # full dictionary_encode just to discover it cannot LUT-encode
        sample = npcol[:: max(1, len(npcol) // _LUT_SAMPLE)][:_LUT_SAMPLE]
        if len(np.unique(sample)) <= _LUT_MAX_VALUES:
            d = pc.dictionary_encode(pa.array(npcol))
            if isinstance(d, pa.ChunkedArray):
                d = d.combine_chunks()
            if len(d.dictionary) <= _LUT_MAX_VALUES:
                lut = np.zeros(_LUT_MAX_VALUES, dtype=np.float32)
                vals = d.dictionary.to_numpy(zero_copy_only=False)
                lut[: len(vals)] = vals.astype(np.float32)
                codes = d.indices.to_numpy(zero_copy_only=False).astype(np.uint8)
                return codes, lut, "lut"
    return npcol, None, "wide"


def widen_cols(cols: dict) -> dict:
    """Inverse of narrow_column, applied at the top of every device step:
    sub-4-byte ints widen to int32, (codes, lut) pairs gather back to f32.
    Wide inputs pass through untouched."""
    import torch

    out = {}
    for idx, v in cols.items():
        if isinstance(v, tuple):
            codes, lut = v
            out[idx] = lut[codes.long()]
        elif v.dtype in (torch.int8, torch.int16, torch.uint8):
            out[idx] = v.to(torch.int32)
        else:
            out[idx] = v
    return out


def pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(arr) == n:
        return arr
    pad = np.full(n - len(arr), fill, dtype=arr.dtype)
    return np.concatenate([arr, pad])


def _put(arr: np.ndarray, device):
    """One host->device copy of a contiguous numpy array. For a CUDA device
    the bytes go through pinned host memory with a non-blocking copy on the
    current stream (the caching host allocator keeps the pinned buffer
    alive until the copy has run); on the CPU the tensor shares the array's
    memory."""
    import torch

    if not arr.flags.writeable:  # e.g. a view of another framework's buffer
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


_H2D_CHUNK_BYTES = 64 << 20  # static per-chunk default (cold store)
_H2D_MIN_CHUNKED = 256 << 20  # arrays below this go as one piece
# tuned-chunk candidates: the power-of-two buckets (16 MB .. 256 MB) the
# picker compares by their observed per-chunk h2d rates
_H2D_CHUNK_CANDIDATES = tuple(1 << p for p in range(24, 29))
_h2d_chunk_pick = 0  # last chunk size chosen; guarded-by: _routing_lock


def _h2d_chunk_bytes() -> int:
    """Per-chunk h2d transfer size: among the power-of-two candidates, the
    bucket whose OBSERVED per-chunk h2d rate is best (exact bucket only;
    buckets without enough observations do not compete), else the static
    64 MB default. Chunking never changes the concatenated bytes. The pick
    is surfaced as `h2d_chunk_bytes` in routing_stats."""
    global _h2d_chunk_pick
    from ballista_tpu_torch.ops import costmodel

    best, best_rate = _H2D_CHUNK_BYTES, None
    for cand in _H2D_CHUNK_CANDIDATES:
        r = costmodel.bucket_rate("h2d", cand)
        if r is None:
            continue
        if best_rate is None or r < best_rate:
            best, best_rate = cand, r
    with _routing_lock:
        _h2d_chunk_pick = best
    return best


def upload(arr: np.ndarray, device):
    """Host numpy array -> tensor on `device`. Arrays past _H2D_MIN_CHUNKED,
    while the cost model is on, split along axis 0 into _h2d_chunk_bytes()
    chunks, double-buffered: chunk j is queued, then chunk j-1's event is
    waited on and its h2d cost observed; the chunks concatenate on the
    device, bit-identical to one put, with a transient 2x peak for this one
    array. Every other array (and every array while the cost model is off:
    its observations would be discarded) is one put."""
    import torch

    from ballista_tpu_torch.ops import costmodel

    arr = np.ascontiguousarray(arr)
    nbytes = arr.nbytes
    rows = arr.shape[0] if arr.ndim else 0
    if not costmodel.enabled() or nbytes < _H2D_MIN_CHUNKED or rows < 2:
        return _put(arr, device)
    chunk_rows = max(1, _h2d_chunk_bytes() // max(1, nbytes // rows))
    if chunk_rows >= rows:
        return _put(arr, device)
    cuda = device.type == "cuda"
    chunks = []
    prev = None  # (tensor, event, t0) of the chunk in flight
    for lo in range(0, rows, chunk_rows):
        t0 = time.perf_counter()
        c = _put(arr[lo:lo + chunk_rows], device)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
        if prev is not None:
            _observe_h2d(*prev)
        prev = (c, ev, t0)
        chunks.append(c)
    _observe_h2d(*prev)
    record_routing_event("h2d_chunked")
    return torch.cat(chunks, dim=0)


def _observe_h2d(chunk, event, t0: float) -> None:
    from ballista_tpu_torch.ops import costmodel

    if event is not None:
        event.synchronize()
    costmodel.observe("h2d", chunk.nbytes, time.perf_counter() - t0)


# -- pipelined ingestion ----------------------------------------------------
# Bounded producer/consumer helpers for the stage prepare (parquet read +
# dictionary decode + group ranking overlap the ordered narrow/encode/upload
# consume side). Both preserve input order exactly: each batch's narrow
# choice feeds the next batch's narrow_column prior, and dictionary codes
# grow in batch order, so results are identical at any worker count.


def ordered_map(fn, items, workers: int, depth: int = 2):
    """Concurrent map over a finite, independent item list, yielding
    results in input order with at most `depth` in flight. workers <= 0 (or
    a single item) degenerates to the serial loop."""
    items = list(items)
    if workers <= 0 or len(items) <= 1:
        for it in items:
            yield fn(it)
        return
    import collections
    from concurrent.futures import ThreadPoolExecutor

    inflight = max(1, depth)
    ex = ThreadPoolExecutor(max_workers=workers)
    pending: collections.deque = collections.deque()
    i = 0
    try:
        while pending or i < len(items):
            while i < len(items) and len(pending) < inflight:
                pending.append(ex.submit(fn, items[i]))
                i += 1
            yield pending.popleft().result()
    finally:
        for f in pending:
            f.cancel()
        ex.shutdown(wait=True)


def pipelined_map(src, fn, workers: int, depth: int = 2, on_src_time=None):
    """Ordered streaming producer/consumer over an iterator: a reader thread
    pulls items from `src` serially, submits fn(item) to a `workers`-thread
    pool, and the caller consumes results in input order with at most
    `depth` results ahead. Exceptions from `src` or `fn` re-raise at the
    consumption point in order. `on_src_time(seconds)` is called from the
    reader thread with each pull's duration. workers <= 0 degenerates to
    the serial in-thread map."""
    if workers <= 0:
        it = iter(src)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            if on_src_time is not None:
                on_src_time(time.perf_counter() - t0)
            yield fn(item)
    import queue as _queue
    from concurrent.futures import ThreadPoolExecutor

    done = object()
    stop = threading.Event()
    slots = threading.Semaphore(max(1, depth))
    out_q: "_queue.Queue" = _queue.Queue()
    ex = ThreadPoolExecutor(max_workers=workers)

    def _reader() -> None:
        it = iter(src)
        while not stop.is_set():
            # bounded wait so a consumer that stopped early can never strand
            # this thread on the semaphore
            if not slots.acquire(timeout=0.05):
                continue
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                slots.release()
                break
            except BaseException as e:  # src failure surfaces in order
                slots.release()
                out_q.put(("err", e))
                return
            if on_src_time is not None:
                on_src_time(time.perf_counter() - t0)
            try:
                out_q.put(("fut", ex.submit(fn, item)))
            except RuntimeError:
                # the consumer exited early and shut the pool down
                return
        out_q.put(done)

    reader = threading.Thread(target=_reader, name="ingest-reader", daemon=True)
    reader.start()
    try:
        while True:
            msg = out_q.get()
            if msg is done:
                break
            tag, val = msg
            if tag == "err":
                raise val
            yield val.result()
            slots.release()
    finally:
        stop.set()
        reader.join(timeout=0.2)
        ex.shutdown(wait=False)


# -- counters ---------------------------------------------------------------
# ingest timings across stage prepares: scan_s = prefetch work (parquet read
# + dictionary decode + group ranking), encode_s = host narrow/encode,
# upload_s = h2d enqueue, wall_s = end-to-end prepare.
_ingest_lock = threading.Lock()
_ingest_totals = {  # guarded-by: _ingest_lock
    "scan_s": 0.0, "encode_s": 0.0, "upload_s": 0.0, "wall_s": 0.0,
    "prepares": 0,
}


def record_ingest(scan_s: float, encode_s: float, upload_s: float,
                  wall_s: float) -> None:
    with _ingest_lock:
        _ingest_totals["scan_s"] += scan_s
        _ingest_totals["encode_s"] += encode_s
        _ingest_totals["upload_s"] += upload_s
        _ingest_totals["wall_s"] += wall_s
        _ingest_totals["prepares"] += 1


def ingest_stats(reset: bool = False) -> Dict[str, float]:
    with _ingest_lock:
        out = dict(_ingest_totals)
        if reset:
            for k in _ingest_totals:
                _ingest_totals[k] = 0.0 if k != "prepares" else 0
    return out


# incremental execution over the chunk-set delta store (ops/stage.py,
# _prepare_partition_chunks), with the JAX package's event names:
# "chunks_reused" (chunks loaded from the store), "chunks_prepared"
# (chunks prepared fresh), "bytes_reprepared_saved" (host bytes of the
# reused chunks) and "save_declined_midappend" (a file whose identity moved
# between the stat and the read was not persisted)
_delta_lock = threading.Lock()
_delta: Dict[str, int] = {}  # guarded-by: _delta_lock


def record_delta(event: str, n: int = 1) -> None:
    with _delta_lock:
        _delta[event] = _delta.get(event, 0) + int(n)


def delta_stats(reset: bool = False) -> Dict[str, int]:
    with _delta_lock:
        out = dict(_delta)
        if reset:
            _delta.clear()
    return out


# kernel library events (ops/cuda_kernels.py), named as the JAX package's
# program cache names them where the meaning is the same:
# "compile_hit_memory" (the library was loaded in this process),
# "compile_hit_disk" (a keyed library from the build directory, no nvcc),
# "compile_prewarmed" (loaded by prewarm) and "kernel_built" (one nvcc run)
_serving_lock = threading.Lock()
_serving: Dict[str, int] = {}  # guarded-by: _serving_lock


def record_serving(event: str, n: int = 1) -> None:
    with _serving_lock:
        _serving[event] = _serving.get(event, 0) + int(n)


def serving_stats(reset: bool = False) -> Dict[str, int]:
    with _serving_lock:
        out = dict(_serving)
        if reset:
            _serving.clear()
    return out


# device->host result readbacks across stage runs: rows = trailing-axis
# length of each fetched result (groups), bytes = transfer size, readbacks =
# transfer count.
_readback_lock = threading.Lock()
_readback_totals = {"rows": 0, "bytes": 0, "readbacks": 0}  # guarded-by: _readback_lock


def record_readback(rows: int, nbytes: int) -> None:
    with _readback_lock:
        _readback_totals["rows"] += int(rows)
        _readback_totals["bytes"] += int(nbytes)
        _readback_totals["readbacks"] += 1


def readback(x, rows: Optional[int] = None) -> np.ndarray:
    """Canonical device->host result materialization: tensor -> numpy plus
    the readback accounting in one step. `rows` defaults to the
    trailing-axis length (the [R, G] result convention). With the cost
    model on, the transfer's wall time lands in the cost store as a
    per-byte "readback" observation; the producing work is synced first so
    the timer measures the copy, not queued kernels."""
    from ballista_tpu_torch.ops import costmodel

    t0 = None
    if costmodel.enabled():
        if x.device.type == "cuda":
            import torch

            torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
    arr = x.detach().cpu().numpy()
    if t0 is not None and arr.nbytes:
        costmodel.observe("readback", arr.nbytes, time.perf_counter() - t0)
    record_readback(
        rows if rows is not None else (arr.shape[-1] if arr.ndim else 1),
        arr.nbytes,
    )
    return arr


def readback_stats(reset: bool = False) -> Dict[str, int]:
    with _readback_lock:
        out = dict(_readback_totals)
        if reset:
            for k in _readback_totals:
                _readback_totals[k] = 0
    return out


# which route each device-stage run took: "batches", "sorted" (the
# chunked-segment layout), "pallas_sorted" (the sorted_grouped_sum kernel
# route; the names are the JAX package's), "fact_topk" / "fact_select" /
# "fact_secondary" (the fact-aggregate stage's three modes, ops/factagg.py),
# or "host" (the stage declined, with its reason counted). A stage that
# declines still returns the right answer through the host operator, so
# these counts are how a run proves where its aggregates ran. Named events
# (e.g. "skew_replan": the top-k prepare split dominant groups off its
# one-chunk cover; "mapped_rewrite": a join tree ran as a mapped fact scan)
# count beside them. A rung of the stage ladder that steps aside
# (kernels.step_aside) counts its reason apart from host declines: the next
# rung may still run the aggregate on the device.
_routing_lock = threading.Lock()
_routes: Dict[str, int] = {}  # guarded-by: _routing_lock
_decline_reasons: Dict[str, int] = {}  # guarded-by: _routing_lock
_routing_events: Dict[str, int] = {}  # guarded-by: _routing_lock
_step_asides: Dict[str, int] = {}  # guarded-by: _routing_lock
# cost-model decisions (ops/costmodel.py): predicted and observed seconds
# summed over the decisions that carried both, and the gross mispredicts
_routing_costs = {  # guarded-by: _routing_lock
    "predicted_s": 0.0, "observed_s": 0.0, "predictions": 0, "mispredicts": 0,
}


def record_route(route: str, reason: Optional[str] = None) -> None:
    with _routing_lock:
        _routes[route] = _routes.get(route, 0) + 1
        if reason:
            _decline_reasons[reason] = _decline_reasons.get(reason, 0) + 1


def record_routing_reason(reason: str) -> None:
    """A decline counted among the reasons with no stage route (a planning
    decision that left the device path before any stage ran)."""
    with _routing_lock:
        _decline_reasons[reason] = _decline_reasons.get(reason, 0) + 1


def record_routing_event(event: str, n: int = 1) -> None:
    with _routing_lock:
        _routing_events[event] = _routing_events.get(event, 0) + int(n)


def record_step_aside(reason: str) -> None:
    with _routing_lock:
        _step_asides[reason] = _step_asides.get(reason, 0) + 1


# speculative-attempt scope: the build-side swap (ops/join.py) runs the whole
# device join ladder on the swapped shape, and only an attempt that produced
# a result becomes the decision; a failed attempt is followed by the planned
# sides, which record the real outcome. Decision counters made inside a probe
# (record_routing, record_join_path, record_decline_trace) buffer in it and
# land only on commit, so one join never counts a decline AND the planned
# decision. Named events (record_routing_event: retier, split, ...) pass
# through: they describe work and store changes that really happened.
_probe_tls = threading.local()


class _RoutingProbe:
    def __init__(self) -> None:
        self.buf: List[tuple] = []

    def commit(self) -> None:
        """Land the buffered decisions (after the with-block). Replays
        through the public recorders, so an outer probe keeps buffering."""
        buf, self.buf = self.buf, []
        for kind, args in buf:
            if kind == "routing":
                record_routing(*args)
            elif kind == "trace":
                record_decline_trace(*args)
            else:
                record_join_path(*args)


@contextlib.contextmanager
def routing_probe() -> Iterator[_RoutingProbe]:
    """Buffer the decision counters recorded in the body; the caller
    commits them only when the probed attempt became the decision."""
    prev = getattr(_probe_tls, "probe", None)
    probe = _RoutingProbe()
    _probe_tls.probe = probe
    try:
        yield probe
    finally:
        _probe_tls.probe = prev


def record_decline_trace(counter: str, message: str) -> None:
    """Decline observability (tracing counter and debug log) that respects
    an active routing probe."""
    probe = getattr(_probe_tls, "probe", None)
    if probe is not None:
        probe.buf.append(("trace", (counter, message)))
        return
    import logging

    from ballista_tpu_torch.utils import tracing

    tracing.incr(counter)
    logging.getLogger("ballista.cuda").debug("%s", message)


def record_routing(engine: str, op: str, predicted_s: Optional[float] = None,
                   observed_s: Optional[float] = None) -> None:
    """One cost-model routing decision: the event "<op>:<engine>" (e.g.
    "join:device", "join:host", "join.counts:device") and, when the cost
    model predicted, how the prediction held up. Stage routes are
    record_route's; a join decision never lands there."""
    from ballista_tpu_torch.ops.costmodel import gross_mispredict

    probe = getattr(_probe_tls, "probe", None)
    if probe is not None:
        probe.buf.append(("routing", (engine, op, predicted_s, observed_s)))
        return
    with _routing_lock:
        k = f"{op}:{engine}"
        _routing_events[k] = _routing_events.get(k, 0) + 1
        if predicted_s is not None and observed_s is not None:
            _routing_costs["predictions"] += 1
            _routing_costs["predicted_s"] += float(predicted_s)
            _routing_costs["observed_s"] += float(observed_s)
            if gross_mispredict(predicted_s, observed_s):
                _routing_costs["mispredicts"] += 1


def routing_stats(reset: bool = False) -> Dict[str, Dict[str, int]]:
    """{"routes": {route: n}, "reasons": {decline reason: n},
    "events": {event: n}, "step_asides": {step-aside reason: n},
    "costs": {"predicted_s", "observed_s", "predictions", "mispredicts"},
    "h2d_chunk_bytes": the last chunk size upload() picked (a value)}"""
    global _h2d_chunk_pick
    with _routing_lock:
        out = {"routes": dict(_routes), "reasons": dict(_decline_reasons),
               "events": dict(_routing_events),
               "step_asides": dict(_step_asides),
               "costs": dict(_routing_costs),
               "h2d_chunk_bytes": _h2d_chunk_pick}
        if reset:
            _routes.clear()
            _decline_reasons.clear()
            _routing_events.clear()
            _step_asides.clear()
            _routing_costs.update(predicted_s=0.0, observed_s=0.0,
                                  predictions=0, mispredicts=0)
            _h2d_chunk_pick = 0
    return out


# join-path outcomes across join executions: every device-join attempt lands
# in exactly one bucket: "device" (the device join produced the result),
# "split" (device prefix plus host remainder at the tier boundary),
# "step_aside" (the multiplicity / gather admission declined and the host
# join ran) or "host_fallback" (any other decline). Reasons count verbatim
# as "path: reason", so a run says why a join left the device.
_join_lock = threading.Lock()
_join_paths: Dict[str, int] = {}  # guarded-by: _join_lock
_join_reasons: Dict[str, int] = {}  # guarded-by: _join_lock


def record_join_path(path: str, reason: Optional[str] = None) -> None:
    probe = getattr(_probe_tls, "probe", None)
    if probe is not None:
        probe.buf.append(("join_path", (path, reason)))
        return
    with _join_lock:
        _join_paths[path] = _join_paths.get(path, 0) + 1
        if reason:
            key = f"{path}: {reason}"
            _join_reasons[key] = _join_reasons.get(key, 0) + 1


def join_path_stats(reset: bool = False) -> Dict[str, Dict[str, int]]:
    """{"paths": {path: n}, "reasons": {"path: reason": n}}"""
    with _join_lock:
        out = {"paths": dict(_join_paths), "reasons": dict(_join_reasons)}
        if reset:
            _join_paths.clear()
            _join_reasons.clear()
    return out


# -- distributed-path event counters -----------------------------------------
# In-process accumulators of the scheduler, executors and client (the JAX
# package's names and meanings, ops/runtime.py:769-1028). A standalone
# cluster runs them all in one process; separate daemons each report their
# own share.
class _EventCounts:
    """event -> count, behind its own lock. `whole` counters add int(n);
    the others add n as given (seconds, gauges)."""

    def __init__(self, whole: bool = True) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = {}  # guarded-by: self._lock
        self._whole = whole

    def record(self, event: str, n: float = 1) -> None:
        with self._lock:
            self._counts[event] = self._counts.get(event, 0) + (int(n) if self._whole else n)

    def gauge(self, name: str, value: float) -> None:
        """Overwrite a gauge, keeping its `_peak` sibling."""
        with self._lock:
            self._counts[name] = value
            peak = f"{name}_peak"
            self._counts[peak] = max(self._counts.get(peak, value), value)

    def stats(self, reset: bool = False) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counts)
            if reset:
                self._counts.clear()
        return out


# recovery work after injected or real faults (task_retry,
# result_partition_restarted, scheduler_restart, ...)
_recovery = _EventCounts()
record_recovery, recovery_stats = _recovery.record, _recovery.stats
# multi-tenant serving: result-cache hits / misses / puts / invalidations,
# plan-cache hits, admission quota deferrals
_tenancy = _EventCounts()
record_tenancy, tenancy_stats = _tenancy.record, _tenancy.stats
# shared-scan batches: scheduler-side formation (batches_formed,
# batched_stages, ...) and the executor's solo members (member_solo)
_shared_scan = _EventCounts()
record_shared_scan, shared_scan_stats = _shared_scan.record, _shared_scan.stats
# disaggregated shuffle tier: storage_publish / local_publish, storage_fetch
# / peer_fetch, storage_fallback_peer, storage_publish_torn
_shuffle_tier = _EventCounts()
record_shuffle_tier, shuffle_tier_stats = _shuffle_tier.record, _shuffle_tier.stats
# the exchange registry (ops/exchange.py): published / publish_bytes,
# reupload_skipped / h2d_bytes_saved, served_from_registry /
# d2h_bytes_saved, skipped_budget / evicted_budget, evicted_chaos,
# locality_preferred, miss
_exchange = _EventCounts()
record_exchange, exchange_stats = _exchange.record, _exchange.stats
# speculative execution: launched / won / lost / failed / promoted /
# orphaned / executor_lost, wasted_seconds (a float), slo_misses / slo_met
_speculation = _EventCounts(whole=False)
record_speculation, speculation_stats = _speculation.record, _speculation.stats
# elastic fleet: scale_up / scale_down / drain_* counts and the fleet_size /
# backlog_ms gauges with their _peak siblings
_fleet = _EventCounts(whole=False)
record_fleet, record_fleet_gauge, fleet_stats = _fleet.record, _fleet.gauge, _fleet.stats
