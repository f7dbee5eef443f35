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

import threading
import time
from typing import Dict, List, Optional, Tuple

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
# One card's memory is shared by every cached stage. A prepared partition
# stays resident only while the total fits ballista.tpu.hbm_budget_bytes;
# past it the partition streams (uploaded, run, dropped) per query. There is
# no LRU eviction in this package yet: first come, first pinned.
_res_lock = threading.Lock()
_resident_bytes = 0  # guarded-by: _res_lock
_reservations: Dict[tuple, int] = {}  # (id(stage), partition) -> bytes; guarded-by: _res_lock


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
    stage's cache dict. Returns False (the partition streams) when it does
    not fit beside what is already resident, or the stage was retired."""
    global _resident_bytes
    token = (id(stage), partition)
    with _res_lock:
        if getattr(stage, "_retired", False):
            return False
        if token not in _reservations:
            if _resident_bytes + nbytes > budget:
                return False
            _reservations[token] = nbytes
            _resident_bytes += nbytes
        cache[partition] = entry
        return True


def release_stage_residency(stage) -> None:
    """Drop a stage's cached device entries and their reservations (the
    dispatcher calls this when it permanently declines a stage)."""
    global _resident_bytes
    with _res_lock:
        stage._retired = True
        cache = getattr(stage, "_device_cache", None)
        if cache:
            for p in list(cache):
                _resident_bytes -= _reservations.pop((id(stage), p), 0)
            cache.clear()


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


def upload(arr: np.ndarray, device):
    """Host numpy array -> tensor on `device`. For a CUDA device the bytes
    go through pinned host memory with a non-blocking copy on the current
    stream (the caching host allocator keeps the pinned buffer alive until
    the copy has run)."""
    import torch

    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of another framework's buffer
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


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
    trailing-axis length (the [R, G] result convention)."""
    arr = x.detach().cpu().numpy()
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


# which route each fused-stage run took: "batches", "sorted" (the
# chunked-segment layout), "pallas_sorted" (the sorted_grouped_sum kernel
# route; the names are the JAX package's), or "host" (the stage declined,
# with its reason counted). A stage that declines still returns the right
# answer through the host operator, so these counts are how a run proves
# where its aggregates ran. Named events (e.g. "skew_replan": the top-k
# prepare split dominant groups off its one-chunk cover) count beside them.
_routing_lock = threading.Lock()
_routes: Dict[str, int] = {}  # guarded-by: _routing_lock
_decline_reasons: Dict[str, int] = {}  # guarded-by: _routing_lock
_routing_events: Dict[str, int] = {}  # guarded-by: _routing_lock


def record_route(route: str, reason: Optional[str] = None) -> None:
    with _routing_lock:
        _routes[route] = _routes.get(route, 0) + 1
        if reason:
            _decline_reasons[reason] = _decline_reasons.get(reason, 0) + 1


def record_routing_event(event: str) -> None:
    with _routing_lock:
        _routing_events[event] = _routing_events.get(event, 0) + 1


def routing_stats(reset: bool = False) -> Dict[str, Dict[str, int]]:
    """{"routes": {route: n}, "reasons": {decline reason: n},
    "events": {event: n}}"""
    with _routing_lock:
        out = {"routes": dict(_routes), "reasons": dict(_decline_reasons),
               "events": dict(_routing_events)}
        if reset:
            _routes.clear()
            _decline_reasons.clear()
            _routing_events.clear()
    return out
