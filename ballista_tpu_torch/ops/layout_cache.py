"""Persisted device-layout cache: warm starts for expensive stage prepares.

The host work behind a device stage (Parquet decode, string dictionary
encoding, dense ranking of group keys, the chunked-segment sort, tile
materialization, narrowing) is a pure function of the stage plan and its
input files' identities. This module persists those host artifacts (narrow
numpy tiles, LUTs, group codes, group key values, layout scalars, string
dictionary snapshots) so a new process goes straight to the host->device
upload. It is the JAX package's ``ops/layout_cache.py`` with the port's own
store:

- Location. Both packages read ``ballista.tpu.layout_cache_dir``, and the
  JAX package's cap eviction treats every directory under that base as a
  shard of its own evictable entries. The port therefore never stores under
  the configured base: it stores in the sibling directory ``<base>_torch``
  (``store_dir``), as the port's cost store keeps its own file.
- Identity. ``_FORMAT`` is the port's own, and every key hashes ``_TAG``
  with it, so no entry of one package is ever read as the other's.

Storage layout (one directory per (stage key, partition)):
  meta.json          versioned manifest: kind, scalars, and under "arrays"
                     each array's (dtype, shape, byte offset)
  arrays.bin         every array's bytes, C order, each at a 64-byte
                     aligned offset (tiles, LUTs, codes, key values, dicts)

The JAX package writes one ``.npy`` file per array. The port keeps two
files per entry: a "batches" stage persists one entry per chunk, and on
the H100 host every file an entry opens cost time (PERF.md §6).

Writes are capped by ballista.tpu.layout_cache_cap_bytes (oldest-mtime
entry directories evicted first; a load refreshes its entry's mtime) and
are atomic (a ``.wip-`` directory renamed into place). A failed save leaves
no entry and never raises; a corrupt or foreign entry loads as a miss.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ballista_tpu_torch.utils.tracing import span
from ballista_tpu_torch.utils.locks import make_lock

# bump to invalidate every persisted entry of the port
_FORMAT = 1
# hashed into every key and stamped into every manifest: the JAX package's
# entries (its own _FORMAT, no tag) can never collide with the port's
_TAG = "ballista_tpu_torch"
# the port's store is this sibling of the configured base
STORE_SUFFIX = "_torch"


def store_dir(config) -> str:
    """The port's store for a config: ``<ballista.tpu.layout_cache_dir>``
    with STORE_SUFFIX appended (a sibling of the JAX package's base, never
    inside it), or "" when the setting is empty (persistence off)."""
    base = config.tpu_layout_cache_dir()
    if not base:
        return ""
    return os.path.normpath(base) + STORE_SUFFIX


def cache_dir_for(base: str, stage_key: str, partition: int) -> str:
    h = hashlib.sha256(
        f"{_TAG}|v{_FORMAT}|{stage_key}|p{partition}".encode()
    ).hexdigest()
    return os.path.join(base, h[:2], h)


_ALIGN = 64
_DATA = "arrays.bin"


def _write_arrays(d: str, arrays: List[np.ndarray]) -> List[list]:
    """Write every array's bytes into d/arrays.bin; returns the manifest
    [[dtype str, shape, offset], ...] that _read_arrays takes."""
    manifest = []
    offset = 0
    with open(os.path.join(d, _DATA), "wb") as f:
        for a in arrays:
            a = a if a.flags.c_contiguous else a.copy(order="C")
            if a.dtype.hasobject:
                raise TypeError("object arrays are not persisted")
            pad = -offset % _ALIGN
            f.write(b"\0" * pad)
            offset += pad
            manifest.append([a.dtype.str, list(a.shape), offset])
            a.tofile(f)
            offset += a.nbytes
    return manifest


def _read_arrays(d: str, manifest: List[list]) -> List[np.ndarray]:
    """Inverse of _write_arrays: one read of arrays.bin into a writable
    buffer, each array a view of it."""
    path = os.path.join(d, _DATA)
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise OSError(f"short read of {path}")
    out = []
    for dtype, shape, offset in manifest:
        dt = np.dtype(dtype)
        count = int(np.prod(shape, dtype=np.int64))
        if offset + count * dt.itemsize > len(buf):
            raise ValueError(f"{path}: array past the end of the file")
        out.append(np.frombuffer(buf, dt, count, offset).reshape(shape))
    return out


# in-flight write dirs carry this prefix so eviction never deletes them
# while live; ones untouched this long are crashed writers' orphans
_TMP_PREFIX = ".wip-"
_WIP_ORPHAN_S = 6 * 3600.0


def _dir_bytes(base: str) -> int:
    """Committed bytes under base; in-flight .wip- directories are not
    counted (they are not evictable)."""
    total = 0
    for root, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if not d.startswith(_TMP_PREFIX)]
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


# per-process running size estimate per store: a full walk per save would be
# O(entries^2) stat traffic as the store fills. It is refreshed with a real
# walk only when it says the cap is exceeded (other processes' writes are
# invisible until then: the cap is best-effort)
_size_lock = make_lock("ops.layout_cache._size_lock")
_size_cache: Dict[str, int] = {}  # store -> bytes; guarded-by: _size_lock


def _size_note(base: str, delta: int) -> None:
    with _size_lock:
        if base in _size_cache:
            _size_cache[base] = max(0, _size_cache[base] + delta)


def _evict_to_cap(base: str, incoming: int, cap: int) -> bool:
    """Evict the oldest entry directories until `incoming` fits under `cap`.
    Returns False when it cannot fit (an entry larger than the whole cap).
    A crashed writer's .wip- directory older than _WIP_ORPHAN_S is
    reclaimed on the way; a live one is never touched."""
    if incoming > cap:
        return False
    with _size_lock:
        total = _size_cache.get(base)
    if total is not None and total + incoming <= cap:
        return True
    total = _dir_bytes(base)
    with _size_lock:
        _size_cache[base] = total
    if total + incoming <= cap:
        return True
    entries = []
    for shard in os.listdir(base):
        sp = os.path.join(base, shard)
        if not os.path.isdir(sp):
            continue
        for name in os.listdir(sp):
            p = os.path.join(sp, name)
            if not os.path.isdir(p):
                continue
            if name.startswith(_TMP_PREFIX):
                try:
                    if time.time() - os.path.getmtime(p) > _WIP_ORPHAN_S:
                        shutil.rmtree(p, ignore_errors=True)
                except OSError:
                    pass
                continue
            try:
                entries.append((os.path.getmtime(p), p, _dir_bytes(p)))
            except OSError:
                pass
    entries.sort()
    for _mtime, p, nbytes in entries:
        if total + incoming <= cap:
            break
        shutil.rmtree(p, ignore_errors=True)
        total -= nbytes
        _size_note(base, -nbytes)
    return total + incoming <= cap


def save_entry(base: str, stage_key: str, partition: int, meta: dict,
               arrays: List[np.ndarray], cap_bytes: int) -> bool:
    """Atomically persist one prepared-partition artifact. `meta` must be
    JSON-serializable and name arrays by index into `arrays`. Returns
    whether an entry now exists under the key (an existing one is kept).
    Best-effort: any failure leaves no partial entry and never raises.
    Timed as the span "layout_cache.save"."""
    with span("layout_cache.save"):
        return _save_entry(base, stage_key, partition, meta, arrays, cap_bytes)


def _save_entry(base: str, stage_key: str, partition: int, meta: dict,
                arrays: List[np.ndarray], cap_bytes: int) -> bool:
    try:
        target = cache_dir_for(base, stage_key, partition)
        if os.path.isdir(target):
            return True
        incoming = sum(a.nbytes for a in arrays)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        if not _evict_to_cap(base, incoming, cap_bytes):
            return False
        tmp = tempfile.mkdtemp(dir=os.path.dirname(target), prefix=_TMP_PREFIX)
        try:
            manifest = _write_arrays(tmp, arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"format": _FORMAT, "package": _TAG, **meta,
                           "arrays": manifest}, f)
            try:
                os.rename(tmp, target)
                _size_note(base, incoming)
            except OSError:  # raced with another writer: keep theirs
                shutil.rmtree(tmp, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return True
    except Exception:
        return False


def load_entry(base: str, stage_key: str,
               partition: int) -> Optional[Tuple[dict, List[np.ndarray]]]:
    """Load a persisted artifact; None on a miss, a corrupt entry, or an
    entry of another format or package. A hit refreshes the entry's mtime
    (LRU recency for _evict_to_cap). Timed as the span "layout_cache.load"."""
    with span("layout_cache.load"):
        return _load_entry(cache_dir_for(base, stage_key, partition))


def _load_entry(d: str) -> Optional[Tuple[dict, List[np.ndarray]]]:
    try:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != _FORMAT or meta.get("package") != _TAG:
            return None
        manifest = meta.pop("arrays")
        if len(manifest) != meta.get("n_arrays", len(manifest)):
            return None
        arrays = _read_arrays(d, manifest)
        try:
            os.utime(d)
        except OSError:
            pass  # a read-only store: the hit still counts
        return meta, arrays
    except Exception:
        return None


def entry_count(base: str) -> int:
    """Committed entries in a store (tests and the smoke count writes)."""
    if not base or not os.path.isdir(base):
        return 0
    n = 0
    for shard in os.listdir(base):
        sp = os.path.join(base, shard)
        if os.path.isdir(sp):
            n += sum(1 for name in os.listdir(sp)
                     if not name.startswith(_TMP_PREFIX)
                     and os.path.isdir(os.path.join(sp, name)))
    return n


def store_bytes(base: str) -> int:
    """Committed bytes in a store (0 when it does not exist)."""
    return _dir_bytes(base) if base and os.path.isdir(base) else 0


# -- (de)hydration helpers for the stage entry shapes -----------------------

def pack_arrow_arrays(arrays_pa) -> np.ndarray:
    """Serialize a list of equal-length Arrow arrays (group key values of any
    Arrow type) as one uint8 Arrow IPC file buffer, so they ride the
    numpy-only entry format unchanged."""
    import pyarrow as pa

    cols = {}
    for i, kv in enumerate(arrays_pa):
        if isinstance(kv, pa.ChunkedArray):
            kv = kv.combine_chunks()
        elif not isinstance(kv, pa.Array):
            kv = pa.array(kv)
        cols[f"k{i}"] = kv
    table = pa.table(cols) if cols else pa.table({})
    sink = pa.BufferOutputStream()
    with pa.ipc.new_file(sink, table.schema) as w:
        w.write_table(table)
    return np.frombuffer(sink.getvalue(), dtype=np.uint8).copy()


def unpack_arrow_arrays(buf: np.ndarray) -> List:
    import pyarrow as pa

    table = pa.ipc.open_file(pa.BufferReader(buf.tobytes())).read_all()
    return [table.column(i).combine_chunks() for i in range(table.num_columns)]


def pack_dict_snapshot(dicts) -> Tuple[dict, List[np.ndarray]]:
    """Snapshot a ScanDictionaries registry as (meta, arrays). String codes
    are baked into the persisted tiles, so a new process must adopt the
    same value->code mapping before it compiles a predicate."""
    meta = {}
    arrays: List[np.ndarray] = []
    for idx, d in dicts.dicts.items():
        snap = d.snapshot()
        if snap is None:
            continue
        meta[str(idx)] = len(arrays)
        arrays.append(np.asarray(snap.to_pylist(), dtype=object).astype(str))
    return meta, arrays


def adopt_dict_snapshot(dicts, meta: dict, arrays: List[np.ndarray]) -> bool:
    """Restore dictionary state. Refuses (False) when a live dictionary is
    not a prefix of the snapshot: its codes would disagree with the
    persisted tiles. Dictionaries grow append-only, so a process that
    compiled the same literals first always passes."""
    import pyarrow as pa
    import pyarrow.compute as pc

    for key, ai in meta.items():
        idx = int(key)
        values = pa.array(list(arrays[ai]))
        d = dicts.for_column(idx)
        with d._lock:
            cur = d.values
            if cur is not None:
                if len(cur) > len(values):
                    return False
                if len(cur) and not pc.all(
                    pc.equal(cur, values.slice(0, len(cur)))
                ).as_py():
                    return False
            d.values = values
    return True
