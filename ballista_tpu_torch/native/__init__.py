"""Native (C++) runtime components, bound via ctypes.

Builds lazily with g++ on first import; falls back to the numpy path when no
compiler or build failure (the library is optional, the contract is not).
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import subprocess
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa

log = logging.getLogger("ballista.native")

_HERE = pathlib.Path(__file__).resolve().parent
_SO = _HERE / "libballista_shuffle.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile into a private file and rename it into place, so processes
    building at once never load a half-written library."""
    src = _HERE / "shuffle.cpp"
    tmp = _SO.with_name(f"{_SO.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except Exception as e:
        tmp.unlink(missing_ok=True)
        log.warning("native shuffle build failed, using numpy fallback: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SO.exists() or _SO.stat().st_mtime < (_HERE / "shuffle.cpp").stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.hash_mix_i64.argtypes = [i64p, ctypes.c_int64, u64p]
        lib.hash_mix_i32.argtypes = [i32p, ctypes.c_int64, u64p]
        lib.hash_mix_f64.argtypes = [f64p, ctypes.c_int64, u64p]
        lib.hash_mix_str.argtypes = [i32p, u8p, ctypes.c_int64, u64p]
        lib.hash_to_partitions.argtypes = [u64p, ctypes.c_int64, ctypes.c_uint32, i32p]
        lib.partition_indices.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_uint32, i64p, i64p
        ]
        _lib = lib
    except OSError as e:
        log.warning("cannot load native shuffle lib: %s", e)
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_hash_rows(arrays: List[pa.Array], num_partitions: int) -> Optional[np.ndarray]:
    """C++ row hashing over Arrow buffers; None -> caller uses numpy path.

    Produces bit-identical results to the numpy implementation in
    physical/repartition.py (same splitmix64/FNV-1a scheme), so executors
    with and without a compiler can cooperate in one shuffle.
    """
    lib = get_lib()
    if lib is None:
        return None
    try:
        n = len(arrays[0])
        acc = np.zeros(n, dtype=np.uint64)
        for arr in arrays:
            a = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
            if a.null_count:
                return None
            t = a.type
            if pa.types.is_date32(t):
                a = a.cast(pa.int32())
                t = a.type
            if (
                pa.types.is_integer(t)
                or pa.types.is_boolean(t)
                or pa.types.is_timestamp(t)
            ):
                # everything integer-like routes through int64, matching the
                # numpy path exactly (sub-64-bit values sign/zero-extend the
                # same way; uint32 > 2^31 must not truncate)
                vals = np.ascontiguousarray(
                    a.cast(pa.int64()).to_numpy(zero_copy_only=False).astype(np.int64)
                )
                lib.hash_mix_i64(
                    _ptr(vals, ctypes.c_int64), n, _ptr(acc, ctypes.c_uint64)
                )
            elif pa.types.is_floating(t):
                vals = np.ascontiguousarray(
                    a.cast(pa.float64()).to_numpy(zero_copy_only=False)
                )
                lib.hash_mix_f64(_ptr(vals, ctypes.c_double), n, _ptr(acc, ctypes.c_uint64))
            elif pa.types.is_string(t):
                bufs = a.buffers()  # [validity, offsets, data]
                if a.offset != 0:
                    return None
                offsets = np.frombuffer(bufs[1], dtype=np.int32, count=n + 1)
                data = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] else np.zeros(1, np.uint8)
                lib.hash_mix_str(
                    _ptr(np.ascontiguousarray(offsets), ctypes.c_int32),
                    _ptr(np.ascontiguousarray(data), ctypes.c_uint8),
                    n,
                    _ptr(acc, ctypes.c_uint64),
                )
            else:
                return None
        out = np.empty(n, dtype=np.int32)
        lib.hash_to_partitions(
            _ptr(acc, ctypes.c_uint64), n, num_partitions, _ptr(out, ctypes.c_int32)
        )
        return out
    except Exception as e:  # contract: any native-path surprise -> numpy path
        log.warning("native hash failed, numpy fallback: %s", e)
        return None


def native_partition_indices(
    part_ids: np.ndarray, num_partitions: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Counting-sort split: returns (row indices grouped by partition,
    offsets[num_partitions+1]); None -> numpy fallback."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(part_ids)
    ids = np.ascontiguousarray(part_ids, dtype=np.int32)
    indices = np.empty(n, dtype=np.int64)
    offsets = np.empty(num_partitions + 1, dtype=np.int64)
    lib.partition_indices(
        _ptr(ids, ctypes.c_int32), n, num_partitions,
        _ptr(indices, ctypes.c_int64), _ptr(offsets, ctypes.c_int64),
    )
    return indices, offsets
