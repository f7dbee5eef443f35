"""Chunked segment layout: cardinality-independent grouped aggregation.

The device path's round-1 ceiling was group count: XLA lowers segment_* to
scatter (serializes on TPU) and unrolled per-group reductions are O(G)
passes. This module removes the ceiling with a cache-time data layout
instead of a clever kernel:

  host, once per (partition, group-key set):
    sort rows by group key, assign dense ranks, split every rank's run of
    rows into chunks of L1 (L1 = power of two covering the 90th-percentile
    run length), and materialize the used columns as [V, L1] tiles (zero
    padded). V = number of chunks; chunks are emitted in rank order, so the
    chunk->rank "owner" array is sorted.

  device, per query (ONE call, one readback):
    evaluate filter masks / value expressions elementwise on the [V, L1]
    tiles, reduce axis 1 -> per-chunk partials [n_out, V]. Pure VPU work,
    no scatter, no matmul: O(N) regardless of G, and f32 sums reduce in
    tree order (better than sequential accumulation).

  host, per query:
    fold chunk partials to groups with np.*.reduceat over the sorted owner
    array (identity when every rank has one chunk, the common case).

Reference equivalent: the hash-aggregate kernels DataFusion provides under
HashAggregateExec (rust/core/proto/ballista.proto:370-384); the redesign
trades their per-row hash table for sorted residency + static shapes, which
is what XLA/TPU wants.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _chunk_spans(starts: np.ndarray, lens: np.ndarray, L: int,
                 min_one_chunk: bool = True):
    """Split each group's [start, start+len) row range into chunks of <= L
    rows. Vectorized. Returns (chunk start rows [V], chunk lengths [V],
    owner group of each chunk [V], all in group order)."""
    nchunks = -(-lens // L)
    if min_one_chunk:
        nchunks = np.maximum(nchunks, 1)
    V = int(nchunks.sum())
    owner = np.repeat(np.arange(len(lens), dtype=np.int64), nchunks)
    offs = np.repeat(np.cumsum(nchunks) - nchunks, nchunks)
    chunk_pos = np.arange(V, dtype=np.int64) - offs
    cstart = starts[owner] + chunk_pos * L
    clen = np.clip(lens[owner] - chunk_pos * L, 0, L)
    return cstart, clen, owner


class SortedSegmentLayout:
    """Host-side artifact built once per partition per group-key set."""

    def __init__(self, codes: np.ndarray, n_groups: int,
                 cover_max: bool = False, force_L1: Optional[int] = None,
                 min_one_chunk: bool = True) -> None:
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        grid = np.arange(n_groups, dtype=np.int64)
        starts = np.searchsorted(sorted_codes, grid)
        ends = np.searchsorted(sorted_codes, grid, side="right")
        lens = ends - starts

        # cover_max: one chunk per group whenever the longest run fits 1024
        # (fact-agg needs chunk partials == group partials); default: cover
        # the 90th percentile and let fold_* handle the tail.
        # force_L1: mesh shards must share one tile width so their [V, L1]
        # tiles stack into a single sharded array.
        if force_L1 is not None:
            L1 = force_L1
        else:
            target = int(lens.max()) if (cover_max and n_groups) else (
                int(np.percentile(lens, 90)) if n_groups else 1
            )
            L1 = 8
            while L1 < target and L1 < 1024:
                L1 <<= 1
        # min_one_chunk=False: groups with no rows here get NO chunk (mesh
        # shards fold to dense [G] with in-program segment ops, which supply
        # the identity for absent groups; the host fold_* path needs the
        # dense chunk cover instead)
        cstart, clen, owner = _chunk_spans(
            starts, lens, L1, min_one_chunk=min_one_chunk
        )

        V = len(owner)
        # int32 index math: at SF=100 these transients are the prepare's
        # host-memory peak (600M rows: int64 idx alone was 9.6 GB; the
        # whole prepare OOM-killed a 125 GB host before this). Oversized
        # partitions must DECLINE to the host path, not wrap indices.
        if len(codes) >= (1 << 31):
            from ballista_tpu_torch.ops.runtime import UnsupportedOnDevice

            raise UnsupportedOnDevice(
                f"partition of {len(codes)} rows exceeds int32 row indexing"
            )
        idx = cstart.astype(np.int32)[:, None] + np.arange(L1, dtype=np.int32)[None, :]
        idx = np.where(
            np.arange(L1, dtype=np.int32)[None, :] < clen[:, None], idx, 0
        )

        self.n_groups = n_groups
        self.L1 = L1
        self.V = V
        # valid-row count per chunk; the [V, L1] boolean mask it implies is
        # expanded IN-PROGRAM (arange(L1) < clen[:, None]) — shipping the
        # bool tiles cost 1 byte/slot of HBM (1.05 GB at SF=100, exactly
        # the margin that pushed q5 past the budget)
        self.clen = clen.astype(np.int16)
        # take-index into ORIGINAL row positions
        self.row_take = order.astype(np.int32)[idx.reshape(-1)].reshape(V, L1)
        del idx
        self.owner = owner  # sorted [V]
        # fold_*'s reduceat bookkeeping assumes every group owns >=1 chunk;
        # min_one_chunk=False layouts fold in-program instead (mesh path)
        self._host_folds = min_one_chunk
        self.one_chunk_per_group = min_one_chunk and V == n_groups
        if self._host_folds and not self.one_chunk_per_group:
            self._fold_starts = np.searchsorted(owner, grid)

    # ------------------------------------------------------------------
    def state(self) -> dict:
        """Persistable post-materialize scalars (ops/layout_cache.py).
        row_take is intentionally absent: it is only needed to materialize,
        and persisted entries carry already-materialized tiles."""
        return {
            "n_groups": int(self.n_groups),
            "L1": int(self.L1),
            "V": int(self.V),
            "host_folds": bool(self._host_folds),
            "one_chunk_per_group": bool(self.one_chunk_per_group),
        }

    @classmethod
    def from_state(cls, meta: dict, owner: np.ndarray, clen: np.ndarray):
        """Rehydrate a layout from persisted state; supports every
        post-materialize consumer (fold_*, one_chunk_per_group checks) but
        not materialize()."""
        self = cls.__new__(cls)
        self.n_groups = int(meta["n_groups"])
        self.L1 = int(meta["L1"])
        self.V = int(meta["V"])
        self.owner = owner
        self.clen = clen.astype(np.int16)
        self.row_take = None  # materialize() unsupported after rehydration
        self._host_folds = bool(meta["host_folds"])
        self.one_chunk_per_group = bool(meta["one_chunk_per_group"])
        if self._host_folds and not self.one_chunk_per_group:
            self._fold_starts = np.searchsorted(
                owner, np.arange(self.n_groups, dtype=np.int64)
            )
        return self

    def materialize(self, col: np.ndarray) -> np.ndarray:
        """Lay a row-space column out as [V, L1] tiles (pad slots carry row
        0's value; every consumer masks with the clen-derived pad)."""
        return col[self.row_take.reshape(-1)].reshape(self.V, self.L1)

    # ------------------------------------------------------------------
    def fold_sum(self, chunk_partials: np.ndarray) -> np.ndarray:
        assert self._host_folds, "min_one_chunk=False layouts fold in-program"
        if self.one_chunk_per_group:
            return chunk_partials
        # widen before folding: float for accuracy, int so exact chunk sums
        # stay exact across groups of any size
        if chunk_partials.dtype == np.float32:
            cp = chunk_partials.astype(np.float64)
        elif chunk_partials.dtype == np.int32:
            cp = chunk_partials.astype(np.int64)
        else:
            cp = chunk_partials
        return np.add.reduceat(cp, self._fold_starts)

    def fold_min(self, chunk_partials: np.ndarray) -> np.ndarray:
        assert self._host_folds, "min_one_chunk=False layouts fold in-program"
        if self.one_chunk_per_group:
            return chunk_partials
        return np.minimum.reduceat(chunk_partials, self._fold_starts)

    def fold_max(self, chunk_partials: np.ndarray) -> np.ndarray:
        assert self._host_folds, "min_one_chunk=False layouts fold in-program"
        if self.one_chunk_per_group:
            return chunk_partials
        return np.maximum.reduceat(chunk_partials, self._fold_starts)
