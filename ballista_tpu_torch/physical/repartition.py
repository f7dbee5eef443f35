"""RepartitionExec: hash / round-robin redistribution.

Reference: PhysicalRepartition (rust/core/proto/ballista.proto:415-422,
serde from_proto.rs:133-164). In the distributed path the planner replaces
this with a stage boundary (shuffle write + shuffle read); this operator is
the in-process fallback and defines the row->partition hash contract shared
by the shuffle writer and the TPU all_to_all exchange.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.physical.expr import PhysicalExpr, _as_array
from ballista_tpu_torch.physical.plan import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    batch_table,
)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Stable 64-bit mix; the row-hash contract for hash partitioning."""
    z = (x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hash_rows(arrays: List[pa.Array], num_partitions: int) -> np.ndarray:
    """Map each row to a partition id by hashing key columns. Uses the C++
    kernel when available (bit-identical scheme), numpy otherwise."""
    from ballista_tpu_torch.native import native_hash_rows

    native = native_hash_rows(arrays, num_partitions)
    if native is not None:
        return native.astype(np.int64)
    n = len(arrays[0])
    acc = np.zeros(n, dtype=np.uint64)
    for arr in arrays:
        a = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
        if pa.types.is_date32(a.type):
            a = a.cast(pa.int32())
        elif pa.types.is_date64(a.type) or pa.types.is_timestamp(a.type):
            a = a.cast(pa.int64())
        # NULL keys hash deterministically to 0 (NaN->int is platform-
        # dependent; a mixed cluster must agree on NULL's partition)
        null_mask = None
        if a.null_count:
            null_mask = pc.is_null(a).to_numpy(zero_copy_only=False)
            a = pc.fill_null(a, pa.scalar(0, type=a.type) if not pa.types.is_string(a.type) else "")
        if pa.types.is_integer(a.type) or pa.types.is_boolean(a.type):
            vals = pc.cast(a, pa.int64()).to_numpy(zero_copy_only=False).astype(np.int64)
            h = _splitmix64(vals.view(np.uint64) if vals.dtype == np.int64 else vals.astype(np.uint64))
        elif pa.types.is_floating(a.type):
            vals = a.to_numpy(zero_copy_only=False)
            h = _splitmix64(np.asarray(vals, dtype=np.float64).view(np.uint64))
        else:
            # strings / other: stable FNV-1a over utf8 bytes (python loop;
            # string partition keys are off the TPC-H hot path)
            h = np.empty(n, dtype=np.uint64)
            for i, v in enumerate(a.to_pylist()):
                if v is None:
                    h[i] = np.uint64(0)
                    continue
                acc2 = np.uint64(0xCBF29CE484222325)
                for b in str(v).encode():
                    acc2 = np.uint64((int(acc2) ^ b) * 0x100000001B3 & 0xFFFFFFFFFFFFFFFF)
                h[i] = acc2
        if null_mask is not None:
            h = np.where(null_mask, np.uint64(0), h)
        acc = _splitmix64(acc ^ h)
    return (acc % np.uint64(num_partitions)).astype(np.int64)


def split_by_partition(
    batch: pa.RecordBatch, part_ids: np.ndarray, n_out: int
) -> List[pa.RecordBatch]:
    """One-pass split: counting-sort row indices by partition (C++ kernel
    when available), then a single take + per-partition zero-copy slices —
    O(n + P) instead of P full-batch filters."""
    from ballista_tpu_torch.native import native_partition_indices

    res = native_partition_indices(np.asarray(part_ids, dtype=np.int32), n_out)
    if res is None:
        order = np.argsort(part_ids, kind="stable")
        sorted_ids = np.asarray(part_ids)[order]
        offsets = np.searchsorted(sorted_ids, np.arange(n_out + 1))
        indices = order
    else:
        indices, offsets = res
    taken = batch.take(pa.array(indices))
    return [
        taken.slice(int(offsets[m]), int(offsets[m + 1] - offsets[m]))
        for m in range(n_out)
    ]


class RepartitionExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, partitioning: Partitioning) -> None:
        self.input = input
        self.partitioning = partitioning
        self._lock = threading.Lock()
        self._splits: Optional[List[pa.Table]] = None  # guarded-by: self._lock

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def output_partitioning(self) -> Partitioning:
        return self.partitioning

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "RepartitionExec":
        return RepartitionExec(children[0], self.partitioning)

    def split_batch(self, batch: pa.RecordBatch) -> List[pa.RecordBatch]:
        """Split one batch into num_partitions batches (shuffle-writer entry)."""
        n_out = self.partitioning.partition_count()
        if self.partitioning.scheme == "hash":
            keys = [
                _as_array(e.evaluate(batch), batch.num_rows)
                for e in self.partitioning.exprs
            ]
            part_ids = hash_rows(keys, n_out)
        else:
            part_ids = np.arange(batch.num_rows, dtype=np.int64) % n_out
        return split_by_partition(batch, part_ids, n_out)

    # executes the input plan while holding the lock (see join.py note)
    # may-acquire: group:exec_substrate
    def _materialize(self, ctx: TaskContext) -> List[pa.Table]:
        with self._lock:
            if self._splits is None:
                n_out = self.partitioning.partition_count()
                buckets: List[List[pa.RecordBatch]] = [[] for _ in range(n_out)]
                for p in range(self.input.output_partitioning().partition_count()):
                    for batch in self.input.execute(p, ctx):
                        for i, piece in enumerate(self.split_batch(batch)):
                            if piece.num_rows:
                                buckets[i].append(piece)
                self._splits = [
                    pa.Table.from_batches(bs, schema=self.schema())
                    if bs
                    else self.schema().empty_table()
                    for bs in buckets
                ]
            return self._splits

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        splits = self._materialize(ctx)
        yield from batch_table(splits[partition], ctx.batch_size)

    def fmt(self) -> str:
        return f"RepartitionExec: {self.partitioning!r}"
