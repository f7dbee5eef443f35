"""Arrow <-> bytes helpers for the wire contract.

Schemas and record batches travel as Arrow IPC — the Arrow wire format
itself — instead of the reference's hand-rolled type enum
(reference rust/core/proto/ballista.proto:611-800).
"""

from __future__ import annotations

import io
from typing import List

import pyarrow as pa


def schema_to_ipc(schema: pa.Schema) -> bytes:
    return schema.serialize().to_pybytes()


def schema_from_ipc(data: bytes) -> pa.Schema:
    return pa.ipc.read_schema(pa.BufferReader(data))


def dtype_to_ipc(dtype: pa.DataType) -> bytes:
    return schema_to_ipc(pa.schema([pa.field("f", dtype)]))


def dtype_from_ipc(data: bytes) -> pa.DataType:
    return schema_from_ipc(data).field(0).type


def batches_to_ipc(batches: List[pa.RecordBatch], schema: pa.Schema) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, schema) as w:
        for b in batches:
            w.write_batch(b)
    return sink.getvalue()


def batches_from_ipc(data: bytes) -> List[pa.RecordBatch]:
    with pa.ipc.open_stream(pa.BufferReader(data)) as r:
        return list(r)
