"""Error types.

Mirrors the reference's single error enum with per-subsystem variants
(reference rust/core/src/error.rs:30-163) as a small exception hierarchy.
"""

from __future__ import annotations


class BallistaError(Exception):
    """Base error for all ballista_tpu failures."""


class NotImplementedError_(BallistaError):
    """Feature not implemented (reference error.rs NotImplemented variant)."""


class InternalError(BallistaError):
    """Invariant violation inside the engine."""


class PlanError(BallistaError):
    """Logical/physical planning failure (reference DataFusionError role)."""


class SchemaError(BallistaError):
    """Schema mismatch / unknown column."""


class SqlError(BallistaError):
    """SQL lex/parse/plan failure (reference error.rs Sql variant)."""


class SerdeError(BallistaError):
    """Plan (de)serialization failure."""


class IoError(BallistaError):
    """Filesystem / IPC failure (reference error.rs Io variant)."""


class RpcError(BallistaError):
    """Control-plane (gRPC) failure (reference Tonic/Grpc variants)."""


class ShuffleFetchError(RpcError):
    """A shuffle fetch from a peer executor failed mid-task. Carries the
    lost location (owning executor + map stage/partition + path) so the
    executor can report a `fetch_failed` status and the scheduler can
    recompute just that map partition (lineage-based shuffle recovery)
    instead of failing the job."""

    def __init__(
        self,
        message: str,
        *,
        executor_id: str = "",
        host: str = "",
        port: int = 0,
        path: str = "",
        stage_id: int = 0,
        map_partition: int = 0,
    ) -> None:
        super().__init__(message)
        self.executor_id = executor_id
        self.host = host
        self.port = port
        self.path = path
        self.stage_id = stage_id
        self.map_partition = map_partition


class DeviceError(RuntimeError):
    """A device-path failure that must not fall back to the host: a kernel
    that does not build, load or launch, a stage run on a device it was
    not prepared for, a mesh over CUDA devices that are missing. It is no
    decline (``UnsupportedOnDevice``): it propagates and fails the query or
    the task. A ``RuntimeError``, so callers that caught the untyped error
    still catch it."""


class ExecutionError(BallistaError):
    """Runtime failure while executing a physical plan."""
