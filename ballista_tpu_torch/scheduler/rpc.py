"""gRPC plumbing for the SchedulerGrpc service.

The service contract lives in ballista.proto (ref proto:594-605). The grpc
codegen plugin isn't in this toolchain, so the server registration and the
client stub are written over grpcio's generic API — same wire behavior as
generated stubs (method paths /ballista.SchedulerGrpc/<Method>).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

import grpc

from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.utils.locks import make_lock

SERVICE_NAME = "ballista.SchedulerGrpc"

# serialized logical plans embed in-memory table data; gRPC's 4MB default
# rejects them for anything but toy tables. 256MB matches the data sizes the
# memory-scan path is meant for — file-backed scans ship only paths.
_MAX_MSG = 256 * 1024 * 1024
GRPC_MESSAGE_OPTIONS = [
    ("grpc.max_send_message_length", _MAX_MSG),
    ("grpc.max_receive_message_length", _MAX_MSG),
    # a scheduler restart closes every channel (GOAWAY); grpc's default
    # ~1s initial TCP reconnect backoff would outlast the app-level retry
    # budget (ballista.rpc.retries x backoff_ms), so a client whose
    # reconnect attempt lands in the tiny rebind gap reported "connection
    # refused" for a full second. Restarts are routine here (ISSUE 6
    # crash tolerance, rolling deploys): reconnect fast, cap at 1s.
    ("grpc.initial_reconnect_backoff_ms", 50),
    ("grpc.min_reconnect_backoff_ms", 50),
    ("grpc.max_reconnect_backoff_ms", 1000),
]

_METHODS = {
    "ExecuteQuery": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    "PollWork": (pb.PollWorkParams, pb.PollWorkResult),
    "GetJobStatus": (pb.GetJobStatusParams, pb.GetJobStatusResult),
    "GetExecutorsMetadata": (pb.GetExecutorMetadataParams, pb.GetExecutorMetadataResult),
    "GetFileMetadata": (pb.GetFileMetadataParams, pb.GetFileMetadataResult),
    "ReportLostPartition": (
        pb.ReportLostPartitionParams,
        pb.ReportLostPartitionResult,
    ),
}

# server-streaming methods (ISSUE 8/11): the response type streams. Kept in
# a separate table because the handler/stub constructors differ.
_STREAM_METHODS = {
    "SubscribeWork": (pb.SubscribeWorkParams, pb.TaskDefinition),
    "SubscribeJobStatus": (pb.GetJobStatusParams, pb.GetJobStatusResult),
}


def add_scheduler_service(server: grpc.Server, servicer) -> None:
    handlers = {}
    for name, (req_cls, resp_cls) in _METHODS.items():
        method = getattr(servicer, name)

        def make(method):
            def handle(request, context):
                return method(request, context)

            return handle

        handlers[name] = grpc.unary_unary_rpc_method_handler(
            make(method),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )
    for name, (req_cls, resp_cls) in _STREAM_METHODS.items():
        method = getattr(servicer, name, None)
        if method is None:
            continue  # wire compat: pre-ISSUE-8 servicers have no stream

        def make_stream(method):
            def handle(request, context):
                return method(request, context)

            return handle

        handlers[name] = grpc.unary_stream_rpc_method_handler(
            make_stream(method),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


def backoff_delay(attempt: int, base: float, cap: float = 2.0) -> float:
    """Jittered exponential backoff: base * 2^attempt scaled by a uniform
    [0.5, 1.5) jitter so a fleet of retrying clients decorrelates, then
    capped — the cap is a hard ceiling (an executor sleeping past it eats
    into its heartbeat/lease budget). The jitter draws from the module rng —
    it shapes TIMING only, never results, so it stays outside the
    deterministic chaos machinery."""
    if base <= 0.0:
        return 0.0
    return min(cap, base * (2.0 ** attempt) * random.uniform(0.5, 1.5))


class SchedulerGrpcClient:
    """Client stub (plays the role of tonic's generated SchedulerGrpcClient).

    Transient failures (UNAVAILABLE / connect errors — a scheduler restart,
    a network blip) are retried `retries` times with jittered exponential
    backoff; execution errors surface immediately. An armed chaos injector
    (utils/chaos.py "rpc.call" site) exercises exactly this loop.

    Replicated control plane (ISSUE 20): the client may hold a LIST of
    scheduler endpoints. Calls go to the active endpoint; every transient
    failure rotates to the next before retrying, so a dead replica (or an
    ownership redirect, which the replicas answer as UNAVAILABLE naming
    the owner) re-homes the caller within one retry loop. Channels are
    built lazily per endpoint and all share one options/backoff config."""

    def __init__(
        self,
        host: str,
        port: int,
        channel: Optional[grpc.Channel] = None,
        retries: int = 3,
        backoff_s: float = 0.05,
        chaos=None,
        endpoints=None,
    ) -> None:
        # (host, port) stays endpoint 0 for wire compat; `endpoints` adds
        # failover peers in preference order (duplicates of endpoint 0 drop)
        self.endpoints = [(host, int(port))]
        for ep in endpoints or ():
            ep = (ep[0], int(ep[1]))
            if ep not in self.endpoints:
                self.endpoints.append(ep)
        self._channels: dict = {}
        if channel is not None:
            self._channels[0] = channel
        self._active = 0
        self._stub_cache: dict = {}
        self.retries = max(0, retries)
        self.backoff_s = backoff_s
        self.chaos = chaos
        self._chaos_mu = make_lock("scheduler.rpc._chaos_mu")
        # method -> call count
        # guarded-by: self._chaos_mu
        self._chaos_calls: dict = {}

    @property
    def channel(self) -> grpc.Channel:
        """The ACTIVE endpoint's channel (wire compat with single-endpoint
        callers that reach in for it)."""
        return self._channel(self._active)

    def _channel(self, idx: int) -> grpc.Channel:
        ch = self._channels.get(idx)
        if ch is None:
            h, p = self.endpoints[idx]
            ch = grpc.insecure_channel(
                f"{h}:{p}", options=GRPC_MESSAGE_OPTIONS
            )
            self._channels[idx] = ch
        return ch

    def _stub(self, name: str, stream: bool = False):
        idx = self._active
        key = (idx, name)
        stub = self._stub_cache.get(key)
        if stub is None:
            factory = (
                self._channel(idx).unary_stream
                if stream
                else self._channel(idx).unary_unary
            )
            resp_cls = (_STREAM_METHODS if stream else _METHODS)[name][1]
            stub = factory(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString,
            )
            self._stub_cache[key] = stub
        return stub

    def active_endpoint(self):
        return self.endpoints[self._active]

    def rotate_endpoint(self) -> None:
        """Advance to the next endpoint (no-op with one). Benign under
        concurrent callers: _active is a plain index and every value of it
        names a valid endpoint."""
        if len(self.endpoints) > 1:
            self._active = (self._active + 1) % len(self.endpoints)

    def prefer_endpoint(self, addr: str) -> bool:
        """Jump to the endpoint named by a `host:port` ownership hint
        (GetJobStatusResult.owner_addr). True iff this SWITCHED the active
        endpoint; unknown addresses are ignored — the hint optimizes
        rotation, it never widens the configured endpoint set."""
        host, _, port = addr.rpartition(":")
        try:
            ep = (host, int(port))
        except ValueError:
            return False
        if ep not in self.endpoints or ep == self.endpoints[self._active]:
            return False
        self._active = self.endpoints.index(ep)
        return True

    def _prefer_from_detail(self, detail: str) -> bool:
        """Parse a replica's ownership-redirect detail (`... owned by peer
        replica '<id>' at <host:port>; ...`) and jump to the named owner.
        False when the detail carries no usable hint."""
        if "owned by peer replica" not in detail:
            return False
        _, _, rest = detail.partition(" at ")
        addr = rest.split(";", 1)[0].strip()
        return bool(addr) and self.prefer_endpoint(addr)

    def _chaos_key(self, name: str) -> str:
        # per-method call index: a RETRY of a failed call draws a fresh
        # deterministic verdict instead of failing forever
        with self._chaos_mu:
            n = self._chaos_calls.get(name, 0) + 1
            self._chaos_calls[name] = n
        return f"{name}/{n}"

    def _call(self, name: str, params, also_transient=None):
        """One RPC with the transient-retry loop. `also_transient` is an
        optional predicate over the error detail string for responses a
        specific method knows to be retryable (e.g. the GetFileMetadata
        throttle hint) even though their status code says otherwise."""
        from ballista_tpu_torch.errors import RpcError
        from ballista_tpu_torch.ops.runtime import record_recovery
        from ballista_tpu_torch.utils.chaos import ChaosInjected

        attempts = self.retries + 1
        for i in range(attempts):
            try:
                if self.chaos is not None:
                    self.chaos.maybe_fail("rpc.call", self._chaos_key(name))
                return self._stub(name)(params)
            except ChaosInjected as e:
                transient, detail, err = True, str(e), e
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                detail = e.details() if hasattr(e, "details") else str(e)
                # UNAVAILABLE covers both "server not up yet" (connect
                # refused) and "went away mid-call". CANCELLED is the other
                # went-away shape (ISSUE 11): a scheduler crash/restart
                # stops its gRPC server, which GOAWAYs in-flight unary
                # calls as CANCELLED — for a crash-tolerant client that is
                # the same transient as UNAVAILABLE (this client never
                # cancels its own unary calls). Anything else is the
                # server actually answering — surface it immediately.
                transient = code in (
                    grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.CANCELLED
                ) or (
                    also_transient is not None and also_transient(detail)
                )
                err = e
            if not transient or i + 1 >= attempts:
                raise RpcError(f"{name} failed: {detail}") from err
            record_recovery("rpc_retry")
            # replica failover (ISSUE 20): try another endpoint before
            # sleeping — a dead or redirecting replica should cost one
            # backoff step, not the whole retry budget. An ownership
            # redirect names the owner in its detail; jump straight there
            # when it is a configured endpoint, else rotate blind.
            if not self._prefer_from_detail(detail):
                self.rotate_endpoint()
            time.sleep(backoff_delay(i, self.backoff_s))
        raise AssertionError("unreachable")  # loop always returns or raises

    def execute_query(self, params: pb.ExecuteQueryParams) -> pb.ExecuteQueryResult:
        return self._call("ExecuteQuery", params)

    def poll_work(self, params: pb.PollWorkParams) -> pb.PollWorkResult:
        return self._call("PollWork", params)

    def subscribe_work(self, params: pb.SubscribeWorkParams):
        """Open the push-dispatch stream (ISSUE 8). Returns the live gRPC
        call object — an iterator of TaskDefinition that also supports
        .cancel(). NO retry wrapper here: stream life-cycle (reconnect with
        backoff, fallback to polling while down) belongs to the subscribe
        loop in executor/execution_loop.py, which must observe every drop.
        Opens against the ACTIVE endpoint — after a failover rotated the
        client, a re-subscribe lands on the adopting replica."""
        return self._stub("SubscribeWork", stream=True)(params)

    def get_job_status(self, params: pb.GetJobStatusParams) -> pb.GetJobStatusResult:
        return self._call("GetJobStatus", params)

    def subscribe_job_status(self, params: pb.GetJobStatusParams):
        """Open the push job-status stream (ISSUE 11). Returns the live
        gRPC call object — an iterator of GetJobStatusResult that also
        supports .cancel(). NO retry wrapper, like subscribe_work: the
        client's status-watch helper owns fallback-to-polling on any drop.
        Opens against the ACTIVE endpoint (re-homed by owner_addr hints)."""
        return self._stub("SubscribeJobStatus", stream=True)(params)

    def get_executors_metadata(self) -> pb.GetExecutorMetadataResult:
        return self._call("GetExecutorsMetadata", pb.GetExecutorMetadataParams())

    def report_lost_partition(
        self, params: pb.ReportLostPartitionParams
    ) -> pb.ReportLostPartitionResult:
        return self._call("ReportLostPartition", params)

    def get_file_metadata(self, params: pb.GetFileMetadataParams) -> pb.GetFileMetadataResult:
        """GetFileMetadata with throttle handling: the server sheds load
        with a fail-fast 'too many concurrent metadata requests; retry'
        error (scheduler/server.py caps its slots); honor the hint with the
        shared backoff loop instead of surfacing it to the caller."""
        return self._call(
            "GetFileMetadata",
            params,
            also_transient=lambda detail: (
                "too many concurrent metadata requests" in detail
            ),
        )

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()
