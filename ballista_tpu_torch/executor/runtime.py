"""Executor process assembly + standalone (local) cluster.

BallistaExecutor ties together the Flight data plane and the poll loop
(reference rust/executor/src/main.rs). start_standalone_cluster is the
`--local` mode equivalent (ref main.rs:101-138): an in-process scheduler on
an embedded KV backend plus N executors, all in one process.
"""

from __future__ import annotations

import logging
import socket
import tempfile
import threading
import uuid
from typing import List, Optional, Tuple

import grpc

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.executor.execution_loop import PollLoop
from ballista_tpu_torch.executor.flight_service import BallistaFlightService
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.scheduler.kv import KvBackend, MemoryBackend
from ballista_tpu_torch.scheduler.rpc import SchedulerGrpcClient
from ballista_tpu_torch.scheduler.server import SchedulerServer, serve
from ballista_tpu_torch.utils import counters

log = logging.getLogger("ballista.executor")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class BallistaExecutor:
    """One executor: Flight server + poll loop + work dir
    (ref BallistaExecutor/ExecutorConfig, rust/executor/src/lib.rs:20-49)."""

    def __init__(
        self,
        scheduler_host: str,
        scheduler_port: int,
        external_host: str = "127.0.0.1",
        port: Optional[int] = None,
        work_dir: Optional[str] = None,
        concurrent_tasks: int = 4,
        config: Optional[BallistaConfig] = None,
        executor_id: Optional[str] = None,
        scheduler_endpoints: Optional[List[Tuple[str, int]]] = None,
        device=None,
        mesh_devices=None,
    ) -> None:
        from ballista_tpu_torch.engine.context import resolve_device

        # the torch.device this executor's device stages run on: the GPU
        # unless the caller asks for the CPU (raises when CUDA is missing)
        self.device = resolve_device(device)
        self.id = executor_id or str(uuid.uuid4())
        self.host = external_host
        self.port = port or _free_port()
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-executor-")
        self.config = config or BallistaConfig()
        self.flight = BallistaFlightService(
            f"grpc://0.0.0.0:{self.port}", self.work_dir, self.config,
            device=self.device,
        )
        self._flight_thread = threading.Thread(target=self.flight.serve, daemon=True)
        from ballista_tpu_torch.utils.chaos import chaos_from_config

        # replicated control plane (ISSUE 20): the extra endpoints let the
        # client rotate to a peer replica when its home scheduler dies —
        # failed polls rotate, and the ownership-redirect abort names the
        # new owner so re-homing converges in one hop
        self.scheduler_client = SchedulerGrpcClient(
            scheduler_host,
            scheduler_port,
            retries=self.config.rpc_retries(),
            backoff_s=self.config.rpc_backoff_s(),
            chaos=chaos_from_config(self.config),
            endpoints=scheduler_endpoints,
        )
        meta = pb.ExecutorMetadata(id=self.id, host=self.host, port=self.port)
        self.poll_loop = PollLoop(
            self.scheduler_client,
            meta,
            self.work_dir,
            config=self.config,
            concurrent_tasks=concurrent_tasks,
            # chaos executor.death must be a TOTAL death: heartbeats stop
            # AND the data plane goes away, so completed shuffle outputs
            # really become unreachable and lineage recovery is exercised
            on_death=self._die,
            device=self.device,
            mesh_devices=mesh_devices,
        )

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful scale-in (ISSUE 15): stop offering slots, finish and
        report every in-flight task. See PollLoop.drain."""
        return self.poll_loop.drain(timeout)

    def start(self) -> None:
        if self.config.tpu_prewarm() and self.config.backend() == "cuda":
            # load every kernel library BEFORE serving, so the first query
            # builds nothing (a no-op on CPU tensors). Not caught: a kernel
            # that does not build or load fails executor start.
            from ballista_tpu_torch.ops import cuda_kernels

            cuda_kernels.prewarm(self.config, self.device)
        self._flight_thread.start()
        self.poll_loop.start()
        log.info("executor %s serving flight on port %s", self.id, self.port)

    def _die(self) -> None:
        """The data plane goes with a dead executor: its Flight service and
        its exchange registry entries."""
        from ballista_tpu_torch.ops import exchange

        self.flight.shutdown()
        exchange.evict_executor(self.id)

    def stop(self) -> None:
        self.poll_loop.stop()
        self._die()
        self.scheduler_client.close()


class StandaloneCluster:
    """In-process scheduler + N executors (ref --local mode).

    Elastic fleet (ISSUE 15): with ballista.fleet.max > 0 an autoscaler
    thread re-sizes the fleet every ballista.fleet.interval_s against the
    admission queue's cost-model-predicted backlog seconds
    (SchedulerState.predicted_backlog_seconds) — scale-OUT spawns
    executors while the backlog exceeds ballista.fleet.target_backlog_s,
    scale-IN gracefully drains one executor per idle evaluation (stop
    offering slots, finish running tasks, retire) down to
    ballista.fleet.min. On the shared shuffle tier a retired executor's
    completed outputs stay readable from storage, so scale-in completes
    running jobs with zero task retries."""

    def __init__(
        self,
        n_executors: int = 2,
        kv: Optional[KvBackend] = None,
        config: Optional[BallistaConfig] = None,
        concurrent_tasks: int = 4,
        n_schedulers: int = 1,
        device=None,
        mesh_devices=None,
    ) -> None:
        from ballista_tpu_torch.engine.context import resolve_device
        from ballista_tpu_torch.utils.chaos import chaos_from_config
        from ballista_tpu_torch.utils.locks import make_lock

        # every executor shares this device (the GPU unless the caller asks
        # for the CPU); resolved before any server starts, so a missing
        # CUDA raises with nothing left running
        self.device = resolve_device(device)
        # the devices every executor's mesh stages span (parallel/mesh.py)
        self.mesh_devices = mesh_devices
        self.config = config or BallistaConfig()
        self.kv = kv or MemoryBackend()
        # replicated control plane (ISSUE 20): n_schedulers > 1 runs peer
        # SchedulerServer replicas over the SAME KV store, each with a
        # stable replica id and an advertised address (the ownership hint
        # clients/executors re-home on). n_schedulers == 1 keeps the legacy
        # anonymous single scheduler (replica_id "" — a restart reclaims
        # its predecessor's leases instead of adopting them as a peer).
        self.n_schedulers = max(1, n_schedulers)
        self.scheduler_impls: List[SchedulerServer] = []
        self.ports: List[int] = []
        self.grpc_servers: List[grpc.Server] = []
        for i in range(self.n_schedulers):
            port = _free_port()
            replica_id = f"replica-{i}" if self.n_schedulers > 1 else ""
            impl = SchedulerServer(
                self.kv,
                config=self.config,
                replica_id=replica_id,
                advertise_addr=f"127.0.0.1:{port}" if replica_id else "",
            )
            self.scheduler_impls.append(impl)
            self.ports.append(port)
            self.grpc_servers.append(serve(impl, "127.0.0.1", port))
        self._concurrent_tasks = concurrent_tasks
        # fleet membership: mutated by the autoscaler thread, read by
        # shutdown/tests. Executors are constructed and started OUTSIDE
        # the lock (their own threads take their own locks); only the
        # list/counter mutations sit under it.
        self._fleet_mu = make_lock("executor.runtime._fleet_mu")
        self.executors: List[BallistaExecutor] = []  # guarded-by: self._fleet_mu
        self._next_executor_idx = 0  # guarded-by: self._fleet_mu
        # fleet.scale chaos (ISSUE 15): a per-process decision sequence —
        # a torn verdict skips that evaluation's scale action, the next
        # evaluation draws fresh. Autoscaler-thread-only.
        self._fleet_chaos = chaos_from_config(self.config)
        self._fleet_seq = 0
        self._fleet_stop = threading.Event()
        self._fleet_thread: Optional[threading.Thread] = None
        for _ in range(n_executors):
            self._spawn_executor()
        if self.config.fleet_max() > 0:
            self._fleet_thread = threading.Thread(
                target=self._autoscale_loop, daemon=True
            )
            self._fleet_thread.start()

    def _spawn_executor(self) -> BallistaExecutor:
        """Start one executor with the next stable local-N id (chaos keys
        and test assertions address executors deterministically; ids are
        never reused across scale-in/out within one cluster)."""
        with self._fleet_mu:
            idx = self._next_executor_idx
            self._next_executor_idx += 1
        # round-robin home replica; the full (rotated) endpoint list rides
        # along so a dead home rotates to a live peer instead of stranding
        home = idx % self.n_schedulers
        endpoints = [
            ("127.0.0.1", self.ports[(home + k) % self.n_schedulers])
            for k in range(self.n_schedulers)
        ]
        ex = BallistaExecutor(
            "127.0.0.1",
            self.ports[home],
            config=self.config,
            concurrent_tasks=self._concurrent_tasks,
            executor_id=f"local-{idx}",
            scheduler_endpoints=endpoints,
            device=self.device,
            mesh_devices=self.mesh_devices,
        )
        ex.start()
        with self._fleet_mu:
            self.executors.append(ex)
        return ex

    def fleet_size(self) -> int:
        with self._fleet_mu:
            return len(self.executors)

    def _autoscale_loop(self) -> None:
        interval = self.config.fleet_interval_s()
        while not self._fleet_stop.wait(interval):
            try:
                self.autoscale_once()
            except Exception:
                log.warning("autoscaler evaluation failed", exc_info=True)

    def autoscale_once(self) -> int:
        """One autoscaler evaluation; returns the executor delta applied
        (+n grown, -1 drained, 0 no action). Public so tests and the bench
        harness can drive evaluations deterministically.

        Policy: desired = clamp(ceil(backlog / target_backlog_s),
        [min, max]) on a loaded queue — a deep backlog grows the fleet in
        ONE evaluation; an idle cluster (zero predicted backlog, nothing
        running) drains one executor per evaluation toward the floor, so
        scale-in stays gradual and each drain completes before the next
        starts."""
        import math

        fmin, fmax = self.config.fleet_min(), self.config.fleet_max()
        if fmax <= 0:
            return 0
        state = self.scheduler_impl.state
        with self.kv.lock():
            backlog = state.predicted_backlog_seconds()
            running = state.has_running_tasks()
        size = self.fleet_size()
        counters.fleet.record("evaluations")
        counters.fleet.gauge("backlog_ms", backlog * 1000.0)
        counters.fleet.gauge("fleet_size", float(size))
        target = self.config.fleet_target_backlog_s()
        desired = size
        if backlog > target and size < fmax:
            desired = min(
                fmax, max(size + 1, math.ceil(backlog / target))
            )
        elif backlog <= 0.0 and not running and size > fmin:
            desired = size - 1
        if desired == size:
            return 0
        if self._fleet_chaos is not None:
            self._fleet_seq += 1
            if self._fleet_chaos.should_inject(
                "fleet.scale", f"scale{self._fleet_seq}"
            ):
                # torn BEFORE any executor is touched: the fleet keeps its
                # size this evaluation; the next draws a fresh verdict
                counters.recovery.record("chaos_injected")
                counters.fleet.record("scale_chaos_skipped")
                log.warning(
                    "chaos[fleet.scale]: scale %d -> %d skipped",
                    size, desired,
                )
                return 0
        if desired > size:
            for _ in range(desired - size):
                self._spawn_executor()
            counters.fleet.record("scale_up", desired - size)
            counters.fleet.gauge("fleet_size", float(desired))
            log.info("fleet scaled out %d -> %d (backlog %.2fs)",
                     size, desired, backlog)
            return desired - size
        return -1 if self.scale_in_one(floor=fmin) else 0

    def scale_in_one(self, timeout: float = 60.0, floor: int = 1) -> bool:
        """Gracefully retire the newest executor: drain (stop offering
        slots, finish — and report — running tasks), stop, remove. The ONE
        scale-in mechanism, shared by the autoscaler and operator-driven
        scale-in (tests/bench drive it mid-job: on the shared shuffle tier
        the retiree's completed outputs stay readable from storage, so a
        running job finishes with zero task retries). The drain runs
        outside the fleet lock — it can take as long as the executor's
        in-flight work. Returns False when the fleet is already at
        `floor`."""
        with self._fleet_mu:
            if len(self.executors) <= max(1, floor):
                return False
            size = len(self.executors)
            ex = self.executors[-1]
        if not ex.drain(timeout=timeout):
            # capacity must actually shrink, so the retire proceeds — but
            # loudly: in-flight work dies with the executor and rides the
            # normal lease/orphan recovery (a retry), which is exactly what
            # a completed drain avoids. drain_timeout is already counted.
            log.warning(
                "scale-in drain of %s timed out after %.0fs; retiring with "
                "in-flight work (recovery will retry it)", ex.id, timeout,
            )
        ex.stop()
        with self._fleet_mu:
            if ex in self.executors:
                self.executors.remove(ex)
            size2 = len(self.executors)
        counters.fleet.record("scale_down")
        counters.fleet.gauge("fleet_size", float(size2))
        log.info("fleet scaled in: retired %s (%d -> %d)", ex.id, size, size2)
        return True

    # -- single-scheduler compat surface (replica 0) -------------------
    @property
    def scheduler_impl(self) -> SchedulerServer:
        return self.scheduler_impls[0]

    @property
    def port(self) -> int:
        return self.ports[0]

    @property
    def grpc_server(self) -> grpc.Server:
        return self.grpc_servers[0]

    @property
    def scheduler_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.port)

    @property
    def scheduler_addrs(self) -> List[str]:
        return [f"127.0.0.1:{p}" for p in self.ports]

    @property
    def scheduler_endpoints(self) -> List[Tuple[str, int]]:
        return [("127.0.0.1", p) for p in self.ports]

    def kill_scheduler(self, i: int) -> SchedulerServer:
        """Kill replica `i` PERMANENTLY (ISSUE 20 failover): fence its
        in-flight work, tear down its push streams and listening socket,
        and do NOT restart it. Its `leases/{job}` entries stop renewing;
        within one lease TTL an idle peer's housekeeping scan adopts the
        orphaned jobs via a scoped recovery run, and the dead replica's
        executors rotate to peer endpoints on their next failed poll."""
        impl = self.scheduler_impls[i]
        impl.crashed = True
        impl.stop_housekeeping()
        impl.close_push_streams()
        self.grpc_servers[i].stop(grace=None).wait()
        log.info("killed scheduler replica %d (%s)", i, impl.state.replica_id)
        return impl

    def restart_scheduler(self, i: int = 0) -> SchedulerServer:
        """Simulate scheduler process death + restart on the same KV store
        (ISSUE 6): stop the gRPC server, build a FRESH SchedulerServer over
        the same backend (its __init__ runs restart recovery — torn-job
        sweep + durable-ledger reload), and serve again on the same port so
        executors and clients ride their transient-UNAVAILABLE retry loops
        across the gap. All in-memory scheduler state (task index, ledger
        timestamps, planning threads) dies with the old instance — exactly
        what a real restart loses. The successor keeps the predecessor's
        replica identity, so it reclaims (not adopts) its own leases."""
        old = self.scheduler_impls[i]
        # fence the old instance FIRST: its still-running planning threads
        # must not publish into the store the successor is recovering
        old.crashed = True
        old.stop_housekeeping()
        # unblock the push-stream generators NOW (sentinel close) so the
        # stop below drains without waiting out their 0.25s tick — the gap
        # must stay inside retrying clients' backoff budget
        old.close_push_streams()
        # wait for the listening socket to actually close before rebinding
        # the same port (so_reuseport is not guaranteed everywhere)
        self.grpc_servers[i].stop(grace=None).wait()
        fresh = SchedulerServer(
            self.kv,
            config=self.config,
            replica_id=old.state.replica_id,
            advertise_addr=old.state.replica_addr,
        )
        # test harness tuning survives the restart (a redeployed scheduler
        # keeps its deployment config)
        fresh.lost_task_check_interval = old.lost_task_check_interval
        self.scheduler_impls[i] = fresh
        self.grpc_servers[i] = serve(fresh, "127.0.0.1", self.ports[i])
        return fresh

    def shutdown(self) -> None:
        self._fleet_stop.set()
        t = self._fleet_thread
        if t is not None:
            t.join(timeout=5)
        with self._fleet_mu:
            executors = list(self.executors)
        for ex in executors:
            ex.stop()
        for impl, srv in zip(self.scheduler_impls, self.grpc_servers):
            impl.stop_housekeeping()
            impl.close_push_streams()
            srv.stop(grace=None)
