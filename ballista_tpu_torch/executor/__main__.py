"""Executor daemon: python -m ballista_tpu_torch.executor [--local ...]

(ref rust/executor/src/main.rs: config parse; --local spins an in-process
scheduler first, main.rs:101-138; start Flight server; run the poll loop.)

SIGINT stops the executor cleanly and logs one JSON line,
{"executor_stop": {...}}, with what ran in this process: kernel launches,
the libraries it loaded, routes, shuffle-tier and exchange counters. Those
counters live in this process only; the line is how a caller reads them.
SIGTERM and SIGKILL end the process without a stop.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import tempfile
import time

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.daemon_config import EXECUTOR_SPEC, load_config
from ballista_tpu_torch.executor.runtime import BallistaExecutor
from ballista_tpu_torch.scheduler.kv import SqliteBackend
from ballista_tpu_torch.scheduler.server import SchedulerServer, serve


# the executor daemon's spec: the shared one with the port's backends (the
# device stages default to "cuda") and the torch device they run on
_SPEC = [
    ("backend", "cuda", "kernel backend: cuda | cpu") if name == "backend" else (name, default, help_)
    for name, default, help_ in EXECUTOR_SPEC
] + [("device", "", "torch device of the device stages ('' = the GPU; cpu)")]


def stop_record(executor: BallistaExecutor, backend: str) -> dict:
    """The {"executor_stop": ...} line's object: this process's counters
    and, on a card, the device memory its allocator held at most."""
    import torch

    from ballista_tpu_torch.ops import cuda_kernels, runtime

    on_card = executor.device.type == "cuda" and torch.cuda.is_initialized()
    return {"executor_stop": {
        "id": executor.id,
        "pid": os.getpid(),
        "backend": backend,
        "device": str(executor.device),
        "launch_counts": cuda_kernels.launch_counts(),
        "kernel_libraries": cuda_kernels.loaded_libraries(),
        "routing_stats": runtime.routing_stats(),
        "shuffle_tier_stats": runtime.shuffle_tier_stats(),
        "exchange_stats": runtime.exchange_stats(),
        "max_memory_reserved": torch.cuda.max_memory_reserved() if on_card else 0,
    }}


def main() -> None:
    # SIGINT is the clean stop. A process started in the background of
    # a shell (or under nohup) inherits SIGINT ignored, and Python keeps
    # it so: SIGINT then did nothing at all
    signal.signal(signal.SIGINT, signal.default_int_handler)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    log = logging.getLogger("ballista.executor")
    cfg = load_config(
        _SPEC,
        "BALLISTA_EXECUTOR_",
        "/etc/ballista/executor.toml",
        prog="ballista-executor",
    )
    scheduler_host, scheduler_port = cfg["scheduler_host"], cfg["scheduler_port"]
    if cfg["local"]:
        kv = SqliteBackend(tempfile.mktemp(prefix="ballista-local-", suffix=".db"))
        impl = SchedulerServer(kv, namespace=cfg["namespace"])
        serve(impl, "127.0.0.1", cfg["scheduler_port"])
        scheduler_host = "127.0.0.1"
        log.info("in-process scheduler on port %s", scheduler_port)

    executor = BallistaExecutor(
        scheduler_host,
        scheduler_port,
        external_host=cfg["external_host"],
        port=cfg["port"],
        work_dir=cfg["work_dir"] or None,
        concurrent_tasks=cfg["concurrent_tasks"],
        device=cfg["device"] or None,
        config=BallistaConfig(
            {
                "ballista.executor.backend": cfg["backend"],
                "ballista.executor.data_roots": cfg["data_roots"],
                # disaggregated tier (ISSUE 15): a daemon-configured tier
                # is PINNED — per-job settings cannot redirect shuffle
                # writes/reads elsewhere (execution_loop re-pins both keys,
                # and the Flight data plane always uses this config) — and
                # the daemon's GC sweep owns this root's TTL
                "ballista.shuffle.tier": cfg["shuffle_tier"],
                "ballista.shuffle.dir": cfg["shuffle_dir"],
                # on a card every kernel library loads (or builds) before
                # the executor serves, so no task pays for a build and a
                # library that does not build fails the start (a no-op on
                # the CPU and on the "cpu" backend)
                "ballista.tpu.prewarm": "true",
            }
        ),
    )
    executor.start()
    try:
        # inside the try: a SIGINT sent on seeing this line stops cleanly
        log.info(
            "Ballista executor up (id=%s, flight=%s:%s, backend=%s, device=%s)",
            executor.id, cfg["external_host"], executor.port, cfg["backend"],
            executor.device,
        )
        # short sleeps: a SIGINT that the kernel delivers to another of this
        # process's threads (grpc's, Arrow Flight's) only sets Python's
        # flag, and the main thread raises KeyboardInterrupt when its sleep
        # ends; with time.sleep(3600) the stop came up to an hour late
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        executor.stop()
        log.info("%s", json.dumps(stop_record(executor, cfg["backend"]), default=str))


if __name__ == "__main__":
    main()
