"""Executor daemon: python -m ballista_tpu_torch.executor [--local ...]

(ref rust/executor/src/main.rs: config parse; --local spins an in-process
scheduler first, main.rs:101-138; start Flight server; run the poll loop.)
"""

from __future__ import annotations

import logging
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


def main() -> None:
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
            }
        ),
    )
    executor.start()
    log.info(
        "Ballista executor up (id=%s, flight=%s:%s, backend=%s, device=%s)",
        executor.id, cfg["external_host"], executor.port, cfg["backend"],
        executor.device,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        executor.stop()


if __name__ == "__main__":
    main()
