"""Scheduler daemon: python -m ballista_tpu_torch.scheduler [--port 50050 ...]

(ref rust/scheduler/src/main.rs: parse config, pick state backend, serve.)
"""

from __future__ import annotations

import logging
import time

from ballista_tpu_torch.daemon_config import SCHEDULER_SPEC, load_config
from ballista_tpu_torch.scheduler.kv import EtcdBackend, MemoryBackend, SqliteBackend
from ballista_tpu_torch.scheduler.server import SchedulerServer, serve


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    cfg = load_config(
        SCHEDULER_SPEC,
        "BALLISTA_SCHEDULER_",
        "/etc/ballista/scheduler.toml",
        prog="ballista-scheduler",
    )
    backend = cfg["config_backend"].lower()
    if backend == "etcd":
        kv = EtcdBackend(cfg["etcd_urls"])
    elif backend == "sqlite":
        kv = SqliteBackend(cfg["sqlite_path"])
    else:
        kv = MemoryBackend()
    from ballista_tpu_torch.config import BallistaConfig

    impl = SchedulerServer(
        kv,
        namespace=cfg["namespace"],
        config=BallistaConfig(
            {"ballista.executor.data_roots": cfg["data_roots"]}
        ),
    )
    server = serve(impl, cfg["bind_host"], cfg["port"])
    logging.getLogger("ballista.scheduler").info(
        "Ballista-TPU scheduler up (backend=%s, namespace=%s, port=%s)",
        backend, cfg["namespace"], cfg["port"],
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop(grace=2)


if __name__ == "__main__":
    main()
