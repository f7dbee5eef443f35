"""Scheduler daemon: python -m ballista_tpu_torch.scheduler [--port 50050 ...]

(ref rust/scheduler/src/main.rs: parse config, pick state backend, serve.)
"""

from __future__ import annotations

import logging
import signal
import time

from ballista_tpu_torch.daemon_config import SCHEDULER_SPEC, load_config
from ballista_tpu_torch.scheduler.kv import EtcdBackend, MemoryBackend, SqliteBackend
from ballista_tpu_torch.scheduler.server import SchedulerServer, serve


def main() -> None:
    # SIGINT is the clean stop. A process started in the background of
    # a shell (or under nohup) inherits SIGINT ignored, and Python keeps
    # it so: SIGINT then did nothing at all
    signal.signal(signal.SIGINT, signal.default_int_handler)
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
    try:
        # inside the try: a SIGINT sent on seeing this line stops cleanly
        logging.getLogger("ballista.scheduler").info(
            "Ballista-TPU scheduler up (backend=%s, namespace=%s, port=%s)",
            backend, cfg["namespace"], cfg["port"],
        )
        # short sleeps: a SIGINT that the kernel delivers to another of this
        # process's threads (grpc's, Arrow Flight's) only sets Python's
        # flag, and the main thread raises KeyboardInterrupt when its sleep
        # ends; with time.sleep(3600) the stop came up to an hour late
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        server.stop(grace=2)


if __name__ == "__main__":
    main()
