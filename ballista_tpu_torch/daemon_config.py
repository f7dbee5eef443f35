"""Daemon configuration with the reference's precedence chain.

The reference generates config parsing from TOML specs via configure_me
(rust/executor/executor_config_spec.toml, rust/scheduler/scheduler_config_spec.toml)
with precedence: defaults < env (BALLISTA_SCHEDULER_*/BALLISTA_EXECUTOR_*)
< config file (/etc/ballista/*.toml or --config-file) < CLI
(docs/user-guide/src/configuration.md:1-16).
"""

from __future__ import annotations

import argparse
import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: same API under the PyPI name
    import tomli as tomllib
from typing import Any, Dict, List, Optional, Tuple

SCHEDULER_SPEC: List[Tuple[str, Any, str]] = [
    # (name, default, help)
    ("namespace", "ballista", "cluster namespace"),
    ("config_backend", "standalone", "standalone | sqlite | etcd"),
    ("sqlite_path", "/tmp/ballista-scheduler.db", "sqlite backend db path"),
    ("etcd_urls", "localhost:2379", "etcd endpoints (etcd backend)"),
    ("bind_host", "0.0.0.0", "bind address"),
    ("port", 50050, "grpc port"),
    ("data_roots", "", "comma-separated dirs wire-plan scans may read ('' = any)"),
]

EXECUTOR_SPEC: List[Tuple[str, Any, str]] = [
    ("namespace", "ballista", "cluster namespace"),
    ("scheduler_host", "localhost", "scheduler hostname"),
    ("scheduler_port", 50050, "scheduler grpc port"),
    ("local", False, "spin an in-process scheduler (single-node mode)"),
    ("bind_host", "0.0.0.0", "flight bind address"),
    ("external_host", "localhost", "address peers use to reach this executor"),
    ("port", 50051, "flight port"),
    ("work_dir", "", "shuffle work dir (default: temp dir)"),
    ("concurrent_tasks", 4, "max concurrent tasks"),
    ("backend", "cpu", "kernel backend: cpu | tpu"),
    ("data_roots", "", "comma-separated dirs wire-plan scans may read ('' = any)"),
    # disaggregated shuffle tier (ISSUE 15): 'shared' publishes pieces to
    # shuffle_dir (a mount every node sees) instead of the private work
    # dir, so executor loss/retirement destroys no shuffle data
    ("shuffle_tier", "local", "shuffle piece home: local | shared"),
    ("shuffle_dir", "", "shared-storage root for the shared shuffle tier"),
]


def load_config(
    spec: List[Tuple[str, Any, str]],
    env_prefix: str,
    default_file: str,
    argv: Optional[List[str]] = None,
    prog: str = "ballista",
) -> Dict[str, Any]:
    values: Dict[str, Any] = {name: default for name, default, _ in spec}
    types = {name: type(default) for name, default, _ in spec}

    def coerce(name: str, raw: Any) -> Any:
        t = types[name]
        if t is bool and isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes")
        return t(raw)

    # 1. environment
    for name in values:
        env = f"{env_prefix}{name.upper()}"
        if env in os.environ:
            values[name] = coerce(name, os.environ[env])

    # CLI pre-pass for --config-file
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--config-file")
    for name, default, help_ in spec:
        flag = "--" + name.replace("_", "-")
        if types[name] is bool:
            ap.add_argument(flag, action="store_true", default=None, help=help_)
        else:
            ap.add_argument(flag, default=None, help=help_)
    args = ap.parse_args(argv)

    # 2. config file
    path = args.config_file or default_file
    if path and os.path.isfile(path):
        with open(path, "rb") as f:
            file_cfg = tomllib.load(f)
        for name, raw in file_cfg.items():
            key = name.replace("-", "_")
            if key in values:
                values[key] = coerce(key, raw)

    # 3. CLI wins
    for name in values:
        raw = getattr(args, name, None)
        if raw is not None:
            values[name] = coerce(name, raw)
    return values
