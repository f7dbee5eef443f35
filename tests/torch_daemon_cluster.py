"""One host's deployment of the port as processes, for
tests/test_torch_daemons.py and chip_smoke.py's phase 13: the scheduler
daemon and two executor daemons, each started with ``python -m``, as
deployment/docker-compose.yaml lays them out (one scheduler on an sqlite
store, executors publishing their shuffle pieces to one shared directory).
Deployments start the daemons themselves and never import this module.

    cluster = DaemonCluster(work_dir)   # executors on the GPU
    cluster.start()
    ctx = BallistaContext(*cluster.scheduler_addr)
    ...
    records = cluster.stop()   # SIGINT: each executor's {"executor_stop"} line
    cluster.close()            # kills whatever is still alive

Every daemon's output is drained into memory (a full pipe would block its
logging) and written to ``<work_dir>/<name>.log``. Readiness is read from the
daemons' own lines: the scheduler's "scheduler up", each executor's
"executor up" and the scheduler's "executor <id> subscribed". The scheduler's
store is a file, so task statuses can be read from this process while it
runs (`tasks`, which reads the scheduler's KV layout from outside it: a
change there shows as a failing test).
"""

from __future__ import annotations

import json
import os
import pathlib
import random
import re
import signal
import socket
import sqlite3
import subprocess
import sys
import threading
import time
from typing import List, Optional

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_EXECUTOR_UP = re.compile(r"executor up \(id=([^,]+),.*backend=([^,]+), device=([^)]+)\)")


def free_port() -> int:
    """A port free now, below Linux's ephemeral range (32768-60999): a port
    the kernel hands out (bind to 0, an outgoing connection) could go to
    another process in the seconds before the daemon binds it."""
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in 20000-32767")


class Daemon:
    """One daemon process and the lines it has printed so far."""

    def __init__(self, name: str, argv: List[str], cwd: str, env: dict,
                 log_path: pathlib.Path) -> None:
        self.name = name
        self.lines: List[tuple] = []  # (time.time(), line)
        self._cv = threading.Condition()
        self._log = open(log_path, "w")
        self.started = time.time()
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.pid = self.proc.pid
        # an executor's, from its start line (DaemonCluster.start_executors)
        self.up_at = self.executor_id = self.backend = self.device = None
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append((time.time(), line.rstrip("\n")))
                self._cv.notify_all()
            self._log.write(line)
            self._log.flush()
        with self._cv:
            self._cv.notify_all()

    def wait_for(self, pattern: str, timeout: float) -> tuple:
        """The first (time, line) printed that matches the regular
        expression `pattern`; raises when the process exits or `timeout`
        seconds pass first."""
        rx = re.compile(pattern)
        deadline = time.time() + timeout
        with self._cv:
            while True:
                for t, line in self.lines:
                    if rx.search(line):
                        return t, line
                if self.proc.poll() is not None and not self._reader.is_alive():
                    raise RuntimeError(
                        f"{self.name} exited (rc {self.proc.returncode}) before "
                        f"printing /{pattern}/:\n" + self.tail())
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(
                        f"{self.name} printed no /{pattern}/ in {timeout} s:\n" + self.tail())
                self._cv.wait(min(left, 0.2))

    def tail(self, n: int = 30) -> str:
        with self._cv:
            return "\n".join(line for _t, line in self.lines[-n:])

    def alive(self) -> bool:
        return self.proc.poll() is None

    def interrupt(self, timeout: float = 30.0) -> int:
        """SIGINT (the daemons' clean stop) and wait for the exit code."""
        if self.alive():
            self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout)
        finally:
            self._reader.join(5)

    def kill(self) -> None:
        """SIGKILL: the process dies at once, with no stop."""
        if self.alive():
            self.proc.kill()
        self.proc.wait(30)
        self._reader.join(5)

    def close(self) -> None:
        self.kill()
        self._log.close()


def parse_stop_record(lines) -> Optional[dict]:
    """The object of an executor's {"executor_stop": ...} line, or None."""
    for line in lines:
        at = line.find('{"executor_stop"')
        if at >= 0:
            return json.loads(line[at:])["executor_stop"]
    return None


class DaemonCluster:
    """A scheduler daemon on an sqlite file and executor daemons (their
    default settings) on one shared shuffle directory, all under
    `work_dir`, started from the checkout at `root` (the directory that
    holds ballista_tpu_torch/). `device` is each executor's --device ("" =
    the GPU); `timeout` bounds each daemon's readiness."""

    def __init__(self, work_dir: str, device: str = "", root: Optional[str] = None,
                 timeout: float = 120.0) -> None:
        self.work = pathlib.Path(work_dir)
        self.work.mkdir(parents=True, exist_ok=True)
        self.root = str(root or _ROOT)
        self.device = device
        self.timeout = timeout
        self.db = str(self.work / "scheduler.db")
        self.shuffle_dir = str(self.work / "shuffle")
        self.namespace = "ballista"
        self.port = free_port()
        path = os.pathsep.join(p for p in (self.root, os.environ.get("PYTHONPATH")) if p)
        self.env = {**os.environ, "PYTHONPATH": path}
        self.scheduler: Optional[Daemon] = None
        self.executors: List[Daemon] = []
        self._generation = 0

    @property
    def scheduler_addr(self) -> tuple:
        return ("127.0.0.1", self.port)

    def _module(self, name: str, module: str, args: List[str]) -> Daemon:
        return Daemon(name, [sys.executable, "-m", module, *args], str(self.work),
                      self.env, self.work / f"{name}.log")

    def start_executors(self) -> List[Daemon]:
        """Start two executors at once (docker-compose.yaml's two) and wait
        until each has printed its start line and the scheduler has taken
        its push subscription. Returns them."""
        self._generation += 1
        started = []
        for i in range(2):
            name = f"executor{self._generation}-{i}"
            args = ["--scheduler-host", "127.0.0.1", "--scheduler-port", str(self.port),
                    "--bind-host", "127.0.0.1", "--external-host", "127.0.0.1",
                    # 0: the executor takes a free port as it binds
                    "--port", "0", "--namespace", self.namespace,
                    "--shuffle-tier", "shared", "--shuffle-dir", self.shuffle_dir,
                    "--work-dir", str(self.work / name)]
            if self.device:
                args += ["--device", self.device]
            started.append(self._module(name, "ballista_tpu_torch.executor", args))
        self.executors.extend(started)
        for ex in started:
            ex.up_at, line = ex.wait_for(r"executor up \(id=", self.timeout)
            m = _EXECUTOR_UP.search(line)
            ex.executor_id, ex.backend, ex.device = m.groups()
            self.scheduler.wait_for(
                rf"executor {re.escape(ex.executor_id)} subscribed", self.timeout)
        return started

    def start(self) -> "DaemonCluster":
        """Start the scheduler and the executors at once, as
        docker-compose does, and wait until every executor has subscribed."""
        self.scheduler = self._module("scheduler", "ballista_tpu_torch.scheduler", [
            "--config-backend", "sqlite", "--sqlite-path", self.db,
            "--bind-host", "127.0.0.1", "--port", str(self.port),
            "--namespace", self.namespace,
        ])
        self.start_executors()
        return self

    def live_executors(self) -> List[Daemon]:
        return [ex for ex in self.executors if ex.alive()]

    def _rows(self, prefix: str) -> List[tuple]:
        """(key without `prefix`, value) of the store's live rows under
        /ballista/<namespace>/<prefix>, read from its file."""
        full = f"/ballista/{self.namespace}/{prefix}"
        con = sqlite3.connect(f"file:{self.db}?mode=ro", uri=True, timeout=10)
        try:
            rows = con.execute("SELECT key, value, expires FROM kv WHERE key >= ? AND key < ?",
                               (full, full + "\uffff")).fetchall()
        finally:
            con.close()
        now = time.time()
        return [(k[len(full):], v) for k, v, exp in rows if exp is None or exp > now]

    def executor_ids(self) -> set:
        """The executors the scheduler holds registered (lease not lapsed)."""
        return {key for key, _v in self._rows("executors/")}

    def tasks(self) -> List[dict]:
        """Every task status in the scheduler's store: {"job", "stage",
        "partition", "state" (pending / running / completed / failed /
        ...), "executor", "attempt", "storage_uri"}."""
        from ballista_tpu_torch.proto import ballista_pb2 as pb

        out = []
        for key, value in self._rows("tasks/"):
            job, stage, part = key.split("/")
            st = pb.TaskStatus()
            st.ParseFromString(value)
            state = st.WhichOneof("status") or "pending"
            body = getattr(st, state) if state != "pending" else None
            out.append({"job": job, "stage": int(stage), "partition": int(part),
                        "state": state, "attempt": st.attempt,
                        "executor": getattr(body, "executor_id", ""),
                        "storage_uri": getattr(body, "storage_uri", "")})
        return out

    def stop_executor(self, ex: Daemon, timeout: float = 60.0) -> dict:
        """SIGINT one executor; returns its stop record (raises without one)."""
        rc = ex.interrupt(timeout)
        record = parse_stop_record(line for _t, line in ex.lines)
        if record is None:
            raise RuntimeError(f"{ex.name} (rc {rc}) printed no executor_stop line:\n"
                               + ex.tail())
        return record

    def stop(self, timeout: float = 60.0) -> List[dict]:
        """SIGINT every live executor, then the scheduler. Returns the
        executors' stop records."""
        records = [self.stop_executor(ex, timeout) for ex in self.live_executors()]
        if self.scheduler is not None and self.scheduler.alive():
            self.scheduler.interrupt(timeout)
        return records

    def close(self) -> None:
        """Kill every daemon still alive (a no-op once all have stopped)."""
        for d in [*self.executors, self.scheduler]:
            if d is not None:
                d.close()


def straggler_seed(coords, target: tuple, rate: float) -> int:
    """The first ballista.chaos.seed whose task.slow verdicts, at `rate`,
    slow the task `target` (stage, partition) at attempts 0 and 1 (so a
    speculative duplicate is as slow) and no other task of `coords` at
    attempt 0. Verdicts hash (stage, partition, attempt), not the job, so
    the tasks of one run of a query predict those of the next."""
    from ballista_tpu_torch.utils.chaos import ChaosInjector

    others = [c for c in coords if tuple(c) != tuple(target)]
    for seed in range(100_000):
        inj = ChaosInjector(seed, rate, sites=("task.slow",))
        slow = lambda c, a: inj.should_inject("task.slow", f"{c[0]}/{c[1]}@a{a}")  # noqa: E731
        if slow(target, 0) and slow(target, 1) and not any(slow(c, 0) for c in others):
            return seed
    raise ValueError(f"no chaos seed slows only {target}")


def kill_between_stages(cluster: DaemonCluster, job: str, slowed: tuple,
                        timeout: float = 120.0) -> dict:
    """SIGKILL the live executor that has published output of `job` to the
    shared tier and holds none of its tasks, while the task `slowed`
    (stage, partition) still runs on another executor: the stages that
    wait on it must then read the dead process's pieces from the shared
    directory. Polls the scheduler's store. Returns {"victim" (the
    Daemon), "survivor" (the Daemon running `slowed`), "killed_at"
    (time.time()), "victim_outputs" (its completed tasks)}."""
    by_id = {ex.executor_id: ex for ex in cluster.live_executors()}
    deadline = time.time() + timeout
    while time.time() < deadline:
        tasks = [t for t in cluster.tasks() if t["job"] == job]
        slow = [t for t in tasks if (t["stage"], t["partition"]) == tuple(slowed)]
        if slow and slow[0]["state"] in ("completed", "failed"):
            raise RuntimeError(f"task {slowed} of {job} ended before an executor was free")
        if slow and slow[0]["executor"] in by_id:
            runner = slow[0]["executor"]
            for eid, ex in by_id.items():
                if eid == runner:
                    continue
                mine = [t for t in tasks if t["executor"] == eid]
                outputs = [t for t in mine if t["state"] == "completed" and t["storage_uri"]]
                if outputs and not any(t["state"] == "running" for t in mine):
                    ex.kill()
                    return {"victim": ex, "survivor": by_id[runner],
                            "killed_at": time.time(), "victim_outputs": outputs}
        time.sleep(0.01)
    raise TimeoutError(f"no executor was free of {job} while {slowed} ran")


def kill_while_running(cluster: DaemonCluster, job: str, slowed: tuple,
                       timeout: float = 120.0) -> dict:
    """SIGKILL the executor that runs the task `slowed` (stage, partition)
    of `job` while it runs it. Then wait until the scheduler no longer
    holds the dead executor registered, and until the task is back in
    other hands (a later attempt, or ended). Returns {"victim" (the
    Daemon), "killed_at" (time.time()), "kill_to_forget_s",
    "kill_to_reset_s"}; raises when either wait passes `timeout`."""
    by_id = {ex.executor_id: ex for ex in cluster.live_executors()}

    def slowed_task():
        for t in cluster.tasks():
            if (t["job"], t["stage"], t["partition"]) == (job, *slowed):
                return t
        return None

    def wait(what, done):
        while time.time() < deadline:
            if done():
                return time.time() - killed_at
            time.sleep(0.01)
        raise TimeoutError(f"{what} {time.time() - killed_at:.1f} s after the kill")

    deadline = time.time() + timeout
    while True:
        t = slowed_task()
        if t is not None and t["state"] in ("completed", "failed"):
            raise RuntimeError(f"task {slowed} of {job} ended before the kill")
        if t is not None and t["state"] == "running" and t["executor"] in by_id:
            break
        if time.time() > deadline:
            raise TimeoutError(f"task {slowed} of {job} never ran on a live executor")
        time.sleep(0.01)
    victim, attempt = by_id[t["executor"]], t["attempt"]
    victim.kill()
    killed_at = time.time()
    deadline = killed_at + timeout
    forget_s = wait(f"the scheduler still held {victim.executor_id}",
                    lambda: victim.executor_id not in cluster.executor_ids())
    reset_s = wait(f"task {slowed} of {job} was still attempt {attempt} on the dead executor",
                   lambda: (lambda t: t["attempt"] > attempt
                            or t["state"] in ("completed", "failed"))(slowed_task()))
    return {"victim": victim, "killed_at": killed_at, "kill_to_forget_s": forget_s,
            "kill_to_reset_s": reset_s}
