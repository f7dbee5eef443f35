"""The port's daemons as users deploy them: `python -m
ballista_tpu_torch.scheduler` on an sqlite file and two `python -m
ballista_tpu_torch.executor --device cpu --shuffle-tier shared` processes
(deployment/docker-compose.yaml's layout on one host), driven by a
BallistaContext in the test's process. The executors run the port's "cuda"
backend, whose kernel wrappers take their plain versions on CPU tensors.

- q1, q3, q6 and q18 at SF 0.01 answer as the JAX package's
  StandaloneCluster ("tpu" backend, JAX on the CPU) does on the same data:
  integers and strings equal, floats within rtol 2e-5
  (tests/test_tpu_backend.py:41). Both executors write one layout store and
  one cost store, and a second run of each query reads what either wrote.
- `--local` single-node mode answers as the cluster does.
- An executor SIGKILLed between the stages of q3, once its map output is on
  the shared tier and while the stage's last task still runs elsewhere:
  the answer is bit-equal to a clean run, the survivor reads the dead
  process's pieces from the shared directory, and no task waits for the
  60 s executor lease.
- An executor SIGKILLed while it runs a task of q3: the scheduler forgets
  it and puts the task back at once, not after the lease; the answer is
  bit-equal.
- SIGINT stops an executor and prints its one {"executor_stop"} line.
- Faults the process boundary showed (ROADMAP.md §3): an executor started
  before its scheduler joined seconds late (F6), SIGINT did not stop a
  daemon (F7), a task on a killed executor waited out the lease (F8), push
  dispatch sent a narrow stage to one executor (F9), and a daemon started
  with SIGINT ignored never stopped on it (F10).

The executors run with their default settings (four task slots). Every
daemon is started with a timeout on its readiness and killed by its
fixture's finalizer. The cluster helper is tests/torch_daemon_cluster.py.
"""

import logging
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pytest

import ballista_tpu_torch.config as _port_config
from torch_daemon_cluster import (
    Daemon,
    DaemonCluster,
    free_port,
    kill_between_stages,
    kill_while_running,
    parse_stop_record,
    straggler_seed,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUERIES = ["q1", "q3", "q6", "q18"]
SETTINGS = {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": "",
            "ballista.cache.results": "false"}
RTOL = 2e-5
# the daemons' readiness and stop
TIMEOUT = 60.0
# a task slowed by chaos holds its stage open while another executor dies
SLOW_RATE, SLOW_MS = 0.3, 2000
LEASE_S = 60.0  # scheduler/state.py EXECUTOR_LEASE_SECS

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
logging.getLogger("ballista").setLevel(logging.CRITICAL)


def _sql(name: str) -> str:
    return (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()


def _client(addr, tpch_dir, extra=None):
    from benchmarks.tpch.datagen import register_all
    from ballista_tpu_torch.client import BallistaContext

    ctx = BallistaContext(*addr, settings={**SETTINGS, **(extra or {})}, device="cpu")
    register_all(ctx, tpch_dir)
    return ctx


def _assert_close(got: pa.Table, want: pa.Table, label: str) -> None:
    assert got.column_names == want.column_names, label
    assert got.num_rows == want.num_rows, label
    for c, f in zip(want.column_names, want.schema):
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(g, dtype=float), np.array(w, dtype=float),
                                       rtol=RTOL, err_msg=f"{label}.{c}")
        else:
            assert g == w, f"{label}.{c}"


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_daemons")
    generate(str(d), sf=0.01, parts=2, seed=20261017)
    return str(d)


@pytest.fixture(scope="module")
def jax_answers(tpch_dir):
    """The JAX package's StandaloneCluster on the same data."""
    from benchmarks.tpch.datagen import register_all
    from ballista_tpu.client import BallistaContext as JaxClient
    from ballista_tpu.config import BallistaConfig as JaxConfig
    from ballista_tpu.executor.runtime import StandaloneCluster as JaxCluster

    cluster = JaxCluster(n_executors=2, config=JaxConfig(SETTINGS))
    try:
        ctx = JaxClient(*cluster.scheduler_addr,
                        settings={**SETTINGS, "ballista.executor.backend": "tpu"})
        register_all(ctx, tpch_dir)
        out = {name: ctx.sql(_sql(name)).collect() for name in QUERIES}
        ctx.close()
    finally:
        cluster.shutdown()
    return out


def _cluster(work) -> DaemonCluster:
    return DaemonCluster(str(work), device="cpu", timeout=TIMEOUT)


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}


def _slowed_run(cluster, tpch_dir):
    """A clean run of q3, then a client whose chaos slows one task of
    q3's last map stage (at attempts 0 and 1) and no other: (ctx, chaos
    client, plan, clean answer, the slowed (stage, partition), the final
    stage, the jobs before)."""
    ctx = _client(cluster.scheduler_addr, tpch_dir)
    plan = ctx.sql(_sql("q3")).logical_plan()
    clean = ctx.collect(plan)
    jobs = {t["job"] for t in cluster.tasks()}
    coords = sorted({(t["stage"], t["partition"]) for t in cluster.tasks()})
    final = max(s for s, _p in coords)
    # the last task of the last map stage holds the final stage back
    slowed = max(c for c in coords if c[0] < final)
    seed = straggler_seed(coords, slowed, SLOW_RATE)
    chaos = _client(cluster.scheduler_addr, tpch_dir, {
        "ballista.chaos.rate": str(SLOW_RATE), "ballista.chaos.sites": "task.slow",
        "ballista.chaos.slow_ms": str(SLOW_MS), "ballista.chaos.seed": str(seed)})
    return ctx, chaos, plan, clean, slowed, final, jobs


@pytest.fixture(scope="module")
def daemons(tmp_path_factory):
    cluster = _cluster(tmp_path_factory.mktemp("daemons"))
    try:
        yield cluster.start()
    finally:
        cluster.close()


def test_daemons_start_on_the_port_backend(daemons):
    assert len(daemons.executors) == 2
    for ex in daemons.executors:
        # the start line names the backend and device that run the stages
        assert (ex.backend, ex.device) == ("cuda", "cpu"), ex.tail()
        assert ex.alive()
    assert os.path.isfile(daemons.db)
    assert {t["state"] for t in daemons.tasks()} <= {"completed"}


@pytest.mark.parametrize("name", QUERIES)
def test_daemon_queries_match_jax_cluster(daemons, tpch_dir, jax_answers, name):
    # both executors write (and then read) one layout store and one cost store
    stores = {"ballista.tpu.layout_cache_dir": str(daemons.work / "layouts"),
              "ballista.tpu.cost_model_dir": str(daemons.work / "costs")}
    ctx = _client(daemons.scheduler_addr, tpch_dir, stores)
    try:
        first = ctx.sql(_sql(name)).collect()
        second = ctx.sql(_sql(name)).collect()
    finally:
        ctx.close()
    _assert_close(first, jax_answers[name], name)
    assert second.equals(first), f"{name}: the run over the shared stores differs"
    jobs = {t["job"] for t in daemons.tasks()}
    assert len(jobs) >= 2
    layouts = daemons.work / "layouts_torch"
    assert layouts.is_dir() and not list(layouts.glob("*/.wip-*"))


@pytest.mark.parametrize("name", ["q3", "q18"])
def test_collect_stream_through_daemons_equals_collect(daemons, tpch_dir, name):
    ctx = _client(daemons.scheduler_addr, tpch_dir)
    try:
        want = ctx.sql(_sql(name)).collect()
        batches = list(ctx.collect_stream(ctx.sql(_sql(name)).logical_plan()))
    finally:
        ctx.close()
    assert batches
    got = pa.Table.from_batches(batches, schema=batches[0].schema).cast(want.schema)
    assert got.equals(want)


def test_local_mode_answers_as_the_cluster(tmp_path, tpch_dir, jax_answers):
    port = free_port()
    d = Daemon("local", [sys.executable, "-m", "ballista_tpu_torch.executor", "--local",
                         "--scheduler-port", str(port), "--port", str(free_port()),
                         "--external-host", "127.0.0.1", "--device", "cpu"],
               str(tmp_path), _env(), tmp_path / "local.log")
    try:
        d.wait_for(r"executor up \(id=.*backend=cuda, device=cpu\)", TIMEOUT)
        ctx = _client(("127.0.0.1", port), tpch_dir)
        try:
            for name in ("q1", "q6"):
                _assert_close(ctx.sql(_sql(name)).collect(), jax_answers[name], name)
        finally:
            ctx.close()
        assert d.interrupt(TIMEOUT) == 0
        record = parse_stop_record(line for _t, line in d.lines)
        assert record is not None and sum(record["routing_stats"]["routes"].values()) >= 2
    finally:
        d.close()


def test_sigkill_between_stages_is_bit_identical(tmp_path, tpch_dir):
    cluster = _cluster(tmp_path)
    try:
        cluster.start()
        ctx, chaos, plan, clean, slowed, final, jobs = _slowed_run(cluster, tpch_dir)
        job = chaos.submit(plan)
        kill = kill_between_stages(cluster, job, slowed, timeout=TIMEOUT)
        got = chaos._collect_results(job, plan.schema(), timeout=TIMEOUT)
        kill_to_answer = time.time() - kill["killed_at"]
        assert got.equals(clean)
        assert not kill["victim"].alive()
        tasks = [t for t in cluster.tasks() if t["job"] == job]
        assert job not in jobs and all(t["state"] == "completed" for t in tasks)
        # every later stage ran on the survivor; none waited for the lease
        victim, survivor = kill["victim"].executor_id, kill["survivor"].executor_id
        assert {t["executor"] for t in tasks if t["stage"] == final} == {survivor}
        assert all(t["attempt"] == 0 for t in tasks)
        assert kill_to_answer < LEASE_S / 2, kill_to_answer
        assert any(t["executor"] == victim for t in tasks)
        chaos.close()
        ctx.close()
        (record,) = cluster.stop(TIMEOUT)
        # the survivor read the pieces, the dead process's among them, from
        # the shared directory
        assert record["id"] == survivor
        assert record["shuffle_tier_stats"].get("storage_fetch", 0) >= 1
        assert record["shuffle_tier_stats"].get("peer_fetch", 0) == 0
    finally:
        cluster.close()


def test_sigkill_while_a_task_runs_is_reset_at_once(tmp_path, tpch_dir):
    """F8: an executor SIGKILLed while it runs a task. Its push stream
    breaks and its Flight port refuses connections, so the scheduler
    forgets it and resets the task at once; it held the executor
    registered, and the task, until the 60 s lease lapsed."""
    cluster = _cluster(tmp_path)
    try:
        cluster.start()
        ctx, chaos, plan, clean, slowed, _final, _jobs = _slowed_run(cluster, tpch_dir)
        job = chaos.submit(plan)
        kill = kill_while_running(cluster, job, slowed, timeout=LEASE_S / 2)
        got = chaos._collect_results(job, plan.schema(), timeout=TIMEOUT)
        kill_to_answer = time.time() - kill["killed_at"]
        assert got.equals(clean)
        assert kill["kill_to_forget_s"] < LEASE_S / 4, kill
        assert kill["kill_to_reset_s"] < LEASE_S / 4, kill
        assert kill_to_answer < LEASE_S / 2, kill_to_answer
        (survivor,) = cluster.live_executors()
        tasks = [t for t in cluster.tasks() if t["job"] == job]
        assert all(t["state"] == "completed" for t in tasks)
        assert {t["executor"] for t in tasks if tuple(slowed) == (t["stage"], t["partition"])} \
            == {survivor.executor_id}
        chaos.close()
        ctx.close()
        cluster.stop(TIMEOUT)
    finally:
        cluster.close()


def test_push_dispatch_spreads_a_stage_over_the_executors():
    """F9: two subscribed executors with four slots each and a stage of two
    tasks: one push pump hands each executor one task. It filled the first
    subscriber's slots before offering the next, so both went to one
    executor while the other idled."""
    from ballista_tpu_torch.physical.basic import EmptyExec
    from ballista_tpu_torch.proto import ballista_pb2 as pb
    from ballista_tpu_torch.scheduler.kv import MemoryBackend
    from ballista_tpu_torch.scheduler.server import SchedulerServer, _PushSubscriber

    server = SchedulerServer(MemoryBackend(), synchronous_planning=True)
    state = server.state
    running = pb.JobStatus()
    running.running.SetInParent()
    state.save_job_metadata("j", running)
    state.save_stage_plan("j", 1, EmptyExec(True, pa.schema([("a", pa.int64())])))
    for part in range(2):
        task = pb.TaskStatus()
        task.partition_id.job_id, task.partition_id.stage_id = "j", 1
        task.partition_id.partition_id = part
        state.save_task_status(task)
    subs = []
    for eid in ("e1", "e2"):
        state.save_executor_metadata(pb.ExecutorMetadata(id=eid, host="127.0.0.1", port=1))
        subs.append(_PushSubscriber(eid, slots=4))
        with server._push_mu:
            server._subscribers[eid] = subs[-1]
    with state.kv.lock():
        assert server._pump_pushes() == 2
    assert [sub.queue.qsize() for sub in subs] == [1, 1]
    assert {t.running.executor_id for t in state.get_all_tasks()} == {"e1", "e2"}


@pytest.mark.parametrize("daemon", ["scheduler", "executor"])
def test_daemon_started_with_sigint_ignored_stops_on_sigint(tmp_path, daemon):
    """F10: a daemon started from a shell's background (or nohup) inherits
    SIGINT ignored; it restores the handler, so SIGINT still stops it
    cleanly. It ignored SIGINT, and only SIGKILL ended it."""
    port = free_port()
    if daemon == "scheduler":
        args = ["ballista_tpu_torch.scheduler", "--bind-host", "127.0.0.1",
                "--port", str(port)]
        ready = r"scheduler up"
    else:
        args = ["ballista_tpu_torch.executor", "--local", "--scheduler-port", str(port),
                "--port", str(free_port()), "--external-host", "127.0.0.1", "--device", "cpu"]
        ready = r"executor up \(id="
    # sh passes an ignored SIGINT on through exec, as a background job's is
    d = Daemon(daemon, ["sh", "-c", 'trap "" INT; exec "$0" "$@"', sys.executable, "-m", *args],
               str(tmp_path), _env(), tmp_path / f"{daemon}.log")
    try:
        d.wait_for(ready, TIMEOUT)
        assert d.interrupt(20) == 0, d.tail()
        if daemon == "executor":
            assert parse_stop_record(line for _t, line in d.lines) is not None, d.tail()
    finally:
        d.close()


def test_executor_joins_a_scheduler_started_after_it(tmp_path):
    """F6: a channel that failed to connect is dropped, so a process that
    started before its scheduler daemon, or outlived it, connects within one
    call of the daemon coming up (grpc's own reconnect backoff held it off
    for 1-10 s). Twice: a first start, then a restart after SIGKILL."""
    from ballista_tpu_torch.errors import RpcError
    from ballista_tpu_torch.scheduler.rpc import SchedulerGrpcClient

    port = free_port()
    client = SchedulerGrpcClient("127.0.0.1", port, retries=0)
    env = _env()
    scheds = []
    try:
        for start in range(2):
            t0 = time.time()
            while time.time() - t0 < 0.6:
                with pytest.raises(RpcError):
                    client.get_executors_metadata()
                time.sleep(0.05)
            sched = Daemon(f"scheduler{start}", [
                sys.executable, "-m", "ballista_tpu_torch.scheduler",
                "--bind-host", "127.0.0.1", "--port", str(port)],
                str(tmp_path), env, tmp_path / f"scheduler{start}.log")
            scheds.append(sched)
            while True:
                try:
                    client.get_executors_metadata()
                    break
                except RpcError:
                    time.sleep(0.05)
                    assert sched.alive(), sched.tail()
                    assert time.time() - t0 < TIMEOUT, "the scheduler never answered"
            connected = time.time()
            up, _line = sched.wait_for(r"scheduler up", TIMEOUT)
            assert connected - up < 0.75, (start, f"connected {connected - up:.2f} s "
                                                  "after the scheduler was up")
            sched.kill()
    finally:
        client.close()
        for sched in scheds:
            sched.close()


def test_sigint_stops_each_daemon_with_its_stop_line(daemons, tpch_dir):
    """F7: SIGINT stops the daemons (each executor prints its stop line).
    It stops the module's cluster, so it comes after every other test
    that uses it."""
    ctx = _client(daemons.scheduler_addr, tpch_dir)
    try:
        ctx.sql(_sql("q6")).collect()
    finally:
        ctx.close()
    t0 = time.time()
    records = daemons.stop(TIMEOUT)
    assert time.time() - t0 < 20
    assert not daemons.scheduler.alive() and daemons.scheduler.proc.returncode == 0
    assert [r["pid"] for r in records] == [ex.pid for ex in daemons.executors]
    routes = {}
    for r in records:
        assert r["backend"] == "cuda" and r["device"] == "cpu"
        # CPU tensors take the plain versions: no kernel launches, no library
        assert r["launch_counts"] == {"sorted_grouped_sum": 0, "grouped_aggregate": 0}
        assert r["kernel_libraries"] == {}
        assert r["shuffle_tier_stats"].get("storage_publish", 0) >= 1
        for k, v in r["routing_stats"]["routes"].items():
            routes[k] = routes.get(k, 0) + v
    assert routes.get("batches", 0) >= 1, routes
    # the client, with no shuffle directory of its own, fetched result
    # partitions over Flight from the executor processes' registries
    assert sum(r["exchange_stats"].get("served_from_registry", 0) for r in records) >= 1


def test_daemon_config_precedence(tmp_path, monkeypatch):
    """defaults < BALLISTA_EXECUTOR_* env < --config-file < flags; the
    port's executor defaults to the "cuda" backend, and the JAX package's
    examples/executor.toml selects the host backend."""
    from ballista_tpu_torch.daemon_config import load_config
    from ballista_tpu_torch.executor.__main__ import _SPEC

    def load(argv):
        return load_config(_SPEC, "BALLISTA_EXECUTOR_", "", argv=argv)

    assert load([])["backend"] == "cuda"
    assert load([])["concurrent_tasks"] == 4 and load([])["device"] == ""
    monkeypatch.setenv("BALLISTA_EXECUTOR_CONCURRENT_TASKS", "2")
    assert load([])["concurrent_tasks"] == 2
    toml = tmp_path / "executor.toml"
    toml.write_text('concurrent_tasks = 3\nbackend = "cuda"\ndevice = "cpu"\n')
    cfg = load(["--config-file", str(toml)])
    assert (cfg["concurrent_tasks"], cfg["device"]) == (3, "cpu")
    assert load(["--config-file", str(toml), "--concurrent-tasks", "5"])["concurrent_tasks"] == 5
    example = str(ROOT / "examples/executor.toml")
    assert load(["--config-file", example])["backend"] == "cpu"
    assert load(["--config-file", example, "--backend", "cuda"])["backend"] == "cuda"


def test_native_library_builds_in_two_processes_at_once(tmp_path):
    """Two processes importing a fresh copy of ballista_tpu_torch.native
    both build it (a pid temp file, then os.replace) and both load it."""
    import shutil

    pkg = tmp_path / "copy" / "native"
    pkg.mkdir(parents=True)
    src = ROOT / "ballista_tpu_torch" / "native"
    shutil.copy(src / "__init__.py", pkg / "__init__.py")
    shutil.copy(src / "shuffle.cpp", pkg / "shuffle.cpp")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import native; "
            "lib = native.get_lib(); print('loaded' if lib is not None else 'none')")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pkg.parent)],
                              stdout=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["loaded", "loaded"]
    assert (pkg / "libballista_shuffle.so").is_file()
    assert not list(pkg.glob("*.tmp.so"))
