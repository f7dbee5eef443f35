"""The port's runtime lock witness (ballista_tpu_torch/utils/locks.py) and
its cross-check against the port's static lock-order graph
(ballista_tpu_torch/analysis):

- the witness reads the port's own manifest
  (ballista_tpu_torch/analysis/lockorder.toml), never the JAX package's;
- the port's StandaloneCluster on device="cpu" runs a seeded chaos e2e
  under the witness — an executor death mid-run and a scheduler restart
  on the same store, concurrent clients, a shared-scan batch and the
  sorted_grouped_sum route — with zero recorded violations and zero
  runtime edges the static analyzer missed (the JAX package's
  tests/test_lockorder.py::test_witness_chaos_e2e_zero_violations_zero_missed
  on the port), each answer equal to the JAX package's StandaloneCluster
  on the same table;
- per-process <OUT>.<pid> dumps of env-armed subprocesses merge in
  `python -m ballista_tpu_torch.analysis --check-witness`."""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "ballista_tpu_torch"
sys.path.insert(0, str(REPO))

from ballista_tpu_torch.analysis.lockgraph import Manifest, diff_witness  # noqa: E402
from ballista_tpu_torch.analysis.rules_lockorder import static_edges  # noqa: E402
from ballista_tpu_torch.utils import locks  # noqa: E402


@pytest.fixture
def witness():
    locks.reset_witness()
    locks.enable_witness()
    yield locks
    locks.disable_witness()
    locks.reset_witness()


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.analysis", *args],
        cwd=str(REPO), capture_output=True, text=True, env=env,
    )


# -- the manifest the witness holds acquisitions to ---------------------------

def test_witness_loads_the_port_manifest():
    path = pathlib.Path(locks.manifest_path())
    assert path == PKG / "analysis" / "lockorder.toml"
    assert "dev" not in path.relative_to(REPO).parts
    ranks, tree, plan = locks._load_manifest()
    assert ranks == Manifest.load(str(path)).rank
    # the port's own lock classes are ranked; the JAX package's
    # per-counter locks, which the port has no counterpart of, are not
    for name in ("utils.counters._counts_lock", "ops.cuda_kernels._build_lock",
                 "utils.tracing._mu"):
        assert name in ranks, name
    assert "ops.runtime._recovery_lock" not in ranks
    assert "ops.stage._prepare_lock" in plan and plan <= tree


def test_witness_asserts_an_inversion_of_the_port_order(witness):
    counts = locks.make_lock("utils.counters._counts_lock")
    kv = locks.make_rlock("scheduler.kv.lock")
    with kv:
        with counts:
            pass
    assert witness.witness_edges() == {
        ("scheduler.kv.lock", "utils.counters._counts_lock"): 1
    }
    with pytest.raises(locks.LockOrderViolation, match="inversion"):
        with counts:
            with kv:
                pass
    assert [v["kind"] for v in witness.witness_violations()] == \
        ["order_inversion"]


def test_every_port_lock_is_a_witness_lock():
    """Each lock the port creates at import is a WitnessLock under its
    canonical name, so the witness sees it."""
    from ballista_tpu_torch.ops import costmodel, cuda_kernels, kernels, \
        layout_cache, runtime
    from ballista_tpu_torch.physical import scan
    from ballista_tpu_torch.utils import counters, tracing

    for obj, name in (
        (costmodel._lock, "ops.costmodel._lock"),
        (cuda_kernels._build_lock, "ops.cuda_kernels._build_lock"),
        (counters.readback._counts_lock, "utils.counters._counts_lock"),
        (kernels._stage_cache_lock, "ops.kernels._stage_cache_lock"),
        (layout_cache._size_lock, "ops.layout_cache._size_lock"),
        (runtime._res_lock, "ops.runtime._res_lock"),
        (counters.routing._counts_lock, "utils.counters._counts_lock"),
        (counters.recovery._counts_lock, "utils.counters._counts_lock"),
        (runtime.ColumnDictionary()._lock, "ops.runtime._lock"),
        (scan._TABLE_CACHE_MU, "physical.scan._TABLE_CACHE_MU"),
        (tracing._mu, "utils.tracing._mu"),
    ):
        assert isinstance(obj, locks.WitnessLock), name
        assert obj.name == name


def test_kernel_build_lock_takes_no_counter_lock(witness, monkeypatch):
    """The kernel libraries' build and load count their serving events
    after _build_lock is released: no edge leaves it (the nvcc build takes
    seconds, and every executor thread records serving stats)."""
    from ballista_tpu_torch.ops import cuda_kernels as ck
    from ballista_tpu_torch.ops.runtime import serving_stats

    class _Lib:
        def bt_sorted_grouped_sum_tile_rows(self):
            return ck.SORTED_TILE_ROWS

    monkeypatch.setattr(ck, "_libs", {"sorted_grouped_sum": _Lib()})
    serving_stats(reset=True)
    ck._load("sorted_grouped_sum")
    assert serving_stats(reset=True) == {"compile_hit_memory": 1}
    assert not [e for e in witness.witness_edges()
                if e[0] == "ops.cuda_kernels._build_lock"]


# -- per-process dumps --------------------------------------------------------

_CHILD = (
    "import sys\n"
    "from ballista_tpu_torch.utils import locks\n"
    "a = locks.make_rlock('scheduler.kv.lock')\n"
    "b = locks.make_lock(sys.argv[1])\n"
    "with a:\n"
    "    with b:\n"
    "        pass\n"
)


def test_subprocess_dumps_are_pid_suffixed_and_merged(tmp_path):
    out = tmp_path / "w.json"
    env = dict(os.environ, BALLISTA_LOCK_WITNESS="1",
               BALLISTA_LOCK_WITNESS_OUT=str(out), PYTHONPATH=str(REPO))
    for dst in ("scheduler.state._tenant_mu", "utils.counters._counts_lock"):
        proc = subprocess.run([sys.executable, "-c", _CHILD, dst], cwd=str(REPO),
                              capture_output=True, text=True, env=env)
        assert proc.returncode == 0, proc.stderr
    assert not out.exists()
    dumps = sorted(tmp_path.glob("w.json.*"))
    assert len(dumps) == 2, dumps
    args = [a for d in dumps for a in ("--check-witness", str(d))]
    proc = _cli(*args, "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["ok"] and report["witness_files"] == 2
    assert report["runtime_edges"] == 2 and report["missed"] == []

    # an edge the static graph does not hold, in either dump, fails the merge
    bogus = tmp_path / "bogus.json"
    bogus.write_text(json.dumps({"edges": [
        {"src": "utils.tracing._mu", "dst": "scheduler.kv.lock", "count": 1}],
        "violations": []}))
    proc = _cli(*args, "--check-witness", str(bogus), "--json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["missed"] == [
        ["utils.tracing._mu", "scheduler.kv.lock"]]


# -- the chaos e2e under the witness ------------------------------------------

def _death_seed():
    """local-0 dies at one of its polls 4-16; local-1 lives (the seed scan
    of tests/test_torch_recovery.py)."""
    from ballista_tpu_torch.utils.chaos import ChaosInjector

    for seed in range(2000):
        inj = ChaosInjector(seed, rate=0.005, sites={"executor.death"})

        def death_poll(eid, horizon):
            for n in range(1, horizon):
                if inj.should_inject("executor.death", f"{eid}/poll{n}"):
                    return n
            return None

        d0 = death_poll("local-0", 17)
        if d0 is not None and 4 <= d0 and death_poll("local-1", 400) is None:
            return seed
    pytest.fail("no death seed found")


QUERIES = {
    "by_key": "select g, sum(v) as s, count(*) as c from t group by g order by g",
    "wide": "select k, sum(x) as s, count(*) as c from t group by k order by k",
    "filtered": "select sum(v) as s, count(*) as c from t where v < 50",
}


def _table(path: str) -> None:
    rng = np.random.default_rng(7)
    n = 6000
    pq.write_table(pa.table({
        "g": pa.array([f"k{v}" for v in rng.integers(0, 5, n)]),
        "k": pa.array(rng.integers(0, 1500, n), type=pa.int64()),
        "v": pa.array(rng.integers(0, 100, n), type=pa.int64()),
        "x": pa.array(rng.random(n) * 100.0),
    }), path, row_group_size=1500)


RTOL = 2e-5  # float sums: the port's and the JAX package's f32 reductions


def _jax_answers(path: str) -> dict:
    """The JAX package's StandaloneCluster on the same table."""
    from ballista_tpu.client import BallistaContext as JaxClient
    from ballista_tpu.config import BallistaConfig as JaxConfig
    from ballista_tpu.executor.runtime import StandaloneCluster as JaxCluster

    settings = {"ballista.cache.results": "false",
                "ballista.tpu.layout_cache_dir": "",
                "ballista.tpu.cost_model_dir": ""}
    cluster = JaxCluster(n_executors=2, config=JaxConfig(settings))
    try:
        ctx = JaxClient(*cluster.scheduler_addr,
                        settings={**settings, "ballista.executor.backend": "tpu"})
        ctx.register_parquet("t", path)
        out = {name: ctx.sql(sql).collect() for name, sql in QUERIES.items()}
        ctx.close()
    finally:
        cluster.shutdown()
    return out


def _assert_close(got: dict, want: pa.Table, label: str) -> None:
    assert list(got) == want.column_names, label
    for c, f in zip(want.column_names, want.schema):
        g, w = got[c], want.column(c).to_pylist()
        assert len(g) == len(w), f"{label}.{c}"
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(g, dtype=float), np.array(w, dtype=float),
                                       rtol=RTOL, err_msg=f"{label}.{c}")
        else:
            assert g == w, f"{label}.{c}"


def test_witness_chaos_e2e_zero_violations_zero_missed(tmp_path):
    import ballista_tpu_torch.scheduler.state as state_mod
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.runtime import StandaloneCluster
    from ballista_tpu_torch.ops.runtime import recovery_stats, routing_stats

    path = str(tmp_path / "t.parquet")
    _table(path)
    settings = {"ballista.cache.results": "false",
                "ballista.tpu.sorted_kernel": "pallas",
                "ballista.tpu.layout_cache_dir": "",
                "ballista.tpu.cost_model_dir": ""}

    locks.reset_witness()
    locks.enable_witness()
    old_lease = state_mod.EXECUTOR_LEASE_SECS
    state_mod.EXECUTOR_LEASE_SECS = 1.0
    recovery_stats(reset=True)
    routing_stats(reset=True)
    cluster = StandaloneCluster(n_executors=2, device="cpu", config=BallistaConfig({
        "ballista.debug.lock_witness": "1",
        "ballista.chaos.rate": "0.005",
        "ballista.chaos.seed": str(_death_seed()),
        "ballista.chaos.sites": "executor.death",
        "ballista.rpc.retries": "20",
        "ballista.executor.idle_poll_max_s": "0.25",
        **settings,
    }))
    cluster.scheduler_impl.lost_task_check_interval = 0.3
    answers = {}
    errors = []
    try:
        def client(name: str) -> None:
            try:
                ctx = BallistaContext(*cluster.scheduler_addr, settings=settings,
                                      device="cpu")
                ctx.register_parquet("t", path)
                answers.setdefault(name, []).append(
                    ctx.sql(QUERIES[name]).collect().to_pydict())
                ctx.close()
            except Exception as e:  # pragma: no cover - reported below
                errors.append(f"{name}: {e!r}")

        def round_of_clients() -> None:
            threads = [threading.Thread(target=client, args=(q,)) for q in QUERIES]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)

        round_of_clients()
        # let the seeded death fire (local-0 dies within its first ~16
        # polls at 250 ms), then restart the scheduler on the same store
        # and run the clients again on the degraded cluster
        deadline = time.time() + 10
        while time.time() < deadline and not recovery_stats().get(
            "chaos_executor_death"
        ):
            time.sleep(0.1)
        cluster.restart_scheduler()
        round_of_clients()
    finally:
        state_mod.EXECUTOR_LEASE_SECS = old_lease
        cluster.shutdown()
        locks.disable_witness()

    assert errors == [], errors
    want = _jax_answers(path)
    assert sorted(answers) == sorted(QUERIES)
    for name, runs in answers.items():
        assert len(runs) == 2 and runs[0] == runs[1], name
        for i, got in enumerate(runs):
            _assert_close(got, want[name], f"{name} round {i + 1}")
    stats = recovery_stats(reset=True)
    assert stats.get("chaos_executor_death", 0) >= 1, stats
    assert stats.get("scheduler_restart", 0) >= 1, stats
    assert routing_stats(reset=True)["routes"].get("pallas_sorted", 0) >= 1
    assert locks.witness_violations() == []
    record = locks.dump(str(tmp_path / "witness.json"))
    locks.reset_witness()
    assert record["edges"], "witness saw no edges — not armed?"
    report = diff_witness(record, static_edges([str(PKG)]), Manifest.load())
    assert report["missed"] == [], (
        "runtime edges the static analyzer missed: "
        f"{report['missed']} (add the call resolution or a may-acquire "
        "annotation)"
    )
