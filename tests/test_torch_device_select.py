"""Device selection on the port's distributed path, and its differences by
design from the JAX package (ROADMAP §3).

- BallistaExecutor, StandaloneCluster and BallistaContext run on the GPU
  unless given device="cpu", and raise without CUDA, as ExecutionContext
  does (tests/test_torch_engine.py::test_context_without_cuda_raises).
  StandaloneCluster raises before it starts any server.
- The executor hands its device to every task's TaskContext.
- The executor's kernel prewarm (ballista.tpu.prewarm) is not caught: a
  kernel library that fails to build fails executor start.
- The SPMD fusion (ballista.tpu.spmd_stages) is not planned: the port plans
  the unfused stages and counts one routing reason.
- Members of a shared-scan batch run solo: the scheduler forms the batch as
  the JAX package's does, and the executor runs each member's own plan
  (shared_scan_stats counts member_solo under the reason), answers equal
  to the queries run one at a time.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import ballista_tpu_torch.config as _port_config
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.executor.runtime import BallistaExecutor, StandaloneCluster

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
CPU = torch.device("cpu")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_executor_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BallistaExecutor("127.0.0.1", 1)
    ex = BallistaExecutor("127.0.0.1", 1, device="cpu")
    try:
        assert ex.device == CPU and ex.poll_loop.device == CPU and ex.flight.device == CPU
    finally:
        ex.stop()


def test_cluster_without_cuda_raises_before_serving(no_cuda, monkeypatch):
    from ballista_tpu_torch.executor import runtime

    served = []
    monkeypatch.setattr(runtime, "serve", lambda *a, **k: served.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StandaloneCluster(n_executors=2)
    assert served == []


def test_context_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BallistaContext("127.0.0.1", 1)
    ctx = BallistaContext("127.0.0.1", 1, device="cpu")
    try:
        assert ctx.device == CPU
    finally:
        ctx.close()


def test_cluster_passes_its_device_to_every_task(sales_table, monkeypatch):
    from ballista_tpu_torch.executor import execution_loop

    devices = []
    real = execution_loop.TaskContext

    def recording(*a, **kw):
        devices.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(execution_loop, "TaskContext", recording)
    cluster = StandaloneCluster(n_executors=2, device="cpu")
    try:
        assert {ex.device for ex in cluster.executors} == {CPU}
        ctx = BallistaContext(*cluster.scheduler_addr, device="cpu")
        ctx.register_record_batches("sales", sales_table, n_partitions=3)
        out = ctx.sql("select region, sum(qty) as q from sales group by region "
                      "order by region").collect()
        ctx.close()
    finally:
        cluster.shutdown()
    assert out.column("q").to_pylist() == [19, 11, 25]
    assert devices and set(devices) == {CPU}


def test_prewarm_failure_fails_executor_start(monkeypatch):
    from ballista_tpu_torch.ops import cuda_kernels

    calls = []

    def broken(config, device):
        calls.append(device)
        raise RuntimeError("nvcc: kernel does not build")

    monkeypatch.setattr(cuda_kernels, "prewarm", broken)
    ex = BallistaExecutor("127.0.0.1", 1, device="cpu",
                          config=BallistaConfig({"ballista.tpu.prewarm": "true"}))
    try:
        with pytest.raises(RuntimeError, match="does not build"):
            ex.start()
        assert calls == [CPU]
        assert not ex._flight_thread.is_alive()
    finally:
        ex.stop()


def test_spmd_stages_plan_unfused_and_count_the_reason(sales_table):
    from ballista_tpu_torch.distributed.planner import SPMD_NOT_PORTED, DistributedPlanner
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import runtime

    ctx = ExecutionContext(BallistaConfig({"ballista.tpu.coalesce_aggregates": "false"}),
                           device="cpu")
    ctx.register_record_batches("sales", sales_table, n_partitions=3)
    plan = ctx.create_physical_plan(ctx.sql(
        "select region, sum(amount) as s from sales group by region").logical_plan())

    def stages(settings):
        planner = DistributedPlanner(BallistaConfig(settings))
        return [s.display_indent() for s in planner.plan_query_stages("j", plan)]

    runtime.routing_stats(reset=True)
    plain = stages({})
    assert runtime.routing_stats()["reasons"] == {}
    assert stages({"ballista.tpu.spmd_stages": "true"}) == plain
    assert len(plain) == 2  # the partial stage, and the final one as the job's root
    assert runtime.routing_stats(reset=True)["reasons"] == {SPMD_NOT_PORTED: 1}


SHARED_QUERIES = [
    "select g, sum(q) as s, count(*) as c from t group by g order by g",
    "select g, min(q) as mn, max(q) as mx from t where q > 3 group by g order by g",
]
SHARED_SETTINGS = {"ballista.cache.results": "false", "ballista.shuffle.partitions": "2",
                   "ballista.tpu.device_cache": "false"}


def test_shared_scan_members_run_solo(tmp_path):
    from ballista_tpu_torch.executor.execution_loop import BATCH_SOLO_REASON
    from ballista_tpu_torch.ops.runtime import shared_scan_stats

    rng = np.random.default_rng(42)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({
        "g": pa.array([f"k{v}" for v in rng.integers(0, 6, 20_000)]),
        "q": pa.array(rng.integers(1, 50, 20_000), type=pa.int64()),
    }), path)

    # the queries one at a time: nothing co-pends, nothing batches
    cluster = StandaloneCluster(n_executors=1, device="cpu")
    try:
        ctx = BallistaContext(*cluster.scheduler_addr, settings=SHARED_SETTINGS, device="cpu")
        ctx.register_parquet("t", path)
        solo = [ctx.sql(q).collect().to_pydict() for q in SHARED_QUERIES]
        ctx.close()
    finally:
        cluster.shutdown()

    # both submitted while no executor can take work, so their scan stages
    # co-pend and the scheduler batches them at first dispatch
    shared_scan_stats(reset=True)
    results = [None] * len(SHARED_QUERIES)
    cluster = StandaloneCluster(n_executors=0, device="cpu")
    try:
        def submit(i):
            c = BallistaContext(*cluster.scheduler_addr, settings=SHARED_SETTINGS,
                                device="cpu")
            c.register_parquet("t", path)
            results[i] = c.sql(SHARED_QUERIES[i]).collect().to_pydict()
            c.close()

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(SHARED_QUERIES))]
        for th in threads:
            th.start()
        time.sleep(1.5)
        ex = BallistaExecutor("127.0.0.1", cluster.port, config=cluster.config,
                              executor_id="late-0", device="cpu")
        ex.start()
        cluster.executors.append(ex)
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
    finally:
        cluster.shutdown()
    assert results == solo
    stats = shared_scan_stats(reset=True)
    assert stats.get("batches_formed", 0) >= 1, stats
    assert stats.get(BATCH_SOLO_REASON, 0) == stats["batches_formed"], stats
    assert stats.get("member_solo", 0) >= 2 * stats["batches_formed"], stats
