"""The executor's half of shared scan in the port
(ballista_tpu_torch/ops/sharedscan.py) against its own solo runs and against
the JAX package's sharedscan.precompute.

One Parquet file made from a seed with numpy; each query's scan stage is
planned by the package's DistributedPlanner and handed to precompute as a
batch member, as the executor does for a batched task. Every member's
precomputed table is bit-identical to the port's solo stage run of the same
node, and to the JAX package's batched table on its integer, count and
min / max columns (f32 sums within rtol 2e-5, test_tpu_backend.py:41).

Differences by design, pinned here: eager PyTorch compiles nothing, so the
combined step always runs and warm_fallback_launches stays 0 (the JAX
package warms a cold composition in the background); and an error that is
not a decline fails the whole batched task instead of sending its members
solo.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.distributed.planner import DistributedPlanner as JaxPlanner
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu.physical.plan import TaskContext as JaxTask
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed.planner import DistributedPlanner
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.ops import kernels, runtime, sharedscan
from ballista_tpu_torch.physical.plan import TaskContext

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
CPU = torch.device("cpu")

SUM_F32 = "select g, sum(v) as s, count(*) as c from t group by g"
MIN_MAX = "select g, min(q) as mn, max(q) as mx from t where v > 0 group by g"
SUM_INT = "select g, sum(q) as sq from t where q < 30 group by g"
COUNT_DATE = "select g, count(*) as c, max(d) as md from t group by g"
# a string device column: per-stage dictionaries, never in a shared upload
STRING_FILTER = "select g, count(*) as c from t where s <> 'x1' group by g"
# past MAX_GROUPS groups per batch: hands the member back to solo
HIGH_CARD = "select h, sum(q) as sq from t group by h"
SETTINGS = {"ballista.tpu.coalesce_aggregates": "false", "ballista.tpu.device_cache": "false"}


@pytest.fixture(scope="module")
def table_path(tmp_path_factory):
    rng = np.random.default_rng(42)
    n = 40_000
    t = pa.table({
        "g": pa.array([f"k{v}" for v in rng.integers(0, 6, n)]),
        "s": pa.array([f"x{v}" for v in rng.integers(0, 4, n)]),
        "v": pa.array(np.round(rng.uniform(-100, 100, n), 2)),
        "q": pa.array(rng.integers(1, 50, n), type=pa.int64()),
        "h": pa.array(rng.integers(0, 5000, n), type=pa.int64()),
        "d": pa.array(rng.integers(8000, 12000, n), type=pa.int32()).cast(pa.date32()),
    })
    path = str(tmp_path_factory.mktemp("torch_sharedscan") / "t.parquet")
    pq.write_table(t, path)
    return path


def _items(path, queries, settings=SETTINGS, jax_side=False):
    """(scan stage plan, partition 0, task context) per query."""
    if jax_side:
        cfg = JaxConfig({**settings, "ballista.executor.backend": "tpu"})
        ctx, planner = JaxContext(cfg), JaxPlanner
    else:
        cfg = BallistaConfig(settings)
        ctx, planner = ExecutionContext(cfg, device="cpu"), DistributedPlanner
    ctx.register_parquet("t", path)
    out = []
    for q in queries:
        stage = planner(cfg).plan_query_stages("j", ctx.create_physical_plan(
            ctx.sql(q).logical_plan()))[0]
        tctx = (JaxTask(config=cfg) if jax_side
                else TaskContext(config=cfg, device=CPU))
        out.append((stage, 0, tctx))
    return out


def _precompute(items):
    res = sharedscan.precompute(items)
    return [res.take(sharedscan._find_aggregate(plan), p) for plan, p, _ in items]


def _solo(items):
    """Each member's own stage run (the path a member takes unbatched)."""
    kernels.clear_stage_cache()
    return [kernels.hash_aggregate(sharedscan._find_aggregate(plan), p, ctx)
            for plan, p, ctx in items]


def _bits(table):
    return {f.name: table.column(f.name).to_pylist() if pa.types.is_string(f.type)
            else table.column(f.name).to_numpy().tobytes() for f in table.schema}


def test_batched_bit_identical_to_solo_and_to_the_jax_package(table_path, monkeypatch):
    from ballista_tpu.ops import sharedscan as jax_sharedscan

    queries = [SUM_F32, MIN_MAX, SUM_INT, COUNT_DATE, STRING_FILTER]
    kernels.clear_stage_cache()
    runtime.shared_scan_stats(reset=True)
    items = _items(table_path, queries)
    batched = _precompute(items)
    stats = runtime.shared_scan_stats(reset=True)
    solo = _solo(_items(table_path, queries))
    assert batched[-1] is None  # the string-filter member runs solo
    for got, want in zip(batched[:-1], solo[:-1]):
        assert _bits(got) == _bits(want)
    # 40,000 rows are two batches: per batch one combined step for the three
    # exact members, one own step for the f32 sum, four members on one upload
    assert stats == {"member_ineligible": 1, "shared_groups": 1, "device_launches": 4,
                     "launches_saved": 4, "uploads_saved": 6}, stats

    monkeypatch.setattr(jax_sharedscan, "SYNC_COMPILE", True)
    jitems = _items(table_path, queries, jax_side=True)
    jres = jax_sharedscan.precompute(jitems)
    for (plan, p, _), got in zip(jitems[:-1], batched[:-1]):
        want = jres.take(jax_sharedscan._find_aggregate(plan), p)
        assert want is not None and got.schema.names == want.schema.names
        for f in got.schema:
            g, w = got.column(f.name), want.column(f.name)
            if pa.types.is_floating(f.type) and f.name.startswith(("SUM", "AVG")):
                np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=2e-5)
            else:
                assert g.to_pylist() == w.to_pylist(), f.name


def test_f32_members_alone_run_their_own_steps(table_path):
    """Fewer than two exact members: no combined step, each member its own
    step and readback over the shared upload; still bit-identical to solo."""
    kernels.clear_stage_cache()
    runtime.shared_scan_stats(reset=True)
    items = _items(table_path, [SUM_F32, SUM_F32.replace("sum(v)", "sum(v * 2)"), MIN_MAX])
    batched = _precompute(items)
    stats = runtime.shared_scan_stats(reset=True)
    solo = _solo(_items(table_path, [SUM_F32, SUM_F32.replace("sum(v)", "sum(v * 2)"), MIN_MAX]))
    for got, want in zip(batched, solo):
        assert _bits(got) == _bits(want)
    assert stats == {"shared_groups": 1, "device_launches": 6, "uploads_saved": 4}, stats
    assert "warm_fallback_launches" not in stats


def test_high_cardinality_member_degrades_to_solo(table_path):
    kernels.clear_stage_cache()
    runtime.shared_scan_stats(reset=True)
    batched = _precompute(_items(table_path, [HIGH_CARD, MIN_MAX, SUM_INT]))
    stats = runtime.shared_scan_stats(reset=True)
    assert batched[0] is None and batched[1] is not None and batched[2] is not None
    assert stats["member_degraded"] == 1 and stats["launches_saved"] == 2, stats


def test_budget_overrun_sends_the_group_solo(table_path):
    kernels.clear_stage_cache()
    runtime.shared_scan_stats(reset=True)
    tiny = {**SETTINGS, "ballista.tpu.hbm_budget_bytes": "4096"}
    batched = _precompute(_items(table_path, [MIN_MAX, SUM_INT], settings=tiny))
    assert batched == [None, None]
    assert runtime.shared_scan_stats(reset=True) == {"batch_degraded": 1}


def test_device_error_fails_every_member(table_path, monkeypatch):
    """An exception that is not a decline leaves precompute, and the executor
    fails every member of the batched task (no solo rerun)."""
    from ballista_tpu_torch.executor.execution_loop import PollLoop
    from ballista_tpu_torch.proto import ballista_pb2 as pb

    def boom(stages):
        raise RuntimeError("injected device error")

    monkeypatch.setattr(sharedscan, "_combined_step", boom)
    kernels.clear_stage_cache()
    items = _items(table_path, [MIN_MAX, SUM_INT])
    with pytest.raises(RuntimeError, match="injected device error"):
        sharedscan.precompute(items)

    loop = PollLoop(None, pb.ExecutorMetadata(id="e"), "/tmp", device=CPU)
    task = pb.TaskDefinition()
    task.task_id.partition_id = 0
    task.siblings.add().task_id.partition_id = 0
    members = iter([task, task.siblings[0]])
    prepped = {id(td): (td, pb.TaskStatus(), plan, ctx)
               for td, (plan, _p, ctx) in zip([task, task.siblings[0]], items)}
    monkeypatch.setattr(loop, "_member_setup", lambda td: prepped[id(next(members))])
    ran = []
    monkeypatch.setattr(loop, "_member_execute", lambda *a, **k: ran.append(a))
    loop._run_task(task)
    assert ran == []
    statuses = [loop._finished.get_nowait() for _ in range(2)]
    assert all("shared scan: RuntimeError: injected device error" in s.failed.error
               for s in statuses)
