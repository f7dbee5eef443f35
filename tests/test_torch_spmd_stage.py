"""The port's mesh aggregation stage (ballista_tpu_torch/parallel/spmd_stage.py)
and the distributed planner that emits it, against the JAX package's
SpmdAggregateExec on its 8 forced CPU devices.

Both packages plan the same table (made from a seed with numpy) through their
DistributedPlanner under ballista.tpu.spmd_stages, find the fused stage and
execute it; the port's mesh is [cpu] * 8. Group keys, counts, integer sums
and min / max are bit-identical to the JAX package's; f32 sums agree within
rtol 2e-5 (test_tpu_backend.py:41), and within rtol 1e-4 / atol 2e-3 at high
cardinality (test_highcard.py:71). Both take the mesh path, both agree with
the pyarrow group_by oracle.

Differences by design, pinned here: an exception on the mesh path other
than UnsupportedOnDevice propagates (the JAX package answers on the host),
and an UnsupportedOnDevice decline is counted with its reason.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.distributed.planner import DistributedPlanner as JaxPlanner
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu.logical import col as jcol, functions as JF
from ballista_tpu.parallel.spmd_stage import SpmdAggregateExec as JaxSpmd
from ballista_tpu.physical.plan import TaskContext as JaxTask
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed.planner import DistributedPlanner
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.logical import col, functions as F
from ballista_tpu_torch.parallel.spmd_stage import SpmdAggregateExec
from ballista_tpu_torch.physical.plan import TaskContext

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
CPU = torch.device("cpu")
SPMD = {"ballista.tpu.spmd_stages": "true", "ballista.tpu.mesh": "data:8"}
JAX_SETTINGS = {**SPMD, "ballista.executor.backend": "tpu"}
PORT_SETTINGS = {**SPMD, "ballista.executor.backend": "cuda"}


def _sales(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "region": pa.array(np.array(["east", "west", "north", "south"])[rng.integers(0, 4, n)]),
        "amount": pa.array(rng.uniform(0, 100, n)),
        "qty": pa.array(rng.integers(1, 50, n), type=pa.int64()),
    })


def _find(node, cls):
    if isinstance(node, cls):
        return node
    for c in node.children():
        r = _find(c, cls)
        if r is not None:
            return r
    return None


def _port_task(cfg, shards=8):
    return TaskContext(config=cfg, work_dir="/tmp", job_id="t", device=CPU,
                       mesh_devices=[CPU] * shards)


def _plan(table, keys, aggs, n_partitions, jax_side, settings=None):
    """(fused stage, config, task context, stages, unfused stage count) of
    one aggregate query in one package."""
    if jax_side:
        cfg = JaxConfig(settings or JAX_SETTINGS)
        ctx, c, f, planner, cls = JaxContext(cfg), jcol, JF, JaxPlanner, JaxSpmd
        tctx = JaxTask(config=cfg, work_dir="/tmp", job_id="t")
    else:
        cfg = BallistaConfig(settings or PORT_SETTINGS)
        ctx, c, f, planner, cls = (ExecutionContext(cfg, device="cpu"), col, F,
                                   DistributedPlanner, SpmdAggregateExec)
        tctx = _port_task(cfg)
    ctx.register_record_batches("t", table, n_partitions=n_partitions)
    df = ctx.table("t").aggregate([c(k) for k in keys], aggs(c, f))
    phys = ctx.create_physical_plan(df.logical_plan())
    stages = planner(cfg).plan_query_stages("job", phys)
    spmd = next(s for s in (_find(st, cls) for st in stages) if s is not None)
    return spmd, cfg, tctx, stages, len(planner().plan_query_stages("job", phys))


def _run(spmd, tctx, keys):
    out = pa.Table.from_batches(list(spmd.execute(0, tctx)), schema=spmd.schema())
    return out.sort_by([(k, "ascending") for k in keys])


def _aggs_full(c, f):
    return [f.sum(c("v")).alias("s"), f.count(c("q")).alias("c"), f.min(c("v")).alias("mn"),
            f.sum(c("q")).alias("sq"), f.max(c("q")).alias("mx")]


def _aggs_sum_count(c, f):
    return [f.sum(c("v")).alias("s"), f.count(c("v")).alias("c")]


def _keyed(n, g, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, g, n).astype(np.int64)),
        "v": pa.array(rng.uniform(0, 100, n)),
        "q": pa.array(rng.integers(1, 50, n).astype(np.int64)),
    })


def _multi_key(seed=11, n=6000):
    rng = np.random.default_rng(seed)
    return pa.table({
        "region": pa.array(np.array(["east", "west", "north", "south"])[rng.integers(0, 4, n)]),
        "tier": pa.array(rng.integers(0, 7, n).astype(np.int64)),
        "v": pa.array(rng.uniform(0, 100, n)),
    })


def _skewed(seed=13):
    """One mega-group in the first half (its shard's L1 is 8), every group
    1..1100 at count 16 in the second (L1 16): the shards rebuild their
    layouts to one tile width (the force_L1 branch)."""
    rng = np.random.default_rng(seed)
    g = 1100
    keys = np.concatenate([np.zeros(g * 32, dtype=np.int64),
                           np.tile(np.arange(1, g + 1, dtype=np.int64), 32)])
    return pa.table({"k": pa.array(keys), "v": pa.array(rng.uniform(0, 10, len(keys)))})


CASES = {
    # name: (table, keys, aggs, partitions, high cardinality)
    "unrolled": (lambda: _keyed(4000, 5, 3), ["k"], _aggs_full, 4, False),
    "sorted": (lambda: _keyed(60_000, 5000, 7), ["k"], _aggs_full, 5, True),
    "multi_column_key": (_multi_key, ["region", "tier"],
                         lambda c, f: [f.sum(c("v")).alias("s"), f.count(c("v")).alias("c"),
                                       f.max(c("tier")).alias("mt")], 6, False),
    "skewed_runs": (_skewed, ["k"], _aggs_sum_count, 2, True),
    "fewer_partitions_than_shards": (lambda: _keyed(500, 4, 5), ["k"],
                                     lambda c, f: [f.sum(c("q")).alias("sq"),
                                                   f.max(c("v")).alias("mx")], 2, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_matches_jax_package_and_host(name):
    make, keys, aggs, parts, highcard = CASES[name]
    table = make()
    jspmd, _, jctx, _, _ = _plan(table, keys, aggs, parts, jax_side=True)
    want = _run(jspmd, jctx, keys)
    spmd, _, tctx, _, _ = _plan(table, keys, aggs, parts, jax_side=False)
    got = _run(spmd, tctx, keys)
    assert jspmd.last_path == spmd.last_path == "mesh"
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    tol = dict(rtol=1e-4, atol=2e-3) if highcard else dict(rtol=2e-5)
    for f in got.schema:
        g, w = got.column(f.name).to_numpy(), want.column(f.name).to_numpy()
        if f.name == "s":
            np.testing.assert_allclose(g, w, **tol)
        elif g.dtype == object:  # string keys
            assert g.tolist() == w.tolist(), f.name
        else:  # keys, counts, integer sums, min / max: bit-identical
            assert g.tobytes() == w.tobytes(), f.name
    # and the pyarrow oracle: keys and counts exactly
    ora = table.group_by(keys).aggregate([(keys[0], "count")]).sort_by(
        [(k, "ascending") for k in keys])
    assert got.column(keys[-1]).to_pylist() == ora.column(keys[-1]).to_pylist()


def test_planner_fuses_partial_final_into_one_stage():
    """The port's planner emits the fused stage where the JAX package's does,
    with the same stage count (one fewer than the unfused plan)."""
    table = _sales()
    aggs = lambda c, f: [f.sum(c("amount")).alias("s"), f.count(c("qty")).alias("c")]
    _, _, _, jstages, jplain = _plan(table, ["region"], aggs, 4, jax_side=True)
    spmd, _, _, stages, plain = _plan(table, ["region"], aggs, 4, jax_side=False)
    assert isinstance(spmd, SpmdAggregateExec)
    assert len(stages) == len(jstages) == plain - 1 == jplain - 1


def test_serde_round_trip_and_jax_bytes():
    """The node round-trips through the port's serde, and bytes the JAX
    package encodes decode in the port to the same plan (and back)."""
    from ballista_tpu.proto import ballista_pb2 as jpb
    from ballista_tpu.serde import physical as jser
    from ballista_tpu_torch.proto import ballista_pb2 as pb
    from ballista_tpu_torch.serde.physical import phys_plan_from_proto, phys_plan_to_proto

    table = _sales()
    aggs = lambda c, f: [f.sum(c("amount")).alias("s")]
    spmd, cfg, tctx, _, _ = _plan(table, ["region"], aggs, 4, jax_side=False)
    back = phys_plan_from_proto(phys_plan_to_proto(spmd))
    assert isinstance(back, SpmdAggregateExec) and back.schema() == spmd.schema()
    # the partial side round-trips unchanged (a FINAL aggregate is rebuilt
    # on decode over its state columns, as in the JAX package's serde)
    assert back.partial.display_indent() == spmd.partial.display_indent()
    jspmd, _, _, _, _ = _plan(table, ["region"], aggs, 4, jax_side=True)
    jback = jser.phys_plan_from_proto(jser.phys_plan_to_proto(jspmd))
    node = pb.PhysicalPlanNode()
    node.ParseFromString(jser.phys_plan_to_proto(jspmd).SerializeToString())
    decoded = phys_plan_from_proto(node)
    assert isinstance(decoded, SpmdAggregateExec)
    assert decoded.subplan.display_indent() == jback.subplan.display_indent()
    jnode = jpb.PhysicalPlanNode()
    jnode.ParseFromString(phys_plan_to_proto(spmd).SerializeToString())
    jdecoded = jser.phys_plan_from_proto(jnode)
    assert isinstance(jdecoded, JaxSpmd)
    assert jdecoded.subplan.display_indent() == back.subplan.display_indent()
    out = pa.Table.from_batches(list(back.execute(0, tctx)))
    assert back.last_path == "mesh" and out.num_rows == 4


def test_decline_runs_host_and_counts_the_reason():
    """A q2-shape exact float MIN declines with UnsupportedOnDevice: the
    host subplan answers, the reason is counted, spmd.host_fallback too."""
    from ballista_tpu_torch.ops import runtime
    from ballista_tpu_torch.utils import tracing

    table = _sales(n=800, seed=9)
    spmd, _, tctx, _, _ = _plan(table, ["region"], lambda c, f: [f.min(c("amount")).alias("m")],
                                3, jax_side=False)
    spmd.partial.exact_floats = True
    runtime.routing_stats(reset=True)
    before = tracing.counters().get("spmd.host_fallback", 0)
    out = _run(spmd, tctx, ["region"])
    assert spmd.last_path == "host"
    assert tracing.counters().get("spmd.host_fallback", 0) == before + 1
    reasons = runtime.routing_stats(reset=True)["reasons"]
    assert reasons == {"mesh aggregate: exact float min/max required": 1}
    ora = table.group_by("region").aggregate([("amount", "min")]).sort_by("region")
    assert out.column("m").to_pylist() == ora.column("amount_min").to_pylist()


def test_device_error_propagates(monkeypatch):
    """Unlike the JAX package (which answers on the host), an error on the
    mesh path that is not a decline fails the task."""
    table = _sales(n=800, seed=9)
    spmd, _, tctx, _, _ = _plan(table, ["region"], lambda c, f: [f.sum(c("amount")).alias("s")],
                                3, jax_side=False)

    def boom(ctx):
        raise RuntimeError("injected device error")

    monkeypatch.setattr(spmd, "_execute_mesh", boom)
    with pytest.raises(RuntimeError, match="injected device error"):
        list(spmd.execute(0, tctx))


def test_cpu_backend_runs_the_subplan():
    table = _sales(n=500, seed=4)
    settings = {**PORT_SETTINGS, "ballista.executor.backend": "cpu"}
    spmd, _, tctx, _, _ = _plan(table, ["region"], lambda c, f: [f.sum(c("qty")).alias("sq")],
                                2, jax_side=False, settings=settings)
    out = _run(spmd, tctx, ["region"])
    assert spmd.last_path is None  # never reached the mesh
    ora = table.group_by("region").aggregate([("qty", "sum")]).sort_by("region")
    assert out.column("sq").to_pylist() == ora.column("qty_sum").to_pylist()


@pytest.mark.parametrize("mesh_slower", [True, False])
def test_admission_follows_the_cost_model(tmp_path, mesh_slower):
    """With both rates warm and the mesh predicted slower, execute() routes
    to the host up front (spmd.host_declined); seeded the other way the same
    node runs the mesh. A warm mesh rate alone never declines."""
    from ballista_tpu_torch.ops import costmodel
    from ballista_tpu_torch.utils import tracing

    table = _sales()
    settings = {**PORT_SETTINGS, "ballista.tpu.cost_model": "true",
                "ballista.tpu.cost_model_dir": str(tmp_path / "costs")}
    aggs = lambda c, f: [f.sum(c("amount")).alias("s"), f.count(c("qty")).alias("c")]
    spmd, cfg, tctx, _, _ = _plan(table, ["region"], aggs, 4, jax_side=False, settings=settings)
    fp = spmd.fingerprint()
    costmodel.reset(clear_dir=True)
    costmodel.configure(cfg)
    try:
        costmodel.seed("mesh.agg|" + fp, 1.0, 10.0 if mesh_slower else 1e-6)
        _run(spmd, tctx, ["region"])
        assert spmd.last_path == "mesh"  # the host rate is still cold
        costmodel.seed("mesh.agg|" + fp, 1.0, 10.0 if mesh_slower else 1e-6)
        costmodel.seed("mesh.agg.host|" + fp, 1.0, 1e-4 if mesh_slower else 10.0,
                       engine="host")
        before = tracing.counters().get("spmd.host_declined", 0)
        out = _run(spmd, tctx, ["region"])
        assert spmd.last_path == ("host" if mesh_slower else "mesh")
        assert tracing.counters().get("spmd.host_declined", 0) == before + int(mesh_slower)
        ora = table.group_by("region").aggregate([("qty", "count")]).sort_by("region")
        assert out.column("c").to_pylist() == ora.column("qty_count").to_pylist()
    finally:
        costmodel.reset(clear_dir=True)
