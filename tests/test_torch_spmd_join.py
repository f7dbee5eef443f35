"""The port's mesh join (ballista_tpu_torch/parallel/spmd_join.py) against the
JAX package's SpmdJoinExec on its 8 forced CPU devices.

Both packages plan the same two tables (made from a seed with numpy) through
their DistributedPlanner under ballista.tpu.spmd_stages, find the fused join
and execute it; the port's mesh is [cpu] * 8. The joined tables are equal
row for row, in order (probe-slot-major over the exchanged slots, stable
among ties), and agree with the "cpu" backend's host join as sets of rows.
Covered: INNER and LEFT, string and composite keys, duplicate build keys,
the dense re-map that keeps null keys unmatched, and the step-aside past
the top multiplicity tier (an inline host join with a recorded reason).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.distributed.planner import DistributedPlanner as JaxPlanner
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu.parallel.spmd_join import SpmdJoinExec as JaxJoin
from ballista_tpu.physical.plan import TaskContext as JaxTask
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed.planner import DistributedPlanner
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.parallel.spmd_join import SpmdJoinExec
from ballista_tpu_torch.physical.plan import TaskContext

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
CPU = torch.device("cpu")
SPMD = {"ballista.tpu.spmd_stages": "true", "ballista.tpu.mesh": "data:8"}


def _dim(n=500, seed=1):
    rng = np.random.default_rng(seed)
    keys = np.arange(n, dtype=np.int64)
    rng.shuffle(keys)
    return pa.table({
        "dk": pa.array(keys),
        "name": pa.array([None if i % 97 == 0 else f"dim-{i}" for i in range(n)]),
        "weight": pa.array(rng.uniform(0, 1, n)),
    })


def _fact(n=6000, nk=700, seed=2):
    rng = np.random.default_rng(seed)
    fk = rng.integers(0, nk, n)
    return pa.table({
        "fk": pa.array([None if i % 143 == 0 else int(v) for i, v in enumerate(fk)],
                       type=pa.int64()),
        "amount": pa.array(rng.uniform(-50, 50, n)),
    })


def _composite():
    n = 300
    left = pa.table({
        "c1": pa.array([f"g{i % 20}" for i in range(n)]),
        "c2": pa.array(np.arange(n, dtype=np.int64) % 15),
        "lv": pa.array(np.arange(n, dtype=np.int64)),
    }).group_by(["c1", "c2"]).aggregate([("lv", "max")])
    right = pa.table({
        "k1": pa.array([f"g{i % 23}" for i in range(900)]),
        "k2": pa.array(np.arange(900, dtype=np.int64) % 17),
        "rv": pa.array(np.random.default_rng(0).uniform(0, 1, 900)),
    })
    return left, right


def _dup_left():
    rng = np.random.default_rng(7)
    left = pa.table({"dk": pa.array(rng.integers(0, 60, 400), type=pa.int64()),
                     "name": pa.array([f"d{i}" for i in range(400)])})
    right = pa.table({"fk": pa.array(rng.integers(0, 40, 900), type=pa.int64()),
                      "amount": pa.array(rng.uniform(-5, 5, 900))})
    return left, right


def _nulls_past_int32():
    """Composite keys whose packed cardinality passes 2^31: the dense
    re-map must keep the null key at -1 (never matching)."""
    n = 60_000
    left = pa.table({
        "a": pa.array([None] + list(range(1, n)), type=pa.int64()),
        "b": pa.array(np.arange(n) * 7 % (n + 13), type=pa.int64()),
        "lv": pa.array(np.arange(n, dtype=np.int64)),
    })
    right = pa.table({
        "x": pa.array([None, 5, 10, None, 999999], type=pa.int64()),
        "y": pa.array([int(left.column("b")[1].as_py()), 35 % (n + 13), 70 % (n + 13), 3, 4],
                      type=pa.int64()),
        "rv": pa.array([1.0, 2.0, 3.0, 4.0, 5.0]),
    })
    return left, right


def _past_top_tier():
    from ballista_tpu_torch.ops.kernels import JOIN_MULTIPLICITY_TIERS

    mult = JOIN_MULTIPLICITY_TIERS[-1] + 10
    left = pa.table({"dk": pa.array([7] * mult + [1, 2], type=pa.int64()),
                     "name": pa.array([f"d{i}" for i in range(mult + 2)])})
    right = pa.table({"fk": pa.array([7, 1, 9], type=pa.int64()),
                      "amount": pa.array([1.0, 2.0, 3.0])})
    return left, right


CASES = {
    # name: (tables, left keys, right keys, how, partitions (l, r), path)
    "inner": (lambda: (_dim(), _fact()), ["dk"], ["fk"], "inner", (3, 4), "mesh"),
    "left": (lambda: (_dim(), _fact(nk=300)), ["dk"], ["fk"], "left", (3, 4), "mesh"),
    "string_composite_keys": (_composite, ["c1", "c2"], ["k1", "k2"], "inner", (3, 4), "mesh"),
    "duplicate_build_keys": (
        lambda: (pa.table({"dk": pa.array([1, 2, 2, 3], type=pa.int64()),
                           "name": pa.array(["a", "b", "c", "d"])}),
                 pa.table({"fk": pa.array([2, 3, 4, 2], type=pa.int64()),
                           "amount": pa.array([1.0, 2.0, 3.0, 4.0])})),
        ["dk"], ["fk"], "inner", (1, 2), "mesh"),
    "duplicate_build_keys_left": (_dup_left, ["dk"], ["fk"], "left", (3, 4), "mesh"),
    "null_keys_past_int32": (_nulls_past_int32, ["a", "b"], ["x", "y"], "left", (2, 2), "mesh"),
    "step_aside_past_top_tier": (_past_top_tier, ["dk"], ["fk"], "inner", (1, 2),
                                 "host-inline"),
}


def _plan(left, right, lk, rk, how, nl, nr, jax_side, settings=None):
    if jax_side:
        cfg = JaxConfig({**SPMD, "ballista.executor.backend": "tpu"})
        ctx, planner, cls = JaxContext(cfg), JaxPlanner, JaxJoin
        tctx = JaxTask(config=cfg, work_dir="/tmp", job_id="t")
    else:
        cfg = BallistaConfig(settings or {**SPMD, "ballista.executor.backend": "cuda"})
        ctx, planner, cls = ExecutionContext(cfg, device="cpu"), DistributedPlanner, SpmdJoinExec
        tctx = TaskContext(config=cfg, work_dir="/tmp", job_id="t", device=CPU,
                           mesh_devices=[CPU] * 8)
    ctx.register_record_batches("l", left, n_partitions=nl)
    ctx.register_record_batches("r", right, n_partitions=nr)
    df = ctx.table("l").join(ctx.table("r"), lk, rk, how=how)
    phys = ctx.create_physical_plan(df.logical_plan())

    def find(n):
        if isinstance(n, cls):
            return n
        for c in n.children():
            r = find(c)
            if r is not None:
                return r
        return None

    stages = planner(cfg).plan_query_stages("job", phys)
    return next(j for j in (find(s) for s in stages) if j is not None), tctx


def _host_oracle(left, right, lk, rk, how):
    ctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}), device="cpu")
    ctx.register_record_batches("l", left, n_partitions=1)
    ctx.register_record_batches("r", right, n_partitions=1)
    return ctx.table("l").join(ctx.table("r"), lk, rk, how=how).collect()


def _rows(table):
    return sorted(zip(*(table.column(i).to_pylist() for i in range(table.num_columns))),
                  key=repr)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_join_matches_jax_package(name):
    from ballista_tpu_torch.ops.runtime import join_path_stats

    make, lk, rk, how, (nl, nr), path = CASES[name]
    left, right = make()
    jspmd, jctx = _plan(left, right, lk, rk, how, nl, nr, jax_side=True)
    want = pa.Table.from_batches(list(jspmd.execute(0, jctx)), schema=jspmd.schema())
    spmd, tctx = _plan(left, right, lk, rk, how, nl, nr, jax_side=False)
    join_path_stats(reset=True)
    got = pa.Table.from_batches(list(spmd.execute(0, tctx)), schema=spmd.schema())
    stats = join_path_stats(reset=True)
    assert jspmd.last_path == spmd.last_path == path
    # row for row, in order
    assert got.to_pydict() == want.to_pydict()
    assert _rows(got) == _rows(_host_oracle(left, right, lk, rk, how))
    if path == "mesh":
        assert stats["paths"] == {"device": 1}
    else:
        assert stats["paths"] == {"step_aside": 1}
        assert any("multiplicity" in r for r in stats["reasons"])


def test_serde_round_trip_executes():
    from ballista_tpu_torch.serde.physical import phys_plan_from_proto, phys_plan_to_proto

    dim, fact = _dim(100), _fact(400, nk=120)
    spmd, tctx = _plan(dim, fact, ["dk"], ["fk"], "left", 3, 4, jax_side=False)
    back = phys_plan_from_proto(phys_plan_to_proto(spmd))
    assert isinstance(back, SpmdJoinExec) and back.schema() == spmd.schema()
    assert back.subplan.partitioned == spmd.subplan.partitioned
    out = pa.Table.from_batches(list(back.execute(0, tctx)))
    assert back.last_path == "mesh"
    assert _rows(out) == _rows(_host_oracle(dim, fact, ["dk"], ["fk"], "left"))


def test_admission_declines_when_model_prefers_host(tmp_path):
    from ballista_tpu_torch.ops import costmodel
    from ballista_tpu_torch.ops.runtime import join_path_stats

    dim, fact = _dim(), _fact()
    settings = {**SPMD, "ballista.executor.backend": "cuda", "ballista.tpu.cost_model": "true",
                "ballista.tpu.cost_model_dir": str(tmp_path / "costs")}
    spmd, tctx = _plan(dim, fact, ["dk"], ["fk"], "inner", 3, 4, jax_side=False,
                       settings=settings)
    costmodel.reset(clear_dir=True)
    costmodel.configure(BallistaConfig(settings))
    try:
        costmodel.seed("join.mesh", 1000.0, 1e6)
        costmodel.seed("join.host", 1000.0, 1e-6, engine="host")
        join_path_stats(reset=True)
        out = pa.Table.from_batches(list(spmd.execute(0, tctx)))
        assert spmd.last_path == "host-inline"
        stats = join_path_stats(reset=True)
        assert stats["paths"] == {"host_declined": 1}
        assert any("cost model" in r for r in stats["reasons"])
        assert _rows(out) == _rows(_host_oracle(dim, fact, ["dk"], ["fk"], "inner"))
    finally:
        costmodel.reset(clear_dir=True)


def test_device_error_propagates(monkeypatch):
    """Unlike the JAX package (which joins on the host), an error on the
    mesh path that is not a decline fails the task."""
    import ballista_tpu_torch.parallel.spmd_join as sj

    dim, fact = _dim(50), _fact(200, nk=60)
    spmd, tctx = _plan(dim, fact, ["dk"], ["fk"], "inner", 2, 2, jax_side=False)

    def boom(*_a, **_k):
        raise RuntimeError("injected device error")

    monkeypatch.setattr(sj, "join_program", boom)
    with pytest.raises(RuntimeError, match="injected device error"):
        list(spmd.execute(0, tctx))
