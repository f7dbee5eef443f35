"""The slice end to end: SQL -> plan -> fused aggregate stage -> partial
states -> final merge, on the JAX package's "tpu" backend (CPU JAX, Pallas
in interpret mode) against ballista_tpu_torch's "cuda" backend run on CPU
tensors (device="cpu"), over TPC-H SF 0.01 made by benchmarks/tpch/datagen.

Tolerances (tests/test_tpu_backend.py's assert_close rules): non-float
columns equal; q1/q6 floats within rtol 2e-5; high-cardinality floats
within tests/test_highcard.py's rtol 1e-4 / atol 2e-3. Both packages must
take the same device route, read from each stage cache's prepared entries.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext

ROOT = pathlib.Path(__file__).resolve().parent.parent

Q15_REVENUE = (
    "select l_suppkey as supplier_no, sum(l_extendedprice * (1 - l_discount)) "
    "as total_revenue from lineitem where l_shipdate >= date '1996-01-01' and "
    "l_shipdate < date '1996-01-01' + interval '3' month group by l_suppkey"
)
Q18_INNER = (
    "select l_orderkey, sum(l_quantity) as sum_qty from lineitem "
    "group by l_orderkey having sum(l_quantity) > 300"
)
HIGHCARD = (
    "select k, sum(v * (1 - f)) as s, count(v) as c, avg(v) as a "
    "from t where f > 0.4 group by k"
)


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_torch")
    generate(str(d), sf=0.01, parts=2, seed=20261016)
    return str(d)


@pytest.fixture(scope="module")
def highcard_path(tmp_path_factory):
    rng = np.random.default_rng(4)
    n, g = 30_000, 3000
    table = pa.table({
        "k": pa.array(rng.integers(0, g, n), type=pa.int64()),
        "v": pa.array(rng.uniform(-100, 100, n)),
        "f": pa.array(rng.uniform(0, 1, n)),
    })
    path = str(tmp_path_factory.mktemp("highcard") / "t.parquet")
    pq.write_table(table, path)
    return path


def _routes(stage_cache):
    return sorted(
        ent.get("kind")
        for s in stage_cache.values()
        if s not in (None, False)
        for ent in s._device_cache.values()
    )


def _run_both(sql, settings, register):
    from ballista_tpu.ops import kernels as jax_kernels
    from ballista_tpu_torch.ops import kernels as torch_kernels

    jax_kernels._stage_cache.clear()
    jax_kernels._stage_cache_pins.clear()
    torch_kernels.clear_stage_cache()
    jctx = JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"}))
    register(jctx)
    jax_out = jctx.sql(sql).collect()
    pctx = ExecutionContext(
        BallistaConfig({**settings, "ballista.executor.backend": "cuda"}),
        device="cpu",
    )
    register(pctx)
    torch_out = pctx.sql(sql).collect()
    return (jax_out, _routes(jax_kernels._stage_cache),
            torch_out, _routes(torch_kernels._stage_cache))


def _assert_close(want: pa.Table, got: pa.Table, rtol, atol=0.0):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    keys = [f.name for f in want.schema if not pa.types.is_floating(f.type)]
    if keys:
        want = want.sort_by([(k, "ascending") for k in keys])
        got = got.sort_by([(k, "ascending") for k in keys])
    for c, f in zip(want.column_names, want.schema):
        w = want.column(c).to_numpy(zero_copy_only=False)
        g = got.column(c).to_numpy(zero_copy_only=False)
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=c)
        else:
            assert list(g) == list(w), c


def _tpch(tpch_dir):
    from benchmarks.tpch.datagen import register_all

    return lambda ctx: register_all(ctx, tpch_dir)


_BASE = {"ballista.tpu.layout_cache_dir": ""}
_PALLAS = {**_BASE, "ballista.tpu.sorted_kernel": "pallas"}


@pytest.mark.parametrize(
    "name,settings,route,rtol,atol",
    [
        ("q1", _BASE, "batches", 2e-5, 0.0),
        ("q6", _BASE, "batches", 2e-5, 0.0),
        ("q15_revenue", _PALLAS, "batches", 1e-4, 2e-3),
        ("q18_inner", _PALLAS, "pallas_sorted", 1e-4, 2e-3),
        ("q18_inner", _BASE, "sorted", 1e-4, 2e-3),
    ],
)
def test_tpch_query_matches_reference(tpch_dir, name, settings, route, rtol, atol):
    sql = {
        "q15_revenue": Q15_REVENUE,
        "q18_inner": Q18_INNER,
    }.get(name) or (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
    jax_out, jax_routes, torch_out, torch_routes = _run_both(
        sql, settings, _tpch(tpch_dir)
    )
    assert torch_routes == jax_routes == [route]
    _assert_close(jax_out, torch_out, rtol, atol)


def test_highcard_filter_expression_matches_reference(highcard_path):
    jax_out, jax_routes, torch_out, torch_routes = _run_both(
        HIGHCARD, _PALLAS, lambda ctx: ctx.register_parquet("t", highcard_path)
    )
    assert torch_routes == jax_routes == ["pallas_sorted"]
    _assert_close(jax_out, torch_out, 1e-4, 2e-3)


def test_highcard_default_route_matches_reference(highcard_path):
    """Past MAX_GROUPS under the default configuration both packages take
    the chunked-segment layout route."""
    from ballista_tpu_torch.ops import runtime

    runtime.routing_stats(reset=True)
    jax_out, jax_routes, torch_out, torch_routes = _run_both(
        HIGHCARD, _BASE, lambda ctx: ctx.register_parquet("t", highcard_path)
    )
    stats = runtime.routing_stats(reset=True)
    assert torch_routes == jax_routes == ["sorted"]
    assert stats["routes"] == {"sorted": 1} and not stats["reasons"]
    _assert_close(jax_out, torch_out, 1e-4, 2e-3)


def test_highcard_without_kernel_declines_to_host(highcard_path):
    """Past MAX_GROUPS without the sorted kernel, the layout route runs; a
    stage whose tiles exceed ballista.tpu.hbm_budget_bytes still declines
    to the host with that reason, and the host path returns the
    reference's answer."""
    from ballista_tpu_torch.ops import runtime

    runtime.routing_stats(reset=True)
    tiny = {**_BASE, "ballista.tpu.hbm_budget_bytes": str(1 << 16)}
    jax_out, _, torch_out, torch_routes = _run_both(
        HIGHCARD, tiny, lambda ctx: ctx.register_parquet("t", highcard_path)
    )
    stats = runtime.routing_stats(reset=True)
    assert torch_routes == []
    assert stats["routes"].get("host") == 1
    assert any("exceed the HBM budget" in r for r in stats["reasons"])
    _assert_close(jax_out, torch_out, 1e-4, 2e-3)


def test_readbacks_recorded(tpch_dir):
    from benchmarks.tpch.datagen import register_all
    from ballista_tpu_torch.ops import kernels, runtime

    kernels.clear_stage_cache()
    ctx = ExecutionContext(BallistaConfig(_BASE), device="cpu")
    register_all(ctx, tpch_dir)
    runtime.readback_stats(reset=True)
    ctx.sql((ROOT / "benchmarks/tpch/queries/q6.sql").read_text()).collect()
    stats = runtime.readback_stats(reset=True)
    # q6 has int32 count rows and f32 sum rows: one transfer each
    assert stats["readbacks"] == 2 and stats["bytes"] > 0


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import ballista_tpu_torch, ballista_tpu_torch.engine\n"
        "import ballista_tpu_torch.ops.stage, ballista_tpu_torch.ops.kernels\n"
        "import ballista_tpu_torch.ops.cuda_kernels, ballista_tpu_torch.ops.state\n"
        "import ballista_tpu_torch.ops.factagg, ballista_tpu_torch.ops.mappedscan\n"
        "import ballista_tpu_torch.physical.planner, ballista_tpu_torch.sql.planner\n"
        "import ballista_tpu_torch.proto.ballista_pb2, ballista_tpu_torch.serde.physical\n"
        "import ballista_tpu_torch.distributed.planner, ballista_tpu_torch.scheduler.server\n"
        "import ballista_tpu_torch.executor.runtime, ballista_tpu_torch.client.dbapi\n"
        "import ballista_tpu_torch.ops.exchange, ballista_tpu_torch.native\n"
        "import ballista_tpu_torch.ops.sharedscan, ballista_tpu_torch.utils.tracing\n"
        "import ballista_tpu_torch.parallel.mesh, ballista_tpu_torch.parallel.multihost\n"
        "import ballista_tpu_torch.parallel.spmd, ballista_tpu_torch.parallel.spmd_stage\n"
        "import ballista_tpu_torch.parallel.spmd_join\n"
        "import ballista_tpu_torch.scheduler.state, ballista_tpu_torch.scheduler.rpc\n"
        "import ballista_tpu_torch.scheduler.kv, ballista_tpu_torch.scheduler.delta\n"
        "import ballista_tpu_torch.scheduler.fingerprint, ballista_tpu_torch.utils.chaos\n"
        "import ballista_tpu_torch.executor.execution_loop\n"
        "import ballista_tpu_torch.executor.flight_service, ballista_tpu_torch.client.context\n"
        "import ballista_tpu_torch.client.flight, ballista_tpu_torch.distributed.stages\n"
        "import ballista_tpu_torch.ops.costmodel, ballista_tpu_torch.ops.runtime\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ballista_tpu' or m.startswith('ballista_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_or_reference_import():
    import re

    pattern = re.compile(
        r"^\s*(import jax|from jax|import ballista_tpu\b(?!_torch)|from ballista_tpu[. ](?!_torch))",
        re.M,
    )
    files = list((ROOT / "ballista_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []


def test_context_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExecutionContext()
    assert ExecutionContext(device="cpu").device == torch.device("cpu")


def test_device_stage_needs_a_device(tpch_dir):
    """A TaskContext without a device never silently runs on the CPU."""
    from benchmarks.tpch.datagen import register_all
    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.physical.plan import TaskContext, collect_all

    kernels.clear_stage_cache()
    ctx = ExecutionContext(BallistaConfig(_BASE), device="cpu")
    register_all(ctx, tpch_dir)
    df = ctx.sql((ROOT / "benchmarks/tpch/queries/q6.sql").read_text())
    plan = ctx.create_physical_plan(df.logical_plan())
    with pytest.raises(RuntimeError, match="without a device"):
        collect_all(plan, TaskContext(config=ctx.config))


def test_backend_defaults():
    assert BallistaConfig().backend() == "cuda"
    assert BallistaConfig().tpu_coalesce_aggregates()
    settings = {"ballista.executor.backend": "cpu", "ballista.tpu.sorted_kernel": "pallas"}
    assert BallistaConfig(settings).tpu_sorted_kernel() == "pallas"
    assert not BallistaConfig(settings).tpu_coalesce_aggregates()
