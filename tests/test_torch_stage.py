"""The port's fused stage step run on exactly the state the JAX stage
prepared: ops/state.py::prepared_from_reference carries a JAX stage's
`_device_cache` entry ("batches" and "pallas_sorted" here; "sorted" in
tests/test_torch_layout.py) to torch tensors, and
the port's FusedAggregateStage.execute_prepared must produce the same
partial-state table as the JAX stage's own run.

Shapes: the table of tests/test_highcard.py (_make_table) with 60 groups
for the "batches" route, and its 2000-group sorted-kernel query. Tolerances: keys, counts and integer sums
equal; float min/max bit-equal (both packages go through the floatbits
bijection); f32 sums within rtol 1e-4 / atol 2e-3 (different summation
order; the test_highcard.py tolerance for sums that cancel).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu.logical import col as jcol, functions as JF, lit as jlit
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.logical import col, functions as F, lit
from ballista_tpu_torch.ops.state import prepared_from_reference
from ballista_tpu_torch.ops.stage import FusedAggregateStage

CPU = torch.device("cpu")


def _make_table(n, g, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table(
        {
            "k": pa.array(rng.integers(0, g, n), type=pa.int64()),
            "v": pa.array(rng.uniform(-100, 100, n).astype(np.float64)),
            "w": pa.array(rng.integers(-1000, 1000, n), type=pa.int64()),
            "f": pa.array(rng.uniform(0, 1, n).astype(np.float64)),
        }
    )


def _aggregate_node(plan):
    stack = [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashAggregateExec" and node.mode.value in ("partial", "single"):
            return node
        stack.extend(node.children())
    raise AssertionError("no partial/single aggregate in the plan")


def _to_numpy(obj):
    """A JAX stage entry with every device array converted to numpy."""
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_to_numpy(v) for v in obj)
    if hasattr(obj, "block_until_ready"):
        return np.asarray(obj)
    return obj


def _both_stages(path, settings, build):
    """(JAX partial table, JAX entry kind, port partial table) for one query
    shape: `build(ctx, col, F, lit)` returns the DataFrame."""
    from ballista_tpu.ops.stage import FusedAggregateStage as JaxStage
    from ballista_tpu.physical.plan import TaskContext as JaxTaskContext

    # the reference run needs no AOT disk tier: exporting each traced
    # program to .ballista_cache/aot was a large share of its time
    jctx = JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu",
                                 "ballista.tpu.aot_cache": ""}))
    jctx.register_parquet("t", path)
    jplan = jctx.create_physical_plan(build(jctx, jcol, JF, jlit).logical_plan())
    jstage = JaxStage(_aggregate_node(jplan))
    jtable = jstage.run(0, JaxTaskContext(config=jctx.config))
    entry = _to_numpy(jstage._device_cache[0])

    pctx = ExecutionContext(BallistaConfig(settings), device="cpu")
    pctx.register_parquet("t", path)
    pplan = pctx.create_physical_plan(build(pctx, col, F, lit).logical_plan())
    pstage = FusedAggregateStage(_aggregate_node(pplan))
    ptable = pstage.execute_prepared(prepared_from_reference(entry, CPU), CPU)
    return jtable, entry["kind"], ptable


def _assert_tables(jt, pt, exact, approx):
    assert pt.schema == jt.schema
    jt, pt = jt.sort_by("k"), pt.sort_by("k")
    for name in exact:
        assert pt.column(name).to_pylist() == jt.column(name).to_pylist(), name
    for name in approx:
        np.testing.assert_allclose(
            pt.column(name).to_numpy(), jt.column(name).to_numpy(),
            rtol=1e-4, atol=2e-3, err_msg=name,
        )


def test_batches_entry_from_reference(tmp_path):
    """"batches" route (<= 1024 groups): narrow LUT columns, f64 key planes
    for min/max, int32 sums, avg."""
    path = str(tmp_path / "t.parquet")
    # the JAX reference unrolls its program per group: 16 groups compile in a
    # fraction of the time 60 took
    pq.write_table(_make_table(n=10_000, g=16), path)

    def build(ctx, col, F, lit):
        ctx_df = ctx.table("t")
        return ctx_df.filter(col("f") > lit(0.25)).aggregate(
            [col("k")],
            [
                F.sum(col("v")).alias("sv"),
                F.count(col("v")).alias("c"),
                F.min(col("v")).alias("mn"),
                F.max(col("v")).alias("mx"),
                F.avg(col("v")).alias("av"),
                F.sum(col("w")).alias("sw"),
            ],
        )

    jt, kind, pt = _both_stages(path, {"ballista.tpu.layout_cache_dir": ""}, build)
    assert kind == "batches"
    names = pt.column_names
    exact = ["k"] + [n for n in names if n.startswith(("c", "mn", "mx", "sw"))]
    approx = [n for n in names if n not in exact]
    _assert_tables(jt, pt, exact, approx)


def test_pallas_sorted_entry_from_reference(tmp_path):
    """"pallas_sorted" route (the tests/test_highcard.py:119 shape): the
    JAX entry is padded to 1024-row blocks; the port's kernel route takes it
    as it is."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(_make_table(n=60_000, g=2000), path)

    def build(ctx, col, F, lit):
        return ctx.table("t").filter(col("f") > lit(0.4)).aggregate(
            [col("k")],
            [F.sum(col("v")).alias("s"), F.count(col("v")).alias("c"),
             F.avg(col("v")).alias("a")],
        )

    settings = {"ballista.tpu.layout_cache_dir": "",
                "ballista.tpu.sorted_kernel": "pallas"}
    jt, kind, pt = _both_stages(path, settings, build)
    assert kind == "pallas_sorted"
    names = pt.column_names
    exact = ["k"] + [n for n in names if n.startswith("c")]
    _assert_tables(jt, pt, exact, [n for n in names if n not in exact])


def test_prepared_from_reference_rejects_unknown_kind():
    with pytest.raises(ValueError):
        prepared_from_reference({"kind": "fact"}, CPU)


def test_floatbits_match_reference():
    from ballista_tpu.ops import floatbits as jfb
    from ballista_tpu_torch.ops import floatbits as tfb

    x = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-40, 2.5, np.inf], np.float32)
    np.testing.assert_array_equal(
        tfb.torch_f32_to_i32(torch.from_numpy(x)).numpy(), jfb.f32_to_i32(x)
    )
    k = jfb.f32_to_i32(x)
    np.testing.assert_array_equal(
        tfb.torch_i32_to_f32(torch.from_numpy(k)).numpy().view(np.int32),
        jfb.i32_to_f32(k).view(np.int32),
    )
    y = np.array([-1e300, -2.0, 0.0, 3.0, 1e-310], np.float64)
    hi, lo = tfb.i64_to_planes(tfb.f64_to_i64(y))
    jhi, jlo = jfb.i64_to_planes(jfb.f64_to_i64(y))
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)


def test_civil_from_days_matches_reference():
    import datetime

    import jax.numpy as jnp

    from ballista_tpu.ops.jaxexpr import _civil_from_days as jax_civil
    from ballista_tpu_torch.ops.torchexpr import _civil_from_days

    days = np.array(
        [(datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
         for y, m, d in [(1970, 1, 1), (1992, 2, 29), (1998, 12, 31),
                         (2000, 3, 1), (1969, 12, 31), (1600, 2, 29)]],
        dtype=np.int32,
    )
    got = _civil_from_days(torch.from_numpy(days))
    want = jax_civil(jnp.asarray(days))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
