"""The port's chunked-segment layout (ballista_tpu_torch/ops/layout.py) and
"sorted" stage route against the JAX package's.

- SortedSegmentLayout equal to the reference's on the same codes: owner,
  clen, L1, V, the materialized tiles and the three folds, bit for bit.
- The shapes of tests/test_highcard.py (at smaller row counts) through the
  port's "cuda" backend on CPU tensors and the JAX "tpu" backend (CPU JAX):
  the same device route, and the same answers.
- A JAX "sorted" entry carried by ops/state.py::prepared_from_reference and
  run by the port's execute_prepared.

Tolerances: keys, counts, integer sums and float min/max bit-equal (both go
through the floatbits bijection); f32 sums within rtol 1e-4 / atol 2e-3,
averages within rtol 1e-4 / atol 1e-4 (test_highcard.py's, for f32 sums in
another order).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu.logical import col as jcol, functions as JF, lit as jlit
from ballista_tpu.ops.layout import SortedSegmentLayout as JaxLayout
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.logical import col, functions as F, lit
from ballista_tpu_torch.ops.layout import SortedSegmentLayout

CPU = torch.device("cpu")


def _codes(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        g = 3000
        return rng.integers(0, g, 40_000), g
    if kind == "skewed":  # one giant group among many small ones
        c = np.concatenate([np.zeros(20_000, np.int64), rng.integers(1, 500, 5000)])
        rng.shuffle(c)
        return c, 500
    if kind == "with_empty_groups":
        return rng.choice(np.arange(0, 2000, 3), 9000), 2000
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind,kwargs",
    [
        ("uniform", {}),
        ("skewed", {}),
        ("with_empty_groups", {}),
        ("skewed", {"cover_max": True}),
        ("uniform", {"force_L1": 16}),
        ("skewed", {"min_one_chunk": False}),
    ],
)
def test_layout_matches_reference(kind, kwargs):
    codes, g = _codes(kind)
    ours, ref = SortedSegmentLayout(codes, g, **kwargs), JaxLayout(codes, g, **kwargs)
    assert (ours.L1, ours.V, ours.n_groups) == (ref.L1, ref.V, ref.n_groups)
    assert ours.one_chunk_per_group == ref.one_chunk_per_group
    assert ours.state() == ref.state()
    np.testing.assert_array_equal(ours.owner, ref.owner)
    np.testing.assert_array_equal(ours.clen, ref.clen)
    assert ours.clen.dtype == np.int16
    rng = np.random.default_rng(1)
    col_f = rng.normal(size=len(codes)).astype(np.float32)
    col_i = rng.integers(-50, 50, len(codes)).astype(np.int32)
    for c in (col_f, col_i):
        np.testing.assert_array_equal(ours.materialize(c), ref.materialize(c))
    if not kwargs.get("min_one_chunk", True):
        return  # such layouts fold in-program, not on the host
    for partials in (rng.normal(size=ours.V).astype(np.float32),
                     rng.integers(-1000, 1000, ours.V).astype(np.int32)):
        for fold in ("fold_sum", "fold_min", "fold_max"):
            a, b = getattr(ours, fold)(partials), getattr(ref, fold)(partials)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_layout_from_state_round_trip():
    codes, g = _codes("skewed")
    ref = JaxLayout(codes, g)
    back = SortedSegmentLayout.from_state(ref.state(), ref.owner, ref.clen)
    partials = np.arange(back.V, dtype=np.int32)
    np.testing.assert_array_equal(back.fold_sum(partials), ref.fold_sum(partials))
    assert back.row_take is None and back.state() == ref.state()


# -- tests/test_highcard.py's shapes through both packages -------------------
def _write(tmp_path, table, name="t.parquet"):
    path = str(tmp_path / name)
    pq.write_table(table, path)
    return path


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


def _kinds(stage_cache):
    return sorted(
        ent.get("kind")
        for s in stage_cache.values()
        if s not in (None, False)
        for ent in s._device_cache.values()
    )


def _both(path, build):
    """(JAX result, JAX routes, port result, port routes): `build(ctx, col,
    F, lit)` returns the DataFrame; results sorted by k."""
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu_torch.ops import kernels as tk

    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    tk.clear_stage_cache()
    settings = {"ballista.tpu.layout_cache_dir": ""}
    jctx = JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"}))
    jctx.register_parquet("t", path)
    jout = build(jctx, jcol, JF, jlit).collect().sort_by("k")
    pctx = ExecutionContext(
        BallistaConfig({**settings, "ballista.executor.backend": "cuda"}), device="cpu"
    )
    pctx.register_parquet("t", path)
    pout = build(pctx, col, F, lit).collect().sort_by("k")
    return jout, _kinds(jk._stage_cache), pout, _kinds(tk._stage_cache)


def _assert_columns(jout, pout, exact, approx=()):
    assert pout.column_names == jout.column_names
    for name in exact:
        a = pout.column(name).to_numpy(zero_copy_only=False)
        b = jout.column(name).to_numpy(zero_copy_only=False)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64), err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name, rtol, atol in approx:
        np.testing.assert_allclose(
            pout.column(name).to_numpy(), jout.column(name).to_numpy(),
            rtol=rtol, atol=atol, err_msg=name,
        )


def test_highcard_groupby_matches_reference(tmp_path):
    """test_highcard.py:36: a filter and six aggregates over 3000 groups."""
    path = _write(tmp_path, _make_table(n=60_000, g=3000))

    def build(ctx, col, F, lit):
        return ctx.table("t").filter(col("f") > lit(0.25)).aggregate(
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

    jout, jroutes, pout, proutes = _both(path, build)
    assert proutes == jroutes == ["sorted"]
    _assert_columns(jout, pout, ["k", "c", "mn", "mx", "sw"],
                    [("sv", 1e-4, 2e-3), ("av", 1e-4, 1e-4)])


def test_highcard_uses_sorted_layout(tmp_path):
    """test_highcard.py:92: the sorted route runs, not a host decline."""
    from ballista_tpu_torch.ops import runtime

    path = _write(tmp_path, _make_table(n=50_000, g=3000))
    runtime.routing_stats(reset=True)
    jout, jroutes, pout, proutes = _both(
        path, lambda ctx, col, F, lit: ctx.table("t").aggregate(
            [col("k")], [F.sum(col("v")).alias("s")])
    )
    stats = runtime.routing_stats(reset=True)
    assert proutes == jroutes == ["sorted"]
    assert stats["routes"] == {"sorted": 1} and not stats["reasons"]
    assert pout.num_rows == 3000
    _assert_columns(jout, pout, ["k"], [("s", 1e-4, 2e-3)])


def test_skewed_groups_multi_chunk_fold(tmp_path):
    """test_highcard.py:162: one giant group among many small ones takes
    the host chunk fold, min/max included."""
    rng = np.random.default_rng(1)
    k = np.concatenate([np.zeros(40_000, np.int64), rng.integers(1, 2000, 10_000)])
    path = _write(tmp_path, pa.table({"k": k, "v": rng.uniform(-50, 50, len(k))}))

    def build(ctx, col, F, lit):
        return ctx.table("t").aggregate(
            [col("k")],
            [F.sum(col("v")).alias("s"), F.min(col("v")).alias("mn"),
             F.max(col("v")).alias("mx"), F.count(col("v")).alias("c")],
        )

    jout, jroutes, pout, proutes = _both(path, build)
    assert proutes == jroutes == ["sorted"]
    _assert_columns(jout, pout, ["k", "c", "mn", "mx"], [("s", 1e-4, 2e-3)])


def test_int_sum_overflow_declines_like_reference(tmp_path):
    """test_highcard.py:193: an int32 sum that could overflow declines to
    the host in both packages, and the answers stay exact."""
    rng = np.random.default_rng(2)
    n = 50_000
    path = _write(tmp_path, pa.table({
        "k": pa.array(rng.integers(0, 4, n), type=pa.int64()),
        "v": pa.array(rng.integers(16_000_000, 17_000_000, n), type=pa.int64()),
    }))
    jout, jroutes, pout, proutes = _both(
        path, lambda ctx, col, F, lit: ctx.table("t").aggregate(
            [col("k")], [F.sum(col("v")).alias("s")])
    )
    assert proutes == jroutes == []
    _assert_columns(jout, pout, ["k", "s"])


def test_int_sum_exact_on_device(tmp_path):
    """test_highcard.py:220: in-range integer sums stay exact on the
    device."""
    rng = np.random.default_rng(3)
    n = 60_000
    path = _write(tmp_path, pa.table({
        "k": pa.array(rng.integers(0, 8, n), type=pa.int64()),
        "v": pa.array(rng.integers(250, 300, n), type=pa.int64()),
    }))
    jout, jroutes, pout, proutes = _both(
        path, lambda ctx, col, F, lit: ctx.table("t").aggregate(
            [col("k")], [F.sum(col("v")).alias("s")])
    )
    assert proutes == jroutes == ["batches"]
    _assert_columns(jout, pout, ["k", "s"])


def test_sorted_int_sum_and_date_minmax_exact(tmp_path):
    """Integer sums over a high-cardinality layout accumulate in int32 per
    chunk (checked against L1) and fold in int64 on the host: exact, as in
    the reference."""
    rng = np.random.default_rng(6)
    k = np.concatenate([np.zeros(30_000, np.int64), rng.integers(1, 2500, 20_000)])
    path = _write(tmp_path, pa.table({
        "k": pa.array(k),
        "w": pa.array(rng.integers(-60_000, 60_000, len(k)), type=pa.int64()),
    }))
    jout, jroutes, pout, proutes = _both(
        path, lambda ctx, col, F, lit: ctx.table("t").aggregate(
            [col("k")], [F.sum(col("w")).alias("s"), F.min(col("w")).alias("mn"),
                         F.max(col("w")).alias("mx")])
    )
    assert proutes == jroutes == ["sorted"]
    _assert_columns(jout, pout, ["k", "s", "mn", "mx"])


# -- a JAX "sorted" entry run by the port's step ------------------------------
def _to_numpy(obj):
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_to_numpy(v) for v in obj)
    if hasattr(obj, "block_until_ready"):
        return np.asarray(obj)
    return obj


def _aggregate_node(plan):
    stack = [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashAggregateExec" and node.mode.value in ("partial", "single"):
            return node
        stack.extend(node.children())
    raise AssertionError("no partial/single aggregate in the plan")


def test_sorted_entry_from_reference(tmp_path):
    """prepared_from_reference carries the JAX stage's "sorted" entry
    (layout scalars, owner, clen, narrow tiles with their LUTs, key values)
    and the port's step over exactly those tiles gives the JAX stage's
    partial table."""
    from ballista_tpu.ops.stage import FusedAggregateStage as JaxStage
    from ballista_tpu.physical.plan import TaskContext as JaxTaskContext
    from ballista_tpu_torch.ops.stage import FusedAggregateStage
    from ballista_tpu_torch.ops.state import prepared_from_reference

    table = _make_table(n=40_000, g=2500, seed=8)
    # a decimal grid of 11 values: narrowed to uint8 codes plus an f32 LUT
    d = np.round(np.random.default_rng(9).uniform(0, 0.1, table.num_rows), 2)
    path = _write(tmp_path, table.append_column("d", pa.array(d)))

    def build(ctx, col, F, lit):
        return ctx.table("t").filter(col("f") > lit(0.3)).aggregate(
            [col("k")],
            [F.sum(col("v") * (lit(1) - col("d"))).alias("s"),
             F.count(col("v")).alias("c"),
             F.min(col("v")).alias("mn"), F.max(col("w")).alias("mx"),
             F.sum(col("w")).alias("sw")],
        )

    settings = {"ballista.tpu.layout_cache_dir": ""}
    jctx = JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"}))
    jctx.register_parquet("t", path)
    jstage = JaxStage(_aggregate_node(
        jctx.create_physical_plan(build(jctx, jcol, JF, jlit).logical_plan())
    ))
    jtable = jstage.run(0, JaxTaskContext(config=jctx.config))
    entry = _to_numpy(jstage._device_cache[0])
    assert entry["kind"] == "sorted"
    assert any(isinstance(v, tuple) for v in entry["cols"].values())  # a LUT pair

    pctx = ExecutionContext(BallistaConfig(settings), device="cpu")
    pctx.register_parquet("t", path)
    pstage = FusedAggregateStage(_aggregate_node(
        pctx.create_physical_plan(build(pctx, col, F, lit).logical_plan())
    ))
    carried = prepared_from_reference(entry, CPU)
    assert carried["layout"].V == entry["layout"].V
    ptable = pstage.execute_prepared(carried, CPU)
    assert ptable.schema == jtable.schema
    jt, pt = jtable.sort_by("k"), ptable.sort_by("k")
    names = pt.column_names
    exact = ["k"] + [n for n in names if n.startswith(("c", "mn", "mx", "sw"))]
    _assert_columns(jt, pt, exact,
                    [(n, 1e-4, 2e-3) for n in names if n not in exact])


def test_sorted_entry_with_derived_tiles_is_refused():
    """Derived tiles (a fact-aggregate stage's per-row extra columns) are
    carried only on the layout's [V, L1] grid; any other shape is refused."""
    from ballista_tpu_torch.ops.state import prepared_from_reference

    codes, g = _codes("uniform")
    with pytest.raises(ValueError):
        prepared_from_reference(
            {"kind": "sorted", "layout": JaxLayout(codes, g), "cols": {},
             "clen": None, "key_values": [], "n_groups": g,
             "derived": {"x": np.zeros(1)}},
            CPU,
        )
