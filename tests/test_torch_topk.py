"""The port's fused Sort+Limit epilogue (ballista_tpu_torch/ops/stage.py::
_run_topk) against the JAX package's (ballista_tpu/ops/stage.py::_run_topk)
on the same data: the eleven cases of tests/test_topk_epilogue.py, each run
through the JAX "tpu" backend (CPU JAX) and the port's "cuda" backend on CPU
tensors, plus the top-k query chip_smoke.py drives, at TPC-H SF 0.01.

Tolerances: keys, counts, integer sums and float min/max bit-equal (both
packages rank the same exact int32 lanes); f32 sums and averages within
rtol 1e-4 / atol 2e-3 (different summation order). Each case also holds the
port's readback rows to the JAX package's: exactly k where fusion is live,
k plus the full readback where the boundary-tie probe falls back.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext


def _fresh():
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr

    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    jk._stage_latest.clear()
    jr.reset_residency()
    jr.readback_stats(reset=True)
    tk.clear_stage_cache()
    tr.readback_stats(reset=True)
    tr.routing_stats(reset=True)


def _run(tmp_path, table, sql, name="t"):
    """(JAX result, JAX readback stats, port result, port readback stats)."""
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import runtime as tr

    path = str(tmp_path / f"{name}.parquet")
    pq.write_table(table, path)
    _fresh()
    jctx = JaxContext(JaxConfig({"ballista.executor.backend": "tpu"}))
    jctx.register_parquet(name, path)
    jout = jctx.sql(sql).collect()
    jrb = jr.readback_stats(reset=True)
    pctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cuda"}),
                            device="cpu")
    pctx.register_parquet(name, path)
    pout = pctx.sql(sql).collect()
    prb = tr.readback_stats(reset=True)
    return jout, jrb, pout, prb


def _assert_same(jout, pout, approx=()):
    """Row for row: exact except the f32 columns named in `approx`; float
    columns compare by their f64 bits (-0.0 == +0.0 by the floatbits
    collapse)."""
    assert pout.column_names == jout.column_names
    jd, pd = jout.to_pydict(), pout.to_pydict()
    for c in jout.column_names:
        if c in approx:
            np.testing.assert_allclose(pd[c], jd[c], rtol=1e-4, atol=2e-3, err_msg=c)
        elif pa.types.is_floating(jout.schema.field(c).type):
            for a, b in zip(pd[c], jd[c]):
                assert (a == b == 0.0) or (
                    np.float64(a).tobytes() == np.float64(b).tobytes()
                ), (c, a, b)
            assert len(pd[c]) == len(jd[c]), c
        else:
            assert pd[c] == jd[c], c


def _table(n=30_000, n_groups=2500, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table(
        {
            "g": pa.array(rng.integers(0, n_groups, n), type=pa.int64()),
            "v": pa.array(np.round(rng.uniform(-100, 100, n), 2)),
            "q": pa.array(rng.integers(1, 50, n), type=pa.int64()),
        }
    )


def _skewed_table(seed=17, n_small=3000, monster=2049):
    rng = np.random.default_rng(seed)
    g = np.concatenate([np.arange(n_small), np.full(monster, n_small)])
    return pa.table(
        {
            "g": pa.array(g, type=pa.int64()),
            "v": pa.array(rng.uniform(-1e9, 1e9, len(g))
                          + rng.uniform(0, 1e-6, len(g))),
            "q": pa.array(rng.integers(1, 50, len(g)), type=pa.int64()),
        }
    )


def test_fused_topk_reads_back_limit_rows(tmp_path):
    sql = ("select g, sum(q) s, min(v) mn from t group by g "
           "order by s desc, g limit 11")
    jout, jrb, pout, prb = _run(tmp_path, _table(), sql)
    _assert_same(jout, pout)
    assert jrb["rows"] == prb["rows"] == 11
    assert prb["readbacks"] == 1


def test_fused_topk_ascending_and_float_score(tmp_path):
    sql = "select g, sum(v) rev from t group by g order by rev limit 9"
    jout, jrb, pout, prb = _run(tmp_path, _table(seed=3), sql)
    _assert_same(jout, pout, approx=("rev",))
    assert jrb["rows"] == prb["rows"] == 9
    # fusion off (a computed sort key defeats the annotation): the port's
    # full readback through the host Sort picks the same groups
    _, _, unfused, urb = _run(
        tmp_path, _table(seed=3),
        "select g, sum(v) rev from t group by g order by rev + 0 limit 9",
    )
    assert unfused.to_pydict()["g"] == pout.to_pydict()["g"]
    assert urb["rows"] > 9


def test_multi_key_lexicographic(tmp_path):
    rng = np.random.default_rng(5)
    n = 20_000
    t = pa.table(
        {
            "g": pa.array(rng.integers(0, 700, n), type=pa.int64()),
            "a": pa.array(rng.integers(0, 3, n), type=pa.int64()),
            "b": pa.array(rng.integers(1, 100, n), type=pa.int64()),
            "v": pa.array(np.round(rng.uniform(0, 10, n), 2)),
        }
    )
    sql = ("select g, sum(a) sa, min(b) mb from t group by g "
           "order by sa desc, mb, g limit 13")
    jout, jrb, pout, prb = _run(tmp_path, t, sql)
    _assert_same(jout, pout)
    assert prb["rows"] == jrb["rows"]


def test_boundary_tie_falls_back_to_host_order(tmp_path):
    rows_g, rows_q = [], []
    for g in range(40):
        rows_g.extend([g] * 4)
        rows_q.extend([g // 2, 0, 0, 0])
    t = pa.table({"g": pa.array(rows_g, type=pa.int64()),
                  "q": pa.array(rows_q, type=pa.int64())})
    sql = ("select g, sum(q) s from t group by g "
           "order by s desc, g desc limit 3")
    jout, jrb, pout, prb = _run(tmp_path, t, sql)
    _assert_same(jout, pout)
    assert pout.to_pydict()["g"] == [39, 38, 37]
    # the probe's readback, then the full readback of all 40 groups
    assert prb["rows"] == jrb["rows"] == 3 + 40
    assert prb["readbacks"] == jrb["readbacks"] == 2


def test_ineligible_key_kind_runs_unfused(tmp_path):
    sql = "select g, avg(q) a from t group by g order by a desc, g limit 5"
    jout, jrb, pout, prb = _run(tmp_path, _table(seed=7), sql)
    assert pout.to_pydict()["g"] == jout.to_pydict()["g"]
    np.testing.assert_allclose(pout.to_pydict()["a"], jout.to_pydict()["a"],
                               rtol=1e-4)
    assert prb["rows"] == jrb["rows"] > 5  # full readback of every chunk


def test_limit_wider_than_groups_runs_unfused(tmp_path):
    sql = "select g, sum(q) s from t group by g order by s desc, g limit 50"
    jout, jrb, pout, prb = _run(tmp_path, _table(n=2000, n_groups=8, seed=9), sql)
    _assert_same(jout, pout)
    assert pout.num_rows == 8
    assert prb["rows"] == jrb["rows"]


def test_topk_cover_and_skew_plan_match_reference():
    from ballista_tpu.ops import stage as jstage
    from ballista_tpu_torch.ops import stage as tstage

    assert tstage.TOPK_MAX_L1 == jstage.TOPK_MAX_L1
    assert tstage.SKEW_MAX_DOMINANT == jstage.SKEW_MAX_DOMINANT
    rng = np.random.default_rng(11)
    even = np.sort(rng.integers(0, 64, 100_000).astype(np.int64))
    skew = np.zeros(tstage.TOPK_MAX_L1 + 1, dtype=np.int64)
    mixed = np.sort(np.concatenate([np.arange(3), np.full(4097, 3)]))
    big = np.sort(np.concatenate(
        [np.arange(4000), np.full(tstage.TOPK_MAX_L1, 4000)]
    ).astype(np.int64))
    monster = _skewed_table().column("g").to_numpy().astype(np.int64)
    cases = [(even, 64), (skew, 1), (mixed, 4), (big, 4001), (monster, 3001)]
    for codes, g in cases:
        assert tstage._topk_cover_L1(codes, g) == jstage._topk_cover_L1(codes, g)
        assert tstage.skew_split_plan(codes, g) == jstage.skew_split_plan(codes, g)
    assert tstage._topk_cover_L1(even, 64) is not None
    assert tstage._topk_cover_L1(skew, 1) is None
    assert tstage._topk_cover_L1(big, 4001) is None
    assert tstage.skew_split_plan(monster, 3001) is not None


def test_exact_float_minmax_epilogue_composes(tmp_path):
    rng = np.random.default_rng(13)
    n = 25_000
    v = rng.uniform(-1e9, 1e9, n) + rng.uniform(0, 1e-6, n)
    v[::173] = -0.0
    t = pa.table({"g": pa.array(rng.integers(0, 900, n), type=pa.int64()),
                  "v": pa.array(v)})
    sql = ("select g, min(v) mn, max(v) mx from t group by g "
           "order by mn, g limit 17")
    jout, jrb, pout, prb = _run(tmp_path, t, sql)
    _assert_same(jout, pout)
    assert prb["rows"] == jrb["rows"] == 17


def test_skewed_cover_folds_in_program(tmp_path):
    from ballista_tpu_torch.ops import runtime as tr

    sql = ("select g, min(v) mn, max(v) mx, count(*) c from t group by g "
           "order by mn, g limit 15")
    jout, jrb, pout, prb = _run(tmp_path, _skewed_table(), sql)
    _assert_same(jout, pout)
    assert prb["rows"] == jrb["rows"] == 15
    # the cover failed on the monster group: the skew re-plan split it off
    assert tr.routing_stats()["events"].get("skew_replan") == 1


def test_skewed_int_sum_keeps_full_readback(tmp_path):
    sql = "select g, sum(q) s from t group by g order by s desc, g limit 6"
    jout, jrb, pout, prb = _run(tmp_path, _skewed_table(seed=19), sql)
    _assert_same(jout, pout)
    assert prb["rows"] == jrb["rows"] > 6  # fusion declined, not wrong


def test_too_many_key_lanes_runs_unfused(tmp_path):
    rng = np.random.default_rng(23)
    n = 8000
    cols = {"g": pa.array(rng.integers(0, 24, n), type=pa.int64())}
    for i in range(4):
        cols[f"v{i}"] = pa.array(rng.uniform(-1e9, 1e9, n))
    aggs = ", ".join(f"min(v{i}) m{i}" for i in range(4))
    order = ", ".join(f"m{i}" for i in range(4))  # 4 x f64 = 8 lanes > 6
    sql = f"select g, {aggs} from t group by g order by {order}, g limit 5"
    jout, jrb, pout, prb = _run(tmp_path, pa.table(cols), sql)
    _assert_same(jout, pout)
    # the spec declined: both read every group back ("batches" route; the
    # port reads int and float rows in two transfers, the reference in one)
    assert jrb["rows"] > 5 and prb["rows"] > 5


def test_lineitem_revenue_topk_reads_back_k(tmp_path):
    """chip_smoke.py's single-table top-k query at SF 0.01: a SINGLE
    aggregate (coalesced), the "sorted" route, 10 rows read back."""
    from benchmarks.tpch.datagen import generate, register_all
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr

    sql = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue "
           "from lineitem group by l_orderkey order by revenue desc limit 10")
    generate(str(tmp_path), sf=0.01, parts=2, seed=20261016)
    _fresh()
    jctx = JaxContext(JaxConfig({"ballista.executor.backend": "tpu"}))
    register_all(jctx, str(tmp_path))
    jout = jctx.sql(sql).collect()
    pctx = ExecutionContext(BallistaConfig({}), device="cpu")
    register_all(pctx, str(tmp_path))
    plan = pctx.create_physical_plan(pctx.sql(sql).logical_plan())
    aggs, stack = [], [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashAggregateExec":
            aggs.append(node)
        stack.extend(node.children())
    assert [a.mode.value for a in aggs] == ["single"]
    assert aggs[0]._topk_pushdown["k"] == 10
    pout = pctx.sql(sql).collect()
    rb = tr.readback_stats(reset=True)
    routes = tr.routing_stats(reset=True)
    assert routes["routes"] == {"sorted": 1}
    assert rb["rows"] == 10
    kinds = [e["kind"] for s in tk._stage_cache.values() if s not in (None, False)
             for e in s._device_cache.values()]
    assert kinds == ["sorted"]
    _assert_same(jout, pout, approx=("revenue",))


@pytest.fixture(autouse=True)
def _clean_caches():
    yield
    _fresh()
