"""Resident layouts shared across filter constants (ops/stage.py's layout
registry, ops/runtime.py's SharedEntry).

A query with fresh parameters resolves a new stage (the stage cache keys on
the plan display, which holds the literals), but its staged partitions are
a function of the files alone: the filters run on the device at every run.
Such a stage binds the partitions another stage of the same layout
identity prepared, and prepares nothing (ingest_stats()["prepares"] 0,
["reused"] one per partition). Every answer is held to the port's host path
(backend "cpu") on TPC-H at SF 0.01, 2 files per table.

- q1, q6, q3 (fact stage) and q5 (fact stage with the secondary dim's
  derived column) at a second parameter set bind every partition;
- q12 (a mapped scan: host-filtered batches) still prepares;
- a string literal the adopted dictionary lacks matches no row;
- a rewritten file (new mtime) re-prepares and answers the new data;
- under a tight ballista.tpu.hbm_budget_bytes the shared bytes count once,
  an eviction drops them from every binder, and the next stage re-prepares;
- one stage's permanent decline leaves another stage's binding intact;
- through StandaloneCluster(n_executors=2) a second fresh-parameter q1
  prepares nothing on either executor.
"""

import logging
import os
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.ops import kernels, runtime
from ballista_tpu_torch.ops.stage import FusedAggregateStage

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
logging.getLogger("ballista").setLevel(logging.CRITICAL)

RTOL, ATOL = 1e-4, 2e-3

Q1 = """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    avg(l_discount) as avg_disc, count(*) as count_order
from lineitem where l_shipdate <= date '{DATE}'
group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""
Q6 = """select sum(l_extendedprice * l_discount) as revenue from lineitem
where l_shipdate >= date '{DATE}' and l_shipdate < date '{DATE}' + interval '1' year
    and l_discount between {LO} and {HI} and l_quantity < {QTY}"""
Q3 = """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{SEGMENT}' and c_custkey = o_custkey and l_orderkey = o_orderkey
    and o_orderdate < date '{DATE}' and l_shipdate > date '{DATE}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10"""
Q5 = """select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey and l_suppkey = s_suppkey
    and c_nationkey = s_nationkey and s_nationkey = n_nationkey
    and n_regionkey = r_regionkey and r_name = '{REGION}'
    and o_orderdate >= date '{DATE}' and o_orderdate < date '{DATE}' + interval '1' year
group by n_name order by revenue desc"""
Q12 = """select l_shipmode, sum(case when o_orderpriority = '1-URGENT'
        or o_orderpriority = '2-HIGH' then 1 else 0 end) as high_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('{M1}', '{M2}')
    and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
    and l_receiptdate >= date '{DATE}' and l_receiptdate < date '{DATE}' + interval '1' year
group by l_shipmode order by l_shipmode"""

# (template, first parameters, second parameters, the route a run records)
SHARED = {
    "q1": (Q1, {"DATE": "1998-09-02"}, {"DATE": "1998-08-11"}, "batches"),
    "q6": (Q6, {"DATE": "1994-01-01", "LO": "0.05", "HI": "0.07", "QTY": 24},
           {"DATE": "1996-01-01", "LO": "0.02", "HI": "0.04", "QTY": 25}, "batches"),
    "q3": (Q3, {"SEGMENT": "BUILDING", "DATE": "1995-03-15"},
           {"SEGMENT": "MACHINERY", "DATE": "1995-03-22"}, "fact_topk"),
    "q5": (Q5, {"REGION": "ASIA", "DATE": "1994-01-01"},
           {"REGION": "EUROPE", "DATE": "1995-01-01"}, "fact_secondary"),
}


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_share")
    generate(str(d), sf=0.01, parts=2, seed=20261019)
    return str(d)


@pytest.fixture(autouse=True)
def _fresh():
    kernels.clear_stage_cache()
    runtime.reset_residency()
    runtime.ingest_stats(reset=True)
    runtime.routing_stats(reset=True)
    yield
    kernels.clear_stage_cache()
    runtime.reset_residency()


def _ctx(tables, backend="cuda", **settings):
    ctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": backend,
                                           **settings}), device="cpu")
    for name, path in tables.items():
        ctx.register_parquet(name, path)
    return ctx


def _tpch(tpch_dir, backend="cuda", **settings):
    from benchmarks.tpch.datagen import register_all

    ctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": backend,
                                           **settings}), device="cpu")
    register_all(ctx, tpch_dir)
    return ctx


def _assert_same(got: pa.Table, want: pa.Table, label: str) -> None:
    """Rows equal as sets: exact columns equal, floats within the "cuda"
    backend's f32 tolerance."""
    g, w = got.to_pandas(), want.to_pandas()
    assert list(g.columns) == list(w.columns), label
    assert len(g) == len(w), (label, len(g), len(w))
    if not len(w):
        return
    floats = [c for c in w.columns if pd.api.types.is_float_dtype(w[c])]
    key = [c for c in w.columns if c not in floats] + floats
    g = g.sort_values(key).reset_index(drop=True)
    w = w.sort_values(key).reset_index(drop=True)
    for c in w.columns:
        if c in floats:
            np.testing.assert_allclose(g[c].to_numpy(float), w[c].to_numpy(float),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{label}.{c}")
        else:
            assert g[c].tolist() == w[c].tolist(), f"{label}.{c}"


def _run(ctx, host, sql, label):
    """One query on the device and on the host path, compared; returns the
    (ingest, routes) counters of the device run."""
    runtime.ingest_stats(reset=True)
    runtime.routing_stats(reset=True)
    out = ctx.sql(sql).collect()
    ingest = runtime.ingest_stats(reset=True)
    routes = runtime.routing_stats(reset=True)["routes"]
    _assert_same(out, host.sql(sql).collect(), label)
    return ingest, routes


@pytest.mark.parametrize("name", sorted(SHARED))
def test_second_parameter_set_binds_every_partition(tpch_dir, name):
    tmpl, first, second, route = SHARED[name]
    ctx, host = _tpch(tpch_dir), _tpch(tpch_dir, "cpu")
    ingest, routes = _run(ctx, host, tmpl.format(**first), f"{name} first")
    partitions = routes.get(route, 0)
    assert partitions >= 1 and "host" not in routes, routes
    assert ingest["prepares"] == partitions and ingest["reused"] == 0
    ingest, routes = _run(ctx, host, tmpl.format(**second), f"{name} second")
    assert routes.get(route) == partitions, routes
    assert ingest["prepares"] == 0
    assert ingest["reused"] == partitions
    assert ingest["wall_s"] == 0.0


def test_mapped_scan_with_a_new_literal_still_prepares(tpch_dir):
    ctx, host = _tpch(tpch_dir), _tpch(tpch_dir, "cpu")
    _run(ctx, host, Q12.format(M1="MAIL", M2="SHIP", DATE="1994-01-01"), "q12 first")
    ingest, routes = _run(ctx, host, Q12.format(M1="AIR", M2="RAIL", DATE="1995-01-01"),
                          "q12 second")
    assert "host" not in routes and sum(routes.values()) >= 1, routes
    assert ingest["reused"] == 0
    assert ingest["prepares"] >= 1


def test_absent_string_literal_matches_no_row(tpch_dir):
    """The second stage adopts the first's dictionary; 'ZEPPELIN' is not in
    it, so it gets a code past every staged one and matches nothing, as on
    the host. A third stage binds after it, with a literal the data has."""
    sql = ("select l_shipmode, count(*) as n, sum(l_quantity) as q from lineitem "
           "where l_shipmode in ('{A}', '{B}') and l_shipdate < date '{D}' "
           "group by l_shipmode")
    ctx, host = _tpch(tpch_dir), _tpch(tpch_dir, "cpu")
    ingest, _ = _run(ctx, host, sql.format(A="MAIL", B="SHIP", D="1997-01-01"), "first")
    assert ingest["prepares"] >= 1
    ingest, _ = _run(ctx, host, sql.format(A="ZEPPELIN", B="BALLOON", D="1996-01-01"),
                     "absent")
    assert ingest["prepares"] == 0 and ingest["reused"] >= 1
    assert ctx.sql(sql.format(A="ZEPPELIN", B="BALLOON", D="1996-01-01")).collect().num_rows == 0
    ingest, _ = _run(ctx, host, sql.format(A="RAIL", B="ZEPPELIN", D="1995-06-01"), "third")
    assert ingest["prepares"] == 0 and ingest["reused"] >= 1


def _write(path, seed, n=20_000, groups=40):
    r = np.random.default_rng(seed)
    pq.write_table(pa.table({
        "k": pa.array(r.integers(0, groups, n), type=pa.int64()),
        "x": pa.array(r.integers(0, 1000, n), type=pa.int64()),
        "v": pa.array(r.uniform(-10, 10, n)),
    }), path)


QUERY = "select k, count(*) as n, sum(v) as s from t where x < {X} group by k"


def test_rewritten_file_reprepares_and_answers_new_data(tmp_path):
    path = str(tmp_path / "t.parquet")
    _write(path, seed=1)
    ctx, host = _ctx({"t": path}), _ctx({"t": path}, "cpu")
    first, _ = _run(ctx, host, QUERY.format(X=500), "first")
    assert first["prepares"] == 1
    second, _ = _run(ctx, host, QUERY.format(X=400), "second")
    assert (second["prepares"], second["reused"]) == (0, 1)
    # new data, a later mtime: the layout identity moves
    _write(path, seed=2)
    os.utime(path, (time.time() + 5, time.time() + 5))
    ctx, host = _ctx({"t": path}), _ctx({"t": path}, "cpu")
    third, _ = _run(ctx, host, QUERY.format(X=300), "rewritten")
    assert (third["prepares"], third["reused"]) == (1, 0)
    fourth, _ = _run(ctx, host, QUERY.format(X=500), "rewritten, old literal")
    assert (fourth["prepares"], fourth["reused"]) == (0, 1)


def _stages_over(table):
    return [s for s in kernels._stage_cache.values()
            if isinstance(s, FusedAggregateStage) and table in s.scan.fmt()]


def test_eviction_releases_shared_bytes_once(tmp_path):
    """Two stages over table a share one pin; table b's stage under a
    budget for the larger plus half the smaller evicts it from both, and a
    third stage over a re-prepares and answers correctly."""
    tables = {}
    for name, seed in (("ta", 3), ("tb", 4)):
        tables[name] = str(tmp_path / f"{name}.parquet")
        _write(tables[name], seed)
    q = "select k, count(*) as n, sum(v) as s from {T} where x < {X} group by k"
    host = _ctx(tables, "cpu")
    sizes = {}
    for name in tables:
        kernels.clear_stage_cache()
        runtime.reset_residency()
        _ctx(tables).sql(q.format(T=name, X=700)).collect()
        sizes[name] = runtime.resident_bytes()
    kernels.clear_stage_cache()
    runtime.reset_residency()
    budget = max(sizes.values()) + min(sizes.values()) // 2
    ctx = _ctx(tables, **{"ballista.tpu.hbm_budget_bytes": str(budget)})
    _run(ctx, host, q.format(T="ta", X=700), "a1")
    ingest, _ = _run(ctx, host, q.format(T="ta", X=600), "a2")
    assert (ingest["prepares"], ingest["reused"]) == (0, 1)
    binders = _stages_over("ta")
    assert len(binders) == 2 and all(0 in s._device_cache for s in binders)
    assert binders[0]._device_cache[0] is binders[1]._device_cache[0]
    assert runtime.resident_bytes() == sizes["ta"]  # counted once
    runtime.residency_stats(reset=True)
    _run(ctx, host, q.format(T="tb", X=700), "b")
    assert runtime.residency_stats(reset=True)["evictions"] == 1
    assert all(0 not in s._device_cache for s in binders)
    assert runtime.resident_bytes() == sizes["tb"]
    ingest, _ = _run(ctx, host, q.format(T="ta", X=500), "a3")
    assert (ingest["prepares"], ingest["reused"]) == (1, 0)
    assert runtime.resident_bytes() <= budget


def test_decline_of_one_binder_leaves_the_other_bound(tmp_path, monkeypatch):
    """The dispatcher releases a permanently declined stage; the entry it
    bound stays pinned for the stage that prepared it, and a later stage
    still binds it."""
    path = str(tmp_path / "t.parquet")
    _write(path, seed=5)
    ctx, host = _ctx({"t": path}), _ctx({"t": path}, "cpu")
    _run(ctx, host, QUERY.format(X=500), "a")
    (first,) = _stages_over("t.parquet")
    nbytes = runtime.resident_bytes()
    real = FusedAggregateStage.execute_prepared
    armed = {"on": True}

    def failing(self, prepared, device):
        if armed["on"]:
            armed["on"] = False
            raise runtime.UnsupportedOnDevice("planted decline")
        return real(self, prepared, device)

    monkeypatch.setattr(FusedAggregateStage, "execute_prepared", failing)
    ingest, routes = _run(ctx, host, QUERY.format(X=400), "declined")
    assert ingest["reused"] == 1 and routes.get("host") == 1
    assert runtime.resident_bytes() == nbytes
    assert 0 in first._device_cache
    ingest, routes = _run(ctx, host, QUERY.format(X=500), "a again")
    assert (ingest["prepares"], ingest["reused"]) == (0, 0) and "host" not in routes
    ingest, _ = _run(ctx, host, QUERY.format(X=300), "c")
    assert (ingest["prepares"], ingest["reused"]) == (0, 1)
    assert runtime.resident_bytes() == nbytes


def test_cluster_second_fresh_q1_prepares_nothing(tpch_dir):
    from benchmarks.tpch.datagen import register_all
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.executor.runtime import StandaloneCluster

    settings = {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": "",
                "ballista.cache.results": "false"}
    host = _tpch(tpch_dir, "cpu")
    cluster = StandaloneCluster(n_executors=2, config=BallistaConfig(settings),
                                device="cpu")
    try:
        client = BallistaContext(*cluster.scheduler_addr, settings=settings, device="cpu")
        register_all(client, tpch_dir)
        first, routes = _run(client, host, Q1.format(DATE="1998-09-02"), "cluster first")
        partitions = routes.get("batches", 0)
        assert partitions == 2 and first["prepares"] == 2, (routes, first)
        second, routes = _run(client, host, Q1.format(DATE="1998-07-20"), "cluster second")
        assert routes.get("batches") == 2
        assert (second["prepares"], second["reused"]) == (0, 2)
    finally:
        cluster.shutdown()
