"""The port's distributed path: scheduler, two executors, wire serde and the
Flight shuffle of ballista_tpu_torch's StandaloneCluster (device="cpu"),
held against the TPC-H oracles and against the JAX package's cluster.

One TPC-H dataset per module (benchmarks/tpch/datagen, SF 0.005, 2 files
per table, seed 20261017), one cluster per package per module, each shut
down in a finally. Both cost stores are in memory and emptied, and both
stage caches cleared, before each query.

- All 22 queries through the port's cluster match benchmarks/tpch/oracles
  (rows and columns equal; floats within rtol 1e-4 / atol 2e-3: the
  "cuda" backend sums in f32).
- q1, q3, q6, q12, q13 and q18 through both clusters ("tpu" backend in the
  JAX package, "cuda" in the port): keys and counts equal, f32 within
  rtol 1e-4 / atol 2e-3, the same device stages and stage routes, and the
  same join paths and reasons.
- Under ballista.tpu.sorted_kernel=pallas, q18's inner aggregate takes
  "pallas_sorted" in both packages' executors.
"""

import logging
import pathlib

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.client import BallistaContext as JaxClient
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.executor.runtime import StandaloneCluster as JaxCluster
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.executor.runtime import StandaloneCluster

ROOT = pathlib.Path(__file__).resolve().parent.parent
TABLES = ["lineitem", "orders", "customer", "supplier", "nation", "region",
          "part", "partsupp"]
# the scheduler's result cache would answer a repeated query without running
# a stage, so it is off: every query here runs its stages
SETTINGS = {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": "",
            "ballista.cache.results": "false"}
PARITY_QUERIES = ["q1", "q3", "q6", "q12", "q13", "q18"]
Q18_INNER = (
    "select l_orderkey, sum(l_quantity) as sum_qty from lineitem "
    "group by l_orderkey having sum(l_quantity) > 300"
)
PALLAS = {"ballista.tpu.sorted_kernel": "pallas"}
RTOL, ATOL = 1e-4, 2e-3

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
logging.getLogger("ballista").setLevel(logging.CRITICAL)


def _sql(name: str) -> str:
    return (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_dist")
    generate(str(d), sf=0.005, parts=2, seed=20261017)
    return str(d)


@pytest.fixture(scope="module")
def port_cluster():
    cluster = StandaloneCluster(n_executors=2, config=BallistaConfig(SETTINGS),
                                device="cpu")
    try:
        yield cluster
    finally:
        cluster.shutdown()


@pytest.fixture(scope="module")
def jax_cluster():
    cluster = JaxCluster(n_executors=2, config=JaxConfig(SETTINGS))
    try:
        yield cluster
    finally:
        cluster.shutdown()


@pytest.fixture(autouse=True)
def _fresh_state():
    from ballista_tpu.ops import costmodel as jcm
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import costmodel as tcm
    from ballista_tpu_torch.ops import kernels as tk

    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)
    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    jk._stage_latest.clear()
    jr.reset_residency()
    tk.clear_stage_cache()
    yield


def _port_client(cluster, tpch_dir, extra=None):
    from benchmarks.tpch.datagen import register_all

    ctx = BallistaContext(*cluster.scheduler_addr, settings={**SETTINGS, **(extra or {})},
                          device="cpu")
    register_all(ctx, tpch_dir)
    return ctx


def _jax_client(cluster, tpch_dir, extra=None):
    from benchmarks.tpch.datagen import register_all

    ctx = JaxClient(*cluster.scheduler_addr, settings={
        **SETTINGS, "ballista.executor.backend": "tpu", **(extra or {})})
    register_all(ctx, tpch_dir)
    return ctx


def _stages(cache):
    """Sorted descriptions of a stage cache's built stages: the stage type,
    its scan and the routes (device entry kinds) its runs took."""
    out = []
    for s in cache.values():
        if s in (None, False):
            continue
        if type(s).__name__ == "FactAggregateStage":
            mode = ("secondary" if s.secondary is not None
                    else "topk" if s.topk is not None else "select")
            out.append(("fact", mode))
        else:
            kinds = tuple(sorted({e.get("kind") for e in s._device_cache.values()}))
            out.append((type(s.scan).__name__, kinds, s.topk is not None))
    return sorted(out)


def _assert_frames_close(got: pd.DataFrame, want: pd.DataFrame, label: str) -> None:
    assert list(got.columns) == list(want.columns), label
    assert len(got) == len(want), (label, len(got), len(want))
    if not len(want):
        return
    floats = [c for c in want.columns if pd.api.types.is_float_dtype(want[c])]
    # a total order: exact columns first, floats only to break their ties
    key = [c for c in want.columns if c not in floats] + floats
    g = got.sort_values(key).reset_index(drop=True)
    w = want.sort_values(key).reset_index(drop=True)
    for c in want.columns:
        if c in floats:
            np.testing.assert_allclose(
                g[c].to_numpy().astype(float), w[c].to_numpy().astype(float),
                rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=f"{label}.{c}")
        else:
            assert g[c].tolist() == w[c].tolist(), f"{label}.{c}"


def _assert_tables_close(got: pa.Table, want: pa.Table, label: str) -> None:
    assert got.column_names == want.column_names, label
    assert got.num_rows == want.num_rows, label
    for c, f in zip(want.column_names, want.schema):
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(g, dtype=float), np.array(w, dtype=float),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{label}.{c}")
        else:
            assert g == w, f"{label}.{c}"


@pytest.fixture(scope="module")
def oracle_tables(tpch_dir):
    import pyarrow.parquet as pq

    return {t: pq.read_table(str(pathlib.Path(tpch_dir) / t)).to_pandas() for t in TABLES}


@pytest.mark.parametrize("name", [f"q{i}" for i in range(1, 23)])
def test_query_through_port_cluster_matches_oracle(port_cluster, tpch_dir, oracle_tables, name):
    from benchmarks.tpch.oracles import ORACLES

    ctx = _port_client(port_cluster, tpch_dir)
    try:
        got = ctx.sql(_sql(name)).collect().to_pandas()
    finally:
        ctx.close()
    _assert_frames_close(got, ORACLES[name](oracle_tables), name)


@pytest.mark.parametrize("name", PARITY_QUERIES)
def test_cluster_matches_reference_cluster(port_cluster, jax_cluster, tpch_dir, name):
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr

    jctx = _jax_client(jax_cluster, tpch_dir)
    try:
        jr.join_path_stats(reset=True)
        jout = jctx.sql(_sql(name)).collect()
        jpaths = jr.join_path_stats(reset=True)
    finally:
        jctx.close()
    pctx = _port_client(port_cluster, tpch_dir)
    try:
        tr.join_path_stats(reset=True)
        tr.routing_stats(reset=True)
        pout = pctx.sql(_sql(name)).collect()
        ppaths = tr.join_path_stats(reset=True)
        routes = tr.routing_stats(reset=True)["routes"]
    finally:
        pctx.close()

    _assert_tables_close(pout, jout, name)
    stages = _stages(tk._stage_cache)
    assert stages == _stages(jk._stage_cache)
    # the routes the port counted are the routes its stages' entries took
    kinds = {k for s in stages if s[0] != "fact" for k in s[1]}
    assert kinds <= set(routes), (kinds, routes)
    assert ppaths == jpaths


def test_pallas_sorted_route_in_both_clusters(port_cluster, jax_cluster, tpch_dir):
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr

    jctx = _jax_client(jax_cluster, tpch_dir, PALLAS)
    try:
        jout = jctx.sql(Q18_INNER).collect()
    finally:
        jctx.close()
    pctx = _port_client(port_cluster, tpch_dir, PALLAS)
    try:
        tr.routing_stats(reset=True)
        pout = pctx.sql(Q18_INNER).collect()
        routes = tr.routing_stats(reset=True)["routes"]
    finally:
        pctx.close()
    # one PARTIAL stage run per scan partition, every one on the kernel route
    assert routes == {"pallas_sorted": 2}, routes
    for cache in (tk._stage_cache, jk._stage_cache):
        assert _stages(cache) == [("ParquetScanExec", ("pallas_sorted",), False)]
    _assert_tables_close(pout.sort_by("l_orderkey"), jout.sort_by("l_orderkey"), "q18_inner")
