"""The fourteen TPC-H queries that tests/test_torch_tpch_joins.py does not
hold, end to end: the JAX package ("tpu" backend, CPU JAX) against the port
("cuda" backend on CPU tensors, device="cpu") at SF 0.002
(benchmarks/tpch/datagen, 2 files per table, seed 20261016). Each query
must give the same answer (non-float columns equal, floats within rtol
1e-3, as tests/test_torch_tpch_joins.py), build the same device stages and
record the same join paths and reasons (runtime.join_path_stats; the
join-free queries record none in both). At this size q11 and q20 return
no rows; they prove the join paths here and their answers in chip_smoke.py
at SF 1. Both cost stores are in memory and emptied before each query.
"""

import pathlib

import numpy as np
import pyarrow as pa
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETTINGS = {"ballista.tpu.layout_cache_dir": ""}
QUERIES = ["q1", "q2", "q6", "q8", "q9", "q11", "q13", "q15", "q16", "q17",
           "q19", "q20", "q21", "q22"]

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""


@pytest.fixture(autouse=True)
def _fresh_cost_stores():
    from ballista_tpu.ops import costmodel as jcm
    from ballista_tpu_torch.ops import costmodel as tcm

    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)
    yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_all")
    generate(str(d), sf=0.002, parts=2, seed=20261016)
    return str(d)


def _stages(cache):
    """Sorted descriptions of a stage cache's built stages."""
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


@pytest.mark.parametrize("name", QUERIES)
def test_tpch_query_matches_reference(tpch_dir, name):
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr

    sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    jk._stage_latest.clear()
    jr.reset_residency()
    tk.clear_stage_cache()
    jctx = JaxContext(JaxConfig({**SETTINGS, "ballista.executor.backend": "tpu"}))
    register_all(jctx, tpch_dir)
    jr.join_path_stats(reset=True)
    jout = jctx.sql(sql).collect()
    jpaths = jr.join_path_stats(reset=True)

    pctx = ExecutionContext(BallistaConfig(SETTINGS), device="cpu")
    register_all(pctx, tpch_dir)
    tr.join_path_stats(reset=True)
    tr.routing_stats(reset=True)
    pout = pctx.sql(sql).collect()
    ppaths = tr.join_path_stats(reset=True)
    routing = tr.routing_stats(reset=True)

    assert _stages(tk._stage_cache) == _stages(jk._stage_cache)
    assert ppaths == jpaths
    # every path but "device" says why the join left the device
    for path in ppaths["paths"]:
        assert path == "device" or any(r.startswith(path + ": ") for r in ppaths["reasons"])
    # join declines stay out of the stage routes
    assert not any(r.startswith("empty join side") for r in routing["reasons"])

    assert pout.column_names == jout.column_names
    assert pout.num_rows == jout.num_rows
    for col, f in zip(jout.column_names, jout.schema):
        j, p = jout.column(col).to_pylist(), pout.column(col).to_pylist()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(p, dtype=float), np.array(j, dtype=float),
                                       rtol=1e-3, err_msg=col)
        else:
            assert p == j, col
