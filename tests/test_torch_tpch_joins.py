"""TPC-H aggregates over joins end to end: the JAX package ("tpu" backend,
CPU JAX) against the port ("cuda" backend on CPU tensors, device="cpu") at
SF 0.01 (benchmarks/tpch/datagen, 2 files per table). Each query takes the
same stage type and mode in both packages, the port records no host route,
and the answers agree.

Routes (the JAX package's own ladder, ballista_tpu/ops/kernels.py:324-361):
q3, q5 and q18 build a FactAggregateStage (top-k, secondary and select
mode; q18's inner aggregate is a fused "sorted" stage over lineitem); q4,
q7, q10, q12 and q14 build a FusedAggregateStage over a MappedScanExec, q10
with its fused top-k. q2, q8, q9, q11 and q19 run on the card in
chip_smoke.py; q2 and q11 take 35-56 s on CPU JAX here.

Tolerances (tests/test_mappedscan.py:258): non-float columns equal, floats
within rtol 1e-3.
"""

import pathlib

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETTINGS = {"ballista.tpu.layout_cache_dir": ""}

MAPPED_BATCHES = [("MappedScanExec", ("batches",), False)]
EXPECTED = {
    "q3": [("fact", "topk")],
    "q5": [("fact", "secondary")],
    "q18": [("ParquetScanExec", ("sorted",), False), ("fact", "select")],
    "q10": [("MappedScanExec", ("sorted",), True)],
    "q7": [("MappedScanExec", ("sorted",), False)],
    "q4": MAPPED_BATCHES,
    "q12": MAPPED_BATCHES,
    "q14": MAPPED_BATCHES,
}


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_joins")
    generate(str(d), sf=0.01, parts=2, seed=20261016)
    return str(d)


def _stages(cache):
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


@pytest.mark.parametrize("name", sorted(EXPECTED, key=lambda q: int(q[1:])))
def test_tpch_join_query_matches_reference(tpch_dir, name):
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr
    from ballista_tpu_torch.ops.factagg import FactAggregateStage

    sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    jk._stage_latest.clear()
    jr.reset_residency()
    tk.clear_stage_cache()
    jctx = JaxContext(JaxConfig({**SETTINGS, "ballista.executor.backend": "tpu"}))
    register_all(jctx, tpch_dir)
    jout = jctx.sql(sql).collect()

    pctx = ExecutionContext(BallistaConfig(SETTINGS), device="cpu")
    register_all(pctx, tpch_dir)
    tr.routing_stats(reset=True)
    tr.readback_stats(reset=True)
    pout = pctx.sql(sql).collect()
    routing = tr.routing_stats(reset=True)
    reads = tr.readback_stats(reset=True)

    assert _stages(tk._stage_cache) == _stages(jk._stage_cache) == EXPECTED[name]
    assert "host" not in routing["routes"] and not routing["reasons"], routing
    mapped = any(s[0] == "MappedScanExec" for s in EXPECTED[name])
    assert routing["events"].get("mapped_rewrite", 0) == int(mapped)
    if name == "q10":
        # the fused top-k reads back exactly k = 20 rows
        assert reads == {**reads, "readbacks": 1, "rows": 20}
    if name == "q3":
        (fact,) = [s for s in tk._stage_cache.values() if isinstance(s, FactAggregateStage)]
        n_groups = fact._prepared[0]["n_groups"]
        assert reads["readbacks"] == 1
        assert reads["rows"] == fact.pool_size(n_groups) < n_groups

    assert pout.column_names == jout.column_names
    assert pout.num_rows == jout.num_rows
    for col, f in zip(jout.column_names, jout.schema):
        j, p = jout.column(col).to_pylist(), pout.column(col).to_pylist()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(p, dtype=float), np.array(j, dtype=float),
                                       rtol=1e-3, err_msg=col)
        else:
            assert p == j, col
