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

Device joins run in both packages' dim sides (ballista.tpu.device_join,
on by default): each query records the same join paths and reasons
(runtime.join_path_stats) and reads back the same totals, join readbacks
included. The stage's own readback rules (q10: exactly k = 20 rows, q3: the
candidate pool) are held with device joins off, where the stage's step is
the only readback.

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

import ballista_tpu_torch.config as _port_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETTINGS = {"ballista.tpu.layout_cache_dir": ""}
# the port's cost store stays in memory (the JAX package's is pinned by
# tests/conftest.py) and is dropped per test
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""


@pytest.fixture(autouse=True)
def _fresh_port_cost_store():
    from ballista_tpu_torch.ops import costmodel

    costmodel.reset(clear_dir=True)
    yield

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


def _run_both(tpch_dir, name, settings, monkeypatch):
    """(JAX result, port result, JAX readbacks, port readbacks, JAX join
    paths, port join paths, port routing) for one query, every cache and
    counter emptied first. Each readbacks dict holds the totals and, under
    "joins", the join module's share (the JAX package's counted by wrapping
    the readback its join module calls)."""
    from benchmarks.tpch.datagen import register_all

    from ballista_tpu.ops import join as jj
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr
    from ballista_tpu_torch.utils import counters

    jjoin_reads = {"rows": 0, "bytes": 0, "readbacks": 0}

    def counted(x, rows=None):
        arr = jr.readback(x, rows)
        jjoin_reads["rows"] += int(rows if rows is not None else arr.shape[-1])
        jjoin_reads["bytes"] += int(arr.nbytes)
        jjoin_reads["readbacks"] += 1
        return arr

    monkeypatch.setattr(jj, "readback", counted)

    sql = (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()
    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    jk._stage_latest.clear()
    jr.reset_residency()
    tk.clear_stage_cache()
    jctx = JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"}))
    register_all(jctx, tpch_dir)
    jr.readback_stats(reset=True)
    jr.join_path_stats(reset=True)
    jout = jctx.sql(sql).collect()
    jreads = {**jr.readback_stats(reset=True), "joins": jjoin_reads}
    jjoins = jr.join_path_stats(reset=True)

    pctx = ExecutionContext(BallistaConfig(settings), device="cpu")
    register_all(pctx, tpch_dir)
    tr.routing_stats(reset=True)
    tr.readback_stats(reset=True)
    tr.join_path_stats(reset=True)
    pout = pctx.sql(sql).collect()
    # the join module's share: its readbacks carry the site "join"
    reads = counters.readback.stats(reset=True)
    keys = ("rows", "bytes", "readbacks")
    preads = {**{k: reads[k] for k in keys},
              "joins": {k: reads.get(f"join.{k}", 0) for k in keys}}
    return (jout, pout, jreads, preads, jjoins,
            tr.join_path_stats(reset=True), tr.routing_stats(reset=True))


def _assert_same_answer(jout, pout):
    assert pout.column_names == jout.column_names
    assert pout.num_rows == jout.num_rows
    for col, f in zip(jout.column_names, jout.schema):
        j, p = jout.column(col).to_pylist(), pout.column(col).to_pylist()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(p, dtype=float), np.array(j, dtype=float),
                                       rtol=1e-3, err_msg=col)
        else:
            assert p == j, col


@pytest.mark.parametrize("name", sorted(EXPECTED, key=lambda q: int(q[1:])))
def test_tpch_join_query_matches_reference(tpch_dir, name, monkeypatch):
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu_torch.ops import kernels as tk

    jout, pout, jreads, preads, jjoins, pjoins, routing = _run_both(
        tpch_dir, name, SETTINGS, monkeypatch)

    assert _stages(tk._stage_cache) == _stages(jk._stage_cache) == EXPECTED[name]
    assert "host" not in routing["routes"] and not routing["reasons"], routing
    mapped = any(s[0] == "MappedScanExec" for s in EXPECTED[name])
    assert routing["events"].get("mapped_rewrite", 0) == int(mapped)
    # the same device joins with the same declines, reading back the same
    # counts planes and gathers
    assert pjoins == jjoins
    assert all(path == "device" or any(r.startswith(path + ": ") for r in pjoins["reasons"])
               for path in pjoins["paths"]), pjoins
    assert preads["joins"] == jreads["joins"]
    assert preads["readbacks"] >= preads["joins"]["readbacks"]
    _assert_same_answer(jout, pout)


@pytest.mark.parametrize("name", ["q3", "q10"])
def test_tpch_join_stage_readback_rule(tpch_dir, name, monkeypatch):
    """With device joins off the stage's step is the only readback: q10's
    fused top-k reads back exactly k = 20 rows, q3's fact top-k its
    candidate pool, fewer than its groups."""
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops.factagg import FactAggregateStage

    settings = {**SETTINGS, "ballista.tpu.device_join": "false"}
    jout, pout, jreads, reads, jjoins, pjoins, routing = _run_both(
        tpch_dir, name, settings, monkeypatch)
    assert pjoins == jjoins == {"paths": {}, "reasons": {}}
    assert "host" not in routing["routes"] and not routing["reasons"], routing
    if name == "q10":
        assert (reads["readbacks"], reads["rows"]) == (1, 20)
    else:
        (fact,) = [s for s in tk._stage_cache.values() if isinstance(s, FactAggregateStage)]
        n_groups = fact._prepared[0]["n_groups"]
        assert reads["readbacks"] == 1
        assert reads["rows"] == fact.pool_size(n_groups) < n_groups
    assert reads["joins"] == jreads["joins"] == {"rows": 0, "bytes": 0, "readbacks": 0}
    assert (reads["readbacks"], reads["rows"]) == (jreads["readbacks"], jreads["rows"])
    _assert_same_answer(jout, pout)
