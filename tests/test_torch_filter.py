"""The per-operator device filter (ballista_tpu_torch/ops/kernels.py::
filter_batch, reached from FilterExec under
ballista.tpu.per_op_dispatch=true) against the JAX package's filter_batch
("tpu" backend, CPU JAX) and the port's "cpu" backend, on a table made with
numpy from a seed. A filter keeps rows, so answers must be equal, row order
included; each batch reads back its boolean mask once, as in the JAX
package.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""

N = 1000
SETTINGS = {"ballista.tpu.per_op_dispatch": "true"}
PREDICATES = [
    "x > 5 and s = 'b'",
    "s like 'a%' or f < 0.25",
    "d between date '1995-03-01' and date '1995-09-30'",
    "s in ('a1', 'c3', 'zz') and not (x = 7)",
    "s is null or x * 2 + 1 >= 31",
    "flag and f <> 0.5",
]


@pytest.fixture(autouse=True)
def _fresh():
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu_torch.ops import costmodel as tcm
    from ballista_tpu_torch.ops import kernels as tk

    tcm.reset(clear_dir=True)
    jk._filter_cache.clear()
    tk._filter_cache.clear()
    yield


def _table(with_null_numbers=False):
    rng = np.random.default_rng(31)
    strs = np.array(["a1", "b", "c3", "a22", "d"], dtype=object)[rng.integers(0, 5, N)]
    s = [None if m else v for v, m in zip(strs, rng.random(N) < 0.1)]
    x = rng.integers(0, 20, N).astype(np.int64)
    base = datetime.date(1995, 1, 1)
    t = {
        "x": pa.array([None if m else int(v) for v, m in zip(x, rng.random(N) < 0.05)]
                      if with_null_numbers else x, type=pa.int64()),
        "f": pa.array(np.round(rng.random(N), 2)),
        "s": pa.array(s, type=pa.string()),
        "d": pa.array([base + datetime.timedelta(days=int(v)) for v in rng.integers(0, 365, N)],
                      type=pa.date32()),
        "flag": pa.array(rng.random(N) < 0.5),
    }
    return pa.table(t)


def _run(table, where, settings):
    """{backend: (rows, readback stats)} for JAX "tpu", port "cuda" (CPU
    tensors) and port "cpu"."""
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import runtime as tr

    sql = f"select x, f, s, d, flag from t where {where}"
    out = {}
    for name, ctx, rt in (
        ("jax", JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"})), jr),
        ("port", ExecutionContext(BallistaConfig(settings), device="cpu"), tr),
        ("host", ExecutionContext(BallistaConfig({**settings, "ballista.executor.backend": "cpu"}),
                                  device="cpu"), tr),
    ):
        ctx.register_record_batches("t", table, n_partitions=2)
        rt.readback_stats(reset=True)
        out[name] = (ctx.sql(sql).collect().to_pylist(), rt.readback_stats(reset=True))
    return out


@pytest.mark.parametrize("where", PREDICATES)
def test_filter_batch_matches_reference(where):
    out = _run(_table(), where, SETTINGS)
    assert out["port"][0] == out["jax"][0] == out["host"][0]
    assert len(out["port"][0]) > 0
    # one mask readback per batch: 2 partitions of one batch, 1024 slots each
    assert out["port"][1] == out["jax"][1] == {"rows": 2 * 1024, "bytes": 2 * 1024,
                                               "readbacks": 2}
    assert out["host"][1]["readbacks"] == 0


def test_filter_stays_on_host_without_per_op_dispatch():
    out = _run(_table(), PREDICATES[0], {})
    assert out["port"][0] == out["jax"][0] == out["host"][0]
    assert out["port"][1]["readbacks"] == out["jax"][1]["readbacks"] == 0


def test_null_numeric_column_falls_back_per_batch():
    """A nullable numeric column cannot lower: each batch that holds a null
    filters on the host (a "filter:host" routing event), with the same
    answer as the JAX package and the host backend."""
    from ballista_tpu_torch.ops import runtime as tr

    tr.routing_stats(reset=True)
    out = _run(_table(with_null_numbers=True), "x > 5", SETTINGS)
    assert out["port"][0] == out["jax"][0] == out["host"][0]
    assert out["port"][1] == out["jax"][1]
    routing = tr.routing_stats(reset=True)
    assert routing["events"].get("filter:host", 0) >= 1
    assert routing["routes"] == {} and routing["reasons"] == {}


def test_filter_batch_direct():
    """filter_batch on one record batch: the kept rows equal pyarrow's
    filter; a non-boolean predicate is cached as a decline."""
    import torch

    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.physical import expr as px

    batch = _table().to_batches()[0]
    pred = px.BinaryPhysicalExpr(px.ColumnExpr("x", 0), "gt", px.LiteralExpr(10, pa.int64()))
    got = tk.filter_batch(batch, pred, torch.device("cpu"))
    import pyarrow.compute as pc

    assert got.to_pylist() == batch.filter(pc.greater(batch.column(0), 10)).to_pylist()
    arith = px.BinaryPhysicalExpr(px.ColumnExpr("x", 0), "plus", px.LiteralExpr(1, pa.int64()))
    assert tk.filter_batch(batch, arith, torch.device("cpu")) is None
    assert any(v is False for v in tk._filter_cache.values())


@pytest.mark.parametrize("where", ["1 = 1", "true"])
def test_constant_predicate(where):
    """A predicate without a column compiles to a 0-dim mask, which the
    port broadcasts over the batch. The JAX package's filter_batch indexes
    that 0-dim mask and raises IndexError (ROADMAP section 3)."""
    table = _table()
    sql = f"select x, s from t where {where}"
    port = ExecutionContext(BallistaConfig(SETTINGS), device="cpu")
    host = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}), device="cpu")
    jax = JaxContext(JaxConfig({**SETTINGS, "ballista.executor.backend": "tpu"}))
    for ctx in (port, host, jax):
        ctx.register_record_batches("t", table, n_partitions=2)
    assert port.sql(sql).collect().to_pylist() == host.sql(sql).collect().to_pylist()
    assert port.sql(sql).collect().num_rows == N
    with pytest.raises(IndexError):
        jax.sql(sql).collect()
