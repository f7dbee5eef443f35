"""The port's differential sweep, single-process generators: the
counterpart of tests/test_fuzz_device.py's local generators, with the same
data and query generators (imported from that file, so the rng streams
1000+ / 5000+ / 9000+, 2000+, 12000+ / 13000+, 8000+ and 18000+ / 19000+
stay byte-identical) and the same seed ranges.

Every seed holds each query two ways:
- the port's "cuda" backend (on device="cpu", where every kernel wrapper
  runs its plain version) against the port's "cpu" (Arrow host) backend,
  with the reference's _compare tolerance: integers and strings exact,
  floats rtol 1e-3 / atol 1e-3, NaN equal to NaN;
- the port's "cpu" answer against the JAX package's "cpu" backend over the
  same Parquet files or tables: bit-equal (both are the same host
  operators).

Seed 0 of each generator is also held against the JAX package's "tpu"
backend (CPU JAX), with the same tolerance, except the aggregate-over-join
generator, whose seed-0 program takes 87-91 s of XLA compile on a CPU: it
is held to "tpu" at seed 2 (the same star join grouped by a fact column,
six groups, a few seconds to compile).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.ops import costmodel
from ballista_tpu_torch.ops import kernels as port_kernels
from test_fuzz_device import (
    _compare,
    _dup_key_build,
    _extrema_floats,
    _random_query,
    _random_table,
)
from test_torch_layout_cache import reset_jax, reset_port

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""

# the JAX "tpu" leg writes no AOT export (answers do not depend on it)
JAX_TPU = {"ballista.executor.backend": "tpu", "ballista.tpu.aot_cache": ""}
JOIN_TPU_SEED = 2


@pytest.fixture(autouse=True)
def _fresh():
    reset_port()
    reset_jax()
    costmodel.reset(clear_dir=True)
    yield
    reset_port()
    reset_jax()
    costmodel.reset(clear_dir=True)


def _contexts(with_tpu: bool):
    """name -> context: the port's two backends, the JAX package's host
    backend and, where asked, its device backend."""
    out = {
        "port_cuda": ExecutionContext(
            BallistaConfig({"ballista.executor.backend": "cuda"}), device="cpu"),
        "port_cpu": ExecutionContext(
            BallistaConfig({"ballista.executor.backend": "cpu"}), device="cpu"),
        "jax_cpu": JaxContext(JaxConfig({"ballista.executor.backend": "cpu"})),
    }
    if with_tpu:
        out["jax_tpu"] = JaxContext(JaxConfig(JAX_TPU))
    return out


def _hold(outs: dict, sql: str) -> None:
    """The sweep's two comparisons, plus the JAX device leg when present."""
    _compare(outs["port_cuda"], outs["port_cpu"], sql)
    assert outs["port_cpu"].equals(outs["jax_cpu"]), sql
    if "jax_tpu" in outs:
        _compare(outs["port_cuda"], outs["jax_tpu"], sql)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_aggregates(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    table = _random_table(rng, int(rng.integers(1_000, 40_000)))
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path)
    ctxs = _contexts(seed == 0)
    for ctx in ctxs.values():
        ctx.register_parquet("t", path)
    erng = np.random.default_rng(5000 + seed)
    nrng = np.random.default_rng(9000 + seed)
    for _ in range(4):
        sql = _random_query(rng, erng, nrng)
        _hold({k: c.sql(sql).collect() for k, c in ctxs.items()}, sql)


_JOIN_AGGS = [("sum(v)", False), ("count(*)", True), ("sum(q)", True),
              ("avg(v)", False), ("sum(v * q)", False),
              ("sum(case when attr <> 'g1' then v else 0 end)", False),
              ("sum(w)", True), ("min(q)", True), ("max(q)", True)]


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_aggregate_over_join(tmp_path, seed):
    """Random star joins through the fact-stage / mapped-scan ladder (the
    reference generator's draws, in its order)."""
    rng = np.random.default_rng(2000 + seed)
    nk = int(rng.integers(50, 2000))
    nf = int(rng.integers(2_000, 30_000))
    missing = int(rng.integers(0, nk // 4 + 1))
    fact = pa.table({
        "fk": pa.array(rng.integers(0, nk + missing, nf), type=pa.int64()),
        "v": pa.array(np.round(rng.uniform(0, 500, nf), 2)),
        "q": pa.array(rng.integers(1, 50, nf), type=pa.int64()),
        "m": pa.array([f"m{x}" for x in rng.integers(0, 6, nf)]),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(nk), type=pa.int64()),
        "attr": pa.array([f"g{i % rng.integers(2, 40)}" for i in range(nk)]),
        "w": pa.array(rng.integers(0, 10, nk), type=pa.int64()),
    })
    pq.write_table(fact, str(tmp_path / "fact.parquet"))
    pq.write_table(dim, str(tmp_path / "dim.parquet"))
    ctxs = _contexts(seed == JOIN_TPU_SEED)
    for ctx in ctxs.values():
        ctx.register_parquet("fact", str(tmp_path / "fact.parquet"))
        ctx.register_parquet("dim", str(tmp_path / "dim.parquet"))
    group = rng.choice(["fk", "attr", "m", "fk, attr", "attr, m"])
    picks = list(rng.choice(len(_JOIN_AGGS), size=rng.integers(1, 4),
                            replace=False))
    sel = ", ".join([group] + [f"{_JOIN_AGGS[p][0]} as a{i}"
                               for i, p in enumerate(picks)])
    sql = f"select {sel} from dim, fact where dk = fk"
    if rng.random() < 0.6:
        sql += " and " + str(rng.choice(
            ["v > 100", "q < 25", "m <> 'm3'", "w > 2"]))
    sql += f" group by {group}"
    exact = [f"a{i}" for i, p in enumerate(picks) if _JOIN_AGGS[p][1]]
    if exact and rng.random() < 0.5:
        rank = f"{rng.choice(exact)}{' desc' if rng.random() < 0.5 else ''}"
        sql += f" order by {rank}, {group} limit {rng.integers(1, 40)}"
    else:
        sql += f" order by {group}"
    _hold({k: c.sql(sql).collect() for k, c in ctxs.items()}, sql)


def _join_tables(build: pa.Table, probe: pa.Table, how: str, ctxs: dict) -> dict:
    out = {}
    for name, ctx in ctxs.items():
        ctx.register_record_batches("b", build, n_partitions=1)
        ctx.register_record_batches("p", probe, n_partitions=1)
        out[name] = ctx.table("b").join(
            ctx.table("p"), ["bk"], ["pk"], how=how).collect()
    return out


def _dup_key_tables(rng, prng, with_strings: bool, max_probe: int):
    shape = str(rng.choice(["zipf", "all_dup", "monster", "uniform"]))
    bkeys = _dup_key_build(rng, shape)
    nb = len(bkeys)
    bnull = rng.random(nb) < 0.05
    cols = {
        "bk": pa.array([None if isnull else int(v)
                        for v, isnull in zip(bkeys, bnull)], type=pa.int64()),
        "bv": pa.array(np.round(rng.uniform(-100, 100, nb), 3)),
    }
    if with_strings:
        cols["bs"] = pa.array([f"b{v % 11}" for v in range(nb)])
    np_rows = int(prng.integers(500, max_probe))
    pkeys = prng.integers(-1, int(bkeys.max()) + 20, np_rows)
    probe = pa.table({
        "pk": pa.array([None if v < 0 else int(v) for v in pkeys],
                       type=pa.int64()),
        "pv": pa.array(np.round(prng.uniform(0, 50, np_rows), 3)),
    })
    return shape, pa.table(cols), probe, nb, np_rows


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_duplicate_key_joins(seed):
    """The M:N device join (INNER) and the host LEFT join: bit-equal to the
    host backends, multiplicity, order and null padding included."""
    rng = np.random.default_rng(12000 + seed)
    prng = np.random.default_rng(13000 + seed)
    shape, build, probe, _nb, _np = _dup_key_tables(rng, prng, True, 8000)
    how = str(rng.choice(["inner", "left"]))
    out = _join_tables(build, probe, how, _contexts(seed == 0))
    rows = out["port_cpu"].to_pylist()
    for name, got in out.items():
        assert got.schema == out["port_cpu"].schema, (shape, how, name)
        assert got.to_pylist() == rows, (shape, how, name)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_float_extrema_minmax(tmp_path, seed):
    """MIN/MAX over NaN / ±0 / subnormal / negative-heavy doubles: bit-exact
    modulo the documented ±0 collapse (the device path through floatbits,
    the host fallback where NaN forces the decline)."""
    rng = np.random.default_rng(8000 + seed)
    n = int(rng.integers(5_000, 30_000))
    fx = _extrema_floats(rng, n)
    table = pa.table({
        "g": pa.array(rng.integers(0, 2000, n), type=pa.int64()),
        "fx": pa.array(fx),
        "q": pa.array(rng.integers(1, 50, n), type=pa.int64()),
    })
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path)
    ctxs = _contexts(seed == 0)
    for ctx in ctxs.values():
        ctx.register_parquet("t", path)
    queries = [
        "select min(fx) as mn, max(fx) as mx from t",
        "select g, min(fx) as mn, max(fx) as mx from t group by g order by g",
        ("select g, min(fx) as mn, count(*) as c from t where q < 40 "
         "group by g order by mn, g limit 25"),
    ]
    for sql in queries:
        outs = {k: c.sql(sql).collect().to_pydict() for k, c in ctxs.items()}
        ref = outs.pop("port_cpu")
        for name, got in outs.items():
            assert set(got) == set(ref), (sql, name)
            for col in got:
                for a, b in zip(got[col], ref[col]):
                    if isinstance(a, float) and isinstance(b, float):
                        assert (a == b == 0.0) or (
                            np.float64(a).tobytes() == np.float64(b).tobytes()
                        ), (sql, name, col, a, b)
                    else:
                        assert a == b, (sql, name, col, a, b)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_routing(tmp_path, seed):
    """The duplicate-key join sweep under the port's cost model forced
    cold, warm (reloaded from its store), off, and fed seeded adversarial
    rates: routing may differ, answers must not."""
    rng = np.random.default_rng(18000 + seed)
    prng = np.random.default_rng(19000 + seed)
    shape, build, probe, nb, np_rows = _dup_key_tables(rng, prng, False, 6000)

    def run(model: str, store_dir: str) -> list:
        ctx = ExecutionContext(BallistaConfig({
            "ballista.executor.backend": "cuda",
            "ballista.tpu.cost_model": model,
            "ballista.tpu.cost_model_dir": store_dir,
        }), device="cpu")
        return _join_tables(build, probe, "inner", {"c": ctx})["c"].to_pylist()

    store = str(tmp_path / "costs")
    hosts = _join_tables(build, probe, "inner", {
        k: c for k, c in _contexts(seed == 0).items() if k != "port_cuda"})
    baseline = hosts.pop("port_cpu").to_pylist()
    for name, got in hosts.items():
        assert got.to_pylist() == baseline, (shape, seed, name)
    out_off = run("false", "")
    out_cold = run("true", store)
    costmodel.flush()
    costmodel.reset()  # a fresh process: reload from disk
    out_warm = run("true", store)
    fast, slow = (1e-12, 100.0)
    if prng.random() < 0.5:
        fast, slow = slow, fast
    for tier in port_kernels.JOIN_EXTENDED_TIERS:
        costmodel.seed("join.gather", 4096 * tier, fast)
    costmodel.seed("join.gather", 4096, fast)
    costmodel.seed("join.host", nb + np_rows, slow, engine="host")
    assert costmodel.snapshot(), "adversarial seeds must be installed"
    out_adv = run("true", store)
    assert costmodel.snapshot(), "seeds were wiped before the run"
    assert baseline == out_off == out_cold == out_warm == out_adv, (shape, seed)
