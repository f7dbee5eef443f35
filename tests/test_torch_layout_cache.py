"""The port's persisted layout cache (ballista_tpu_torch/ops/layout_cache.py)
against the JAX package's (tests/test_layout_cache.py), on the same seeded
Parquet data with one settings dict for both packages: the JAX package
stores under ballista.tpu.layout_cache_dir, the port under its sibling
`<dir>_torch`.

A new process is simulated by dropping the stage cache and the residency
ledger. A warm start must prepare nothing (ingest_stats()["prepares"] 0),
decode no Parquet, and give answers bit-equal to the cold run. Against the
JAX package: keys and counts equal, float min/max bit-equal (both go
through the floatbits bijection), f32 sums within rtol 1e-4 / atol 2e-3
(tests/test_highcard.py's tolerance; the summation orders differ).
"""

import datetime
import decimal
import json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.ops import kernels, runtime
from ballista_tpu_torch.ops import layout_cache as lc

# a test that names no store persists nothing (the JAX package's conftest
# does the same for its own default)
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""

RTOL, ATOL = 1e-4, 2e-3


def reset_port():
    """A fresh process for the port: no stage, no reservation."""
    kernels.clear_stage_cache()
    runtime.reset_residency()


def reset_jax():
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops.runtime import release_stage_residency, reset_residency

    for stage in jk._stage_cache.values():
        if stage not in (None, False):
            release_stage_residency(stage)
    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    jk._stage_latest.clear()
    reset_residency()


@pytest.fixture(autouse=True)
def _fresh():
    reset_port()
    reset_jax()
    runtime.ingest_stats(reset=True)
    yield
    reset_port()
    reset_jax()


def _settings(cache_dir, **extra):
    return {"ballista.tpu.layout_cache_dir": str(cache_dir), **extra}


def run_port(tables, sql, settings):
    ctx = ExecutionContext(BallistaConfig(settings), device="cpu")
    for name, path in tables.items():
        ctx.register_parquet(name, path)
    return ctx.sql(sql).collect()


def run_jax(tables, sql, settings):
    ctx = JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"}))
    for name, path in tables.items():
        ctx.register_parquet(name, path)
    return ctx.sql(sql).collect()


def assert_matches_reference(port: pa.Table, ref: pa.Table, exact=()):
    """Port answer against the JAX package's: non-float columns equal,
    columns in `exact` bit-equal, other floats within RTOL / ATOL."""
    assert port.column_names == ref.column_names
    assert port.num_rows == ref.num_rows
    for name, f in zip(ref.column_names, ref.schema):
        a = port.column(name).to_numpy(zero_copy_only=False)
        b = ref.column(name).to_numpy(zero_copy_only=False)
        if pa.types.is_floating(f.type) and name not in exact:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        elif a.dtype == object:
            assert list(a) == list(b), name
        else:
            assert a.tobytes() == b.tobytes(), name


def _make_table(n=60_000, g=3000, seed=0):
    """> 1024 groups: the sorted chunked-segment route; a string column
    exercises the dictionary snapshot."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, g, n), type=pa.int64()),
        "v": pa.array(rng.uniform(-100, 100, n).astype(np.float64)),
        "s": pa.array([f"tag{i}" for i in rng.integers(0, 7, n)], type=pa.string()),
    })


QUERY = ("select k, sum(v) as sv, count(v) as c, min(v) as mn, max(v) as mx "
         "from t where s <> 'tag3' group by k order by k")


def _no_decode(monkeypatch, only=None):
    """Fail any Parquet data decode (of files whose path holds `only`)."""
    real = pq.read_table

    def guard(path, *a, **kw):
        if only is None or only in str(path):
            raise AssertionError(f"parquet decode on a warm start: {path}")
        return real(path, *a, **kw)

    monkeypatch.setattr(pq, "read_table", guard)


def test_warm_start_prepares_nothing(tmp_path, monkeypatch):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_make_table(), path)
    settings = _settings(tmp_path / "layouts")
    ref = run_jax({"t": path}, QUERY, settings)
    cold = run_port({"t": path}, QUERY, settings)
    assert runtime.ingest_stats(reset=True)["prepares"] == 1
    assert lc.entry_count(str(tmp_path / "layouts_torch")) >= 1
    reset_port()
    _no_decode(monkeypatch)
    warm = run_port({"t": path}, QUERY, settings)
    monkeypatch.undo()
    assert runtime.ingest_stats(reset=True)["prepares"] == 0
    assert warm.equals(cold)
    assert_matches_reference(warm, ref, exact=("mn", "mx"))


def test_rewritten_file_misses(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_make_table(seed=0), path)
    settings = _settings(tmp_path / "layouts")
    first = run_port({"t": path}, QUERY, settings)
    # new data, a later mtime: the key moves, the old entry must miss
    pq.write_table(_make_table(seed=1), path)
    os.utime(path, (time.time() + 5, time.time() + 5))
    reset_port()
    runtime.ingest_stats(reset=True)
    second = run_port({"t": path}, QUERY, settings)
    assert runtime.ingest_stats(reset=True)["prepares"] == 1
    assert not second.equals(first)
    ref = run_jax({"t": path}, QUERY, settings)
    assert_matches_reference(second, ref, exact=("mn", "mx"))


def test_disabled_dir_persists_nothing(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_make_table(), path)
    settings = _settings("")
    out = run_port({"t": path}, QUERY, settings)
    ref = run_jax({"t": path}, QUERY, settings)
    assert not list(tmp_path.rglob("meta.json"))
    assert sorted(os.listdir(tmp_path)) == ["t.parquet"]
    assert_matches_reference(out, ref, exact=("mn", "mx"))


@pytest.mark.parametrize("live,adopted", [
    (["a"], True),            # a prefix: adopts, codes extend
    (["b"], False),           # conflicts at position 0
    (["a", "b", "c", "d"], False),  # longer than the snapshot
    (None, True),             # no live dictionary
])
def test_dictionary_prefix_refusal(live, adopted):
    """adopt_dict_snapshot gives the JAX package's verdict on each case."""
    from ballista_tpu.ops import layout_cache as jlc
    from ballista_tpu.ops.runtime import ScanDictionaries as JaxDicts
    from ballista_tpu_torch.ops.runtime import ScanDictionaries

    verdicts = []
    for mod, Dicts in ((lc, ScanDictionaries), (jlc, JaxDicts)):
        src = Dicts()
        src.for_column(0).encode(pa.array(["a", "b", "c"]))
        meta, arrays = mod.pack_dict_snapshot(src)
        dst = Dicts()
        if live is not None:
            dst.for_column(0).encode(pa.array(live))
        ok = mod.adopt_dict_snapshot(dst, meta, arrays)
        verdicts.append(ok)
        if ok:
            assert dst.for_column(0).snapshot().to_pylist() == ["a", "b", "c"]
    assert verdicts == [adopted, adopted]


KEY_ARRAYS = [
    pa.array(["x", None, "z"]),
    pa.array(["x", "y", None], type=pa.large_string()),
    pa.array([datetime.date(1994, 1, 1), datetime.date(1995, 2, 2), None]),
    pa.array([1.5, 2.5, 3.5]),
    pa.array([1.5, None, -0.0], type=pa.float32()),
    pa.array([1, -2, None], type=pa.int64()),
    pa.array([1, 2, 3], type=pa.int32()),
    pa.array([True, None, False]),
    pa.array([decimal.Decimal("1.25"), None, decimal.Decimal("-3.50")],
             type=pa.decimal128(12, 2)),
    pa.array([0, 1, 2], type=pa.timestamp("us")),
    pa.DictionaryArray.from_arrays(pa.array([0, 1, 0], type=pa.int32()),
                                   pa.array(["p", "q"])),
]


@pytest.mark.parametrize("arr", KEY_ARRAYS, ids=lambda a: str(a.type))
def test_arrow_roundtrip_types(arr):
    """Group key values of every Arrow type survive the IPC packing, in both
    packages alike."""
    from ballista_tpu.ops import layout_cache as jlc

    out = lc.unpack_arrow_arrays(lc.pack_arrow_arrays([arr]))
    assert len(out) == 1 and out[0].equals(arr)
    assert jlc.unpack_arrow_arrays(jlc.pack_arrow_arrays([arr]))[0].equals(out[0])


def test_arrow_roundtrip_empty():
    assert lc.unpack_arrow_arrays(lc.pack_arrow_arrays([])) == []


FACT_QUERY = ("select fk, sum(amount) as rev, attr from dim, fact "
              "where dk = fk and flag = 1 group by fk, attr "
              "order by rev desc limit 15")


def _star(tmp_path):
    rng = np.random.default_rng(5)
    nf, nk = 20_000, 3000
    fact = pa.table({
        "fk": pa.array(rng.integers(0, nk, nf), type=pa.int64()),
        "amount": pa.array(np.round(rng.uniform(1, 500, nf), 2)),
        "flag": pa.array(rng.integers(0, 2, nf), type=pa.int64()),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(nk), type=pa.int64()),
        "attr": pa.array([f"grp-{i % 37}" for i in range(nk)]),
    })
    pq.write_table(fact, str(tmp_path / "fact.parquet"))
    pq.write_table(dim, str(tmp_path / "dim.parquet"))
    return {"fact": str(tmp_path / "fact.parquet"), "dim": str(tmp_path / "dim.parquet")}


def test_factagg_warm_start(tmp_path, monkeypatch):
    """The fact stage's inner prepare persists under the fact stage's keys:
    a warm start skips the fact side's decode and prepare and reproduces
    the cold answer (the top-k epilogue included)."""
    from ballista_tpu_torch.ops.factagg import FactAggregateStage

    tables = _star(tmp_path)
    settings = _settings(tmp_path / "layouts")
    ref = run_jax(tables, FACT_QUERY, settings)
    cold = run_port(tables, FACT_QUERY, settings)
    stages = [s for s in kernels._stage_cache.values() if isinstance(s, FactAggregateStage)]
    assert stages, "the fact stage did not run"
    assert stages[0].inner.persist_key == stages[0].persist_key is not None
    assert lc.entry_count(str(tmp_path / "layouts_torch")) >= 1
    reset_port()
    runtime.ingest_stats(reset=True)
    _no_decode(monkeypatch, only="fact")
    warm = run_port(tables, FACT_QUERY, settings)
    monkeypatch.undo()
    assert runtime.ingest_stats(reset=True)["prepares"] == 0
    assert warm.equals(cold)
    assert_matches_reference(warm, ref)


def test_disk_hit_pins_into_device_cache(tmp_path):
    """A disk-loaded entry pins like a fresh one: it sits in the stage's
    _device_cache and is reserved in the residency ledger."""
    from ballista_tpu_torch.ops.stage import FusedAggregateStage

    path = str(tmp_path / "t.parquet")
    pq.write_table(_make_table(), path)
    settings = _settings(tmp_path / "layouts")
    run_port({"t": path}, QUERY, settings)
    cold_bytes = runtime.resident_bytes()
    reset_port()
    assert runtime.resident_bytes() == 0
    run_port({"t": path}, QUERY, settings)
    stages = [s for s in kernels._stage_cache.values() if isinstance(s, FusedAggregateStage)]
    assert stages and stages[0]._device_cache[0]["kind"] == "sorted"
    assert runtime.resident_bytes() == cold_bytes > 0


BATCHES_QUERY = ("select g, sum(v) as sv, count(*) as c, sum(w) as sw from t "
                 "where v > -5 group by g order by g")


def _batches_table(n=80_000):
    rng = np.random.default_rng(4)
    return pa.table({
        "g": pa.array([f"grp{i % 5}" for i in rng.integers(0, 5, n)]),
        "v": pa.array(rng.uniform(-10, 10, n)),
        "w": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
    })


def test_batches_path_warm_start(tmp_path, monkeypatch):
    """Low-cardinality stages (the "batches" route, q1 / q6 shapes) persist
    per chunk of each Parquet file, in both packages."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(_batches_table(), path)
    settings = _settings(tmp_path / "layouts", **{"ballista.batch.size": "16384"})
    ref = run_jax({"t": path}, BATCHES_QUERY, settings)
    cold = run_port({"t": path}, BATCHES_QUERY, settings)
    kinds = {json.load(open(p)).get("kind")
             for p in (tmp_path / "layouts_torch").rglob("meta.json")}
    jkinds = {json.load(open(p)).get("kind")
              for p in (tmp_path / "layouts").rglob("meta.json")}
    assert kinds == jkinds == {"chunk"}
    reset_port()
    runtime.ingest_stats(reset=True)
    _no_decode(monkeypatch)
    warm = run_port({"t": path}, BATCHES_QUERY, settings)
    monkeypatch.undo()
    assert runtime.ingest_stats(reset=True)["prepares"] == 0
    assert warm.equals(cold)
    assert_matches_reference(warm, ref)


def test_store_is_a_sibling_that_jax_eviction_spares(tmp_path):
    """One settings dict for both packages: the JAX package stores under the
    configured base and the port under `<base>_torch`, never inside the
    base. A JAX save at a cap too small for any entry evicts every JAX
    entry and no port entry; the port still starts warm."""
    from ballista_tpu.ops import layout_cache as jlc

    path = str(tmp_path / "t.parquet")
    pq.write_table(_make_table(), path)
    base = tmp_path / "layouts"
    settings = _settings(base)
    assert lc.store_dir(BallistaConfig(settings)) == str(base) + "_torch"
    assert lc.store_dir(BallistaConfig(_settings(str(base) + "/"))) == str(base) + "_torch"
    run_jax({"t": path}, QUERY, settings)
    cold = run_port({"t": path}, QUERY, settings)
    port_store = str(tmp_path / "layouts_torch")
    n_port = lc.entry_count(port_store)
    assert n_port >= 1 and jlc._dir_bytes(str(base)) > 0
    # nothing of the port's inside the JAX base
    for meta in base.rglob("meta.json"):
        assert json.load(open(meta)).get("package") != lc._TAG
    blob = np.zeros(1000, dtype=np.uint8)
    jlc.save_entry(str(base), "evict-everything", 0, {"n_arrays": 1}, [blob],
                   cap_bytes=blob.nbytes + 16)
    assert len(list(base.rglob("meta.json"))) == 1  # only the new entry
    assert lc.entry_count(port_store) == n_port
    reset_port()
    runtime.ingest_stats(reset=True)
    assert run_port({"t": path}, QUERY, settings).equals(cold)
    assert runtime.ingest_stats(reset=True)["prepares"] == 0


def test_foreign_entry_is_a_miss(tmp_path):
    """An entry under the port's key whose manifest is not the port's (or
    of another format) loads as a miss, never as data."""
    base = str(tmp_path / "store")
    arrays = [np.arange(4, dtype=np.int32)]
    assert lc.save_entry(base, "k", 0, {"kind": "sorted", "n_arrays": 1}, arrays, 1 << 20)
    assert lc.load_entry(base, "k", 0) is not None
    meta_path = os.path.join(lc.cache_dir_for(base, "k", 0), "meta.json")
    for field, value in (("package", "ballista_tpu"), ("format", lc._FORMAT + 1)):
        meta = json.load(open(meta_path))
        good = meta[field]
        meta[field] = value
        json.dump(meta, open(meta_path, "w"))
        assert lc.load_entry(base, "k", 0) is None
        meta[field] = good
        json.dump(meta, open(meta_path, "w"))
    assert lc.load_entry(base, "k", 0) is not None


def test_entry_arrays_round_trip_and_a_short_file_misses(tmp_path):
    """Every dtype a stage persists (narrow ints, f32, bool, uint8 Arrow
    bytes, dictionary strings), 0-d and empty arrays come back equal,
    writable and aligned from the entry's one data file; a truncated data
    file loads as a miss."""
    base = str(tmp_path / "store")
    arrays = [np.arange(-3, 4, dtype=np.int8), np.arange(5, dtype=np.int16),
              np.arange(6, dtype=np.int32).reshape(2, 3),
              np.linspace(0, 1, 7, dtype=np.float32), np.array([True, False, True]),
              np.frombuffer(b"arrow ipc bytes", dtype=np.uint8),
              np.array(["A", "N", "R"]), np.array(["", "long value"]),
              np.zeros(0, dtype=np.int32), np.array(7, dtype=np.int64)]
    assert lc.save_entry(base, "k", 3, {"n_arrays": len(arrays)}, arrays, 1 << 20)
    meta, got = lc.load_entry(base, "k", 3)
    assert "arrays" not in meta and meta["n_arrays"] == len(arrays)
    for a, b in zip(arrays, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert b.flags.writeable and b.flags.aligned
    data = os.path.join(lc.cache_dir_for(base, "k", 3), "arrays.bin")
    with open(data, "r+b") as f:
        f.truncate(os.path.getsize(data) - 8)
    assert lc.load_entry(base, "k", 3) is None


def test_batch_size_gives_two_keys_and_two_stores(tmp_path):
    """The batch size folds into the stage key (append-only when it is not
    the default, as in the JAX package), so two batch sizes build two
    stages and persist two sets of entries."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(_batches_table(40_000), path)
    store = str(tmp_path / "layouts_torch")
    outs, counts = [], []
    for bs in (None, "8192"):
        extra = {} if bs is None else {"ballista.batch.size": bs}
        outs.append(run_port({"t": path}, BATCHES_QUERY,
                             _settings(tmp_path / "layouts", **extra)))
        counts.append(lc.entry_count(store))
    keys = [k for k, s in kernels._stage_cache.items() if s not in (None, False)]
    assert len(keys) == 2
    assert sum(",bs=8192" in k for k in keys) == 1
    assert not any(",bs=32768" in k for k in keys)
    # 40,000 rows: 2 chunks at the default 32,768, then 5 more at 8,192
    assert counts == [2, 7]
    for name in ("g", "c", "sw"):
        assert outs[0].column(name).equals(outs[1].column(name))
    np.testing.assert_allclose(outs[0].column("sv").to_numpy(),
                               outs[1].column("sv").to_numpy(), rtol=RTOL, atol=ATOL)


MAPPED_QUERY = ("select mode, sum(case when prio = 'p0' then 1 else 0 end) as c0, "
                "sum(amount) as s from dim, fact where dk = fk group by mode order by mode")


def test_mapped_scan_warm_start(tmp_path, monkeypatch):
    """A mapped-scan stage (a join tree rewritten to one fact scan with dim
    columns attached, ops/mappedscan.py) persists one whole-set "batches"
    entry, as in the JAX package: a warm start decodes neither the fact
    nor the dim side and prepares nothing."""
    from ballista_tpu_torch.ops.mappedscan import MappedScanExec

    rng = np.random.default_rng(7)
    n_fact, n_dim = 30_000, 800
    fact = pa.table({
        "fk": pa.array(rng.integers(0, n_dim + 50, n_fact), type=pa.int64()),
        "mode": pa.array([f"m{i % 5}" for i in range(n_fact)]),
        "amount": pa.array(rng.uniform(0, 100, n_fact)),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(n_dim), type=pa.int64()),
        "prio": pa.array([f"p{i % 3}" for i in range(n_dim)]),
    })
    tables = {"fact": str(tmp_path / "fact.parquet"), "dim": str(tmp_path / "dim.parquet")}
    pq.write_table(fact, tables["fact"])
    pq.write_table(dim, tables["dim"])
    settings = _settings(tmp_path / "layouts")
    ref = run_jax(tables, MAPPED_QUERY, settings)
    cold = run_port(tables, MAPPED_QUERY, settings)
    assert any(isinstance(getattr(s, "scan", None), MappedScanExec)
               for s in kernels._stage_cache.values())
    kinds = {json.load(open(p)).get("kind")
             for p in (tmp_path / "layouts_torch").rglob("meta.json")}
    jkinds = {json.load(open(p)).get("kind")
              for p in (tmp_path / "layouts").rglob("meta.json")}
    assert kinds == jkinds == {"batches"}
    reset_port()
    runtime.ingest_stats(reset=True)
    _no_decode(monkeypatch)

    def no_maps(self, ctx):
        raise AssertionError("dim maps built on a warm start")

    monkeypatch.setattr(MappedScanExec, "_build_maps", no_maps)
    warm = run_port(tables, MAPPED_QUERY, settings)
    monkeypatch.undo()
    assert runtime.ingest_stats(reset=True)["prepares"] == 0
    assert warm.equals(cold)
    assert_matches_reference(warm, ref)
