"""The port's chunk-set delta store against the JAX package's
(tests/test_delta_chunks.py): a Parquet "batches" stage persists one entry
per (path, mtime, size, chunk index) beneath the mtime-free chunk key base,
so a query over files + {new} re-prepares only the new file's chunks.

Both packages run on the same seeded files with one settings dict (the JAX
package stores under the configured directory, the port under its `_torch`
sibling), and their runtime.delta_stats() must be equal after every step:
"chunks_reused", "chunks_prepared", "bytes_reprepared_saved" (host bytes of
the reused chunks; both packages stage the same narrow numpy arrays) and
"save_declined_midappend". The port's answers are bit-equal to its own cold
runs; against the JAX package, groups, counts and integer sums and minima
are equal (the answers' tolerance in tests/test_torch_layout_cache.py).
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu.ops import runtime as jr
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.ops import runtime as tr

from test_torch_layout_cache import reset_jax, reset_port

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""


@pytest.fixture(autouse=True)
def _fresh():
    reset_port()
    reset_jax()
    tr.delta_stats(reset=True)
    jr.delta_stats(reset=True)
    yield
    reset_port()
    reset_jax()
    tr.delta_stats(reset=True)
    jr.delta_stats(reset=True)


def _settings(cache_dir):
    # several chunks per file, so per-chunk addressing is real
    return {"ballista.tpu.layout_cache_dir": str(cache_dir),
            "ballista.batch.size": "4096"}


def _part(seed, n=10_000):
    """Low-cardinality shape: the "batches" (chunked) route."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "g": pa.array([f"grp{i}" for i in rng.integers(0, 5, n)]),
        "v": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
        "w": pa.array(rng.uniform(-10, 10, n)),
    })


QUERY = ("select g, sum(v) as sv, count(*) as c, min(v) as mn from t "
         "where w > -5 group by g order by g")


def run_port(data_dir, cache_dir):
    reset_port()
    ctx = ExecutionContext(BallistaConfig(_settings(cache_dir)), device="cpu")
    ctx.register_parquet("t", str(data_dir))
    return ctx.sql(QUERY).collect()


def run_jax(data_dir, cache_dir):
    reset_jax()
    ctx = JaxContext(JaxConfig({**_settings(cache_dir), "ballista.executor.backend": "tpu"}))
    ctx.register_parquet("t", str(data_dir))
    return ctx.sql(QUERY).collect()


def run_both(data_dir, cache_dir):
    """(port answer, JAX answer, port delta_stats, JAX delta_stats), each
    package in a fresh 'process' (stage caches dropped first)."""
    port, ref = run_port(data_dir, cache_dir), run_jax(data_dir, cache_dir)
    return port, ref, tr.delta_stats(reset=True), jr.delta_stats(reset=True)


def assert_same_answer(port, ref):
    assert port.to_pydict() == ref.to_pydict()


def test_append_reprepares_only_new_chunks(tmp_path, monkeypatch):
    from ballista_tpu.ops.stage import FusedAggregateStage as JaxStage
    from ballista_tpu_torch.ops.stage import FusedAggregateStage

    data = tmp_path / "data"
    data.mkdir()
    pq.write_table(_part(0), str(data / "part-0.parquet"))
    pq.write_table(_part(1), str(data / "part-1.parquet"))
    cache = tmp_path / "layouts"
    _, _, cold, jcold = run_both(data, cache)
    assert cold == jcold
    assert cold == {"chunks_prepared": 6}  # 3 chunks of 4,096 rows per file

    pq.write_table(_part(2), str(data / "part-2.parquet"))
    for cls in (FusedAggregateStage, JaxStage):
        real = cls._read_scan_file

        def guard(self, path, ctx, real=real):
            if "part-2" not in str(path):
                raise AssertionError(f"re-read of existing file {path}")
            return real(self, path, ctx)

        monkeypatch.setattr(cls, "_read_scan_file", guard)
    grown, ref, warm, jwarm = run_both(data, cache)
    monkeypatch.undo()
    assert warm == jwarm
    assert warm["chunks_reused"] == 6 and warm["chunks_prepared"] == 3
    assert warm["bytes_reprepared_saved"] > 0
    assert_same_answer(grown, ref)
    # bit-equal to a cold run over the grown set with an empty store
    cold_grown, _, _, _ = run_both(data, tmp_path / "layouts-cold")
    assert grown.equals(cold_grown)


def test_warm_set_reuses_every_chunk(tmp_path, monkeypatch):
    from ballista_tpu_torch.ops.stage import FusedAggregateStage

    data = tmp_path / "data"
    data.mkdir()
    pq.write_table(_part(3), str(data / "part-0.parquet"))
    cache = tmp_path / "layouts"
    first, _, _, _ = run_both(data, cache)

    def no_read(self, path, ctx):
        raise AssertionError("parquet decode on a warm chunk set")

    monkeypatch.setattr(FusedAggregateStage, "_read_scan_file", no_read)
    tr.ingest_stats(reset=True)
    warm, ref, stats, jstats = run_both(data, cache)
    monkeypatch.undo()
    assert stats == jstats
    assert stats["chunks_reused"] == 3 and stats.get("chunks_prepared", 0) == 0
    assert tr.ingest_stats(reset=True)["prepares"] == 0
    assert warm.equals(first)
    assert_same_answer(warm, ref)


def test_midappend_write_fails_closed(tmp_path, monkeypatch):
    """A file whose identity moves between the stat and the read is not
    persisted (the decoded bytes may not be the state the identity names);
    a later process that statted the old identity re-prepares and gets the
    old file's answer, in both packages."""
    from ballista_tpu.ops.stage import FusedAggregateStage as JaxStage
    from ballista_tpu_torch.ops.stage import FusedAggregateStage

    data = tmp_path / "data"
    data.mkdir()
    path = str(data / "part-0.parquet")
    t1 = _part(7)
    pq.write_table(t1, path)
    st1 = os.stat(path)
    t2 = pa.concat_tables([t1, _part(8, n=4_096)])
    cache = tmp_path / "layouts"

    def restore():
        pq.write_table(t1, path)
        os.utime(path, (st1.st_atime, st1.st_mtime))
        assert os.stat(path).st_size == st1.st_size  # a deterministic writer

    stats = {}
    for name, cls, run, counters in (("port", FusedAggregateStage, run_port, tr),
                                     ("jax", JaxStage, run_jax, jr)):
        restore()
        real = cls._read_scan_file

        def mid_append(self, p, ctx, real=real):
            pq.write_table(t2, p)  # the append lands inside the read window
            return real(self, p, ctx)

        monkeypatch.setattr(cls, "_read_scan_file", mid_append)
        run(data, cache)
        monkeypatch.undo()
        stats[name] = counters.delta_stats(reset=True)
    assert stats["port"] == stats["jax"]
    assert stats["port"]["save_declined_midappend"] == 1
    # a racer that statted the OLD identity reads the old state: it is
    # served the old file's answer, never the torn writer's tiles
    restore()
    got, ref, _, _ = run_both(data, cache)
    host = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}),
                            device="cpu")
    host.register_parquet("t", str(data))
    assert got.to_pydict() == host.sql(QUERY).collect().to_pydict()
    assert_same_answer(got, ref)


def test_tampered_chunk_identity_misses(tmp_path):
    """An entry whose stamped identity is not the one its key was computed
    from is refused, and the file re-prepares (fail closed)."""
    data = tmp_path / "data"
    data.mkdir()
    pq.write_table(_part(9), str(data / "part-0.parquet"))
    cache = tmp_path / "layouts"
    first, _, _, _ = run_both(data, cache)
    tampered = 0
    for store in (cache, tmp_path / "layouts_torch"):
        for mp in store.rglob("meta.json"):
            m = json.load(open(mp))
            if m.get("kind") == "chunk":
                m["ident"] = [m["ident"][0], "0.0", 0]
                json.dump(m, open(mp, "w"))
                tampered += 1
    assert tampered == 6  # 3 chunks in each package's store
    again, ref, stats, jstats = run_both(data, cache)
    assert stats == jstats
    assert stats.get("chunks_reused", 0) == 0 and stats["chunks_prepared"] == 3
    assert again.equals(first)
    assert_same_answer(again, ref)
