"""The port's benchmark entry (ballista_tpu_torch/bench/) held to bench.py,
benchmarks/tpch/runner.py and benchmarks/compare.py on the CPU.

- bench_config's rows for q1, q3 and q6 and both taxi shapes (at SF 0.01)
  carry "match": true against the port's "cpu" backend, and the port's
  answers equal the JAX package's "tpu" backend on the same files;
- the elastic, delta, routing and multitenant scenarios give the counters
  that bench.py's own functions give under the same BENCH_* settings;
- a wrong answer (an injected one, or a count off by one) fails the run;
- without BENCH_DEVICE=cpu, and with no card, every entry raises;
- runner.py's convert and benchmark give what the JAX runner gives, and
  compare.py holds all 22 queries to the pandas oracles;
- the bench package imports neither JAX nor the JAX package.
"""

import json
import os
import pathlib
import subprocess
import sys

import pyarrow as pa
import pyarrow.csv as pcsv
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as port_config
from ballista_tpu_torch.bench import compare, data, runner, taxi, tpch
from ballista_tpu_torch.bench.scenarios.delta import _delta_scenario
from ballista_tpu_torch.bench.scenarios.elastic import _elastic_scenario
from ballista_tpu_torch.bench.scenarios.multitenant import _multitenant_scenario
from ballista_tpu_torch.bench.scenarios.routing import _routing_scenario

port_config.DEFAULT_SETTINGS[port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
port_config.DEFAULT_SETTINGS[port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""

ROOT = pathlib.Path(__file__).resolve().parent.parent
SF = 0.01
TAXI_SF = 0.01


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """One bench cache for the module: TPC-H SF 0.01 and the taxi shapes."""
    d = tmp_path_factory.mktemp("bench_cache")
    old = data.CACHE
    data.CACHE = d
    data.ensure_data(SF)
    yield d
    data.CACHE = old
    tpch.reset_contexts()


@pytest.fixture
def on_cpu(monkeypatch, cache):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setattr(data, "CACHE", cache)
    return cache


def _jax_answer(sql, register):
    from ballista_tpu.config import BallistaConfig
    from ballista_tpu.engine import ExecutionContext

    ctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "tpu",
                                           "ballista.batch.size": tpch.BATCH}))
    register(ctx)
    return ctx.sql(sql).collect()


@pytest.mark.parametrize("name", ["q1", "q3", "q6"])
def test_tpch_row_matches_the_cpu_backend_and_the_jax_package(on_cpu, name):
    from benchmarks.tpch.datagen import register_all

    row = tpch.bench_config(SF, name, iters=1)
    assert row["match"] is True and row["sf"] == SF
    assert row["routes"] and not row["declines"], row
    assert set(row["kernel_launches"]) == {"sorted_grouped_sum", "grouped_aggregate"}
    assert {"pins", "evictions", "streams", "resident_bytes"} <= set(row["residency"])
    assert "h2d_chunk_bytes" in row and row["cuda_ms"] > 0 and row["cpu_ms"] > 0
    sql = (tpch.QUERIES_DIR / f"{name}.sql").read_text()
    port = tpch._context("cuda", SF).sql(sql).collect()
    ref = _jax_answer(sql, lambda ctx: register_all(ctx, str(data.data_dir(SF))))
    tpch.check_answer(f"{name} port vs jax", port, ref)


def test_taxi_rows_match_the_cpu_backend_and_the_jax_package(on_cpu):
    from benchmarks.taxi.datagen import TRIP_AGG_QUERY

    rows = taxi._taxi_rows(sf=TAXI_SF)
    assert [r["name"] for r in rows] == ["taxi_100k_265groups", "taxi_100k_10kgroups"]
    for row, (_groups, stem, zones) in zip(rows, data.TAXI_SHAPES):
        label = row["name"]
        assert row["match"] is True and row["sf"] == TAXI_SF and row["rows"] == 20, row
        assert row["routes"] and not row["declines"], row
        table = "trips" if zones is None else "trips_hc"
        sql = TRIP_AGG_QUERY.replace("from trips", f"from {table}")
        port = tpch._context("cuda", None).sql(sql).collect()
        trips = data.taxi_dir(stem, TAXI_SF) / "trips"
        ref = _jax_answer(sql, lambda ctx: ctx.register_parquet(table, str(trips)))
        tpch.check_answer(f"{label} port vs jax", port, ref)


@pytest.mark.parametrize("sf,label", [(1.0, "10M"), (0.01, "100k"), (0.05, "500k")])
def test_taxi_rows_are_named_by_their_trip_count(sf, label):
    assert taxi.trips_label(sf) == label


def test_a_count_off_by_one_is_a_mismatch():
    want = pa.table({"k": ["a", "b"], "n": pa.array([16_777_217, 3], pa.int64()),
                     "s": [1.5, 2.5]})
    got = pa.table({"k": ["a", "b"], "n": pa.array([16_777_216, 3], pa.int64()),
                    "s": [1.5, 2.5]})
    assert tpch.check_answer("same", want, want) == 0.0
    with pytest.raises(tpch.AnswerMismatch, match="column n"):
        tpch.check_answer("count", got, want)
    close = got.set_column(1, "n", want.column("n")).set_column(2, "s", pa.array([1.5001, 2.5]))
    assert tpch.check_answer("f32 sum", close, want) == pytest.approx(1e-4)


@pytest.mark.parametrize("bad", ["cold", "warm"])
def test_an_injected_wrong_answer_fails_main(on_cpu, monkeypatch, bad):
    from ballista_tpu_torch.bench.__main__ import main

    real = tpch.run_once
    cuda_runs = []

    def wrong(backend, sql, sf, device=None):
        dt, out = real(backend, sql, sf, device)
        if backend == "cuda":
            cuda_runs.append(sql)
        # the first run on the card is the cold one
        if backend == "cuda" and (len(cuda_runs) == 1) == (bad == "cold"):
            i = out.column_names.index("count_order")
            bumped = pa.array([v + 1 for v in out.column(i).to_pylist()], out.schema[i].type)
            out = out.set_column(i, out.schema[i], bumped)
        return dt, out

    monkeypatch.setenv("BENCH_SF", str(SF))
    monkeypatch.setenv("BENCH_CONFIGS", f"{SF}:q1")
    monkeypatch.setattr(tpch, "run_once", wrong)
    with pytest.raises(tpch.AnswerMismatch, match="count_order"):
        main()


def test_every_entry_raises_without_a_card(cache, monkeypatch):
    import torch

    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpch._context("cuda", SF, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.main(["benchmark", "--path", str(data.data_dir(SF)), "--query", "6",
                     "--iterations", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare.main(["--data", str(data.data_dir(SF)), "--queries", "q6"])
    # the CLI exits nonzero and prints no result
    env = {k: v for k, v in os.environ.items() if k not in ("BENCH_DEVICE", "PYTHONPATH")}
    env.update(CUDA_VISIBLE_DEVICES="", BENCH_ROUTING_ONLY="1")
    r = subprocess.run([sys.executable, "-m", "ballista_tpu_torch.bench"], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == "", r.stdout
    assert "CUDA is not available" in r.stderr


@pytest.fixture
def jax_bench(monkeypatch, tmp_path):
    """bench.py, its dataset root moved to tmp_path."""
    import bench

    monkeypatch.setattr(bench, "REPO", tmp_path)
    monkeypatch.setattr(bench, "data_dir", lambda sf: tmp_path / ".bench_cache" / f"tpch_sf{sf}")
    return bench


ELASTIC_KEYS = ("jobs", "fleet_min", "fleet_max", "fleet_final", "bit_identical",
                "task_retries")
DELTA_KEYS = ("digest", "bit_identical", "chunks_reused", "chunks_prepared", "advance_hits",
              "advance_declined", "chaos", "restart_advanced", "restart_cache_hit")


def test_elastic_scenario_counters_match_bench_py(on_cpu, jax_bench, monkeypatch):
    monkeypatch.setenv("BENCH_ELASTIC_ROWS", "20000")
    port = _elastic_scenario()
    ref = jax_bench._elastic_scenario()
    assert {k: port[k] for k in ELASTIC_KEYS} == {k: ref[k] for k in ELASTIC_KEYS}
    assert port["task_retries"] == 0 and port["bit_identical"]
    assert port["fleet_peak"] > 1 and ref["fleet_peak"] > 1


def test_delta_scenario_counters_match_bench_py(on_cpu, jax_bench, monkeypatch):
    monkeypatch.setenv("BENCH_DELTA_ROWS", "5000")
    port = _delta_scenario()
    ref = jax_bench._delta_scenario()
    assert {k: port[k] for k in DELTA_KEYS} == {k: ref[k] for k in DELTA_KEYS}
    assert port["chunks_reused"] >= 1 and port["advance_hits"] == 1


def test_routing_scenario_counters_match_bench_py(on_cpu, jax_bench):
    port = _routing_scenario()
    ref = jax_bench._routing_scenario()
    assert port["bit_identical"] and ref["bit_identical"]
    assert port["splits"] == ref["splits"] >= 1
    assert port["engines"] == ref["engines"]
    assert port["skew_replans"] == ref["skew_replans"]


def test_multitenant_scenario_counters_match_bench_py(on_cpu, jax_bench, monkeypatch):
    monkeypatch.setenv("BENCH_MT_REPLAYS", "4")
    port = _multitenant_scenario()
    ref = jax_bench._multitenant_scenario()
    keys = ("tenants", "queries")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys} == {"tenants": 4,
                                                                       "queries": 16}
    assert port["match"] is True
    assert port["cache_hit_rate"] > 0 and ref["cache_hit_rate"] > 0
    assert set(port["task_share"]) <= {f"tenant{i}" for i in range(4)}


def _write_tbl(src: pathlib.Path, out: pathlib.Path) -> None:
    """dbgen-style .tbl files ('|'-delimited, a trailing '|', no header)."""
    from benchmarks.tpch.schema import TPCH_TABLES

    out.mkdir()
    for t in TPCH_TABLES:
        table = pq.read_table(src / t)
        buf = pa.BufferOutputStream()
        pcsv.write_csv(table, buf, write_options=pcsv.WriteOptions(
            include_header=False, delimiter="|", quoting_style="none"))
        lines = buf.getvalue().to_pybytes().decode().splitlines()
        (out / f"{t}.tbl").write_text("".join(line + "|\n" for line in lines))


def test_runner_convert_and_benchmark_match_the_jax_runner(on_cpu, tmp_path, monkeypatch,
                                                           capsys):
    from benchmarks.tpch import runner as jax_runner
    from benchmarks.tpch.schema import TPCH_TABLES

    tbl = tmp_path / "tbl"
    _write_tbl(data.data_dir(SF), tbl)
    outs = {}
    for name, fn in (("port", lambda a: runner.main(a)),
                     ("jax", lambda a: (monkeypatch.setattr(sys, "argv", ["tpch", *a]),
                                        jax_runner.main()))):
        out = tmp_path / f"parquet_{name}"
        fn(["convert", "--input", str(tbl), "--output", str(out), "--partitions", "2"])
        outs[name] = out
    for t in TPCH_TABLES:
        port = pq.read_table(outs["port"] / t)
        assert port.equals(pq.read_table(outs["jax"] / t)), t
        assert port.num_rows == pq.read_table(data.data_dir(SF) / t).num_rows, t
    capsys.readouterr()
    runner.main(["benchmark", "--path", str(outs["port"]), "--iterations", "1",
                 "--backend", "cuda"])
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["tpch", "benchmark", "--path", str(outs["jax"]),
                                      "--iterations", "1", "--backend", "cpu"])
    jax_runner.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(port) == list(ref) == [f"q{i}" for i in range(1, 23)]
    assert {q: v["rows"] for q, v in port.items()} == {q: v["rows"] for q, v in ref.items()}


def test_compare_holds_all_22_queries_to_the_pandas_oracles(on_cpu, capsys):
    rc = compare.main(["--data", str(data.data_dir(SF)), "--queries", "all", "--iterations",
                       "1", "--engines", "cuda", "cpu", "pyarrow", "pandas"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    assert "0 cross-engine mismatches" in out.err
    assert [ln.split(" | ")[0] for ln in out.out.splitlines()[2:]] == [
        f"| q{i}" for i in range(1, 23)]


def test_compare_reports_a_wrong_answer(on_cpu, monkeypatch, capsys):
    real = compare.BallistaEngine.run

    def wrong(self, name):
        out = real(self, name)
        if self.backend != "cuda":
            return out
        return out.set_column(0, out.schema[0], pa.array(
            [v * 2 for v in out.column(0).to_pylist()], out.schema[0].type))

    monkeypatch.setattr(compare.BallistaEngine, "run", wrong)
    rc = compare.main(["--data", str(data.data_dir(SF)), "--queries", "q6", "--iterations",
                       "1"])
    assert rc == 1
    assert "MISMATCH: q6: cuda against the pandas oracle" in capsys.readouterr().err


def test_bench_package_imports_neither_jax_nor_the_jax_package():
    mods = sorted(
        "ballista_tpu_torch." + ".".join(p.relative_to(ROOT / "ballista_tpu_torch")
                                         .with_suffix("").parts)
        for p in (ROOT / "ballista_tpu_torch" / "bench").rglob("*.py")
    )
    assert "ballista_tpu_torch.bench.scenarios.replica" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ballista_tpu' or m.startswith('ballista_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
