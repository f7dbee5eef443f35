"""A configuration, a workload, a query template and a metric added as new
files alone are found by name and run, with no file of the benchmark
edited: the harness is driven by data."""

import json
import pathlib
import time

import pytest

from perfbench import catalog
from perfbench.run import run_cell

ROOT = pathlib.Path(catalog.ROOT)
NEW = {
    "configs/_probe-config.json": json.dumps({
        "engine": "local", "scale_factor": 0.01, "files_per_table": 1,
        "queries": ["q6", "_probe"],
        "settings": {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": ""}}),
    "workloads/_probe-cell.hot.json": json.dumps({
        "config": "_probe-config", "traffic": "repeat_stream", "chips": 1,
        "limits": {"rel_gap": 1e-5}}),
    "queries/_probe.sql": ("select l_returnflag, count(*) as n from lineitem "
                           "where l_quantity < {QUANTITY} group by l_returnflag"),
    "params/_probe.py": ("VALIDATION = {'QUANTITY': 10}\n\n\n"
                         "def space():\n    return [{'QUANTITY': q} for q in range(5, 40)]\n\n\n"
                         "def bind(p):\n    return {'QUANTITY': str(p['QUANTITY'])}\n"),
    "reference/_probe.py": (
        "import numpy as np\n\n"
        "KEYS = ['l_returnflag']\nORDER = None\nLIMIT = None\n\n\n"
        "def answer(t, p):\n"
        "    m = t.col('lineitem', 'l_quantity') < p['QUANTITY']\n"
        "    codes, values = t.codes('lineitem', 'l_returnflag')\n"
        "    n = np.bincount(codes[m], minlength=len(values))\n"
        "    hit = [i for i in range(len(values)) if n[i]]\n"
        "    return {'l_returnflag': [values[i] for i in hit], 'n': n[hit].astype(np.int64)}\n"),
    "metrics/_probe_queries.py": ("UNIT = 'count'\n\n\n"
                                  "def read(run):\n    return len(run['records'])\n"),
    "end_to_end/_probe_ok.py": ("UNIT = 'count'\n\n\n"
                                "def read(run):\n    return sum(r['ok'] for r in run['records'])\n"),
}


@pytest.fixture
def new_files():
    written = []
    try:
        for rel, text in NEW.items():
            path = ROOT / rel
            assert not path.exists(), rel
            path.write_text(text)
            written.append(path)
        import importlib

        importlib.invalidate_caches()
        yield
    finally:
        for path in written:
            path.unlink()


def test_new_files_alone_add_a_cell_a_template_and_metrics(new_files, tmp_path):
    spec = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "_probe_ok", "workloads": ["_probe-cell.hot"]})
    spec["per_layer"].append({"name": "_probe_queries", "workloads": ["_probe-cell.hot"]})
    for trace, metric in ((False, "_probe_ok"), (True, "_probe_queries")):
        r = run_cell("_probe-cell.hot", 5, 1.0, trace, "cpu", time.perf_counter(),
                     data_root=tmp_path, spec=spec)
        assert r["correct"], r["checks"]
        assert r["metrics"][metric]["value"] == r["attempted"] > 0
    assert "_probe" in {p.stem for p in (ROOT / "queries").glob("*.sql")}
