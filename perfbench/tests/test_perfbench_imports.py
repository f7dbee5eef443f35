"""Nothing the benchmark runs imports JAX, the JAX package, the old
benchmark's folder or the port's old bench entry, and the plain reference
imports nothing of the port. Names are compared by their top-level part,
whole: ballista_tpu_torch begins with ballista_tpu and is not it."""

import ast
import pathlib
import subprocess
import sys

from perfbench import catalog
from perfbench.run import FORBIDDEN, FORBIDDEN_MODULES

ROOT = pathlib.Path(catalog.ROOT)


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def _bad(name: str, top: tuple, whole: tuple) -> bool:
    return name.split(".")[0] in top or any(name == w or name.startswith(w + ".")
                                            for w in whole)


def test_no_module_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        bad = {n for n in _imports(path) if _bad(n, FORBIDDEN, FORBIDDEN_MODULES)}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "reference").glob("*.py"):
        bad = {n for n in _imports(path) if _bad(n, ("ballista_tpu_torch",), ())}
        assert not bad, (path, bad)


def test_top_level_names_are_compared_whole():
    assert not _bad("ballista_tpu_torch.engine", FORBIDDEN, FORBIDDEN_MODULES)
    assert _bad("ballista_tpu.engine", FORBIDDEN, FORBIDDEN_MODULES)
    assert _bad("ballista_tpu_torch.bench.tpch", FORBIDDEN, FORBIDDEN_MODULES)
    assert not _bad("ballista_tpu_torch.benchmark", FORBIDDEN, FORBIDDEN_MODULES)


def test_a_run_loads_none_of_them(tmp_path):
    """A whole run of each cell (on the CPU, at SF 0.01), in a fresh
    process: afterwards sys.modules holds none of the forbidden modules."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import pathlib, sys, time\n"
        "from perfbench.run import forbidden_modules, run_cell\n"
        "if __name__ == '__main__':\n"
        "    for cell in ('tpch-sf10-local.hot', 'tpch-sf1-cluster.adhoc'):\n"
        "        r = run_cell(cell, 9, 1.0, False, 'cpu', time.perf_counter(),\n"
        f"                     data_root=pathlib.Path({str(tmp_path)!r}), sf=0.01)\n"
        "        assert r['correct'], r['checks']\n"
        "    print('LOADED', forbidden_modules())\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=ROOT.parent, timeout=600,
                         env={**__import__("os").environ, "PYTHONPATH": str(ROOT.parent)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
