"""The port's durability manifest (ballista_tpu_torch/analysis/
durability.toml) against its scheduler: every attribute of the owner
classes is classified in the source and in the manifest alike, every
durable mutation pairs with a KV op, every derived rebuild is reachable
from recover(), and the ephemeral budgets hold (scheduler.state's is 37:
the port's _spec_failed is the one attribute the JAX package lacks)."""

import json
import os
import pathlib
import subprocess
import sys

try:  # py3.11+
    import tomllib as _toml
except ImportError:  # pragma: no cover - py3.10 fallback
    import tomli as _toml  # type: ignore

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "ballista_tpu_torch"
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "lint_torch"
MANIFEST = PKG / "analysis" / "durability.toml"
JAX_MANIFEST = REPO / "dev" / "analysis" / "durability.toml"

sys.path.insert(0, str(REPO))

from ballista_tpu_torch.analysis.core import (  # noqa: E402
    SourceFile,
    analyze_file,
    durability_manifest_path,
    run_paths,
)
from ballista_tpu_torch.analysis.rules_durability import extract_facts  # noqa: E402


def _manifest(path=MANIFEST) -> dict:
    with open(path, "rb") as f:
        return _toml.load(f)


def _facts(module_file: str) -> dict:
    path = PKG / "scheduler" / module_file
    rel = str(path.relative_to(REPO))
    return extract_facts(SourceFile(str(path), path.read_text(), rel))


def test_scheduler_tree_is_durability_clean():
    findings, _stats = run_paths([str(PKG / "scheduler")], use_cache=False)
    dur = [f for f in findings if f.rule == "durability"]
    assert dur == [], "\n".join(f.format() for f in dur)


def test_the_analyzer_reads_the_port_manifest():
    assert pathlib.Path(durability_manifest_path()) == MANIFEST


def test_manifest_agrees_with_the_annotations():
    """Each [attrs] row names an annotated attribute of an owner class
    with the same classification, and each annotated attribute of an
    owner class has its row."""
    man = _manifest()
    owners = {(o["module"], o["class"]) for o in man["owners"]}
    assert owners == {
        ("scheduler.state", "SchedulerState"),
        ("scheduler.server", "SchedulerServer"),
        ("scheduler.server", "_PushSubscriber"),
    }
    seen = {}
    for module_file, module in (("state.py", "scheduler.state"),
                                ("server.py", "scheduler.server")):
        for cls, table in _facts(module_file)["classes"].items():
            if (module, cls) not in owners:
                continue
            for attr, (dclass, arg, _line) in table.items():
                seen[f"{module}.{cls}.{attr}"] = (dclass, arg)
    assert set(seen) == set(man["attrs"])
    for key, row in man["attrs"].items():
        dclass, arg = seen[key]
        want = dclass if dclass == "ephemeral" else f"{dclass}({arg})"
        assert row == want, (key, row, want)
    assert man["attrs"]["scheduler.state.SchedulerState._spec_failed"] == "ephemeral"


def test_ephemeral_budgets_hold():
    man = _manifest()
    budgets = man["budgets"]
    assert budgets["scheduler.state"] == 37
    # one above the JAX package's budget: the port's _spec_failed
    assert _manifest(JAX_MANIFEST)["budgets"]["scheduler.state"] == 36
    for module_file, module in (("state.py", "scheduler.state"),
                                ("server.py", "scheduler.server")):
        count = _facts(module_file)["ephemeral"]
        assert count <= budgets[module], (module, count, budgets[module])
    assert _facts("state.py")["ephemeral"] == 37


def test_durability_fixture_pair():
    msgs = [f.message for f in analyze_file(str(FIXTURES / "durability_bad.py"))
            if f.rule == "durability"]
    for want in ("no `# durability:` annotation", "needs a KV prefix token",
                 "needs a reason", "needs the rebuild function's name",
                 "conflicting durability classification",
                 "no KV operation against prefix 'assignments'",
                 "without consulting the attempt/ledger guard",
                 "is NOT reachable from", "over its budget of 4", "dangling"):
        assert any(want in m for m in msgs), (want, msgs)
    good = analyze_file(str(FIXTURES / "durability_good.py"))
    assert good == [], "\n".join(f.format() for f in good)


def test_manifest_edit_invalidates_per_file_cache(tmp_path):
    """Per-file verdicts depend on the manifest; the port's override
    variable (not the JAX package's) folds into the cache key."""
    work = tmp_path / "pkg"
    work.mkdir()
    (work / "mod.py").write_text(
        "# ballista-lint: path=ballista_tpu_torch/scheduler/mod.py\n"
        "class Thing:\n"
        "    def __init__(self):\n"
        "        self.a = 1\n"
    )
    cache = tmp_path / "cache.json"
    manifest = tmp_path / "durability.toml"
    env = dict(os.environ, BALLISTA_TORCH_DURABILITY_MANIFEST=str(manifest))

    def run():
        proc = subprocess.run(
            [sys.executable, "-m", "ballista_tpu_torch.analysis", str(work),
             "--json", "--cache-file", str(cache)],
            cwd=str(REPO), capture_output=True, text=True, env=env,
        )
        return proc.returncode, json.loads(proc.stdout)

    manifest.write_text("[attrs]\n")
    rc1, out1 = run()
    assert rc1 == 0 and out1["ok"], out1["findings"]
    manifest.write_text('[[owners]]\nmodule = "scheduler.mod"\n'
                        'class = "Thing"\n[attrs]\n')
    rc2, out2 = run()
    assert rc2 == 1 and out2["stats"]["cache_hits"] == 0
    assert any("no `# durability:` annotation" in f["message"]
               for f in out2["findings"]), out2["findings"]
