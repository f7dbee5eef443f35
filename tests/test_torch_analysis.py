"""ballista-lint for the port (ballista_tpu_torch/analysis): the port's tree
lints clean under its own analyzer and manifests, each rule flags a seeded
fixture and accepts its fixed twin (torch fixtures for the readback and
dtype rules), the analyzer stands alone (standard library only), and no
raw threading lock is left in the package outside utils/locks.py."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "ballista_tpu_torch"
ANALYSIS = PKG / "analysis"
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "lint_torch"

sys.path.insert(0, str(REPO))

from ballista_tpu_torch.analysis.core import (  # noqa: E402
    CACHE_BASENAME,
    RULE_NAMES,
    analyze_file,
)

RULES = [
    "readback-discipline",
    "dtype-discipline",
    "guarded-by",
    "decline-discipline",
    "failure-discipline",
    "routing-discipline",
    "durability",
    "lock-order",
]


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.analysis", *args],
        cwd=str(REPO), capture_output=True, text=True, env=env,
    )


def _messages(path, rule):
    return [f.message for f in analyze_file(str(path)) if f.rule == rule]


# -- the gate: the port's tree is clean ---------------------------------------

def test_port_tree_lints_clean():
    """`python -m ballista_tpu_torch.analysis` (its default scope, the
    package without the analyzer) exits 0 with at most 5 reasoned
    suppressions."""
    proc = _cli("--no-cache", "--json")
    out = json.loads(proc.stdout)
    assert proc.returncode == 0, "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in out["findings"])
    assert out["ok"] and out["findings"] == []
    assert out["stats"]["suppressions"] <= 5
    n_py = sum(1 for p in PKG.rglob("*.py")
               if ANALYSIS not in p.parents and "__pycache__" not in p.parts)
    assert out["stats"]["files"] == n_py > 50


def test_rules_registered():
    names = RULE_NAMES()
    assert sorted(set(names) - {"lint-usage"}) == sorted(RULES)
    assert "lint-usage" in names
    # eager PyTorch has no tracers: the JAX package's tracer rule has no
    # counterpart (a host branch on a device value is a readback)
    assert "tracer-hygiene" not in names


# -- every rule against its seeded fixture and its fixed twin -----------------

CASES = [
    ("readback-discipline", "readback_bad", "readback_good"),
    ("dtype-discipline", "dtype_bad", "dtype_good"),
    ("guarded-by", "guarded_bad", "guarded_good"),
    ("decline-discipline", "decline_bad", "decline_good"),
    ("decline-discipline", "decline_overflow_bad", "decline_overflow_good"),
    ("routing-discipline", "routing_bad", "routing_good"),
    ("failure-discipline", "failure_bad", "failure_good"),
    ("failure-discipline", "failure_sched_bad", "failure_sched_good"),
    ("failure-discipline", "failure_tenancy_bad", "failure_tenancy_good"),
    ("failure-discipline", "failure_push_bad", "failure_push_good"),
    ("failure-discipline", "failure_spec_bad", "failure_spec_good"),
    ("failure-discipline", "failure_batch_bad", "failure_batch_good"),
    ("failure-discipline", "failure_fleet_bad", "failure_fleet_good"),
    ("failure-discipline", "failure_exchange_bad", "failure_exchange_good"),
    ("failure-discipline", "failure_delta_bad", "failure_delta_good"),
    ("failure-discipline", "failure_replica_bad", "failure_replica_good"),
    ("durability", "durability_bad", "durability_good"),
    ("lock-order", "lockorder_bad", "lockorder_good"),
    ("lock-order", "atomicity_bad", "lockorder_good"),
]


@pytest.mark.parametrize("rule,bad,good", CASES, ids=[c[1] for c in CASES])
def test_rule_flags_its_fixture_and_accepts_the_twin(rule, bad, good):
    hit = {f.rule for f in analyze_file(str(FIXTURES / f"{bad}.py"))}
    assert rule in hit, f"{rule} did not fire on {bad}.py (hit: {hit})"
    findings = analyze_file(str(FIXTURES / f"{good}.py"))
    assert findings == [], "\n".join(f.format() for f in findings)


# the rules copied from the JAX package's analyzer: on the same fixture,
# renamed to the JAX package's root, both analyzers report the same
# (rule, line) set, except on the lines marked "rule adapted:" (a pinned
# design of the port that the copied rule was taught)
COPIED_RULES = {"guarded-by", "decline-discipline", "failure-discipline",
                "routing-discipline", "durability", "lock-order", "lint-usage"}
PARITY = sorted({name for rule, bad, good in CASES for name in (bad, good)
                 if rule in COPIED_RULES})


@pytest.mark.parametrize("fixture", PARITY)
def test_copied_rules_agree_with_the_jax_package_analyzer(fixture, tmp_path):
    from dev.analysis.core import analyze_file as reference_analyze

    src = (FIXTURES / f"{fixture}.py").read_text()
    ref_file = tmp_path / f"{fixture}.py"
    ref_file.write_text(src.replace("ballista_tpu_torch", "ballista_tpu"))
    ref = {(f.rule, f.line) for f in reference_analyze(str(ref_file))
           if f.rule in COPIED_RULES}
    port = {(f.rule, f.line) for f in analyze_file(str(FIXTURES / f"{fixture}.py"))
            if f.rule in COPIED_RULES}
    adapted = {i + 1 for i, ln in enumerate(src.splitlines())
               if "rule adapted:" in ln}
    assert {line for _rule, line in ref ^ port} == adapted, (
        sorted(port - ref), sorted(ref - port))
    if fixture.endswith("_bad"):
        assert port & ref, "the seeded fault is found by neither analyzer"


def test_readback_rule_flags_each_materialization():
    """An unrecorded .item() of a torch result, .cpu().numpy(), .tolist()
    of a kernel wrapper's result, bool() of a device value, and .item()
    and .cpu() of loop variables over device tensors (a comprehension and
    a `for`): each flagged on its line. Metadata and numpy calls in the
    twin are not."""
    found = {f.line for f in analyze_file(str(FIXTURES / "readback_bad.py"))
             if f.rule == "readback-discipline"}
    lines = (FIXTURES / "readback_bad.py").read_text().splitlines()
    want = {i + 1 for i, ln in enumerate(lines)
            if "# unrecorded" in ln or "# a host branch" in ln}
    assert found == want and len(want) == 6, (found, want)


def test_readback_rule_is_scoped_to_device_paths(tmp_path):
    src = (FIXTURES / "readback_bad.py").read_text().replace(
        "path=ballista_tpu_torch/ops/", "path=ballista_tpu_torch/physical/")
    p = tmp_path / "host.py"
    p.write_text(src)
    assert _messages(p, "readback-discipline") == []


def test_dtype_rule_flags_each_transfer():
    """A float64 .to(device), a .double().cuda(), an np.float64 array
    through runtime.upload, and a transfer that names float64."""
    msgs = analyze_file(str(FIXTURES / "dtype_bad.py"))
    funcs = {m.message.split("'")[1] for m in msgs
             if m.rule == "dtype-discipline"}
    assert funcs == {"move_wide", "move_double", "upload_wide",
                     "tensor_on_device"}


def test_dtype_rule_exempts_floatbits(tmp_path):
    src = (FIXTURES / "dtype_bad.py").read_text().replace(
        "path=ballista_tpu_torch/ops/fixture_dtype_bad.py",
        "path=ballista_tpu_torch/ops/floatbits.py")
    p = tmp_path / "floatbits.py"
    p.write_text(src)
    assert _messages(p, "dtype-discipline") == []


def test_decline_rule_flags_all_shapes_and_counts_recorded_handlers():
    msgs = _messages(FIXTURES / "decline_bad.py", "decline-discipline")
    assert any("without a reason" in m for m in msgs)
    assert any("ad-hoc" in m for m in msgs)
    # the plain silent None and a handler that records the host route but
    # not the caught reason
    assert sum("return None" in m for m in msgs) == 2, msgs


def test_decline_rule_accepts_the_mesh_handlers():
    """parallel/spmd_stage.py and spmd_join.py record the host route and
    the caught reason, then end their generator: counted, not silent."""
    for name in ("spmd_stage.py", "spmd_join.py"):
        assert _messages(PKG / "parallel" / name, "decline-discipline") == []


def test_guarded_rule_reads_annotations_after_a_description():
    msgs = _messages(FIXTURES / "guarded_bad.py", "guarded-by")
    assert any("'_sizes' is guarded by '_lock'" in m for m in msgs), msgs
    assert any("requires holding" in m for m in msgs)


def test_routing_rule_keeps_the_kernels_module_clean():
    """The helpers' own bodies are the channel; the mapped top-k rung's
    step-aside carries its cold-path reason."""
    assert _messages(PKG / "ops" / "kernels.py", "routing-discipline") == []
    src = (PKG / "ops" / "kernels.py").read_text()
    assert "# cold-path:" in src


def test_failure_rule_sites_track_the_port_chaos_registry():
    from ballista_tpu_torch.analysis.rules_failure import _registered_sites
    from ballista_tpu_torch.utils import chaos

    got = _registered_sites(str(PKG / "executor" / "execution_loop.py"))
    assert got == frozenset(chaos.SITES)


def test_lockorder_fixture_messages():
    msgs = _messages(FIXTURES / "lockorder_bad.py", "lock-order")
    assert any("undeclared lock-order edge" in m for m in msgs), msgs
    assert any("potential deadlock: lock-order cycle" in m for m in msgs)
    assert any("raw threading.Lock()" in m for m in msgs)
    assert any("no guarded-by:/holds-lock: annotation" in m for m in msgs)
    assert any("does not match its canonical identity" in m for m in msgs)
    atom = _messages(FIXTURES / "atomicity_bad.py", "lock-order")
    assert len(atom) == 1 and "check-then-act across a release" in atom[0]


def test_lock_names_strip_the_port_root():
    """Canonical names are <module>.<attr> below ballista_tpu_torch/, the
    JAX package's names for the same locks; a make_lock literal that
    carries the package root is flagged."""
    from ballista_tpu_torch.analysis.lockgraph import module_of

    assert module_of("ballista_tpu_torch/ops/runtime.py") == "ops.runtime"
    assert module_of("ballista_tpu/ops/runtime.py") == "ballista_tpu.ops.runtime"
    from ballista_tpu_torch.analysis.core import SourceFile
    from ballista_tpu_torch.analysis.rules_lockorder import check

    src = textwrap.dedent("""\
        from ballista_tpu_torch.utils.locks import make_lock
        _mu = make_lock("ballista_tpu_torch.ops.m._mu")
        _x = {}  # guarded-by: _mu
    """)
    sf = SourceFile("m.py", src, "ballista_tpu_torch/ops/m.py")
    assert any("does not match its canonical identity 'ops.m._mu'"
               in f.message for f in check(sf))


# -- the port's lock-order graph ----------------------------------------------

def test_port_graph_is_declared_forward_and_acyclic():
    from ballista_tpu_torch.analysis.lockgraph import LockGraph, EdgeSite, Manifest
    from ballista_tpu_torch.analysis.rules_lockorder import static_edges

    edges = static_edges([str(PKG)], use_cache=False)
    for e in (
        ("scheduler.kv.lock", "scheduler.state._tenant_mu"),
        ("scheduler.kv.lock", "utils.counters._counts_lock"),
        ("ops.stage._prepare_lock", "ops.runtime._res_lock"),
        ("ops.kernels._stage_cache_lock", "ops.runtime._res_lock"),
    ):
        assert e in edges, f"expected edge {e} missing"
    # moved out of the nvcc build: no edge leaves the kernel build lock
    assert not [e for e in edges if e[0] == "ops.cuda_kernels._build_lock"]
    m = Manifest.load()
    g = LockGraph()
    for s, d in edges:
        if not m.plan_pair(s, d):
            assert m.check_edge(s, d) is None, (s, d, m.check_edge(s, d))
            g.add(EdgeSite(s, d, "x.py", 1, "f", ""))
    assert g.cycles() == []


def test_method_alias_calls_resolve_to_the_method():
    """`x_stats = counters.x.stats` at module level: a caller of x_stats
    under a lock gets the edge to the lock the method takes (the port's
    runtime re-exports its counter readers as such aliases)."""
    from ballista_tpu_torch.analysis.core import SourceFile
    from ballista_tpu_torch.analysis.rules_lockorder import build_graph, extract_facts

    srcs = {
        "ballista_tpu_torch/utils/counters.py": """
            from ballista_tpu_torch.utils.locks import make_lock
            class Counts:
                def __init__(self):
                    self._counts_lock = make_lock("utils.counters._counts_lock")
                def stats(self):
                    with self._counts_lock:
                        pass
            recovery = Counts()
        """,
        "ballista_tpu_torch/ops/runtime.py": """
            from ballista_tpu_torch.utils import counters
            recovery_stats, other_stats = counters.recovery.stats, counters.recovery.stats
        """,
        "ballista_tpu_torch/scheduler/user.py": """
            from ballista_tpu_torch.ops import runtime
            def f(self):
                with self.kv.lock():
                    runtime.other_stats()
        """,
    }
    facts = {p: extract_facts(SourceFile(p, textwrap.dedent(s), p))
             for p, s in srcs.items()}
    graph, _ = build_graph(facts)
    assert ("scheduler.kv.lock", "utils.counters._counts_lock") in graph.edge_set()


# -- standing alone -----------------------------------------------------------

_FORBIDDEN = ("dev", "ballista_tpu", "jax", "torch", "numpy", "pyarrow")


def test_analyzer_imports_nothing_outside_the_standard_library():
    for path in sorted(ANALYSIS.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                if mod.startswith("ballista_tpu_torch."):
                    assert mod.startswith("ballista_tpu_torch.analysis"), \
                        (path.name, mod)
                else:
                    assert top not in _FORBIDDEN, (path.name, mod)
    code = (
        "import sys, json\n"
        "from ballista_tpu_torch.analysis.__main__ import main\n"
        "from ballista_tpu_torch.analysis.core import _load_rules\n"
        "_load_rules()\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in %r)))\n" % (_FORBIDDEN,)
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == []


def test_no_raw_threading_lock_outside_the_lock_module():
    raw = []
    for path in sorted(PKG.rglob("*.py")):
        if path == PKG / "utils" / "locks.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("Lock", "RLock") \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "threading":
                raw.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert raw == [], raw


# -- suppressions, CLI and cache ----------------------------------------------

def test_suppression_with_reason_suppresses():
    findings = analyze_file(str(FIXTURES / "suppress_ok.py"))
    assert findings == [], "\n".join(f.format() for f in findings)


def test_suppression_without_reason_rejected():
    rules = {f.rule for f in analyze_file(str(FIXTURES / "suppress_noreason.py"))}
    assert {"lint-usage", "readback-discipline"} <= rules


def test_suppression_budget_enforced(tmp_path):
    p = tmp_path / "budget.py"
    lines = ["# ballista-lint: path=ballista_tpu_torch/ops/fixture_budget.py"]
    for i in range(6):
        lines.append(f"x{i} = {i}  # ballista-lint: disable=lint-usage -- r{i}")
    p.write_text("\n".join(lines) + "\n")
    proc = _cli(str(p), "--no-cache", "--json")
    out = json.loads(proc.stdout)
    assert out["over_suppression_budget"] and proc.returncode == 1


def test_bad_fixtures_fail_via_cli():
    for bad in sorted(FIXTURES.glob("*_bad.py")):
        proc = _cli(str(bad), "--no-cache")
        assert proc.returncode == 1, (bad, proc.stdout, proc.stderr)


def test_json_output_and_cache_roundtrip(tmp_path):
    """The port's cache has its own file name (.gitignore lists it); an
    edit invalidates a cached verdict."""
    assert CACHE_BASENAME == ".ballista_torch_lint_cache.json"
    assert CACHE_BASENAME in (REPO / ".gitignore").read_text().split()
    work = tmp_path / "pkg" / "ballista_tpu_torch" / "ops"
    work.mkdir(parents=True)
    shutil.copy(FIXTURES / "readback_bad.py", work / "mod.py")
    cache = tmp_path / "cache.json"

    def run():
        proc = _cli(str(work), "--json", "--cache-file", str(cache))
        return proc.returncode, json.loads(proc.stdout)

    rc1, out1 = run()
    assert rc1 == 1 and {f["rule"] for f in out1["findings"]} == {"readback-discipline"}
    assert out1["stats"]["cache_hits"] == 0
    rc2, out2 = run()
    assert rc2 == 1 and out2["stats"]["cache_hits"] == 1
    assert out2["findings"] == out1["findings"]
    (work / "mod.py").write_text(
        (FIXTURES / "readback_good.py").read_text())
    os.utime(work / "mod.py")
    rc3, out3 = run()
    assert rc3 == 0 and out3["ok"], out3["findings"]
