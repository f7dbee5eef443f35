"""The port's event counters (ballista_tpu_torch/utils/counters.py).

- the registry sits below every layer: it imports nothing of the package
  but utils.locks, and no module under scheduler/, client/, executor/,
  distributed/ or utils/ imports a counting name from ops.runtime other
  than record_routing (utils/ imports nothing of ops/ at all);
- one class, `Counts`: record, add, set, gauge, stats with a reset to the
  set's zero keys, and the (part, name) view that routing_stats and
  join_path_stats return;
- the readers ops.runtime re-exports keep their names and dict shapes, and a
  readback's site tag counts beside the totals without changing them.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from ballista_tpu_torch.ops import runtime
from ballista_tpu_torch.utils import counters
from ballista_tpu_torch.utils.counters import Counts

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "ballista_tpu_torch"
LAYERS = ("scheduler", "client", "executor", "distributed", "utils")


def _imports(path: pathlib.Path):
    """(module, imported names) of every import in the file, nested ones
    included; a plain `import m` gives (m, ())."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.extend((a.name, ()) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.append((node.module, tuple(a.name for a in node.names)))
    return out


def test_the_registry_imports_nothing_of_the_package_but_locks():
    mods = {m for m, _ in _imports(PKG / "utils" / "counters.py")
            if m.split(".")[0] == "ballista_tpu_torch"}
    assert mods == {"ballista_tpu_torch.utils.locks"}
    # and in a fresh process it loads no other module of the package
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, ballista_tpu_torch.utils.counters; "
         "print(sorted(m for m in sys.modules if m.startswith('ballista_tpu_torch')))"],
        cwd=str(REPO), capture_output=True, text=True, check=True)
    loaded = set(ast.literal_eval(proc.stdout.strip()))
    assert loaded == {"ballista_tpu_torch", "ballista_tpu_torch.errors",
                      "ballista_tpu_torch.utils", "ballista_tpu_torch.utils.counters",
                      "ballista_tpu_torch.utils.locks"}, loaded


@pytest.mark.parametrize("layer", LAYERS)
def test_layers_outside_ops_count_through_the_registry(layer):
    """Only the routing decision recorder, which consults the cost model,
    comes from ops.runtime; utils/ imports nothing of ops/."""
    for path in sorted((PKG / layer).rglob("*.py")):
        for mod, names in _imports(path):
            if layer == "utils":
                assert not mod.startswith("ballista_tpu_torch.ops"), (path, mod)
            if mod == "ballista_tpu_torch.ops.runtime":
                bad = [n for n in names if n.startswith("record_") and n != "record_routing"]
                assert not bad, (path, bad)
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            # nor through the module: runtime.record_x(...)
            if isinstance(node, ast.Attribute) and node.attr.startswith("record_") \
                    and isinstance(node.value, ast.Name) and node.value.id == "runtime":
                assert node.attr == "record_routing", (path, node.lineno, node.attr)


def test_counts_record_add_set_and_gauge():
    c = Counts()
    c.record("a")
    c.record("a", 2.7)  # a whole set adds int(n)
    c.add({"b": 1.5, "a": 1})
    c.set("v", 9)
    c.gauge("g", 3.0)
    c.gauge("g", 1.0)
    assert c.stats() == {"a": 4, "b": 1.5, "v": 9, "g": 1.0, "g_peak": 3.0}
    assert c.stats(reset=True)["a"] == 4
    assert c.stats() == {}
    f = Counts(whole=False)
    f.record("s", 0.25)
    f.record("s", 0.5)
    assert f.stats() == {"s": 0.75}


def test_counts_reset_restores_the_zero_keys():
    c = Counts(zero={"rows": 0, "secs": 0.0})
    assert c.stats() == {"rows": 0, "secs": 0.0}
    c.add({"rows": 5, "secs": 0.5, "extra": 1})
    assert c.stats(reset=True) == {"rows": 5, "secs": 0.5, "extra": 1}
    out = c.stats()
    assert out == {"rows": 0, "secs": 0.0}
    assert isinstance(out["rows"], int) and isinstance(out["secs"], float)


def test_grouped_lists_every_part_and_keeps_plain_keys():
    c = Counts(zero={("costs", "n"): 0, "last": 0})
    c.record(("routes", "batches"))
    c.record(("routes", "batches"))
    c.set("last", 7)
    assert c.grouped(("routes", "reasons", "costs")) == {
        "routes": {"batches": 2}, "reasons": {}, "costs": {"n": 0}, "last": 7}
    assert c.grouped(("routes", "reasons", "costs"), reset=True)["routes"] == {"batches": 2}
    assert c.grouped(("routes", "reasons", "costs")) == {
        "routes": {}, "reasons": {}, "costs": {"n": 0}, "last": 0}


def test_routing_and_join_path_readers_keep_their_shape():
    runtime.routing_stats(reset=True)
    runtime.join_path_stats(reset=True)
    assert runtime.routing_stats() == {
        "routes": {}, "reasons": {}, "events": {}, "step_asides": {},
        "costs": {"predicted_s": 0.0, "observed_s": 0.0, "predictions": 0, "mispredicts": 0},
        "h2d_chunk_bytes": 0}
    runtime.record_route("host", "why")
    runtime.record_route("batches")
    runtime.record_routing_reason("planner")
    runtime.record_routing_event("split", 2)
    runtime.record_step_aside("tier")
    runtime.record_routing("device", "join", predicted_s=1.0, observed_s=1.0)
    runtime.record_join_path("split", "tier boundary")
    runtime.record_join_path("device")
    got = runtime.routing_stats(reset=True)
    assert got["routes"] == {"host": 1, "batches": 1}
    assert got["reasons"] == {"why": 1, "planner": 1}
    assert got["events"] == {"split": 2, "join:device": 1}
    assert got["step_asides"] == {"tier": 1}
    assert got["costs"] == {"predicted_s": 1.0, "observed_s": 1.0, "predictions": 1,
                            "mispredicts": 0}
    assert runtime.join_path_stats(reset=True) == {
        "paths": {"split": 1, "device": 1}, "reasons": {"split: tier boundary": 1}}
    assert runtime.join_path_stats() == {"paths": {}, "reasons": {}}


def test_readback_site_counts_beside_the_totals():
    runtime.readback_stats(reset=True)
    runtime.readback(torch.zeros(3, 5, dtype=torch.int32))
    runtime.readback(torch.zeros(8, dtype=torch.int64), rows=2, site="join")
    assert runtime.readback_stats() == {"rows": 7, "bytes": 60 + 64, "readbacks": 2}
    assert counters.readback.stats(reset=True) == {
        "rows": 7, "bytes": 124, "readbacks": 2,
        "join.rows": 2, "join.bytes": 64, "join.readbacks": 1}
    assert runtime.readback_stats() == {"rows": 0, "bytes": 0, "readbacks": 0}


@pytest.mark.parametrize("name", ["ingest", "delta", "serving", "recovery", "tenancy",
                                  "shared_scan", "shuffle_tier", "exchange", "speculation",
                                  "fleet"])
def test_runtime_reexports_each_sets_reader(name):
    reader = getattr(runtime, f"{name}_stats")
    counts = getattr(counters, name)
    reader(reset=True)
    counts.record("probe_event", 3)
    assert reader(reset=True)["probe_event"] == 3
    assert "probe_event" not in reader()


def test_ingest_reports_its_zero_totals():
    runtime.ingest_stats(reset=True)
    assert runtime.ingest_stats() == {"scan_s": 0.0, "encode_s": 0.0, "upload_s": 0.0,
                                      "wall_s": 0.0, "prepares": 0, "reused": 0}


def test_tracing_counters_are_the_named_set():
    from ballista_tpu_torch.utils import tracing

    tracing.reset()
    tracing.incr("probe.named")
    tracing.incr("probe.named", 2)
    assert counters.named.stats()["probe.named"] == 3
    assert tracing.counters()["probe.named"] == 3
    tracing.reset()
    assert "probe.named" not in tracing.counters()
